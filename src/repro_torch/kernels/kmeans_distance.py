"""K1, K2, K5, K7, K8, K11 and K12 — the prologue, the k-means++ seeding
round (ungated, bound-gated, and each batched) and the rejection sampler's
two small kernels (port of ``repro.kernels.kmeans_distance``'s
``seed_prologue_pallas``, ``distance_min_update_pallas``,
``distance_min_update_gated_pallas``, ``distance_min_update_batched_pallas``,
``distance_min_update_gated_batched_pallas``, ``row_min_d2_pallas`` and
``tile_cap_pallas``).

K1 ``seed_prologue`` is the once-per-call pass: the fp32 norms every round
streams, and the tile balls (centers, radii, each row's distance to its
tile's center) the seeding and assignment gates read. ``seed_prologue_batched``
is K1 over B independent problems in one launch, row b K1 on problem b (the
reference batches its prologue kernel through ``pallas_call``'s generic
``vmap`` rule).
K1 reads a tile once where it fits its CTA's shared memory (the lone
route; past the widths it holds, the wide route), every output bitwise
``seed_prologue_template``'s, the kernel before its redesign, which the
card tests hold it to.

One round (K2) folds the newest centroid block c (m, d) into every point's
D² and returns the per-tile partial sums the samplers draw from:

    new_md = min(md, min_c max(||x||² − 2 x·c + ||c||², 0)),
    partials[t] = sum of new_md over tile t's rows.

The batched round (K7) is K2 over B independent problems in one launch:
(B, n, d) points, (B, m, d) centroids, (B, n) norms and D², (B, T)
partials; row b is K2 on problem b. The gated round (K5) does the same as
K2 on the tiles the seeding gate marks active only, skips the rows the
per-point bound prunes, and also returns each tile's max of new_md and its
count of pruned rows; inactive tiles keep their carried values. K8 is K5
over B problems in one launch, each with its own gate, row b K5 on problem
b. At d >= 8, K2 and K7 run K5's row loop with every tile active and no
prune (the same bits as their template body, which ``*_template`` keeps
reachable for the card tests).

K7 and K8 also take a problem list (``problems=``, an (R,) int32 device
tensor): one launch over the listed problems' tiles, writing in place into
the caller's carries (D², partials, and K8's tile maxima), so a problem off
the list is not touched and no listed problem's points are copied; a
listed problem's outputs are bitwise the full launch's. Batched rejection
seeding refreshes through them only the problems whose pending block has
filled.

Rejection seeding (K11, K12) works between refreshes against the pending
block of P centroids not yet folded in, of which the first ``count`` are
live: K11 ``row_min_d2`` is the D² of each drawn row to them (the exact
p of every proposal of a round, one launch), K12 ``tile_cap`` bounds every
tile's current D² from its ball alone. Both use the diff-square form and
add the columns in a fixed order, so the kernels and their plain twins
agree bitwise; both take any (P, d). ``tile_envelope`` is K12 as a hier
round runs it: the caps and, in the same launch, the round's capped tile
masses, tight tiles and their count (bitwise ``tile_envelope_torch``).
``row_min_d2`` and ``tile_envelope`` also take B problems at once (a leading
axis on every argument, the counts (B,)), one launch for all, row b bitwise
the single launch on problem b.

The rounds (K2, K5, K7, K8) read points and centroids as fp32 or as a
bf16 stream, both of one dtype: the bf16 instance widens each value
exactly and then does the fp32 instance's arithmetic, so its results are
the fp32 kernel's on the bf16-rounded inputs. Norms, D², partials and the
gate stay fp32, and the norms are the full-precision points' (the engine's
``precision="bf16"``). The plain twins widen the same way. K1, K11 and K12
read fp32 only.

Each wrapper launches its hand-written CUDA kernel (``csrc/seed_prologue.cu``,
``csrc/kmeans_distance.cu``, ``csrc/rejection.cu``) for tensors on the card,
and runs its plain twin (``*_torch``) only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bounds
from repro_torch.core.guards import KernelFailureError
from repro_torch.core.sampling import tile_partials
from repro_torch.kernels import _build, ops

# the rounds' last int is the stream flag (1: bf16 points and centroids)
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_BATCHED_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7
                     + (ctypes.c_void_p,))
# K5 and K8 take the carried partials and tile maxima; the template entry
# (outputs pre-filled with the carries) does not
_GATED_ARGTYPES = ((ctypes.c_void_p,) * 14 + (ctypes.c_int,) * 6
                   + (ctypes.c_void_p,))
_GATED_BATCHED_ARGTYPES = ((ctypes.c_void_p,) * 14 + (ctypes.c_int,) * 7
                           + (ctypes.c_void_p,))
_GATED_TEMPLATE_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 6
                            + (ctypes.c_void_p,))
# K1 and its template entry
_PROLOGUE_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4
                      + (ctypes.c_void_p,))
_ROW_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_longlong,)
                 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
_CAP_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
_ENVELOPE_ARGTYPES = (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
# the problem-list forms of K7 and K8, and the batched K11 and K12
_LISTED_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7
                    + (ctypes.c_void_p,))
_GATED_LISTED_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 7
                          + (ctypes.c_void_p,))
_ROW_BATCHED_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_longlong,)
                         + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_ENVELOPE_BATCHED_ARGTYPES = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 5
                              + (ctypes.c_void_p,))


def tile_d2(x: torch.Tensor, c: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """(rows, m) matmul-form D² with the cached fp32 norms ``xn`` — THE
    shared round math of the plain twins. A bf16 stream (``x`` and ``c``)
    is widened to fp32 first, exactly, and the norms ``cn`` are the rounded
    centroids': the product is an fp32 one, as the kernels' and the
    reference's (a bf16 ``@`` would round the dots to bf16)."""
    c = c.float()
    cn = (c * c).sum(dim=1)
    dots = x.float() @ c.T
    return torch.clamp_min(xn[:, None] - 2.0 * dots + cn[None, :], 0.0)


def distance_min_update_torch(points: torch.Tensor, norms: torch.Tensor,
                              centroids: torch.Tensor, min_d2: torch.Tensor,
                              *, block_n: int):
    """Plain PyTorch twin of K2. Returns (new_min_d2 (n,), partials
    (n_tiles,))."""
    new = torch.minimum(min_d2, tile_d2(points, centroids, norms).amin(dim=1))
    return new, tile_partials(new, block_n)


def distance_min_update_batched_torch(points: torch.Tensor,
                                      norms: torch.Tensor,
                                      centroids: torch.Tensor,
                                      min_d2: torch.Tensor, *, block_n: int):
    """Plain PyTorch twin of K7: K2's twin on each problem, stacked, so row b
    is bitwise the single twin on problem b. Returns (new_min_d2 (B, n),
    partials (B, n_tiles))."""
    outs = [distance_min_update_torch(p, nr, c, md, block_n=block_n)
            for p, nr, c, md in zip(points, norms, centroids, min_d2)]
    return tuple(torch.stack(o) for o in zip(*outs))


def seed_prologue_torch(points: torch.Tensor, block_n: int):
    """Plain PyTorch twin of K1, the arithmetic of the reference's
    ``_prologue_kernel``: (norms (n,), centers (T, d), radii (T,),
    center_d (n,)), all fp32. Batched points (B, n, d) give each problem's,
    stacked: the twin of the batched K1."""
    return tuple(bounds.prologue(points, block_n))


def gate_select(new_md_full: torch.Tensor, min_d2: torch.Tensor,
                center_d: torch.Tensor, dc: torch.Tensor,
                margin: torch.Tensor, prev_partials: torch.Tensor,
                prev_tile_max: torch.Tensor, active: torch.Tensor, *,
                block_n: int, weights: torch.Tensor | None = None):
    """K5's per-tile selects, given every row's ungated ``new_md_full``:
    rows of active tiles that the per-point bound does not prune take the
    fresh value, all others keep ``min_d2``; active tiles re-sum their
    partial (of D²·``weights`` when given) and max, inactive ones keep the
    carried entries. Returns (min_d2, partials, tile_max, pruned (T,)
    int32)."""
    n = min_d2.shape[0]
    act_pt = bounds.expand_mask(active, block_n, n)
    prune = act_pt & bounds.seed_point_prune(
        min_d2, center_d, bounds.expand_mask(dc, block_n, n),
        bounds.expand_mask(margin, block_n, n))
    md = torch.where(act_pt & ~prune, new_md_full, min_d2)
    wmd = md if weights is None else md * weights
    partials = torch.where(active, tile_partials(wmd, block_n), prev_partials)
    tile_max = torch.where(active, bounds.tile_reduce_max(md, block_n),
                           prev_tile_max)
    return (md, partials, tile_max,
            tile_partials(prune.int(), block_n).to(torch.int32))


def distance_min_update_gated_torch(points, norms, centroids, min_d2,
                                    center_d, dc, margin, prev_partials,
                                    prev_tile_max, active, *, block_n: int):
    """Plain PyTorch twin of K5, the reference's per-tile math: masked tiles
    take every output from the carry, pruned rows keep their ``min_d2``.
    Returns (min_d2 (n,), partials (T,), tile_max (T,), pruned (T,))."""
    full = distance_min_update_torch(points, norms, centroids, min_d2,
                                     block_n=block_n)[0]
    return gate_select(full, min_d2, center_d, dc, margin, prev_partials,
                       prev_tile_max, active, block_n=block_n)


def distance_min_update_gated_batched_torch(*args, block_n: int):
    """Plain PyTorch twin of K8: K5's twin on each problem of the (B, ...)
    arguments (those of ``distance_min_update_gated_torch``), stacked, so
    row b is bitwise the single twin on problem b. Returns (min_d2 (B, n),
    partials (B, T), tile_max (B, T), pruned (B, T))."""
    outs = [distance_min_update_gated_torch(*one, block_n=block_n)
            for one in zip(*args)]
    return tuple(torch.stack(o) for o in zip(*outs))


def _check_prologue(points: torch.Tensor, block_n: int, dims: int) -> None:
    if points.dim() != dims or min(points.shape) < 1:
        want = "(n, d)" if dims == 2 else "(B, n, d)"
        raise ValueError(f"points must be {want}, got {tuple(points.shape)}")
    if block_n < 1:
        raise ValueError(f"block_n must be >= 1, got {block_n}")
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {points.device}")


def _prologue_launch(points: torch.Tensor, block_n: int, symbol: str):
    """One launch over the (B, n, d) points (B = 1 for the single K1) of
    K1's source entry ``symbol``: K1 or its template. Returns the outputs
    with the leading axis."""
    bsz, n, d = points.shape
    n_tiles = -(-n // block_n)
    if bsz * n_tiles >= 2 ** 31:
        raise ValueError(f"{bsz} problems of {n_tiles} tiles exceed the "
                         "grid's 2^31 - 1 blocks")
    ops.check_card_tensors(points=points)
    fn = _build.function("seed_prologue", symbol, _PROLOGUE_ARGTYPES)
    dev = points.device
    norms = torch.empty((bsz, n), dtype=torch.float32, device=dev)
    center_d = torch.empty_like(norms)
    centers = torch.empty((bsz, n_tiles, d), dtype=torch.float32, device=dev)
    radii = torch.empty((bsz, n_tiles), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centers.data_ptr(),
                 radii.data_ptr(), center_d.data_ptr(), bsz, n, d, block_n,
                 stream)
    if err != 0:
        raise KernelFailureError(f"{symbol} failed: cudaError {err}")
    return norms, centers, radii, center_d


def prologue_route(d: int, block_n: int) -> int:
    """The route K1 takes for (d, block_n) tiles on the card, as its source
    decides: 1, the lone route (a CTA a tile, its first rows staged in
    shared memory, all of a tile that fits), or 0, the wide route (past
    the widths whose center and chains fit a CTA). Builds the source."""
    fn = _build.function("seed_prologue", "seed_prologue_route",
                         (ctypes.c_int, ctypes.c_int))
    return int(fn(d, block_n))


def seed_prologue(points: torch.Tensor, block_n: int):
    """The prologue at tile height ``block_n``. Returns (norms (n,),
    centers (T, d), radii (T,), center_d (n,)). On the card this launches
    K1 (on the route :func:`prologue_route` names; every output bitwise
    :func:`seed_prologue_template`'s). CPU tensors take the plain twin."""
    _check_prologue(points, block_n, 2)
    if points.device.type == "cpu":
        return seed_prologue_torch(points, block_n)
    out = _prologue_launch(points[None], block_n,
                           "seed_prologue_batched_launch")
    ops.LAUNCHES["seed_prologue"] += 1
    return tuple(o[0] for o in out)


def seed_prologue_batched(points: torch.Tensor, block_n: int):
    """The prologue of B independent problems (points (B, n, d)) at tile
    height ``block_n``. Returns (norms (B, n), centers (B, T, d), radii
    (B, T), center_d (B, n)). On the card this launches the batched K1, one
    launch for every problem, row b bitwise K1 on problem b; CPU tensors
    take the plain twin."""
    _check_prologue(points, block_n, 3)
    if points.device.type == "cpu":
        return seed_prologue_torch(points, block_n)
    out = _prologue_launch(points, block_n, "seed_prologue_batched_launch")
    ops.LAUNCHES["seed_prologue_batched"] += 1
    return out


def seed_prologue_template(points: torch.Tensor, block_n: int):
    """K1's template kernel (its kernel before the redesign) on (n, d) or
    (B, n, d) points: the bits K1 is held to on the card. It stages the
    (d,) center beside 256 floats and refuses (``KernelFailureError``) past
    d = 57,856. Counts no launch; the engine never calls it. CPU tensors
    take the plain twin."""
    batched = points.dim() == 3
    _check_prologue(points, block_n, 3 if batched else 2)
    if points.device.type == "cpu":
        return seed_prologue_torch(points, block_n)
    out = _prologue_launch(points if batched else points[None], block_n,
                           "seed_prologue_template_launch")
    return out if batched else tuple(o[0] for o in out)


def _check(points, norms, centroids, min_d2, block_n):
    if points.dim() != 2 or centroids.dim() != 2:
        raise ValueError("points and centroids must be 2-D")
    n, d = points.shape
    if n < 1 or centroids.shape[0] < 1 or centroids.shape[1] != d:
        raise ValueError(f"bad shapes: points {tuple(points.shape)}, "
                         f"centroids {tuple(centroids.shape)}")
    if tuple(norms.shape) != (n,) or tuple(min_d2.shape) != (n,):
        raise ValueError(f"norms {tuple(norms.shape)} and min_d2 "
                         f"{tuple(min_d2.shape)} must be ({n},)")
    if block_n < 1:
        raise ValueError(f"block_n must be >= 1, got {block_n}")
    devs = {t.device for t in (points, norms, centroids, min_d2)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    ops.stream_is_bf16(points, centroids)


def _check_batched(points, norms, centroids, min_d2, block_n):
    if points.dim() != 3 or centroids.dim() != 3:
        raise ValueError("points and centroids must be 3-D (B, rows, d)")
    bsz = points.shape[0]
    if centroids.shape[0] != bsz or norms.shape[:1] != (bsz,) \
            or min_d2.shape[:1] != (bsz,) or bsz < 1:
        raise ValueError(f"problem counts differ: points "
                         f"{tuple(points.shape)}, centroids "
                         f"{tuple(centroids.shape)}, norms "
                         f"{tuple(norms.shape)}, min_d2 {tuple(min_d2.shape)}")
    _check(points[0], norms[0], centroids[0], min_d2[0], block_n)
    devs = {t.device for t in (points, norms, centroids, min_d2)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def distance_min_update(points: torch.Tensor, norms: torch.Tensor,
                        centroids: torch.Tensor, min_d2: torch.Tensor, *,
                        block_n: int, resident: bool = True):
    """One seeding round. Returns (new_min_d2 (n,), partials (n_tiles,)).

    On the card this launches K2: ``resident`` stages the centroid block in
    shared memory (the paper's constant memory; in chunks of what fits, so
    any m), ``resident=False`` re-reads it from global memory on every use
    (Fig. 2's global-memory variant); both give the same bits. At d >= 8 it
    is K5's row loop, ungated, below the template body: bitwise
    :func:`distance_min_update_template` either way. CPU tensors take the
    plain twin."""
    _check(points, norms, centroids, min_d2, block_n)
    if points.device.type == "cpu":
        return distance_min_update_torch(points, norms, centroids, min_d2,
                                         block_n=block_n)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms,
                                   min_d2=min_d2)
    n, d = points.shape
    m = centroids.shape[0]
    fn = _build.function("kmeans_distance", "distance_min_update_launch",
                         _ARGTYPES)
    out = torch.empty_like(min_d2)
    partials = torch.empty(-(-n // block_n), dtype=torch.float32,
                           device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 min_d2.data_ptr(), out.data_ptr(), partials.data_ptr(),
                 n, d, m, block_n, int(resident), int(bf16), stream)
    if err != 0:
        raise KernelFailureError(f"distance_min_update launch failed: "
                                 f"cudaError {err}")
    ops.count_launch("distance_min_update", bf16)
    return out, partials


def _check_listed(problems, bsz: int, device, carries) -> None:
    """A problem list's checks: (R,) int32 on the points' device, and the
    in-place carries ``carries`` (name -> (tensor, shape)) as given."""
    if problems.dim() != 1 or problems.dtype != torch.int32 \
            or problems.device != device or problems.numel() > bsz:
        raise ValueError(f"problems must be (R,) int32 on {device} with "
                         f"R <= {bsz}, got {tuple(problems.shape)} "
                         f"{problems.dtype} on {problems.device}")
    for name, (t, shape) in carries.items():
        if t is None or tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != device:
            raise ValueError(f"{name} must be an fp32 {shape} carry on "
                             f"{device}")


def _listed_twin(twin, problems, args, carries, block_n):
    """The plain twin of a listed round: ``twin`` on the listed problems'
    slices of ``args``, its outputs written into the ``carries`` rows of
    those problems (in order). Returns the twin's outputs."""
    pl = problems.long()
    out = twin(*(a.index_select(0, pl) for a in args), block_n=block_n)
    for carry, o in zip(carries, out):
        carry.index_copy_(0, pl, o)
    return out


def distance_min_update_batched(points: torch.Tensor, norms: torch.Tensor,
                                centroids: torch.Tensor, min_d2: torch.Tensor,
                                *, block_n: int, resident: bool = True,
                                problems: torch.Tensor | None = None,
                                partials: torch.Tensor | None = None):
    """One seeding round of B independent problems: points (B, n, d), norms
    and min_d2 (B, n), centroids (B, m, d). Returns (new_min_d2 (B, n),
    partials (B, n_tiles)). On the card this launches K7, one launch for
    every problem, ``resident`` as for K2; CPU tensors take the plain
    twin.

    ``problems`` (R,) int32 on the points' device (any order, each at most
    once) runs the round on the listed problems only, in place: their rows
    of ``min_d2`` and of the ``partials`` carry (B, n_tiles) are updated,
    bitwise the full round's, and nothing else is read or written; returns
    (min_d2, partials). An empty list launches nothing."""
    _check_batched(points, norms, centroids, min_d2, block_n)
    bsz = points.shape[0]
    if problems is not None:
        n_tiles = -(-points.shape[1] // block_n)
        _check_listed(problems, bsz, points.device, {
            "min_d2": (min_d2, (bsz, points.shape[1])),
            "partials": (partials, (bsz, n_tiles))})
        return _listed_round(points, norms, centroids, min_d2, partials,
                             problems, block_n=block_n, resident=resident)
    if points.device.type == "cpu":
        return distance_min_update_batched_torch(points, norms, centroids,
                                                 min_d2, block_n=block_n)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms,
                                   min_d2=min_d2)
    _, n, d = points.shape
    m = centroids.shape[1]
    n_tiles = -(-n // block_n)
    if bsz * n_tiles >= 2 ** 31:
        raise ValueError(f"{bsz} problems of {n_tiles} tiles exceed the "
                         "grid's 2^31 - 1 blocks")
    fn = _build.function("kmeans_distance",
                         "distance_min_update_batched_launch",
                         _BATCHED_ARGTYPES)
    out = torch.empty_like(min_d2)
    partials = torch.empty((bsz, n_tiles), dtype=torch.float32,
                           device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 min_d2.data_ptr(), out.data_ptr(), partials.data_ptr(),
                 bsz, n, d, m, block_n, int(resident), int(bf16), stream)
    if err != 0:
        raise KernelFailureError(f"distance_min_update_batched launch "
                                 f"failed: cudaError {err}")
    ops.count_launch("distance_min_update_batched", bf16)
    return out, partials


def _listed_round(points, norms, centroids, min_d2, partials, problems, *,
                  block_n: int, resident: bool):
    """K7 over the listed problems, in place (see
    :func:`distance_min_update_batched`)."""
    if problems.numel() == 0:
        return min_d2, partials
    if points.device.type == "cpu":
        _listed_twin(distance_min_update_batched_torch, problems,
                     (points, norms, centroids, min_d2), (min_d2, partials),
                     block_n)
        return min_d2, partials
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms,
                                   min_d2=min_d2, partials=partials)
    _, n, d = points.shape
    if problems.numel() * -(-n // block_n) >= 2 ** 31:
        raise ValueError("the listed problems' tiles exceed the grid's "
                         "2^31 - 1 blocks")
    fn = _build.function("kmeans_distance",
                         "distance_min_update_listed_launch",
                         _LISTED_ARGTYPES)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 min_d2.data_ptr(), partials.data_ptr(),
                 problems.contiguous().data_ptr(), problems.numel(), n, d,
                 centroids.shape[1], block_n, int(resident), int(bf16),
                 stream)
    if err != 0:
        raise KernelFailureError(f"distance_min_update_listed launch failed: "
                                 f"cudaError {err}")
    ops.count_launch("distance_min_update_batched", bf16)
    return min_d2, partials


def distance_min_update_template(points: torch.Tensor, norms: torch.Tensor,
                                 centroids: torch.Tensor,
                                 min_d2: torch.Tensor, *, block_n: int,
                                 resident: bool = True):
    """K2 ((n, d) points) or K7 ((B, n, d)) as the template body computes
    them at every width (their kernel before K5's row loop took d >= 8):
    the arguments and returns of :func:`distance_min_update` and
    :func:`distance_min_update_batched`. The reference the card tests and
    the smoke script hold K2 and K7 to, bit for bit; the engine never calls
    it. Counts no launch; CPU tensors take the plain twin."""
    batched = points.dim() == 3
    if batched:
        _check_batched(points, norms, centroids, min_d2, block_n)
    else:
        _check(points, norms, centroids, min_d2, block_n)
    if points.device.type == "cpu":
        plain = (distance_min_update_batched_torch if batched
                 else distance_min_update_torch)
        return plain(points, norms, centroids, min_d2, block_n=block_n)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms,
                                   min_d2=min_d2)
    n, d = points.shape[-2:]
    fn = _build.function("kmeans_distance",
                         "distance_min_update_template_launch",
                         _BATCHED_ARGTYPES)
    out = torch.empty_like(min_d2)
    partials = torch.empty(points.shape[:-2] + (-(-n // block_n),),
                           dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 min_d2.data_ptr(), out.data_ptr(), partials.data_ptr(),
                 points.shape[0] if batched else 1, n, d,
                 centroids.shape[-2], block_n, int(resident), int(bf16),
                 stream)
    if err != 0:
        raise KernelFailureError(f"distance_min_update_template launch "
                                 f"failed: cudaError {err}")
    return out, partials


def _check_gated(points, norms, centroids, min_d2, center_d, dc, margin,
                 prev_partials, prev_tile_max, active, block_n):
    """The gated rounds' shape checks, on (n, d) points (K5) or (B, n, d)
    points with (B, m, d) centroids (K8)."""
    if points.dim() != centroids.dim() or points.dim() not in (2, 3):
        raise ValueError("points and centroids must both be 2-D (K5) or "
                         "3-D (B, rows, d) (K8)")
    lead = tuple(points.shape[:-2])
    one = (lambda t: t) if not lead else (lambda t: t[0])
    _check(one(points), one(norms), one(centroids), one(min_d2), block_n)
    n, d = points.shape[-2:]
    m = centroids.shape[-2]
    n_tiles = -(-n // block_n)
    args = (points, norms, centroids, min_d2, center_d, dc, margin,
            prev_partials, prev_tile_max, active)
    want = ((n, d), (n,), (m, d), (n,), (n,)) + ((n_tiles,),) * 5
    for name, t, shape in zip(("points", "norms", "centroids", "min_d2",
                               "center_d", "dc", "margin", "prev_partials",
                               "prev_tile_max", "active"), args, want):
        if tuple(t.shape) != lead + shape:
            raise ValueError(f"{name} {tuple(t.shape)} must be "
                             f"{lead + shape}")
    if len({t.device for t in args}) != 1:
        raise ValueError("inputs on several devices")


def _mask_bytes(active: torch.Tensor) -> torch.Tensor:
    """The mask as the kernels read it, one byte a tile: a contiguous bool
    mask's own bytes (no copy), any other mask converted."""
    if active.dtype == torch.bool and active.is_contiguous():
        return active.view(torch.uint8)
    return active.to(torch.uint8).contiguous()


def distance_min_update_gated(points: torch.Tensor, norms: torch.Tensor,
                              centroids: torch.Tensor, min_d2: torch.Tensor,
                              center_d: torch.Tensor, dc: torch.Tensor,
                              margin: torch.Tensor,
                              prev_partials: torch.Tensor,
                              prev_tile_max: torch.Tensor,
                              active: torch.Tensor, *, block_n: int,
                              resident: bool = True, inplace: bool = False):
    """One bound-gated seeding round. ``active``/``dc``/``margin`` come from
    ``bounds.seed_gate``, ``center_d`` from the prologue; ``prev_partials``
    and ``prev_tile_max`` are the carried per-tile state, at the tile height
    ``block_n``. Returns (min_d2 (n,), partials (T,), tile_max (T,),
    pruned (T,) int32). On the card this launches K5 over the full grid of
    tiles, which writes every output (a skipped tile its carries), so no
    carry is copied here; ``inplace`` writes the new D² into ``min_d2``
    itself (the TPU kernel's aliasing), for a caller that never reads the
    old carry again. CPU tensors take the plain twin (a new tensor either
    way)."""
    _check_gated(points, norms, centroids, min_d2, center_d, dc, margin,
                 prev_partials, prev_tile_max, active, block_n)
    if points.dim() != 2:
        raise ValueError("points and centroids must be 2-D")
    if points.device.type == "cpu":
        return distance_min_update_gated_torch(
            points, norms, centroids, min_d2, center_d, dc, margin,
            prev_partials, prev_tile_max, active, block_n=block_n)
    return _gated_launch(points, norms, centroids, min_d2, center_d, dc,
                         margin, prev_partials, prev_tile_max, active,
                         block_n=block_n, resident=resident, inplace=inplace)


def distance_min_update_gated_batched(points: torch.Tensor,
                                      norms: torch.Tensor,
                                      centroids: torch.Tensor,
                                      min_d2: torch.Tensor,
                                      center_d: torch.Tensor,
                                      dc: torch.Tensor, margin: torch.Tensor,
                                      prev_partials: torch.Tensor,
                                      prev_tile_max: torch.Tensor,
                                      active: torch.Tensor, *, block_n: int,
                                      resident: bool = True,
                                      inplace: bool = False,
                                      problems: torch.Tensor | None = None):
    """One bound-gated seeding round of B independent problems: the
    arguments of ``distance_min_update_gated`` with a leading problem axis
    (points (B, n, d), centroids (B, m, d), norms, min_d2 and center_d
    (B, n), dc, margin, the carries and ``active`` (B, T)), each problem
    gated by its own mask. Returns (min_d2 (B, n), partials (B, T),
    tile_max (B, T), pruned (B, T) int32). On the card this launches K8,
    one launch over every problem's tiles, which writes every output as K5
    does (``inplace`` as K5's); row b is K5 on problem b, bitwise. CPU
    tensors take the plain twin.

    ``problems`` (R,) int32 on the points' device (any order, each at most
    once) runs the round on the listed problems only, in place: their rows
    of ``min_d2``, ``prev_partials`` and ``prev_tile_max`` (the carries)
    are updated, bitwise the full round's, and nothing else of them is read
    or written; returns (min_d2, prev_partials, prev_tile_max, pruned
    (B, T) int32, 0 off the list). An empty list launches nothing."""
    _check_gated(points, norms, centroids, min_d2, center_d, dc, margin,
                 prev_partials, prev_tile_max, active, block_n)
    if points.dim() != 3:
        raise ValueError("points and centroids must be 3-D (B, rows, d)")
    if problems is not None:
        _check_listed(problems, points.shape[0], points.device, {
            "min_d2": (min_d2, tuple(min_d2.shape)),
            "prev_partials": (prev_partials, tuple(active.shape)),
            "prev_tile_max": (prev_tile_max, tuple(active.shape))})
        return _gated_listed_round(
            points, norms, centroids, min_d2, center_d, dc, margin,
            prev_partials, prev_tile_max, active, problems, block_n=block_n,
            resident=resident)
    if points.device.type == "cpu":
        return distance_min_update_gated_batched_torch(
            points, norms, centroids, min_d2, center_d, dc, margin,
            prev_partials, prev_tile_max, active, block_n=block_n)
    bsz = points.shape[0]
    if bsz * -(-points.shape[1] // block_n) >= 2 ** 31:
        raise ValueError(f"{bsz} problems of {-(-points.shape[1] // block_n)}"
                         " tiles exceed the grid's 2^31 - 1 blocks")
    return _gated_launch(points, norms, centroids, min_d2, center_d, dc,
                         margin, prev_partials, prev_tile_max, active,
                         block_n=block_n, resident=resident, inplace=inplace)


def _gated_launch(points, norms, centroids, min_d2, center_d, dc, margin,
                  prev_partials, prev_tile_max, active, *, block_n: int,
                  resident: bool, inplace: bool):
    """K5 ((n, d) points) or K8 ((B, n, d)) on the card: the outputs
    allocated empty (``min_d2`` itself where ``inplace``), the carries and
    the mask's bytes passed as they are."""
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    prev_partials, prev_tile_max = (t.float().contiguous()
                                    for t in (prev_partials, prev_tile_max))
    bf16 = ops.check_round_tensors(points, centroids, norms=norms,
                                   min_d2=min_d2, center_d=center_d, dc=dc,
                                   margin=margin)
    batched = points.dim() == 3
    n, d = points.shape[-2:]
    m = centroids.shape[-2]
    name = ("distance_min_update_gated_batched" if batched
            else "distance_min_update_gated")
    fn = _build.function("kmeans_distance", f"{name}_launch",
                         _GATED_BATCHED_ARGTYPES if batched
                         else _GATED_ARGTYPES)
    out = min_d2 if inplace else torch.empty_like(min_d2)
    partials = torch.empty_like(prev_partials)
    tile_max = torch.empty_like(prev_tile_max)
    pruned = torch.empty(prev_partials.shape, dtype=torch.int32,
                         device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 min_d2.data_ptr(), out.data_ptr(), partials.data_ptr(),
                 center_d.data_ptr(), dc.data_ptr(), margin.data_ptr(),
                 _mask_bytes(active).data_ptr(), prev_partials.data_ptr(),
                 prev_tile_max.data_ptr(), tile_max.data_ptr(),
                 pruned.data_ptr(), *points.shape[:-2], n, d, m, block_n,
                 int(resident), int(bf16), stream)
    if err != 0:
        raise KernelFailureError(f"{name} launch failed: cudaError {err}")
    ops.count_launch(name, bf16)
    return out, partials, tile_max, pruned


def _gated_listed_round(points, norms, centroids, min_d2, center_d, dc,
                        margin, partials, tile_max, active, problems, *,
                        block_n: int, resident: bool):
    """K8 over the listed problems, in place (see
    :func:`distance_min_update_gated_batched`)."""
    pruned = torch.zeros(active.shape, dtype=torch.int32,
                         device=points.device)
    if problems.numel() == 0:
        return min_d2, partials, tile_max, pruned
    if points.device.type == "cpu":
        pruned_r = _listed_twin(
            distance_min_update_gated_batched_torch, problems,
            (points, norms, centroids, min_d2, center_d, dc, margin,
             partials, tile_max, active),
            (min_d2, partials, tile_max), block_n)[3]
        pruned.index_copy_(0, problems.long(), pruned_r)
        return min_d2, partials, tile_max, pruned
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms,
                                   min_d2=min_d2, center_d=center_d, dc=dc,
                                   margin=margin, partials=partials,
                                   tile_max=tile_max)
    _, n, d = points.shape
    if problems.numel() * -(-n // block_n) >= 2 ** 31:
        raise ValueError("the listed problems' tiles exceed the grid's "
                         "2^31 - 1 blocks")
    fn = _build.function("kmeans_distance",
                         "distance_min_update_gated_listed_launch",
                         _GATED_LISTED_ARGTYPES)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 min_d2.data_ptr(), partials.data_ptr(), center_d.data_ptr(),
                 dc.data_ptr(), margin.data_ptr(),
                 _mask_bytes(active).data_ptr(), tile_max.data_ptr(),
                 pruned.data_ptr(), problems.contiguous().data_ptr(),
                 problems.numel(), n, d, centroids.shape[1], block_n,
                 int(resident), int(bf16), stream)
    if err != 0:
        raise KernelFailureError(f"distance_min_update_gated_listed launch "
                                 f"failed: cudaError {err}")
    ops.count_launch("distance_min_update_gated_batched", bf16)
    return min_d2, partials, tile_max, pruned


def distance_min_update_gated_template(points: torch.Tensor,
                                       norms: torch.Tensor,
                                       centroids: torch.Tensor,
                                       min_d2: torch.Tensor,
                                       center_d: torch.Tensor,
                                       dc: torch.Tensor, margin: torch.Tensor,
                                       prev_partials: torch.Tensor,
                                       prev_tile_max: torch.Tensor,
                                       active: torch.Tensor, *, block_n: int,
                                       resident: bool = True):
    """K5 as the template kernel computes it (``distance_min_update_kernel``'s
    gated instance, K5's kernel before this redesign: its outputs start as
    copies of the carries, which a skipped tile leaves): the arguments and
    returns of :func:`distance_min_update_gated`. The reference the card
    tests and the smoke script hold K5 to, bit for bit; the engine never
    calls it, and it counts no launch. CPU tensors take the plain twin."""
    _check_gated(points, norms, centroids, min_d2, center_d, dc, margin,
                 prev_partials, prev_tile_max, active, block_n)
    if points.dim() != 2:
        raise ValueError("points and centroids must be 2-D")
    if points.device.type == "cpu":
        return distance_min_update_gated_torch(
            points, norms, centroids, min_d2, center_d, dc, margin,
            prev_partials, prev_tile_max, active, block_n=block_n)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms,
                                   min_d2=min_d2, center_d=center_d, dc=dc,
                                   margin=margin)
    n, d = points.shape
    m = centroids.shape[0]
    fn = _build.function("kmeans_distance",
                         "distance_min_update_gated_template_launch",
                         _GATED_TEMPLATE_ARGTYPES)
    out = min_d2.clone()
    partials = prev_partials.float().clone()
    tile_max = prev_tile_max.float().clone()
    pruned = torch.zeros(partials.shape, dtype=torch.int32,
                         device=points.device)
    act = active.to(torch.uint8).contiguous()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 min_d2.data_ptr(), out.data_ptr(), partials.data_ptr(),
                 center_d.data_ptr(), dc.data_ptr(), margin.data_ptr(),
                 act.data_ptr(), tile_max.data_ptr(), pruned.data_ptr(),
                 n, d, m, block_n, int(resident), int(bf16), stream)
    if err != 0:
        raise KernelFailureError(f"distance_min_update_gated_template launch "
                                 f"failed: cudaError {err}")
    return out, partials, tile_max, pruned


# ---------------------------------------------------------------------------
# K11 and K12: the rejection sampler's row distance and per-tile cap
# ---------------------------------------------------------------------------


def diff_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_c (a_c - b_c)²`` over the last dim, broadcasting ``a`` against
    ``b``: the columns added in ascending order, one rounded product and one
    rounded add each — the order K11 and K12 use."""
    t = a[..., 0] - b[..., 0]
    s = t * t
    for c in range(1, a.shape[-1]):
        t = a[..., c] - b[..., c]
        s = s + t * t
    return s


def _live(count, p: int, device) -> torch.Tensor:
    """(p,) bool: pending slot j is live when j < count ((B, p) for (B,)
    counts, each problem's)."""
    slots = torch.arange(p, device=device)
    if isinstance(count, torch.Tensor):
        return slots < count[..., None]
    return slots < count


def row_min_d2_torch(points: torch.Tensor, idx: torch.Tensor,
                     pending: torch.Tensor, count) -> torch.Tensor:
    """Plain PyTorch twin of K11: fp32 D² of each row ``idx`` (0-d or
    (A,), the result the same shape) to the nearest of
    ``pending[:count]``, +inf when count is 0, NaN for an index outside
    [0, n). Entry a is bitwise the 0-d call on ``idx[a]``. Batched: points
    (B, n, d), idx (B, A), pending (B, P, d) and counts (B,), row b bitwise
    the single call on problem b."""
    n = points.shape[-2]
    lead = points.shape[:-2]
    flat = idx.reshape(lead + (-1,)).long()
    inside = (flat >= 0) & (flat < n)
    x = _rows(points, torch.where(inside, flat, 0))          # (..., A, d)
    d2 = diff_sq(x[..., :, None, :], pending[..., None, :, :])  # (..., A, P)
    live = _live(count, pending.shape[-2], points.device)
    best = torch.where(live[..., None, :], d2, torch.inf).amin(dim=-1)
    return torch.where(inside, best, torch.nan).reshape(idx.shape)


def _rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (..., A) of ``points`` (..., n, d), problem by
    problem."""
    if points.dim() == 2:
        return points.index_select(0, idx)
    return torch.take_along_dim(points, idx[..., None], dim=-2)


def tile_cap_torch(centers: torch.Tensor, radii: torch.Tensor,
                   pending: torch.Tensor, count) -> torch.Tensor:
    """Plain PyTorch twin of K12: (T,) fp32 ``(sqrt(min_j D²(center_t,
    pending_j)) + r_t)²`` over ``pending[:count]``, +inf everywhere when
    count is 0. Batched: a leading problem axis on every argument, the
    counts (B,)."""
    d2 = diff_sq(centers[..., :, None, :], pending[..., None, :, :])
    live = _live(count, pending.shape[-2], centers.device)
    v = torch.where(live[..., None, :], d2, torch.inf).amin(
        dim=-1).sqrt() + radii
    cap = v * v
    return torch.where(torch.as_tensor(count, device=centers.device)[
        ..., None] > 0, cap, torch.inf)


def _card_count(count, device) -> torch.Tensor:
    """``count`` as the 0-d int32 device tensor the kernels read."""
    if isinstance(count, torch.Tensor):
        if count.numel() != 1 or count.device != device:
            raise ValueError(f"count must be one value on {device}")
        return count.reshape(()).to(torch.int32)
    return torch.full((), int(count), dtype=torch.int32, device=device)


def _card_counts(count, bsz: int, device) -> torch.Tensor:
    """Batched counts as the (B,) int32 device tensor the kernels read."""
    if not isinstance(count, torch.Tensor) or tuple(count.shape) != (bsz,) \
            or count.device != device:
        raise ValueError(f"counts must be a ({bsz},) tensor on {device}")
    return count.to(torch.int32).contiguous()


def _check_pending(pending: torch.Tensor, d: int) -> None:
    if pending.dim() != 2 or pending.shape[0] < 1 or pending.shape[1] != d:
        raise ValueError(f"pending must be (P, {d}), got "
                         f"{tuple(pending.shape)}")


def row_min_d2(points: torch.Tensor, idx: torch.Tensor,
               pending: torch.Tensor, count) -> torch.Tensor:
    """The rejection sampler's exact p for every proposal of a round: fp32
    D² of each row ``idx`` (a 0-d or (A,) int64 device tensor, never read
    on the host; the result the same shape) to the nearest of
    ``pending[:count]``; +inf when count is 0, NaN for an index outside
    [0, n). On the card this is one K11 launch for all A rows; CPU tensors
    take the plain twin."""
    if points.dim() == 3:
        return _row_min_d2_batched(points, idx, pending, count)
    if points.dim() != 2:
        raise ValueError("points must be 2-D, or 3-D (B, n, d)")
    n, d = points.shape
    _check_pending(pending, d)
    if idx.dim() > 1 or idx.numel() < 1:
        raise ValueError(f"idx must be 0-d or (A,), got {tuple(idx.shape)}")
    if points.device.type == "cpu":
        return row_min_d2_torch(points, idx, pending, count)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ops.check_card_tensors(points=points, pending=pending)
    ops.check_card_tensors(torch.int64, idx=idx)
    cnt = _card_count(count, points.device)
    p = pending.shape[0]
    fn = _build.function("rejection", "row_min_d2_launch", _ROW_ARGTYPES)
    out = torch.empty(idx.shape, dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), idx.data_ptr(), pending.data_ptr(),
                 cnt.data_ptr(), out.data_ptr(), n, d, p, idx.numel(), stream)
    if err != 0:
        raise KernelFailureError(f"row_min_d2 launch failed: cudaError {err}")
    ops.LAUNCHES["row_min_d2"] += 1
    return out


def _row_min_d2_batched(points, idx, pending, count) -> torch.Tensor:
    """K11 over B problems (see :func:`row_min_d2`): one launch, a warp a
    (problem, drawn row)."""
    bsz, n, d = points.shape
    if pending.dim() != 3 or pending.shape[0] != bsz:
        raise ValueError(f"pending must be ({bsz}, P, {d}), got "
                         f"{tuple(pending.shape)}")
    _check_pending(pending[0], d)
    if idx.dim() != 2 or idx.shape[0] != bsz or idx.shape[1] < 1:
        raise ValueError(f"idx must be ({bsz}, A), got {tuple(idx.shape)}")
    if points.device.type == "cpu":
        return row_min_d2_torch(points, idx, pending, count)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ops.check_card_tensors(points=points, pending=pending)
    ops.check_card_tensors(torch.int64, idx=idx)
    cnt = _card_counts(count, bsz, points.device)
    fn = _build.function("rejection", "row_min_d2_batched_launch",
                         _ROW_BATCHED_ARGTYPES)
    out = torch.empty(idx.shape, dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), idx.data_ptr(), pending.data_ptr(),
                 cnt.data_ptr(), out.data_ptr(), n, d, pending.shape[1],
                 idx.shape[1], bsz, stream)
    if err != 0:
        raise KernelFailureError(f"row_min_d2_batched launch failed: "
                                 f"cudaError {err}")
    ops.LAUNCHES["row_min_d2"] += 1
    return out


def tile_cap(centers: torch.Tensor, radii: torch.Tensor,
             pending: torch.Tensor, count) -> torch.Tensor:
    """(T,) per-tile envelope caps of the tile balls (``centers`` (T, d),
    ``radii`` (T,)) against ``pending[:count]``; +inf everywhere when count
    is 0. On the card this launches K12; CPU tensors take the plain
    twin."""
    if centers.dim() != 2 or centers.shape[0] < 1:
        raise ValueError(f"centers must be (T, d), got "
                         f"{tuple(centers.shape)}")
    t, d = centers.shape
    _check_pending(pending, d)
    if tuple(radii.shape) != (t,):
        raise ValueError(f"radii {tuple(radii.shape)} must be ({t},)")
    if centers.device.type == "cpu":
        return tile_cap_torch(centers, radii, pending, count)
    if centers.device.type != "cuda":
        raise ValueError(f"unsupported device {centers.device}")
    ops.check_card_tensors(centers=centers, radii=radii, pending=pending)
    p = pending.shape[0]
    cnt = _card_count(count, centers.device)
    fn = _build.function("rejection", "tile_cap_launch", _CAP_ARGTYPES)
    out = torch.empty(t, dtype=torch.float32, device=centers.device)
    with torch.cuda.device(centers.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(centers.data_ptr(), radii.data_ptr(), pending.data_ptr(),
                 cnt.data_ptr(), out.data_ptr(), t, d, p, stream)
    if err != 0:
        raise KernelFailureError(f"tile_cap launch failed: cudaError {err}")
    ops.LAUNCHES["tile_cap"] += 1
    return out


def tile_envelope_torch(centers, radii, pending, count, partials, tile_w):
    """Plain twin of :func:`tile_envelope`: ``tile_cap_torch``, then the
    hier round's envelope ops (batched: each problem's)."""
    cap = tile_cap_torch(centers, radii, pending, count)
    capw = cap * tile_w   # inf·0 is NaN: loses every < below
    ph = torch.where(capw < partials, capw, partials)
    tight = ph < partials
    return cap, ph, tight, tight.sum(dim=-1, dtype=torch.int32)


def tile_envelope(centers: torch.Tensor, radii: torch.Tensor,
                  pending: torch.Tensor, count, partials: torch.Tensor,
                  tile_w: torch.Tensor):
    """A hier round's tile envelope from the tile balls (``centers`` (T,
    d), ``radii`` (T,)), ``pending[:count]``, the round's ``partials``
    (T,) and the tiles' masses ``tile_w`` (T,): ``(cap, ph, tight,
    n_tight)``, the caps (:func:`tile_cap`), ``ph = min(cap · tile_w,
    partials)`` (a NaN product keeps the partial), ``tight = ph <
    partials`` and its count (0-d int32). On the card this is one launch,
    counted as K12's; CPU tensors take the plain twin.

    Batched: centers (B, T, d), radii and partials (B, T), pending
    (B, P, d), counts (B,) and tile_w (B, T) or (T,) shared: every output
    gains the leading axis (n_tight (B,)), row b bitwise the single call on
    problem b (a problem whose count is 0 gets +inf caps, ph = partials and
    no tight tile), one launch."""
    if centers.dim() == 3:
        return _tile_envelope_batched(centers, radii, pending, count,
                                      partials, tile_w)
    if centers.dim() != 2 or centers.shape[0] < 1:
        raise ValueError(f"centers must be (T, d), got "
                         f"{tuple(centers.shape)}")
    t, d = centers.shape
    _check_pending(pending, d)
    for name, x in (("radii", radii), ("partials", partials),
                    ("tile_w", tile_w)):
        if tuple(x.shape) != (t,):
            raise ValueError(f"{name} {tuple(x.shape)} must be ({t},)")
    if centers.device.type == "cpu":
        return tile_envelope_torch(centers, radii, pending, count, partials,
                                   tile_w)
    if centers.device.type != "cuda":
        raise ValueError(f"unsupported device {centers.device}")
    ops.check_card_tensors(centers=centers, radii=radii, pending=pending,
                           partials=partials, tile_w=tile_w)
    cnt = _card_count(count, centers.device)
    fn = _build.function("rejection", "tile_envelope_launch",
                         _ENVELOPE_ARGTYPES)
    out = torch.empty(2 * t + 1, dtype=torch.float32, device=centers.device)
    cap, ph = out[:t], out[t:2 * t]
    n_tight = out[2 * t:].view(torch.int32).reshape(())
    tight = torch.empty(t, dtype=torch.bool, device=centers.device)
    with torch.cuda.device(centers.device):
        stream = torch.cuda.current_stream().cuda_stream
        key = ("tile_envelope", torch.cuda.current_device(), stream)
        acc = ops.arrivals(key, 2)
        err = fn(centers.data_ptr(), radii.data_ptr(), pending.data_ptr(),
                 cnt.data_ptr(), tile_w.data_ptr(), partials.data_ptr(),
                 cap.data_ptr(), ph.data_ptr(), tight.data_ptr(),
                 n_tight.data_ptr(), acc.data_ptr(), t, d,
                 pending.shape[0], stream)
        if err != 0:
            ops.drop_arrivals(key)
    if err != 0:
        raise KernelFailureError(f"tile_envelope launch failed: cudaError "
                                 f"{err}")
    ops.LAUNCHES["tile_cap"] += 1
    return cap, ph, tight, n_tight


def _tile_envelope_batched(centers, radii, pending, count, partials, tile_w):
    """The tile envelope over B problems (see :func:`tile_envelope`)."""
    bsz, t, d = centers.shape
    if t < 1 or pending.dim() != 3 or pending.shape[0] != bsz:
        raise ValueError(f"bad shapes: centers {tuple(centers.shape)}, "
                         f"pending {tuple(pending.shape)}")
    _check_pending(pending[0], d)
    for name, x in (("radii", radii), ("partials", partials)):
        if tuple(x.shape) != (bsz, t):
            raise ValueError(f"{name} {tuple(x.shape)} must be ({bsz}, {t})")
    if tuple(tile_w.shape) not in ((t,), (bsz, t)):
        raise ValueError(f"tile_w {tuple(tile_w.shape)} must be ({t},) or "
                         f"({bsz}, {t})")
    if centers.device.type == "cpu":
        return tile_envelope_torch(centers, radii, pending, count, partials,
                                   tile_w)
    if centers.device.type != "cuda":
        raise ValueError(f"unsupported device {centers.device}")
    ops.check_card_tensors(centers=centers, radii=radii, pending=pending,
                           partials=partials, tile_w=tile_w)
    cnt = _card_counts(count, bsz, centers.device)
    fn = _build.function("rejection", "tile_envelope_batched_launch",
                         _ENVELOPE_BATCHED_ARGTYPES)
    dev = centers.device
    out = torch.empty((2 * bsz * t + bsz,), dtype=torch.float32, device=dev)
    cap = out[:bsz * t].view(bsz, t)
    ph = out[bsz * t:2 * bsz * t].view(bsz, t)
    n_tight = out[2 * bsz * t:].view(torch.int32)
    tight = torch.empty((bsz, t), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        key = ("tile_envelope", torch.cuda.current_device(), stream)
        acc = ops.arrivals(key, 2 * bsz)
        err = fn(centers.data_ptr(), radii.data_ptr(), pending.data_ptr(),
                 cnt.data_ptr(), tile_w.data_ptr(), partials.data_ptr(),
                 cap.data_ptr(), ph.data_ptr(), tight.data_ptr(),
                 n_tight.data_ptr(), acc.data_ptr(), t, d, pending.shape[1],
                 bsz, t if tile_w.dim() == 2 else 0, stream)
        if err != 0:
            ops.drop_arrivals(key)
    if err != 0:
        raise KernelFailureError(f"tile_envelope_batched launch failed: "
                                 f"cudaError {err}")
    ops.LAUNCHES["tile_cap"] += 1
    return cap, ph, tight, n_tight
