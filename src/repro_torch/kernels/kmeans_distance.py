"""K1, K2, K5, K7, K11 and K12 — the prologue, the k-means++ seeding round
(ungated, bound-gated and batched) and the rejection sampler's two small
kernels (port of ``repro.kernels.kmeans_distance``'s
``seed_prologue_pallas``, ``distance_min_update_pallas``,
``distance_min_update_gated_pallas``, ``distance_min_update_batched_pallas``,
``row_min_d2_pallas`` and ``tile_cap_pallas``).

K1 ``seed_prologue`` is the once-per-call pass: the fp32 norms every round
streams, and the tile balls (centers, radii, each row's distance to its
tile's center) the seeding and assignment gates read.

One round (K2) folds the newest centroid block c (m, d) into every point's
D² and returns the per-tile partial sums the samplers draw from:

    new_md = min(md, min_c max(||x||² − 2 x·c + ||c||², 0)),
    partials[t] = sum of new_md over tile t's rows.

The batched round (K7) is K2 over B independent problems in one launch:
(B, n, d) points, (B, m, d) centroids, (B, n) norms and D², (B, T)
partials; row b is K2 on problem b. The gated round (K5) does the same as
K2 on the tiles the seeding gate marks active only, skips the rows the per-point bound prunes, and also returns
each tile's max of new_md and its count of pruned rows; inactive tiles keep
their carried values.

Rejection seeding (K11, K12) works between refreshes against the pending
block of P centroids not yet folded in, of which the first ``count`` are
live: K11 ``row_min_d2`` is the D² of the one drawn row to them (the exact
p of a proposal), K12 ``tile_cap`` bounds every tile's current D² from its
ball alone. Both use the diff-square form and add the columns in a fixed
order, so the kernels and their plain twins agree bitwise.

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

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_BATCHED_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
                     + (ctypes.c_void_p,))
_GATED_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 5
                   + (ctypes.c_void_p,))
_PROLOGUE_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3
                      + (ctypes.c_void_p,))
_ROW_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_longlong,)
                 + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))
_CAP_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)


def tile_d2(x: torch.Tensor, c: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """(rows, m) matmul-form D² with the cached fp32 norms ``xn`` — THE
    shared round math of the plain twins."""
    cn = (c * c).sum(dim=1)
    dots = x @ c.T
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
    center_d (n,)), all fp32."""
    return tuple(bounds.prologue(points, block_n))


def gate_select(new_md_full: torch.Tensor, min_d2: torch.Tensor,
                center_d: torch.Tensor, dc: torch.Tensor,
                margin: torch.Tensor, prev_partials: torch.Tensor,
                prev_tile_max: torch.Tensor, active: torch.Tensor, *,
                block_n: int):
    """K5's per-tile selects, given every row's ungated ``new_md_full``:
    rows of active tiles that the per-point bound does not prune take the
    fresh value, all others keep ``min_d2``; active tiles re-sum their
    partial and max, inactive ones keep the carried entries. Returns
    (min_d2, partials, tile_max, pruned (T,) int32)."""
    n = min_d2.shape[0]
    act_pt = bounds.expand_mask(active, block_n, n)
    prune = act_pt & bounds.seed_point_prune(
        min_d2, center_d, bounds.expand_mask(dc, block_n, n),
        bounds.expand_mask(margin, block_n, n))
    md = torch.where(act_pt & ~prune, new_md_full, min_d2)
    partials = torch.where(active, tile_partials(md, block_n), prev_partials)
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


def seed_prologue(points: torch.Tensor, block_n: int):
    """The prologue at tile height ``block_n``. Returns (norms (n,),
    centers (T, d), radii (T,), center_d (n,)). On the card this launches
    K1; CPU tensors take the plain twin."""
    if points.dim() != 2 or points.shape[0] < 1 or points.shape[1] < 1:
        raise ValueError(f"points must be (n, d), got {tuple(points.shape)}")
    if block_n < 1:
        raise ValueError(f"block_n must be >= 1, got {block_n}")
    if points.device.type == "cpu":
        return seed_prologue_torch(points, block_n)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ops.check_card_tensors(points=points)
    n, d = points.shape
    n_tiles = -(-n // block_n)
    fn = _build.function("seed_prologue", "seed_prologue_launch",
                         _PROLOGUE_ARGTYPES)
    norms = torch.empty(n, dtype=torch.float32, device=points.device)
    center_d = torch.empty_like(norms)
    centers = torch.empty((n_tiles, d), dtype=torch.float32,
                          device=points.device)
    radii = torch.empty(n_tiles, dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centers.data_ptr(),
                 radii.data_ptr(), center_d.data_ptr(), n, d, block_n,
                 stream)
    if err != 0:
        raise KernelFailureError(f"seed_prologue launch failed: "
                                 f"cudaError {err}")
    ops.LAUNCHES["seed_prologue"] += 1
    return norms, centers, radii, center_d


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


def distance_min_update(points: torch.Tensor, norms: torch.Tensor,
                        centroids: torch.Tensor, min_d2: torch.Tensor, *,
                        block_n: int, resident: bool = True):
    """One seeding round. Returns (new_min_d2 (n,), partials (n_tiles,)).

    On the card this launches K2: ``resident`` stages the centroid block in
    shared memory (the paper's constant memory), ``resident=False`` re-reads
    it from global memory on every use (Fig. 2's global-memory variant).
    CPU tensors take the plain twin."""
    _check(points, norms, centroids, min_d2, block_n)
    if points.device.type == "cpu":
        return distance_min_update_torch(points, norms, centroids, min_d2,
                                         block_n=block_n)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ops.check_card_tensors(points=points, norms=norms, centroids=centroids,
                min_d2=min_d2)
    n, d = points.shape
    m = centroids.shape[0]
    if ops.seed_smem_bytes(d, m, resident) > ops.SMEM_LIMIT:
        raise ValueError(f"a resident ({m}, {d}) centroid block does not fit "
                         f"in {ops.SMEM_LIMIT} bytes of shared memory")
    fn = _build.function("kmeans_distance", "distance_min_update_launch",
                         _ARGTYPES)
    out = torch.empty_like(min_d2)
    partials = torch.empty(-(-n // block_n), dtype=torch.float32,
                           device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 min_d2.data_ptr(), out.data_ptr(), partials.data_ptr(),
                 n, d, m, block_n, int(resident), stream)
    if err != 0:
        raise KernelFailureError(f"distance_min_update launch failed: "
                                 f"cudaError {err}")
    ops.LAUNCHES["distance_min_update"] += 1
    return out, partials


def distance_min_update_batched(points: torch.Tensor, norms: torch.Tensor,
                                centroids: torch.Tensor, min_d2: torch.Tensor,
                                *, block_n: int, resident: bool = True):
    """One seeding round of B independent problems: points (B, n, d), norms
    and min_d2 (B, n), centroids (B, m, d). Returns (new_min_d2 (B, n),
    partials (B, n_tiles)). On the card this launches K7, one launch for
    every problem, ``resident`` as for K2; CPU tensors take the plain
    twin."""
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
    if points.device.type == "cpu":
        return distance_min_update_batched_torch(points, norms, centroids,
                                                 min_d2, block_n=block_n)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ops.check_card_tensors(points=points, norms=norms, centroids=centroids,
                           min_d2=min_d2)
    _, n, d = points.shape
    m = centroids.shape[1]
    if ops.seed_smem_bytes(d, m, resident) > ops.SMEM_LIMIT:
        raise ValueError(f"a resident ({m}, {d}) centroid block does not fit "
                         f"in {ops.SMEM_LIMIT} bytes of shared memory")
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
                 bsz, n, d, m, block_n, int(resident), stream)
    if err != 0:
        raise KernelFailureError(f"distance_min_update_batched launch "
                                 f"failed: cudaError {err}")
    ops.LAUNCHES["distance_min_update_batched"] += 1
    return out, partials


def distance_min_update_gated(points: torch.Tensor, norms: torch.Tensor,
                              centroids: torch.Tensor, min_d2: torch.Tensor,
                              center_d: torch.Tensor, dc: torch.Tensor,
                              margin: torch.Tensor,
                              prev_partials: torch.Tensor,
                              prev_tile_max: torch.Tensor,
                              active: torch.Tensor, *, block_n: int,
                              resident: bool = True):
    """One bound-gated seeding round. ``active``/``dc``/``margin`` come from
    ``bounds.seed_gate``, ``center_d`` from the prologue; ``prev_partials``
    and ``prev_tile_max`` are the carried per-tile state, at the tile height
    ``block_n``. Returns (min_d2 (n,), partials (T,), tile_max (T,),
    pruned (T,) int32). On the card this launches K5 over the full grid of
    tiles (inactive ones exit); the outputs start as copies of the carries,
    so skipped tiles keep them. CPU tensors take the plain twin."""
    _check(points, norms, centroids, min_d2, block_n)
    n = points.shape[0]
    n_tiles = -(-n // block_n)
    if tuple(center_d.shape) != (n,):
        raise ValueError(f"center_d {tuple(center_d.shape)} must be ({n},)")
    for name, t in (("dc", dc), ("margin", margin),
                    ("prev_partials", prev_partials),
                    ("prev_tile_max", prev_tile_max), ("active", active)):
        if tuple(t.shape) != (n_tiles,):
            raise ValueError(f"{name} {tuple(t.shape)} must be ({n_tiles},)")
    if points.device.type == "cpu":
        return distance_min_update_gated_torch(
            points, norms, centroids, min_d2, center_d, dc, margin,
            prev_partials, prev_tile_max, active, block_n=block_n)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ops.check_card_tensors(points=points, norms=norms, centroids=centroids,
                min_d2=min_d2, center_d=center_d, dc=dc, margin=margin)
    m, d = centroids.shape
    if ops.seed_smem_bytes(d, m, resident, gated=True) > ops.SMEM_LIMIT:
        raise ValueError(f"a resident ({m}, {d}) centroid block does not fit "
                         f"in {ops.SMEM_LIMIT} bytes of shared memory")
    fn = _build.function("kmeans_distance",
                         "distance_min_update_gated_launch", _GATED_ARGTYPES)
    out = min_d2.clone()
    partials = prev_partials.float().clone()
    tile_max = prev_tile_max.float().clone()
    pruned = torch.zeros(n_tiles, dtype=torch.int32, device=points.device)
    act = active.to(torch.uint8).contiguous()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 min_d2.data_ptr(), out.data_ptr(), partials.data_ptr(),
                 center_d.data_ptr(), dc.data_ptr(), margin.data_ptr(),
                 act.data_ptr(), tile_max.data_ptr(), pruned.data_ptr(),
                 n, d, m, block_n, int(resident), stream)
    if err != 0:
        raise KernelFailureError(f"distance_min_update_gated launch failed: "
                                 f"cudaError {err}")
    ops.LAUNCHES["distance_min_update_gated"] += 1
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
    """(p,) bool: pending slot j is live when j < count."""
    return torch.arange(p, device=device) < count


def row_min_d2_torch(points: torch.Tensor, idx: torch.Tensor,
                     pending: torch.Tensor, count) -> torch.Tensor:
    """Plain PyTorch twin of K11: 0-d fp32 D² of row ``idx`` to the nearest
    of ``pending[:count]``, +inf when count is 0."""
    x = points.index_select(0, idx.reshape(1).long())      # (1, d)
    d2 = diff_sq(x, pending)
    live = _live(count, pending.shape[0], points.device)
    return torch.where(live, d2, torch.inf).amin()


def tile_cap_torch(centers: torch.Tensor, radii: torch.Tensor,
                   pending: torch.Tensor, count) -> torch.Tensor:
    """Plain PyTorch twin of K12: (T,) fp32 ``(sqrt(min_j D²(center_t,
    pending_j)) + r_t)²`` over ``pending[:count]``, +inf everywhere when
    count is 0."""
    d2 = diff_sq(centers[:, None, :], pending[None, :, :])     # (T, P)
    live = _live(count, pending.shape[0], centers.device)
    v = torch.where(live[None, :], d2, torch.inf).amin(dim=1).sqrt() + radii
    cap = v * v
    return torch.where(torch.as_tensor(count, device=centers.device) > 0,
                       cap, torch.inf)


def _card_count(count, device) -> torch.Tensor:
    """``count`` as the 0-d int32 device tensor the kernels read."""
    if isinstance(count, torch.Tensor):
        if count.numel() != 1 or count.device != device:
            raise ValueError(f"count must be one value on {device}")
        return count.reshape(()).to(torch.int32)
    return torch.full((), int(count), dtype=torch.int32, device=device)


def _check_pending(pending: torch.Tensor, d: int) -> None:
    if pending.dim() != 2 or pending.shape[0] < 1 or pending.shape[1] != d:
        raise ValueError(f"pending must be (P, {d}), got "
                         f"{tuple(pending.shape)}")


def row_min_d2(points: torch.Tensor, idx: torch.Tensor,
               pending: torch.Tensor, count) -> torch.Tensor:
    """The rejection sampler's exact p: 0-d fp32 D² of row ``idx`` (a 0-d
    or (1,) int64 device tensor, never read on the host) to the nearest of
    ``pending[:count]``; +inf when count is 0. On the card this launches
    K11; CPU tensors take the plain twin."""
    if points.dim() != 2:
        raise ValueError("points must be 2-D")
    n, d = points.shape
    _check_pending(pending, d)
    if idx.numel() != 1:
        raise ValueError(f"idx must hold one index, got {tuple(idx.shape)}")
    if points.device.type == "cpu":
        return row_min_d2_torch(points, idx, pending, count)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ops.check_card_tensors(points=points, pending=pending)
    ops.check_card_tensors(torch.int64, idx=idx)
    cnt = _card_count(count, points.device)
    p = pending.shape[0]
    fn = _build.function("rejection", "row_min_d2_launch", _ROW_ARGTYPES)
    out = torch.empty((), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), idx.data_ptr(), pending.data_ptr(),
                 cnt.data_ptr(), out.data_ptr(), n, d, p, stream)
    if err != 0:
        raise KernelFailureError(f"row_min_d2 launch failed: cudaError {err}")
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
    if 4 * p * d > ops.SMEM_LIMIT:
        raise ValueError(f"a ({p}, {d}) pending block does not fit in "
                         f"{ops.SMEM_LIMIT} bytes of shared memory")
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
