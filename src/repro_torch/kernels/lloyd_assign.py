"""K3, K6, K10a and K10b — the tiled Lloyd assignment round, ungated,
bound-gated, and each batched; K4 and K9 — the untiled round, single and
batched (port of ``repro.kernels.lloyd_assign.lloyd_assign_tiled_pallas``,
``lloyd_assign_gated_pallas``, ``lloyd_assign_tiled_batched_pallas``,
``lloyd_assign_gated_batched_pallas``, ``lloyd_assign_pallas`` and
``lloyd_assign_batched_pallas``).

One round assigns every point to its nearest centroid and returns what the
centroid update and the next slice's movement bound need:

    labels (n,) int32   argmin over centroids, first index on ties
    min_d2 (n,)         D² to the assigned centroid
    partials (T,)       per-tile inertia partial
    gaps (T,)           per-tile min of √second − √best (+inf at k = 1)
    ssums (S, k, d)     per-super-tile cluster sums, S = ceil(T / tps)
    scounts (S, k)      per-super-tile cluster counts

On the card K3 runs, by width, on a tensor-core screen with an exact
recheck (d >= 8, ``screened``) or at every other width on a row pass
(labels, D² and the second best: a few consecutive rows a thread below
d = 8, one a thread past the screened widths), each then the tiles'
partials, gaps and sums in the template's order. Both give the template
kernel's bits, which ``lloyd_assign_tiled_template`` computes for the card
tests and the smoke script.

The gated round (K6) computes the same on a super-aligned set of active
tiles only, short-circuits the rows the per-point Hamerly bound prunes, and
also returns each row's lower bound on its second-nearest distance and each
tile's count of pruned rows; skipped tiles and supers keep their carried
values. On the card K6 runs, by width, on a tensor-core screen with an
exact recheck (d >= 8, ``screened``) or on a split row pass (the row
arithmetic in blocks at full occupancy, then the sums), and its kernels
write the carries of skipped tiles and supers themselves; both give the
template kernel's bits, which ``lloyd_assign_gated_template`` computes for
the card tests and the smoke script.

The batched rounds (K10a, K10b) are K3 and K6 over B independent problems
in one launch, every argument and output with a leading problem axis and
every problem gated by its own mask; row b is K3 (K6) on problem b,
bitwise. At d >= 8 (``screened``) the card runs them on the same screen,
which writes K3's (K6's) bits; its counters (candidates per row, rows on
the full scan) are read with ``screen_stats``. At every other width they
take K3's row pass (K6's split row pass) with a problem index.

The untiled round (K4), the weighted and mini-batch fits' round, returns
only labels and D² per row and the cluster sums (k, d) and counts (k,)
over all rows; with per-row weights, each row enters the sums as w·x and
its count as w. K9 is K4 over B problems, row b K4 on problem b. On the
card K4 and K9 run, by width, on the same screen (d >= 8, ``screened``)
or at every other width on K3's row pass without the second best, each
then the tiles' sums in the template's order and the all-tile reduce. Both
give the template kernel's bits, which ``lloyd_assign_template`` and
``lloyd_assign_batched_template`` compute for the card tests and the
smoke script.

All six read points and centroids as fp32 or as a bf16 stream, both of
one dtype; the bf16 instances widen each value exactly and then do the
fp32 instances' arithmetic, so the cluster sums add the bf16-rounded rows,
as the reference's do. Norms, D², partials, gaps, sums, counts, weights
and the gate stay fp32. The plain twins widen the same way.

``lloyd_assign_tiled``, ``lloyd_assign_gated``, ``lloyd_assign_tiled_batched``,
``lloyd_assign_gated_batched``, ``lloyd_assign``, ``lloyd_assign_batched``
and the template entries (``lloyd_assign_tiled_template``,
``lloyd_assign_gated_template``,
``lloyd_assign_template``, ``lloyd_assign_batched_template``) launch the
hand-written CUDA kernels (``csrc/lloyd_assign.cu``) for tensors on the
card, and run the plain twins (``*_torch``) only for tensors on the CPU.
Before a launch they ask the CUDA source for their route and its largest k
(``lloyd_assign_route``: the screened route up to 65,535 centroids, the row
passes any k) and raise ValueError naming the route's largest k where it
does not take k. No round takes the template; its entries, which stage the
whole (k, d) block, raise past what that staging fits
(``ops.template_max_k``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bounds
from repro_torch.core.bounds import super_reduce
from repro_torch.core.guards import KernelFailureError
from repro_torch.core.sampling import segment_sum, tile_partials
from repro_torch.kernels import _build, ops
from repro_torch.kernels.kmeans_distance import tile_d2

# the last int is the stream flag (1: bf16 points and centroids); the
# rounds' entries take pass B's k-chunk cap (``k_chunk``) before it, an
# (n,) lb scratch (K3, K10a), and on the screened route the screen's
# counters and a (B, k) scratch for the centroids' norms; the template
# entries take the template's columns a pass (``cols``) there instead
_PLAIN_TILED_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7
                         + (ctypes.c_void_p,))
_TILED_ARGTYPES = ((ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 7
                   + (ctypes.c_void_p,))
_GATED_ARGTYPES = ((ctypes.c_void_p,) * 25 + (ctypes.c_int,) * 7
                   + (ctypes.c_void_p,))
_PLAIN_GATED_ARGTYPES = ((ctypes.c_void_p,) * 23 + (ctypes.c_int,) * 7
                         + (ctypes.c_void_p,))
_BATCHED_ARGTYPES = ((ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 8
                     + (ctypes.c_void_p,))
_GATED_BATCHED_ARGTYPES = ((ctypes.c_void_p,) * 25 + (ctypes.c_int,) * 8
                           + (ctypes.c_void_p,))
# the screened route's counters of the last card launch of K3, K6, K10a,
# K10b, K4 and K9: (4,) int64 on the card, read with ``screen_stats``
SCREEN_STATS: dict[str, torch.Tensor] = {}
# K4 and K9 (the template entries take no stats)
_UNTILED_ARGTYPES = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 6
                     + (ctypes.c_void_p,))
_UNTILED_BATCHED_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7
                             + (ctypes.c_void_p,))
_PLAIN_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6
                   + (ctypes.c_void_p,))
_PLAIN_BATCHED_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7
                           + (ctypes.c_void_p,))


def _tile_reduce(points, a, m, gap_pt, k, block_n, tps):
    """Per-tile partials and gaps, and per-super cluster sums and counts,
    of per-row labels ``a``, D² ``m`` and gaps ``gap_pt`` — one reduction
    for both twins, so an active super's sums are the same bits gated or
    not. The sums add the stream's rows widened to fp32."""
    points = points.float()
    n, d = points.shape
    pad = (-n) % block_n
    n_tiles = (n + pad) // block_n
    won = a[:, None] == torch.arange(k, device=a.device)
    partials = torch.cat([m, m.new_zeros(pad)]).reshape(n_tiles, block_n) \
        .sum(dim=1)
    gaps = torch.cat([gap_pt, gap_pt.new_full((pad,), torch.inf)]) \
        .reshape(n_tiles, block_n).amin(dim=1)
    onehot = torch.cat([won.float(), won.new_zeros((pad, k)).float()]) \
        .reshape(n_tiles, block_n, k)
    xt = torch.cat([points, points.new_zeros((pad, d))]) \
        .reshape(n_tiles, block_n, d)
    tile_sums = torch.einsum("tbk,tbd->tkd", onehot, xt)
    tile_counts = onehot.sum(dim=1)
    return (partials, gaps, super_reduce(tile_sums, tps),
            super_reduce(tile_counts, tps))


def lloyd_assign_tiled_torch(points: torch.Tensor, norms: torch.Tensor,
                             centroids: torch.Tensor, *, block_n: int,
                             tps: int):
    """Plain PyTorch twin of K3: what ``repro.kernels.ref
    .lloyd_assign_tiled_ref`` computes, on the cached norms. Returns
    (labels, min_d2, partials, gaps, super_sums, super_counts)."""
    k = centroids.shape[0]
    d2 = tile_d2(points, centroids, norms)
    a = d2.argmin(dim=1)
    m = d2.amin(dim=1)
    won = a[:, None] == torch.arange(k, device=a.device)
    second = torch.where(won, torch.inf, d2).amin(dim=1)
    gap_pt = second.sqrt() - m.sqrt()
    return (a.int(), m) + _tile_reduce(points, a, m, gap_pt, k, block_n, tps)


def lloyd_assign_tiled_batched_torch(points: torch.Tensor,
                                     norms: torch.Tensor,
                                     centroids: torch.Tensor, *, block_n: int,
                                     tps: int):
    """Plain PyTorch twin of K10a: K3's twin on each problem, stacked, so
    row b is bitwise the single twin on problem b. Returns (labels (B, n),
    min_d2 (B, n), partials (B, T), gaps (B, T), super_sums (B, S, k, d),
    super_counts (B, S, k))."""
    outs = [lloyd_assign_tiled_torch(p, nr, c, block_n=block_n, tps=tps)
            for p, nr, c in zip(points, norms, centroids)]
    return tuple(torch.stack(o) for o in zip(*outs))


def lloyd_assign_gated_torch(points, norms, centroids, delta, thresh, absorb,
                             prev_assign, prev_min_d2, prev_lb,
                             prev_partials, prev_gaps, prev_super_sums,
                             prev_super_counts, active, *, block_n: int,
                             tps: int):
    """Plain PyTorch twin of K6: the reference's ``_tile_assign_pruned``
    over every tile, then the tile- and super-level selects. A pruned row
    takes its label and D² from the carry and ``lb = prev_lb − absorb``,
    and still enters its tile's cluster sums under its carried label.
    ``active`` must be super-aligned. Returns (labels, min_d2, lb, partials,
    gaps, super_sums, super_counts, pruned (T,) int32)."""
    n = points.shape[0]
    k = centroids.shape[0]
    act_pt = bounds.expand_mask(active, block_n, n)
    prune = bounds.assign_point_prune(
        prev_assign, prev_min_d2, prev_lb, delta,
        bounds.expand_mask(thresh, block_n, n), act_pt)
    d2 = tile_d2(points, centroids, norms)
    a = torch.where(prune, prev_assign.long(), d2.argmin(dim=1))
    m = torch.where(prune, prev_min_d2, d2.amin(dim=1))
    won = a[:, None] == torch.arange(k, device=a.device)
    second = torch.where(won, torch.inf, d2).amin(dim=1)
    # pruned rows carry the decayed bound; fresh rows re-derive it exactly
    lb = torch.where(prune, prev_lb - bounds.expand_mask(absorb, block_n, n),
                     second.sqrt())
    part, gap, ssums, scounts = _tile_reduce(points, a, m, lb - m.sqrt(), k,
                                             block_n, tps)
    sup = bounds.super_any(active, tps)
    return (torch.where(act_pt, a.int(), prev_assign),
            torch.where(act_pt, m, prev_min_d2),
            torch.where(act_pt, lb, prev_lb),
            torch.where(active, part, prev_partials),
            torch.where(active, gap, prev_gaps),
            torch.where(sup[:, None, None], ssums, prev_super_sums),
            torch.where(sup[:, None], scounts, prev_super_counts),
            tile_partials(prune.int(), block_n).to(torch.int32))


def lloyd_assign_gated_batched_torch(*args, block_n: int, tps: int):
    """Plain PyTorch twin of K10b: K6's twin on each problem of the (B, ...)
    arguments (those of ``lloyd_assign_gated_torch``), stacked, so row b is
    bitwise the single twin on problem b. ``active`` must be super-aligned
    in every problem."""
    outs = [lloyd_assign_gated_torch(*one, block_n=block_n, tps=tps)
            for one in zip(*args)]
    return tuple(torch.stack(o) for o in zip(*outs))


def lloyd_assign_torch(points: torch.Tensor, norms: torch.Tensor,
                       centroids: torch.Tensor,
                       weights: torch.Tensor | None = None):
    """Plain PyTorch twin of K4: what ``repro.kernels.ref.lloyd_assign_ref``
    computes, on the cached norms, with the reference's weighted
    ``segment_update`` for the sums when ``weights`` (n,) are given; the
    sums in ``sampling.segment_sum``'s fixed order. Returns (labels (n,)
    int32, min_d2 (n,), sums (k, d), counts (k,))."""
    d2 = tile_d2(points, centroids, norms)
    a = d2.argmin(dim=1)
    x = points.float()
    w = x.new_ones(x.shape[0]) if weights is None else weights.float()
    tot = segment_sum(torch.cat([x * w[:, None], w[:, None]], 1), a,
                      centroids.shape[0])
    return a.int(), d2.amin(dim=1), tot[:, :-1], tot[:, -1]


def lloyd_assign_batched_torch(points: torch.Tensor, norms: torch.Tensor,
                               centroids: torch.Tensor):
    """Plain PyTorch twin of K9: K4's twin on each problem, stacked, so row
    b is bitwise the single twin on problem b. Returns (labels (B, n),
    min_d2 (B, n), sums (B, k, d), counts (B, k))."""
    outs = [lloyd_assign_torch(p, nr, c)
            for p, nr, c in zip(points, norms, centroids)]
    return tuple(torch.stack(o) for o in zip(*outs))


def _gated_shapes(lead, n, d, k, block_n, tps) -> dict:
    """The shapes ``lloyd_assign_gated(_batched)`` takes, by argument."""
    n_tiles = -(-n // block_n)
    n_super = -(-n_tiles // tps)
    shapes = {"delta": (k,), "thresh": (n_tiles,), "absorb": (n_tiles,),
              "prev_assign": (n,), "prev_min_d2": (n,), "prev_lb": (n,),
              "prev_partials": (n_tiles,), "prev_gaps": (n_tiles,),
              "prev_super_sums": (n_super, k, d),
              "prev_super_counts": (n_super, k), "active": (n_tiles,)}
    return {name: lead + s for name, s in shapes.items()}


def _check(points, norms, centroids, block_n, tps):
    if points.dim() != 2 or centroids.dim() != 2:
        raise ValueError("points and centroids must be 2-D")
    n, d = points.shape
    if n < 1 or centroids.shape[0] < 1 or centroids.shape[1] != d:
        raise ValueError(f"bad shapes: points {tuple(points.shape)}, "
                         f"centroids {tuple(centroids.shape)}")
    if tuple(norms.shape) != (n,):
        raise ValueError(f"norms {tuple(norms.shape)} must be ({n},)")
    if block_n < 1 or tps < 1:
        raise ValueError(f"need block_n >= 1 and tps >= 1, got {block_n}, "
                         f"{tps}")
    devs = {t.device for t in (points, norms, centroids)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    ops.stream_is_bf16(points, centroids)


# the CUDA source's round ids and route names (``lloyd_assign_route``)
_ROUNDS = {"lloyd_assign_tiled": 0, "lloyd_assign_gated": 1,
           "lloyd_assign": 2, "lloyd_assign_tiled_batched": 3,
           "lloyd_assign_gated_batched": 4, "lloyd_assign_batched": 5}
_ROUTES = ("template", "screened", "row pass", "split")


def _route(name: str, d: int, k: int, block_n: int, bf16: bool,
           k_chunk: int, template: bool = False,
           gated: bool = False) -> tuple[str, int]:
    """Round ``name``'s card route (the template where ``template``: the
    template entries) as the CUDA source gives it (``lloyd_assign_route``),
    and the template's columns a pass (0 off the template). Raises
    ValueError where the route cannot take k, naming its largest k: the
    source's for the rounds' routes, ``ops.template_max_k`` for the
    template. ``k_chunk`` (>= 0) caps pass B's centroids a block."""
    if k_chunk < 0:
        raise ValueError(f"k_chunk must be >= 0, got {k_chunk}")
    route, most = "template", -1
    if not template:
        fn = _build.function("lloyd_assign", "lloyd_assign_route",
                             (ctypes.c_int,) * 3
                             + (ctypes.POINTER(ctypes.c_int),))
        out = ctypes.c_int()
        route = _ROUTES[fn(_ROUNDS[name], d, int(bf16), ctypes.byref(out))]
        most = out.value
    if most < 0:
        most = ops.template_max_k(d, block_n, gated)
    if k > most:
        raise ValueError(
            f"{name} at d={d}, block_n={block_n} takes the {route} route on "
            f"the card, which holds k <= {most}; got k={k}")
    return route, (ops.assign_cols(d, k, block_n, gated)
                   if route == "template" else 0)


def _cn_scratch(route: str, bsz: int, k: int, dev) -> torch.Tensor | None:
    """The screened route's (B, k) scratch, where pass A writes every
    centroid's norm past one staged chunk of 256."""
    return (torch.empty(bsz * k, dtype=torch.float32, device=dev)
            if route == "screened" else None)


def screened(d: int, bf16: bool) -> bool:
    """Whether K3, K6, K10a, K10b, K4 and K9 take the screened route on
    the card for width ``d`` and the stream: d >= 8 and the row, padded to
    the tensor cores' depth (8 fp32 or 16 bf16 values), at most 512 bytes.
    The rule is the CUDA source's (``lloyd_assign_screened``)."""
    fn = _build.function("lloyd_assign", "lloyd_assign_screened",
                         (ctypes.c_int, ctypes.c_int))
    return bool(fn(d, int(bf16)))


def screen_stats(name: str) -> dict:
    """The screened route's counters of the last card launch of ``name``
    (``"lloyd_assign_tiled"``, ``"lloyd_assign_gated"``,
    ``"lloyd_assign_tiled_batched"``,
    ``"lloyd_assign_gated_batched"``, ``"lloyd_assign"`` or
    ``"lloyd_assign_batched"``, either stream): rows screened, their
    candidates, the most candidates of one row, and rows that took the
    full exact scan (a non-finite row or more than 16 candidates). Reading
    them synchronises the card."""
    rows, cand, most, full = (int(v) for v in SCREEN_STATS[name].tolist())
    return {"rows": rows, "candidates": cand, "max_candidates": most,
            "full_scan_rows": full}


def _stats(name: str, dev) -> torch.Tensor:
    st = torch.zeros(4, dtype=torch.int64, device=dev)
    SCREEN_STATS[name] = st
    return st


def lloyd_assign_tiled(points: torch.Tensor, norms: torch.Tensor,
                       centroids: torch.Tensor, *, block_n: int, tps: int,
                       k_chunk: int = 0):
    """One tiled assignment round. Returns (labels, min_d2, partials, gaps,
    super_sums, super_counts); ``tps`` consecutive tiles share one super-tile
    accumulator slot. On the card this launches K3 (its kernels count as
    one launch): on the screened route where ``screened(d, bf16)`` (its
    counters read with ``screen_stats("lloyd_assign_tiled")``), else on the
    row pass, each then pass B and the super reduce, at any k up to the
    route's. ``k_chunk`` is a test hook, which the engine never sets: > 0
    caps pass B's centroids a block, so that a card test can force its
    k-chunks (the bits do not depend on it). CPU tensors take the plain
    twin."""
    return _tiled(points, norms, centroids, block_n=block_n, tps=tps,
                  k_chunk=k_chunk, template=False)


def lloyd_assign_tiled_template(points: torch.Tensor, norms: torch.Tensor,
                                centroids: torch.Tensor, *, block_n: int,
                                tps: int):
    """K3 as the template kernel computes it (``assign_tile_kernel``, then
    the super reduce: K3's route before the screened route and the row
    pass), at any width whose staging fits: the arguments and returns of
    :func:`lloyd_assign_tiled`. The reference the card tests and the smoke
    script hold K3 to, bit for bit; the engine never calls it, and it
    counts no launch. CPU tensors take the plain twin."""
    return _tiled(points, norms, centroids, block_n=block_n, tps=tps,
                  k_chunk=0, template=True)


def _tiled(points, norms, centroids, *, block_n: int, tps: int, k_chunk: int,
           template: bool):
    _check(points, norms, centroids, block_n, tps)
    if points.device.type == "cpu":
        return lloyd_assign_tiled_torch(points, norms, centroids,
                                        block_n=block_n, tps=tps)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms)
    n, d = points.shape
    k = centroids.shape[0]
    route, cols = _route("lloyd_assign_tiled", d, k, block_n, bf16, k_chunk,
                         template)
    dev = points.device
    n_tiles = -(-n // block_n)
    n_super = -(-n_tiles // tps)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    md = torch.empty(n, dtype=torch.float32, device=dev)
    partials = torch.empty(n_tiles, dtype=torch.float32, device=dev)
    gaps = torch.empty(n_tiles, dtype=torch.float32, device=dev)
    tile_acc = torch.empty((n_tiles, k, d + 1), dtype=torch.float32,
                           device=dev)
    ssums = torch.empty((n_super, k, d), dtype=torch.float32, device=dev)
    scounts = torch.empty((n_super, k), dtype=torch.float32, device=dev)
    outs = (labels.data_ptr(), md.data_ptr(), partials.data_ptr(),
            gaps.data_ptr(), tile_acc.data_ptr(), ssums.data_ptr(),
            scounts.data_ptr())
    if template:
        fn = _build.function("lloyd_assign",
                             "lloyd_assign_tiled_template_launch",
                             _PLAIN_TILED_ARGTYPES)
        extra, ints = (), (n, d, k, block_n, tps, cols, int(bf16))
    else:
        fn = _build.function("lloyd_assign", "lloyd_assign_tiled_launch",
                             _TILED_ARGTYPES)
        # sqrt(second) per row, read by pass B
        lb = torch.empty(n, dtype=torch.float32, device=dev)
        stats = (_stats("lloyd_assign_tiled", dev) if route == "screened"
                 else None)
        cn = _cn_scratch(route, 1, k, dev)
        extra = tuple(None if t is None else t.data_ptr()
                      for t in (lb, stats, cn))
        ints = (n, d, k, block_n, tps, k_chunk, int(bf16))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 *outs, *extra, *ints, stream)
    if err != 0:
        raise KernelFailureError(f"lloyd_assign_tiled"
                                 f"{'_template' if template else ''} launch "
                                 f"failed: cudaError {err}")
    if not template:
        ops.count_launch("lloyd_assign_tiled", bf16)
    return labels, md, partials, gaps, ssums, scounts


def lloyd_assign_tiled_batched(points: torch.Tensor, norms: torch.Tensor,
                               centroids: torch.Tensor, *, block_n: int,
                               tps: int, k_chunk: int = 0):
    """One tiled assignment round of B independent problems: points
    (B, n, d), norms (B, n), centroids (B, k, d). Returns (labels (B, n),
    min_d2 (B, n), partials (B, T), gaps (B, T), super_sums (B, S, k, d),
    super_counts (B, S, k)). On the card this launches K10a (its kernels
    count as one launch) for every problem at once, on the screened route
    where ``screened(d, bf16)``, else on K3's row pass with a problem index
    (``k_chunk`` as K3's); CPU tensors take the plain twin."""
    if points.dim() != 3 or centroids.dim() != 3:
        raise ValueError("points and centroids must be 3-D (B, rows, d)")
    bsz = points.shape[0]
    if centroids.shape[0] != bsz or norms.shape[:1] != (bsz,) or bsz < 1:
        raise ValueError(f"problem counts differ: points "
                         f"{tuple(points.shape)}, centroids "
                         f"{tuple(centroids.shape)}, norms "
                         f"{tuple(norms.shape)}")
    _check(points[0], norms[0], centroids[0], block_n, tps)
    devs = {t.device for t in (points, norms, centroids)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if points.device.type == "cpu":
        return lloyd_assign_tiled_batched_torch(points, norms, centroids,
                                                block_n=block_n, tps=tps)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms)
    _, n, d = points.shape
    k = centroids.shape[1]
    route, _ = _route("lloyd_assign_tiled_batched", d, k, block_n, bf16,
                      k_chunk)
    n_tiles = -(-n // block_n)
    n_super = -(-n_tiles // tps)
    if bsz * n_tiles >= 2 ** 31:
        raise ValueError(f"{bsz} problems of {n_tiles} tiles exceed the "
                         "grid's 2^31 - 1 blocks")
    fn = _build.function("lloyd_assign", "lloyd_assign_tiled_batched_launch",
                         _BATCHED_ARGTYPES)
    dev = points.device
    labels = torch.empty((bsz, n), dtype=torch.int32, device=dev)
    md = torch.empty((bsz, n), dtype=torch.float32, device=dev)
    partials = torch.empty((bsz, n_tiles), dtype=torch.float32, device=dev)
    gaps = torch.empty((bsz, n_tiles), dtype=torch.float32, device=dev)
    tile_acc = torch.empty((bsz, n_tiles, k, d + 1), dtype=torch.float32,
                           device=dev)
    ssums = torch.empty((bsz, n_super, k, d), dtype=torch.float32, device=dev)
    scounts = torch.empty((bsz, n_super, k), dtype=torch.float32, device=dev)
    # lb = sqrt(second) per row, read by pass B
    lb = torch.empty((bsz, n), dtype=torch.float32, device=dev)
    scr = route == "screened"
    stats = _stats("lloyd_assign_tiled_batched", dev) if scr else None
    cn = _cn_scratch(route, bsz, k, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 labels.data_ptr(), md.data_ptr(), partials.data_ptr(),
                 gaps.data_ptr(), tile_acc.data_ptr(), ssums.data_ptr(),
                 scounts.data_ptr(), lb.data_ptr(),
                 stats.data_ptr() if scr else None,
                 cn.data_ptr() if scr else None, bsz, n, d, k, block_n,
                 tps, k_chunk, int(bf16), stream)
    if err != 0:
        raise KernelFailureError(f"lloyd_assign_tiled_batched launch failed: "
                                 f"cudaError {err}")
    ops.count_launch("lloyd_assign_tiled_batched", bf16)
    return labels, md, partials, gaps, ssums, scounts


def lloyd_assign_gated(points: torch.Tensor, norms: torch.Tensor,
                       centroids: torch.Tensor, delta: torch.Tensor,
                       thresh: torch.Tensor, absorb: torch.Tensor,
                       prev_assign: torch.Tensor, prev_min_d2: torch.Tensor,
                       prev_lb: torch.Tensor, prev_partials: torch.Tensor,
                       prev_gaps: torch.Tensor, prev_super_sums: torch.Tensor,
                       prev_super_counts: torch.Tensor, active: torch.Tensor,
                       *, block_n: int, tps: int, k_chunk: int = 0):
    """One bound-gated assignment round. ``active`` (T,) is widened here to
    whole super-tiles (``bounds.align_supers``: idempotent when the caller
    already expanded it);
    ``delta``/``thresh``/``absorb`` come from ``bounds.assign_point_scalars``
    and the ``prev_*`` carries from the previous round, at tile height
    ``block_n`` and fan-in ``tps``. Returns (labels, min_d2, lb, partials,
    gaps, super_sums, super_counts, pruned (T,) int32). On the card this
    launches K6 (its kernels count as one launch): on the screened route
    where ``screened(d, bf16)`` (its counters read with ``screen_stats``),
    else the split row pass, each then pass B (``k_chunk`` as K3's); the
    kernels write every output, a skipped tile or super copying its
    carries. CPU tensors take the plain twin."""
    return _gated(points, norms, centroids, delta, thresh, absorb,
                  prev_assign, prev_min_d2, prev_lb, prev_partials,
                  prev_gaps, prev_super_sums, prev_super_counts, active,
                  block_n=block_n, tps=tps, template=False, k_chunk=k_chunk)


def lloyd_assign_gated_template(*args, block_n: int, tps: int):
    """K6 as the template kernel computes it (``assign_tile_kernel``, the
    route K6 took before the screened and split routes), at any width whose
    staging fits: the arguments and returns of :func:`lloyd_assign_gated`.
    The reference the card tests and the smoke script hold K6 to, bit for
    bit; the engine never calls it, and it counts no launch. CPU tensors
    take the plain twin."""
    return _gated(*args, block_n=block_n, tps=tps, template=True, k_chunk=0)


def _gated(points, norms, centroids, delta, thresh, absorb, prev_assign,
           prev_min_d2, prev_lb, prev_partials, prev_gaps, prev_super_sums,
           prev_super_counts, active, *, block_n: int, tps: int,
           template: bool, k_chunk: int):
    _check(points, norms, centroids, block_n, tps)
    n, d = points.shape
    k = centroids.shape[0]
    n_tiles = -(-n // block_n)
    given = (delta, thresh, absorb, prev_assign, prev_min_d2, prev_lb,
             prev_partials, prev_gaps, prev_super_sums, prev_super_counts,
             active)
    for (name, want), t in zip(_gated_shapes((), n, d, k, block_n,
                                             tps).items(), given):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} must be {want}")
    active = bounds.align_supers(active, tps)
    if points.device.type == "cpu":
        return lloyd_assign_gated_torch(
            points, norms, centroids, delta, thresh, absorb, prev_assign,
            prev_min_d2, prev_lb, prev_partials, prev_gaps, prev_super_sums,
            prev_super_counts, active, block_n=block_n, tps=tps)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms,
                                   delta=delta, thresh=thresh, absorb=absorb,
                                   prev_min_d2=prev_min_d2, prev_lb=prev_lb)
    # the tile and super carries are read where a tile or super is skipped
    prev_partials, prev_gaps, prev_super_sums, prev_super_counts = (
        t.float().contiguous() for t in (prev_partials, prev_gaps,
                                         prev_super_sums, prev_super_counts))
    ops.check_card_tensors(torch.int32, prev_assign=prev_assign)
    route, cols = _route("lloyd_assign_gated", d, k, block_n, bf16, k_chunk,
                         template, gated=True)
    if template:
        fn = _build.function("lloyd_assign",
                             "lloyd_assign_gated_template_launch",
                             _PLAIN_GATED_ARGTYPES)
    else:
        fn = _build.function("lloyd_assign", "lloyd_assign_gated_launch",
                             _GATED_ARGTYPES)
    dev = points.device
    n_super = -(-n_tiles // tps)
    labels = torch.empty(n, dtype=torch.int32, device=dev)
    md = torch.empty(n, dtype=torch.float32, device=dev)
    lb = torch.empty(n, dtype=torch.float32, device=dev)
    partials = torch.empty(n_tiles, dtype=torch.float32, device=dev)
    gaps = torch.empty(n_tiles, dtype=torch.float32, device=dev)
    ssums = torch.empty((n_super, k, d), dtype=torch.float32, device=dev)
    scounts = torch.empty((n_super, k), dtype=torch.float32, device=dev)
    pruned = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    tile_acc = torch.empty((n_tiles, k, d + 1), dtype=torch.float32,
                           device=dev)
    act = active.to(torch.uint8).contiguous()
    if template:   # the template's columns a pass
        extra, ints = (), (n, d, k, block_n, tps, cols, int(bf16))
    else:          # the counters and cn scratch, pass B's k-chunk cap
        stats = (_stats("lloyd_assign_gated", dev) if route == "screened"
                 else None)
        cn = _cn_scratch(route, 1, k, dev)
        extra = tuple(None if t is None else t.data_ptr()
                      for t in (stats, cn))
        ints = (n, d, k, block_n, tps, k_chunk, int(bf16))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 delta.data_ptr(), thresh.data_ptr(), absorb.data_ptr(),
                 prev_assign.data_ptr(), prev_min_d2.data_ptr(),
                 prev_lb.data_ptr(), prev_partials.data_ptr(),
                 prev_gaps.data_ptr(), prev_super_sums.data_ptr(),
                 prev_super_counts.data_ptr(), act.data_ptr(),
                 labels.data_ptr(), md.data_ptr(), lb.data_ptr(),
                 partials.data_ptr(), gaps.data_ptr(), tile_acc.data_ptr(),
                 ssums.data_ptr(), scounts.data_ptr(), pruned.data_ptr(),
                 *extra, *ints, stream)
    if err != 0:
        raise KernelFailureError(f"lloyd_assign_gated"
                                 f"{'_template' if template else ''} launch "
                                 f"failed: cudaError {err}")
    if not template:
        ops.count_launch("lloyd_assign_gated", bf16)
    return labels, md, lb, partials, gaps, ssums, scounts, pruned


def lloyd_assign_gated_batched(points: torch.Tensor, norms: torch.Tensor,
                               centroids: torch.Tensor, delta: torch.Tensor,
                               thresh: torch.Tensor, absorb: torch.Tensor,
                               prev_assign: torch.Tensor,
                               prev_min_d2: torch.Tensor,
                               prev_lb: torch.Tensor,
                               prev_partials: torch.Tensor,
                               prev_gaps: torch.Tensor,
                               prev_super_sums: torch.Tensor,
                               prev_super_counts: torch.Tensor,
                               active: torch.Tensor, *, block_n: int,
                               tps: int, k_chunk: int = 0):
    """One bound-gated assignment round of B independent problems: the
    arguments of ``lloyd_assign_gated`` with a leading problem axis (points
    (B, n, d), norms (B, n), centroids and the rest (B, ...)), each problem
    gated by its own mask, widened here to whole super-tiles per problem
    (``bounds.align_supers``: a problem with nothing active computes
    nothing).
    Returns (labels, min_d2, lb (B, n), partials, gaps (B, T), super_sums
    (B, S, k, d), super_counts (B, S, k), pruned (B, T) int32). On the card
    this launches K10b (its kernels count as one launch) over every
    problem's tiles, on the screened route where ``screened(d, bf16)``,
    else on K6's split row pass with a problem index (``k_chunk`` as
    K3's); the kernels write every output, a skipped tile or super copying
    its carries. CPU tensors take the plain twin."""
    if points.dim() != 3 or centroids.dim() != 3:
        raise ValueError("points and centroids must be 3-D (B, rows, d)")
    bsz, n, d = points.shape
    k = centroids.shape[1]
    _check(points[0], norms[0], centroids[0], block_n, tps)
    given = (delta, thresh, absorb, prev_assign, prev_min_d2, prev_lb,
             prev_partials, prev_gaps, prev_super_sums, prev_super_counts,
             active)
    shapes = dict(_gated_shapes((bsz,), n, d, k, block_n, tps),
                  points=(bsz, n, d), norms=(bsz, n), centroids=(bsz, k, d))
    for name, t in zip(shapes, given + (points, norms, centroids)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} {tuple(t.shape)} must be "
                             f"{shapes[name]}")
    if len({t.device for t in given + (points, norms, centroids)}) != 1:
        raise ValueError("inputs on several devices")
    active = bounds.align_supers(active, tps)
    args = (points, norms, centroids, delta, thresh, absorb, prev_assign,
            prev_min_d2, prev_lb, prev_partials, prev_gaps, prev_super_sums,
            prev_super_counts, active)
    if points.device.type == "cpu":
        return lloyd_assign_gated_batched_torch(*args, block_n=block_n,
                                                tps=tps)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms,
                                   delta=delta, thresh=thresh, absorb=absorb,
                                   prev_min_d2=prev_min_d2, prev_lb=prev_lb)
    # the tile and super carries are read where a tile or super is skipped
    prev_partials, prev_gaps, prev_super_sums, prev_super_counts = (
        t.float().contiguous() for t in (prev_partials, prev_gaps,
                                         prev_super_sums, prev_super_counts))
    ops.check_card_tensors(torch.int32, prev_assign=prev_assign)
    route, _ = _route("lloyd_assign_gated_batched", d, k, block_n, bf16,
                      k_chunk, gated=True)
    n_tiles = -(-n // block_n)
    n_super = -(-n_tiles // tps)
    if bsz * n_tiles >= 2 ** 31:
        raise ValueError(f"{bsz} problems of {n_tiles} tiles exceed the "
                         "grid's 2^31 - 1 blocks")
    fn = _build.function("lloyd_assign", "lloyd_assign_gated_batched_launch",
                         _GATED_BATCHED_ARGTYPES)
    dev = points.device
    labels = torch.empty((bsz, n), dtype=torch.int32, device=dev)
    md = torch.empty((bsz, n), dtype=torch.float32, device=dev)
    lb = torch.empty((bsz, n), dtype=torch.float32, device=dev)
    partials = torch.empty((bsz, n_tiles), dtype=torch.float32, device=dev)
    gaps = torch.empty((bsz, n_tiles), dtype=torch.float32, device=dev)
    ssums = torch.empty((bsz, n_super, k, d), dtype=torch.float32,
                        device=dev)
    scounts = torch.empty((bsz, n_super, k), dtype=torch.float32, device=dev)
    pruned = torch.zeros((bsz, n_tiles), dtype=torch.int32, device=dev)
    tile_acc = torch.empty((bsz, n_tiles, k, d + 1), dtype=torch.float32,
                           device=dev)
    act = active.to(torch.uint8).contiguous()
    stats = _stats("lloyd_assign_gated_batched", dev) \
        if route == "screened" else None
    cn = _cn_scratch(route, bsz, k, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 delta.data_ptr(), thresh.data_ptr(), absorb.data_ptr(),
                 prev_assign.data_ptr(), prev_min_d2.data_ptr(),
                 prev_lb.data_ptr(), prev_partials.data_ptr(),
                 prev_gaps.data_ptr(), prev_super_sums.data_ptr(),
                 prev_super_counts.data_ptr(), act.data_ptr(),
                 labels.data_ptr(), md.data_ptr(), lb.data_ptr(),
                 partials.data_ptr(), gaps.data_ptr(), tile_acc.data_ptr(),
                 ssums.data_ptr(), scounts.data_ptr(), pruned.data_ptr(),
                 None if stats is None else stats.data_ptr(),
                 None if cn is None else cn.data_ptr(), bsz, n, d, k,
                 block_n, tps, k_chunk, int(bf16), stream)
    if err != 0:
        raise KernelFailureError(f"lloyd_assign_gated_batched launch failed: "
                                 f"cudaError {err}")
    ops.count_launch("lloyd_assign_gated_batched", bf16)
    return labels, md, lb, partials, gaps, ssums, scounts, pruned


def _check_untiled(points, norms, centroids, weights, block_n) -> None:
    """The untiled rounds' argument checks, on (n, d) points (K4) or
    (B, n, d) points with (B, k, d) centroids (K9, no weights)."""
    if points.dim() == 3 or centroids.dim() == 3:
        if points.dim() != 3 or centroids.dim() != 3:
            raise ValueError("points and centroids must be 3-D (B, rows, d)")
        bsz, n, _ = points.shape
        if (bsz < 1 or tuple(centroids.shape[:1]) != (bsz,)
                or tuple(norms.shape) != (bsz, n)):
            raise ValueError(f"problem counts differ: points "
                             f"{tuple(points.shape)}, centroids "
                             f"{tuple(centroids.shape)}, norms "
                             f"{tuple(norms.shape)}")
        _check(points[0], norms[0], centroids[0], block_n, 1)
        if len({t.device for t in (points, norms, centroids)}) != 1:
            raise ValueError("inputs on several devices")
        if weights is not None:
            raise ValueError("batched problems take no weights")
        return
    _check(points, norms, centroids, block_n, 1)
    n = points.shape[0]
    if weights is not None and (tuple(weights.shape) != (n,)
                                or weights.device != points.device):
        raise ValueError(f"weights {tuple(weights.shape)} on "
                         f"{weights.device} must be ({n},) on "
                         f"{points.device}")


def _untiled(points, norms, centroids, weights, *, block_n: int,
             template: bool, k_chunk: int = 0):
    """K4 (K9 on (B, n, d) points), or with ``template`` the template's
    untiled instance, which counts no launch and keeps no screen counters;
    CPU tensors take the plain twin."""
    _check_untiled(points, norms, centroids, weights, block_n)
    batched = points.dim() == 3
    if points.device.type == "cpu":
        if batched:
            return lloyd_assign_batched_torch(points, norms, centroids)
        return lloyd_assign_torch(points, norms, centroids, weights)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    bf16 = ops.check_round_tensors(points, centroids, norms=norms)
    if weights is not None:
        ops.check_card_tensors(weights=weights)
    n, d = points.shape[-2:]
    k = centroids.shape[-2]
    bsz = points.shape[0] if batched else 1
    round_name = "lloyd_assign_batched" if batched else "lloyd_assign"
    route, cols = _route(round_name, d, k, block_n, bf16, k_chunk, template)
    n_tiles = -(-n // block_n)
    if bsz * n_tiles >= 2 ** 31:
        raise ValueError(f"{bsz} problems of {n_tiles} tiles exceed the "
                         "grid's 2^31 - 1 blocks")
    if template:
        name, argtypes = (("lloyd_assign_batched_template_launch",
                           _PLAIN_BATCHED_ARGTYPES) if batched else
                          ("lloyd_assign_template_launch", _PLAIN_ARGTYPES))
    else:
        name, argtypes = (("lloyd_assign_batched_launch",
                           _UNTILED_BATCHED_ARGTYPES) if batched else
                          ("lloyd_assign_launch", _UNTILED_ARGTYPES))
    fn = _build.function("lloyd_assign", name, argtypes)
    stats = (_stats(round_name, points.device) if route == "screened"
             else None)
    dev = points.device
    lead = (bsz,) if batched else ()
    labels = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    md = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    tile_acc = torch.empty(lead + (n_tiles, k, d + 1), dtype=torch.float32,
                           device=dev)
    sums = torch.empty(lead + (k, d), dtype=torch.float32, device=dev)
    counts = torch.empty(lead + (k,), dtype=torch.float32, device=dev)
    cn = _cn_scratch(route, bsz, k, dev)
    st = () if template else tuple(None if t is None else t.data_ptr()
                                   for t in (stats, cn))
    # the template's columns a pass, or the rounds' pass B k-chunk cap
    last = (cols,) if template else (k_chunk,)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 *(() if batched else
                   (None if weights is None else weights.data_ptr(),)),
                 labels.data_ptr(), md.data_ptr(), tile_acc.data_ptr(),
                 sums.data_ptr(), counts.data_ptr(), *st, *lead, n, d, k,
                 block_n, *last, int(bf16), stream)
    if err != 0:
        raise KernelFailureError(f"{name.removesuffix('_launch')} launch "
                                 f"failed: cudaError {err}")
    if not template:
        ops.count_launch(round_name, bf16)
    return labels, md, sums, counts


def lloyd_assign(points: torch.Tensor, norms: torch.Tensor,
                 centroids: torch.Tensor,
                 weights: torch.Tensor | None = None, *, block_n: int,
                 k_chunk: int = 0):
    """One untiled assignment round. Returns (labels (n,) int32, min_d2
    (n,), sums (k, d), counts (k,)), the sums and counts over all rows,
    each row weighted by ``weights`` (n,) when given. On the card this
    launches K4 (its kernels count as one launch) with ``block_n``-row
    tiles, which set only the order of the sums: on the screened route
    where ``screened(d, bf16)`` (its counters read with
    ``screen_stats("lloyd_assign")``) or else on the row pass, each then
    the tiles' sums and the all-tile reduce (``k_chunk`` as K3's). CPU
    tensors take the plain twin."""
    if points.dim() != 2 or centroids.dim() != 2:
        raise ValueError("points and centroids must be 2-D")
    return _untiled(points, norms, centroids, weights, block_n=block_n,
                    template=False, k_chunk=k_chunk)


def lloyd_assign_batched(points: torch.Tensor, norms: torch.Tensor,
                         centroids: torch.Tensor, *, block_n: int):
    """One untiled assignment round of B independent problems: points
    (B, n, d), norms (B, n), centroids (B, k, d). Returns (labels (B, n),
    min_d2 (B, n), sums (B, k, d), counts (B, k)). On the card this
    launches K9 (its kernels count as one launch) for every problem at
    once, on the screened route where ``screened(d, bf16)`` (counters:
    ``screen_stats("lloyd_assign_batched")``), else on K4's row pass with a
    problem index; CPU tensors take the plain twin."""
    if points.dim() != 3 or centroids.dim() != 3:
        raise ValueError("points and centroids must be 3-D (B, rows, d)")
    return _untiled(points, norms, centroids, None, block_n=block_n,
                    template=False)


def lloyd_assign_template(points: torch.Tensor, norms: torch.Tensor,
                          centroids: torch.Tensor,
                          weights: torch.Tensor | None = None, *,
                          block_n: int):
    """K4 as the template kernel computes it (``assign_tile_kernel``'s
    untiled instance, then the one-super reduce: K4's route before the
    screened route and the row pass), at any width whose staging fits: the
    arguments and returns of :func:`lloyd_assign`. The reference the card
    tests and the smoke script hold K4 to, bit for bit; the engine never
    calls it, and it counts no launch. CPU tensors take the plain twin."""
    if points.dim() != 2 or centroids.dim() != 2:
        raise ValueError("points and centroids must be 2-D")
    return _untiled(points, norms, centroids, weights, block_n=block_n,
                    template=True)


def lloyd_assign_batched_template(points: torch.Tensor, norms: torch.Tensor,
                                  centroids: torch.Tensor, *, block_n: int):
    """K9 as the template kernel computes it, as
    :func:`lloyd_assign_template` is to K4: the arguments and returns of
    :func:`lloyd_assign_batched`. Counts no launch; CPU tensors take the
    plain twin."""
    if points.dim() != 3 or centroids.dim() != 3:
        raise ValueError("points and centroids must be 3-D (B, rows, d)")
    return _untiled(points, norms, centroids, None, block_n=block_n,
                    template=True)
