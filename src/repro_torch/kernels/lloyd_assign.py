"""K3, K6 and K10a — the tiled Lloyd assignment round, ungated, bound-gated
and batched (port of ``repro.kernels.lloyd_assign.lloyd_assign_tiled_pallas``,
``lloyd_assign_gated_pallas`` and ``lloyd_assign_tiled_batched_pallas``).

One round assigns every point to its nearest centroid and returns what the
centroid update and the next slice's movement bound need:

    labels (n,) int32   argmin over centroids, first index on ties
    min_d2 (n,)         D² to the assigned centroid
    partials (T,)       per-tile inertia partial
    gaps (T,)           per-tile min of √second − √best (+inf at k = 1)
    ssums (S, k, d)     per-super-tile cluster sums, S = ceil(T / tps)
    scounts (S, k)      per-super-tile cluster counts

The gated round (K6) computes the same on a super-aligned set of active
tiles only, short-circuits the rows the per-point Hamerly bound prunes, and
also returns each row's lower bound on its second-nearest distance and each
tile's count of pruned rows; skipped tiles and supers keep their carried
values.

The batched round (K10a) is K3 over B independent problems in one launch,
every output with a leading problem axis; row b is K3 on problem b.

``lloyd_assign_tiled``, ``lloyd_assign_gated`` and
``lloyd_assign_tiled_batched`` launch the hand-written
CUDA kernels (``csrc/lloyd_assign.cu``) for tensors on the card, and run the
plain twins (``*_torch``) only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bounds
from repro_torch.core.bounds import super_reduce
from repro_torch.core.guards import KernelFailureError
from repro_torch.core.sampling import tile_partials
from repro_torch.kernels import _build, ops
from repro_torch.kernels.kmeans_distance import tile_d2

_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6
             + (ctypes.c_void_p,))
_GATED_ARGTYPES = ((ctypes.c_void_p,) * 19 + (ctypes.c_int,) * 6
                   + (ctypes.c_void_p,))
_BATCHED_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7
                     + (ctypes.c_void_p,))


def _tile_reduce(points, a, m, gap_pt, k, block_n, tps):
    """Per-tile partials and gaps, and per-super cluster sums and counts,
    of per-row labels ``a``, D² ``m`` and gaps ``gap_pt`` — one reduction
    for both twins, so an active super's sums are the same bits gated or
    not."""
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


def lloyd_assign_tiled(points: torch.Tensor, norms: torch.Tensor,
                       centroids: torch.Tensor, *, block_n: int, tps: int):
    """One tiled assignment round. Returns (labels, min_d2, partials, gaps,
    super_sums, super_counts); ``tps`` consecutive tiles share one super-tile
    accumulator slot. On the card this launches K3 (its two kernels count
    as one launch); CPU tensors take the plain twin."""
    _check(points, norms, centroids, block_n, tps)
    if points.device.type == "cpu":
        return lloyd_assign_tiled_torch(points, norms, centroids,
                                        block_n=block_n, tps=tps)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ops.check_card_tensors(points=points, norms=norms, centroids=centroids)
    n, d = points.shape
    k = centroids.shape[0]
    cols = ops.assign_cols(d, k, block_n)
    if cols < 1:
        raise ValueError(f"({k}, {d}) centroids with block_n={block_n} do "
                         f"not fit in {ops.SMEM_LIMIT} bytes of shared memory")
    fn = _build.function("lloyd_assign", "lloyd_assign_tiled_launch",
                         _ARGTYPES)
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 labels.data_ptr(), md.data_ptr(), partials.data_ptr(),
                 gaps.data_ptr(), tile_acc.data_ptr(), ssums.data_ptr(),
                 scounts.data_ptr(), n, d, k, block_n, tps, cols, stream)
    if err != 0:
        raise KernelFailureError(f"lloyd_assign_tiled launch failed: "
                                 f"cudaError {err}")
    ops.LAUNCHES["lloyd_assign_tiled"] += 1
    return labels, md, partials, gaps, ssums, scounts


def lloyd_assign_tiled_batched(points: torch.Tensor, norms: torch.Tensor,
                               centroids: torch.Tensor, *, block_n: int,
                               tps: int):
    """One tiled assignment round of B independent problems: points
    (B, n, d), norms (B, n), centroids (B, k, d). Returns (labels (B, n),
    min_d2 (B, n), partials (B, T), gaps (B, T), super_sums (B, S, k, d),
    super_counts (B, S, k)). On the card this launches K10a (its two kernels
    count as one launch) for every problem at once; CPU tensors take the
    plain twin."""
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
    ops.check_card_tensors(points=points, norms=norms, centroids=centroids)
    _, n, d = points.shape
    k = centroids.shape[1]
    cols = ops.assign_cols(d, k, block_n)
    if cols < 1:
        raise ValueError(f"({k}, {d}) centroids with block_n={block_n} do "
                         f"not fit in {ops.SMEM_LIMIT} bytes of shared memory")
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 labels.data_ptr(), md.data_ptr(), partials.data_ptr(),
                 gaps.data_ptr(), tile_acc.data_ptr(), ssums.data_ptr(),
                 scounts.data_ptr(), bsz, n, d, k, block_n, tps, cols, stream)
    if err != 0:
        raise KernelFailureError(f"lloyd_assign_tiled_batched launch failed: "
                                 f"cudaError {err}")
    ops.LAUNCHES["lloyd_assign_tiled_batched"] += 1
    return labels, md, partials, gaps, ssums, scounts


def lloyd_assign_gated(points: torch.Tensor, norms: torch.Tensor,
                       centroids: torch.Tensor, delta: torch.Tensor,
                       thresh: torch.Tensor, absorb: torch.Tensor,
                       prev_assign: torch.Tensor, prev_min_d2: torch.Tensor,
                       prev_lb: torch.Tensor, prev_partials: torch.Tensor,
                       prev_gaps: torch.Tensor, prev_super_sums: torch.Tensor,
                       prev_super_counts: torch.Tensor, active: torch.Tensor,
                       *, block_n: int, tps: int):
    """One bound-gated assignment round. ``active`` (T,) is expanded here to
    whole super-tiles (idempotent when the caller already did);
    ``delta``/``thresh``/``absorb`` come from ``bounds.assign_point_scalars``
    and the ``prev_*`` carries from the previous round, at tile height
    ``block_n`` and fan-in ``tps``. Returns (labels, min_d2, lb, partials,
    gaps, super_sums, super_counts, pruned (T,) int32). On the card this
    launches K6 (its two kernels count as one launch) over the full grid;
    the outputs start as copies of the carries, so skipped tiles and supers
    keep them. CPU tensors take the plain twin."""
    _check(points, norms, centroids, block_n, tps)
    n, d = points.shape
    k = centroids.shape[0]
    n_tiles = -(-n // block_n)
    n_super = -(-n_tiles // tps)
    shapes = {"delta": (delta, (k,)), "thresh": (thresh, (n_tiles,)),
              "absorb": (absorb, (n_tiles,)),
              "prev_assign": (prev_assign, (n,)),
              "prev_min_d2": (prev_min_d2, (n,)), "prev_lb": (prev_lb, (n,)),
              "prev_partials": (prev_partials, (n_tiles,)),
              "prev_gaps": (prev_gaps, (n_tiles,)),
              "prev_super_sums": (prev_super_sums, (n_super, k, d)),
              "prev_super_counts": (prev_super_counts, (n_super, k)),
              "active": (active, (n_tiles,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} must be {want}")
    active = bounds.expand_active_supers(active, tps)
    if points.device.type == "cpu":
        return lloyd_assign_gated_torch(
            points, norms, centroids, delta, thresh, absorb, prev_assign,
            prev_min_d2, prev_lb, prev_partials, prev_gaps, prev_super_sums,
            prev_super_counts, active, block_n=block_n, tps=tps)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    ops.check_card_tensors(points=points, norms=norms, centroids=centroids,
                           delta=delta, thresh=thresh, absorb=absorb,
                           prev_min_d2=prev_min_d2, prev_lb=prev_lb)
    ops.check_card_tensors(torch.int32, prev_assign=prev_assign)
    cols = ops.assign_cols(d, k, block_n, gated=True)
    if cols < 1:
        raise ValueError(f"({k}, {d}) centroids with block_n={block_n} do "
                         f"not fit in {ops.SMEM_LIMIT} bytes of shared memory")
    fn = _build.function("lloyd_assign", "lloyd_assign_gated_launch",
                         _GATED_ARGTYPES)
    dev = points.device
    labels, md, lb = prev_assign.clone(), prev_min_d2.clone(), prev_lb.clone()
    partials = prev_partials.float().clone()
    gaps = prev_gaps.float().clone()
    ssums = prev_super_sums.float().contiguous().clone()
    scounts = prev_super_counts.float().contiguous().clone()
    pruned = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    tile_acc = torch.empty((n_tiles, k, d + 1), dtype=torch.float32,
                           device=dev)
    act = active.to(torch.uint8).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), norms.data_ptr(), centroids.data_ptr(),
                 delta.data_ptr(), thresh.data_ptr(), absorb.data_ptr(),
                 prev_assign.data_ptr(), prev_min_d2.data_ptr(),
                 prev_lb.data_ptr(), act.data_ptr(), labels.data_ptr(),
                 md.data_ptr(), lb.data_ptr(), partials.data_ptr(),
                 gaps.data_ptr(), tile_acc.data_ptr(), ssums.data_ptr(),
                 scounts.data_ptr(), pruned.data_ptr(), n, d, k, block_n,
                 tps, cols, stream)
    if err != 0:
        raise KernelFailureError(f"lloyd_assign_gated launch failed: "
                                 f"cudaError {err}")
    ops.LAUNCHES["lloyd_assign_gated"] += 1
    return labels, md, lb, partials, gaps, ssums, scounts, pruned
