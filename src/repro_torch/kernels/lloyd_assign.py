"""K3 — the tiled Lloyd assignment round (port of
``repro.kernels.lloyd_assign.lloyd_assign_tiled_pallas``).

One round assigns every point to its nearest centroid and returns what the
centroid update and the next slice's movement bound need:

    labels (n,) int32   argmin over centroids, first index on ties
    min_d2 (n,)         D² to the assigned centroid
    partials (T,)       per-tile inertia partial
    gaps (T,)           per-tile min of √second − √best (+inf at k = 1)
    ssums (S, k, d)     per-super-tile cluster sums, S = ceil(T / tps)
    scounts (S, k)      per-super-tile cluster counts

``lloyd_assign_tiled`` launches the hand-written CUDA kernels
(``csrc/lloyd_assign.cu``) for tensors on the card, and runs the plain twin
``lloyd_assign_tiled_torch`` only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bounds import super_reduce
from repro_torch.core.guards import KernelFailureError
from repro_torch.kernels import _build, ops
from repro_torch.kernels.kmeans_distance import tile_d2

_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6
             + (ctypes.c_void_p,))


def lloyd_assign_tiled_torch(points: torch.Tensor, norms: torch.Tensor,
                             centroids: torch.Tensor, *, block_n: int,
                             tps: int):
    """Plain PyTorch twin of K3: what ``repro.kernels.ref
    .lloyd_assign_tiled_ref`` computes, on the cached norms. Returns
    (labels, min_d2, partials, gaps, super_sums, super_counts)."""
    n, d = points.shape
    k = centroids.shape[0]
    d2 = tile_d2(points, centroids, norms)
    a = d2.argmin(dim=1)
    m = d2.amin(dim=1)
    won = a[:, None] == torch.arange(k, device=a.device)
    second = torch.where(won, torch.inf, d2).amin(dim=1)
    gap_pt = second.sqrt() - m.sqrt()

    pad = (-n) % block_n
    n_tiles = (n + pad) // block_n
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
    return (a.int(), m, partials, gaps, super_reduce(tile_sums, tps),
            super_reduce(tile_counts, tps))


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
    for name, t in (("points", points), ("norms", norms),
                    ("centroids", centroids)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
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
