"""K2 — the k-means++ seeding round (port of
``repro.kernels.kmeans_distance.distance_min_update_pallas``).

One round folds the newest centroid block c (m, d) into every point's D²
and returns the per-tile partial sums the samplers draw from:

    new_md = min(md, min_c max(||x||² − 2 x·c + ||c||², 0)),
    partials[t] = sum of new_md over tile t's rows.

``distance_min_update`` launches the hand-written CUDA kernel
(``csrc/kmeans_distance.cu``) for tensors on the card, and runs the plain
twin ``distance_min_update_torch`` only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.guards import KernelFailureError
from repro_torch.core.sampling import tile_partials
from repro_torch.kernels import _build, ops

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


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
    for name, t in (("points", points), ("norms", norms),
                    ("centroids", centroids), ("min_d2", min_d2)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
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
