"""K-means++ seeding — the paper's phase (port of ``repro.core.kmeanspp``).

After each new centroid is chosen, every point's distance to its nearest
centroid is updated in parallel, the normalization term sum(D²) is reduced,
and the next centroid is sampled ∝ D². This module is a thin shim over
``repro_torch.core.engine``; ``variant`` names a backend ('cuda' — the
Hopper kernels — 'fused' or 'reference', or the reference backend's modes
'serial' and 'global'). ``random_init`` is the classic random seeding that
k-means++ improves upon.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core import guards
from repro_torch.core.engine import (Backend, ClusterEngine, KmeansppResult,
                                     make_backend, pairwise_d2, point_d2,
                                     resolve_device)
from repro_torch.core.sampling import Draws

__all__ = ["KmeansppResult", "kmeanspp", "random_init", "pairwise_d2",
           "point_d2"]


def kmeanspp(points, k: int, *, generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None, variant: str = "cuda",
             sampler: str = "cdf", device=None) -> KmeansppResult:
    """K-means++ seeding. Returns k centroids chosen from ``points``."""
    return ClusterEngine(variant, device=device).seed(
        points, k, generator=generator, draws=draws, sampler=sampler)


def random_init(points, k: int, *, generator: Optional[torch.Generator] = None,
                indices=None, backend: Union[str, Backend] = "cuda",
                device=None) -> KmeansppResult:
    """Classic random seeding: k distinct rows drawn uniformly, without
    replacement (``torch.randperm`` on the generator's device), or the
    injected (k,) ``indices``. ``min_d2`` is every row's D² to the nearest
    seed, from ``backend``'s untiled assignment round (K4 on the card).
    ``device`` defaults to the card."""
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    if pts.dim() != 2:
        raise guards.InvalidInputError(
            f"points must be (n, d), got {tuple(pts.shape)}")
    n = pts.shape[0]
    guards.check_shape(k, n)
    if indices is None:
        gdev = "cpu" if generator is None else generator.device
        indices = torch.randperm(n, generator=generator, device=gdev)[:k]
    idx = torch.as_tensor(indices).to(device=dev, dtype=torch.int64)
    if tuple(idx.shape) != (k,):
        raise ValueError(f"indices {tuple(idx.shape)} must be ({k},)")
    pts = pts.contiguous()
    cents = pts.index_select(0, idx)
    return KmeansppResult(cents, idx,
                          make_backend(backend).assign_update(pts,
                                                              cents).min_d2)
