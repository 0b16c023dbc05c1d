"""K-means++ seeding — the paper's phase (port of ``repro.core.kmeanspp``).

After each new centroid is chosen, every point's distance to its nearest
centroid is updated in parallel, the normalization term sum(D²) is reduced,
and the next centroid is sampled ∝ D². This module is a thin shim over
``repro_torch.core.engine``; ``variant`` names a backend ('cuda' — the
Hopper kernels — 'fused' or 'reference').
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.engine import (ClusterEngine, KmeansppResult,
                                     pairwise_d2, point_d2)
from repro_torch.core.sampling import Draws

__all__ = ["KmeansppResult", "kmeanspp", "pairwise_d2", "point_d2"]


def kmeanspp(points, k: int, *, generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None, variant: str = "cuda",
             sampler: str = "cdf", device=None) -> KmeansppResult:
    """K-means++ seeding. Returns k centroids chosen from ``points``."""
    return ClusterEngine(variant, device=device).seed(
        points, k, generator=generator, draws=draws, sampler=sampler)
