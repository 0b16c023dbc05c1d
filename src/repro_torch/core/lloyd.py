"""Lloyd iterations — the clustering phase (port of ``repro.core.lloyd``).
The loop lives in ``repro_torch.core.engine``; these are thin shims."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.engine import (ClusterEngine, LloydResult,
                                     centroid_means, segment_update)

__all__ = ["LloydResult", "update", "lloyd", "kmeans"]


def update(points: torch.Tensor, assignment: torch.Tensor, k: int,
           prev_centroids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Update step: per-cluster means. Empty clusters keep their previous
    centroid."""
    sums, counts = segment_update(points, assignment, k)
    return centroid_means(sums, counts, prev_centroids)


def lloyd(points, init_centroids, *, max_iters: int = 50, tol: float = 1e-6,
          variant: str = "cuda", device=None) -> LloydResult:
    """Lloyd iterations until the relative inertia improvement falls below
    ``tol`` or ``max_iters`` is hit."""
    return ClusterEngine(variant, device=device).fit(
        points, init_centroids, max_iters=max_iters, tol=tol)


def kmeans(points, k: int, *, generator: Optional[torch.Generator] = None,
           variant: str = "cuda", max_iters: int = 50,
           device=None) -> LloydResult:
    """End-to-end k-means: k-means++ seeding + Lloyd clustering."""
    return ClusterEngine(variant, device=device).kmeans(
        points, k, generator=generator, max_iters=max_iters)
