"""Lloyd iterations — the clustering phase (port of ``repro.core.lloyd``).
The loop lives in ``repro_torch.core.engine``; these are thin shims."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.engine import (ClusterEngine, LloydResult,
                                     centroid_means, resolve_device,
                                     segment_update)
from repro_torch.kernels import ops

__all__ = ["LloydResult", "assign", "update", "lloyd", "kmeans"]


def assign(points, centroids, *,
           device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Assignment step: nearest centroid per point, through the untiled
    round (K4 on the card, the reference's ``use_pallas=True``). Returns
    (assignment (n,) int32, min_d2 (n,))."""
    dev = resolve_device(device)
    a, md, _, _ = ops.lloyd_assign(
        torch.as_tensor(points, dtype=torch.float32, device=dev).contiguous(),
        torch.as_tensor(centroids, dtype=torch.float32,
                        device=dev).contiguous())
    return a, md


def update(points: torch.Tensor, assignment: torch.Tensor, k: int,
           weights: Optional[torch.Tensor] = None,
           prev_centroids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Update step: per-cluster (weighted) means, summed in a fixed order.
    Empty clusters keep their previous centroid."""
    sums, counts = segment_update(points, assignment, k, weights)
    return centroid_means(sums, counts, prev_centroids)


def lloyd(points, init_centroids, *, max_iters: int = 50, tol: float = 1e-6,
          weights=None, variant: str = "cuda", device=None) -> LloydResult:
    """Lloyd iterations until the relative inertia improvement falls below
    ``tol`` or ``max_iters`` is hit; ``weights`` weigh each point."""
    return ClusterEngine(variant, device=device).fit(
        points, init_centroids, max_iters=max_iters, tol=tol,
        weights=weights)


def kmeans(points, k: int, *, generator: Optional[torch.Generator] = None,
           variant: str = "cuda", max_iters: int = 50,
           device=None) -> LloydResult:
    """End-to-end k-means: k-means++ seeding + Lloyd clustering."""
    return ClusterEngine(variant, device=device).kmeans(
        points, k, generator=generator, max_iters=max_iters)
