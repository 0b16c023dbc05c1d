"""Clustering-quality metrics (port of ``repro.core.quality``): the paper's
claim is a speedup that keeps the quality of the serial algorithm."""
from __future__ import annotations

import torch

from repro_torch.core.engine import pairwise_d2


def inertia(points: torch.Tensor, centroids: torch.Tensor, *,
            block: int = 8192) -> torch.Tensor:
    """Sum over points of the squared distance to the nearest centroid
    (phi), blocked so the (n, k) distance matrix never materializes whole."""
    c = centroids.float()
    total = torch.zeros((), dtype=torch.float32, device=points.device)
    for start in range(0, points.shape[0], block):
        x = points[start:start + block].float()
        total = total + pairwise_d2(x, c).amin(dim=1).sum()
    return total


def quantization_error(points: torch.Tensor,
                       centroids: torch.Tensor) -> torch.Tensor:
    """Mean squared quantization error (inertia / n), as KV-PQ reports
    it."""
    return inertia(points, centroids) / points.shape[0]


def cluster_sizes(assignment: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) fp32 number of points assigned to each cluster."""
    return torch.bincount(assignment.long(), minlength=k).float()


def balance(assignment: torch.Tensor, k: int) -> torch.Tensor:
    """Load balance max / mean cluster size (1.0 = perfectly balanced)."""
    sizes = cluster_sizes(assignment, k)
    return sizes.max() / sizes.mean().clamp_min(1e-12)
