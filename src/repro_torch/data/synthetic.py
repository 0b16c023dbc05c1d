"""Synthetic data for the k-means workloads: the port's own copy of
``repro.data.synthetic.blobs`` (numpy), and ``blobs_batched``, which makes
a batch of independent blob problems on the device."""
from __future__ import annotations

import numpy as np
import torch


def blobs(n: int, d: int, k: int, *, seed: int = 0, spread: float = 0.05,
          dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """n points from k Gaussian blobs in [0,1]^d. Returns (points, labels)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 1.0, size=(k, d))
    labels = rng.integers(0, k, size=n)
    pts = centers[labels] + rng.normal(0.0, spread, size=(n, d))
    return pts.astype(dtype), labels.astype(np.int32)


def blobs_batched(batch: int, n: int, d: int, k: int, *,
                  generator: torch.Generator, spread: float = 0.05,
                  sort: bool = False) -> torch.Tensor:
    """(batch, n, d) fp32: each problem n points from its own k Gaussian
    blobs in [0,1]^d, drawn from ``generator`` on its device. ``sort``
    orders each problem's rows by blob (stable), so its tiles are
    spatially coherent."""
    dev = generator.device
    centers = torch.rand((batch, k, d), generator=generator, device=dev)
    labels = torch.randint(k, (batch, n, 1), generator=generator, device=dev)
    pts = torch.randn((batch, n, d), generator=generator, device=dev)
    pts.mul_(spread).add_(torch.take_along_dim(centers, labels, dim=1))
    if sort:
        order = torch.argsort(labels, dim=1, stable=True)
        pts = torch.take_along_dim(pts, order, dim=1)
    return pts
