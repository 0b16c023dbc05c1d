"""Synthetic data for the k-means workloads (the port's own copy of
``repro.data.synthetic.blobs``, numpy only)."""
from __future__ import annotations

import numpy as np


def blobs(n: int, d: int, k: int, *, seed: int = 0, spread: float = 0.05,
          dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """n points from k Gaussian blobs in [0,1]^d. Returns (points, labels)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 1.0, size=(k, d))
    labels = rng.integers(0, k, size=n)
    pts = centers[labels] + rng.normal(0.0, spread, size=(n, d))
    return pts.astype(dtype), labels.astype(np.int32)
