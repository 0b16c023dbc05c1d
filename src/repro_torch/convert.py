"""Carry reference state into the port.

The JAX package's results, handed over as numpy arrays, become the port's
result types, and the reference backend's tile geometry becomes a port
backend's. With them a port run can start from the reference's seeds and
tile its rows the same way, so both sides compute the same thing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import Backend, KmeansppResult, LloydResult


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def kmeanspp_result(centroids, indices, min_d2, *,
                    device="cpu") -> KmeansppResult:
    """A reference seeding result (centroids (k, d), indices (k,),
    min_d2 (n,)) as the port's ``KmeansppResult``."""
    return KmeansppResult(_tensor(centroids, device, torch.float32),
                          _tensor(indices, device, torch.int64),
                          _tensor(min_d2, device, torch.float32))


def lloyd_result(centroids, assignment, inertia, n_iters, *,
                 device="cpu") -> LloydResult:
    """A reference Lloyd result as the port's ``LloydResult``."""
    return LloydResult(_tensor(centroids, device, torch.float32),
                       _tensor(assignment, device, torch.int32),
                       _tensor(inertia, device, torch.float32),
                       int(np.asarray(n_iters)))


def with_geometry(backend: Backend, block_n: int, tps: int) -> Backend:
    """``backend`` with the reference backend's tile height and super-tile
    fan-in (its ``seed_tile`` and ``tiles_per_super`` values), so per-tile
    partials and per-super sums cover the same rows on both sides."""
    return dataclasses.replace(backend, block_n=int(block_n), tps=int(tps))
