"""Carry reference state into the port.

The JAX package's results, handed over as numpy arrays, become the port's
result types, and the reference backend's tile geometry becomes a port
backend's. With them a port run can start from the reference's seeds and
tile its rows the same way, so both sides compute the same thing. Its
prologue cache and carried bound state become the port's too, so a gated
round on each side can be fed the same carries.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bounds import BoundState, RoundCache
from repro_torch.core.engine import Backend, KmeansppResult, LloydResult


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def kmeanspp_result(centroids, indices, min_d2, *,
                    device="cpu") -> KmeansppResult:
    """A reference seeding result (centroids (k, d), indices (k,),
    min_d2 (n,), each with a leading (B,) axis when batched) as the port's
    ``KmeansppResult``."""
    return KmeansppResult(_tensor(centroids, device, torch.float32),
                          _tensor(indices, device, torch.int64),
                          _tensor(min_d2, device, torch.float32))


def lloyd_result(centroids, assignment, inertia, n_iters, *,
                 device="cpu") -> LloydResult:
    """A reference Lloyd result as the port's ``LloydResult``; a batched
    one (leading (B,) axis, ``n_iters`` (B,)) keeps ``n_iters`` as a (B,)
    int32 tensor, as ``fit_batched`` returns it."""
    its = np.asarray(n_iters)
    return LloydResult(_tensor(centroids, device, torch.float32),
                       _tensor(assignment, device, torch.int32),
                       _tensor(inertia, device, torch.float32),
                       int(its) if its.ndim == 0
                       else _tensor(its, device, torch.int32))


def with_geometry(backend: Backend, block_n: int, tps: int) -> Backend:
    """``backend`` with the reference backend's tile height and super-tile
    fan-in (its ``seed_tile`` and ``tiles_per_super`` values), so per-tile
    partials and per-super sums cover the same rows on both sides."""
    return dataclasses.replace(backend, block_n=int(block_n), tps=int(tps))


def _fields(obj, cls, device, int_fields=()):
    out = {}
    for name in cls._fields:
        v = getattr(obj, name, None)
        if v is not None:
            dtype = torch.int32 if name in int_fields else torch.float32
            out[name] = _tensor(v, device, dtype)
    return cls(**out)


def round_cache(cache, *, device="cpu") -> RoundCache:
    """A reference ``RoundCache`` (norms, and centers/radii/center_d when it
    was made with bounds; arrays or numpy) as the port's."""
    return _fields(cache, RoundCache, device)


def bound_state(state, *, device="cpu") -> BoundState:
    """A reference ``BoundState`` (any of its fields set, arrays or numpy)
    as the port's: fp32 everywhere but the int32 ``assignment``."""
    return _fields(state, BoundState, device, int_fields=("assignment",))
