"""Carry reference state into the port.

The JAX package's results, handed over as numpy arrays, become the port's
result types, and the reference backend's tile geometry becomes a port
backend's. With them a port run can start from the reference's seeds and
tile its rows the same way, so both sides compute the same thing. Its
prologue cache and carried bound state become the port's too, so a gated
round on each side can be fed the same carries. A reference IVF index (and
a PQ codebook) becomes the port's, so both sides search one index, and a
reference PQ-compressed KV cache the port's, so both sides decode one
cache.
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


def pq_codebook(centroids, *, device="cpu"):
    """A reference ``PQCodebook`` (its (n_sub, n_codes, d_sub) centroids) as
    the port's."""
    from repro_torch.serve.kvquant import PQCodebook
    return PQCodebook(_tensor(centroids, device, torch.float32))


def pq_cache(cache, *, device="cpu") -> dict:
    """A reference ``compress_transformer_cache`` dict (arrays or numpy:
    ``k_codes``/``v_codes`` (L, B, S, KH, n_sub), ``k_cb``/``v_cb`` (L, KH,
    n_sub, 256, dsub), ``pos``) as the port's: codes uint8, codebooks fp32,
    ``pos`` a 0-d int32 tensor (a ``cache_len`` K16 takes)."""
    out = {f"{n}_codes": _tensor(cache[f"{n}_codes"], device, torch.uint8)
           for n in ("k", "v")}
    out.update({f"{n}_cb": _tensor(cache[f"{n}_cb"], device, torch.float32)
                for n in ("k", "v")})
    out["pos"] = _tensor(cache["pos"], device, torch.int32)
    return out


def ivf_index(index, *, backend: str = "cuda", device="cpu"):
    """A reference ``IvfIndex`` (with its ``IvfPq`` when built with PQ;
    arrays or numpy) as the port's, so one index can be searched on both
    sides. ``backend`` is the port index's scan backend ('cuda': K13/K14,
    whose wrappers take the plain twins on CPU tensors)."""
    from repro_torch.serve.ivf import IvfIndex, IvfPq

    def f32(x):
        return _tensor(x, device, torch.float32)

    def i32(x):
        return _tensor(x, device, torch.int32)

    pq = None
    if index.pq is not None:
        p = index.pq
        pq = IvfPq(_tensor(p.codes, device, torch.uint8),
                   pq_codebook(p.codebook.centroids, device=device),
                   f32(p.u), f32(p.centers), f32(p.radii))
    return IvfIndex(
        points=f32(index.points), norms=f32(index.norms),
        centers=f32(index.centers), radii=f32(index.radii),
        labels=i32(index.labels), perm=i32(index.perm),
        starts=i32(index.starts), counts=i32(index.counts),
        centroids=f32(index.centroids),
        centroid_norms=f32(index.centroid_norms),
        super_centers=f32(index.super_centers),
        super_radii=f32(index.super_radii), super_sizes=i32(index.super_sizes),
        list_tiles=_tensor(index.list_tiles, device, torch.bool),
        block_n=int(index.block_n), backend=backend, pq=pq)
