"""KV-cache product quantization via batched k-means++ (port of
``repro.serve.kvquant``).

A key or value vector of head_dim d splits into ``n_sub`` sub-vectors of
d / n_sub; each sub-space is clustered to 256 centroids (k-means++ seeding,
the paper's phase, then a few Lloyd iterations), and every vector becomes
``n_sub`` uint8 codes plus a small codebook. All sub-space clusterings of
one call run as ONE ``ClusterEngine.kmeans_batched`` sweep.

Departures from the reference:

* The reference builds its default engine, ``ClusterEngine("fused",
  tune="cache")``, when the module is imported. Here a call without
  ``engine=`` builds a port ``ClusterEngine()`` at call time (the card,
  raising without one; no tuner, which the port does not have). Importing
  this module touches no device.
* Randomness comes in as a ``generator`` or batched ``Draws`` (one (B,)
  batch per sweep: ``compress_transformer_cache`` takes a pair, for its k
  and v sweeps), in place of the reference's ``key``, ``split`` and
  ``fold_in``. A caller replaying the reference hands over the draws its
  keys give.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.engine import ClusterEngine, pairwise_d2
from repro_torch.core.guards import (InvalidInputError, check_policy,
                                     guard_points)
from repro_torch.core.sampling import Draws


class PQCodebook(NamedTuple):
    centroids: torch.Tensor   # (n_sub, n_codes, d_sub) fp32


class PQCache(NamedTuple):
    codes: torch.Tensor       # (..., n_sub) uint8
    codebook: PQCodebook


def _check_codebook(cb: PQCodebook, *, what: str) -> None:
    """An empty or malformed codebook always raises typed."""
    c = cb.centroids
    if c.dim() != 3 or c.numel() == 0:
        raise InvalidInputError(
            f"{what}: codebook centroids must be a non-empty "
            f"(n_sub, n_codes, d_sub) tensor, got shape {tuple(c.shape)}")


def _check_subspaces(d: int, n_sub: int, *, what: str) -> None:
    if n_sub < 1 or d % n_sub != 0:
        raise InvalidInputError(
            f"{what}: d={d} must split into n_sub={n_sub} equal sub-vectors "
            f"(d % n_sub == 0, n_sub >= 1)")


def _fit_codebooks(problems: torch.Tensor, *, n_codes: int,
                   lloyd_iters: int, engine: Optional[ClusterEngine],
                   order=None, generator: Optional[torch.Generator] = None,
                   draws: Optional[Draws] = None) -> torch.Tensor:
    """problems (B, take, d_sub) -> (B, n_codes, d_sub) centroids, one
    ``kmeans_batched`` call for all B (its ``order`` reorders each problem
    and maps back, so the codebooks do not depend on it). Fewer rows than
    codes fit ``take`` codes and pad the rest with zeros."""
    eng = ClusterEngine() if engine is None else engine
    take = problems.shape[1]
    k_eff = min(n_codes, take)
    cents = eng.kmeans_batched(problems, k_eff, max_iters=lloyd_iters,
                               order=order, generator=generator,
                               draws=draws).centroids.float()
    if k_eff < n_codes:
        cents = torch.cat([cents, cents.new_zeros(
            (cents.shape[0], n_codes - k_eff, cents.shape[2]))], 1)
    return cents


def build_codebook(vectors, *, n_sub: int, n_codes: int = 256,
                   lloyd_iters: int = 10, sample: int = 16384,
                   engine: Optional[ClusterEngine] = None, order=None,
                   validate: str = "raise",
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Draws] = None) -> PQCodebook:
    """vectors (N, d) -> PQ codebook, d % n_sub == 0: every ``N //
    sample``-th row (at most ``sample``), each of its ``n_sub`` sub-spaces
    one problem of one batched sweep through ``engine``. ``order='morton'``
    reorders each sub-space sample for the bound gates. ``validate`` is the
    entry guard policy ('raise', 'sanitize' zeroes non-finite rows, 'off');
    a bad ``n_sub`` always raises. ``draws`` are the sweep's (n_sub,)
    batched draws."""
    check_policy(validate)
    vectors = torch.as_tensor(vectors)
    n_rows, d = vectors.shape
    _check_subspaces(d, n_sub, what="build_codebook")
    vectors = guard_points(vectors.float(), validate, name="vectors")
    dsub = d // n_sub
    take = min(sample, n_rows)
    stride = max(n_rows // take, 1)
    sub = vectors[::stride][:take].reshape(take, n_sub, dsub)
    return PQCodebook(_fit_codebooks(
        sub.movedim(1, 0).contiguous(), n_codes=n_codes,
        lloyd_iters=lloyd_iters, engine=engine, order=order,
        generator=generator, draws=draws))


def encode(vectors, cb: PQCodebook, *, validate: str = "raise"
           ) -> torch.Tensor:
    """(..., d) -> (..., n_sub) uint8 codes, each sub-vector's nearest code
    (the first on a tie), on the codebook's device."""
    check_policy(validate)
    _check_codebook(cb, what="encode")
    n_sub, _, dsub = cb.centroids.shape
    vectors = torch.as_tensor(vectors)
    if vectors.shape[-1] != n_sub * dsub:
        raise InvalidInputError(
            f"encode: vectors dimension {vectors.shape[-1]} != codebook's "
            f"n_sub * d_sub = {n_sub * dsub}")
    vectors = guard_points(vectors.float(), validate, name="vectors")
    lead = vectors.shape[:-1]
    x = vectors.to(cb.centroids.device).reshape(-1, n_sub, dsub)
    codes = torch.stack([
        pairwise_d2(x[:, s], cb.centroids[s]).argmin(dim=1).to(torch.uint8)
        for s in range(n_sub)], dim=-1)
    return codes.reshape(*lead, n_sub)


def decode(codes, cb: PQCodebook, *, validate: str = "raise"
           ) -> torch.Tensor:
    """(..., n_sub) uint8 -> (..., d) reconstruction. ``validate`` is taken
    for symmetry with :func:`encode` (codes are integers)."""
    check_policy(validate)
    _check_codebook(cb, what="decode")
    n_sub, _, dsub = cb.centroids.shape
    codes = torch.as_tensor(codes)
    if codes.shape[-1] != n_sub:
        raise InvalidInputError(
            f"decode: codes width {codes.shape[-1]} != codebook's "
            f"n_sub = {n_sub}")
    lead = codes.shape[:-1]
    c = codes.to(cb.centroids.device).reshape(-1, n_sub).long()
    parts = [cb.centroids[s][c[:, s]] for s in range(n_sub)]
    return torch.cat(parts, dim=-1).reshape(*lead, n_sub * dsub)


def compress_kv(kv, *, n_sub: int = 8, lloyd_iters: int = 10,
                engine: Optional[ClusterEngine] = None, order=None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Draws] = None) -> PQCache:
    """kv (..., d) -> PQ cache (codes + codebook). Compression against
    bf16 is (d * 2) / n_sub."""
    kv = torch.as_tensor(kv)
    cb = build_codebook(kv.reshape(-1, kv.shape[-1]), n_sub=n_sub,
                        lloyd_iters=lloyd_iters, engine=engine, order=order,
                        generator=generator, draws=draws)
    return PQCache(encode(kv, cb), cb)


def reconstruction_error(kv, pq: PQCache) -> torch.Tensor:
    """Relative MSE of the PQ round trip."""
    rec = decode(pq.codes, pq.codebook).float()
    x = torch.as_tensor(kv).to(rec.device).float()
    return ((rec - x) ** 2).mean() / torch.clamp_min((x ** 2).mean(), 1e-12)


def compression_ratio(kv, pq: PQCache) -> float:
    kv = torch.as_tensor(kv)
    raw = kv.numel() * kv.element_size()
    comp = pq.codes.numel() + pq.codebook.centroids.numel() * 4
    return float(raw) / float(comp)


# ---------------------------------------------------------------------------
# transformer-cache integration (the layout pq_decode reads)
# ---------------------------------------------------------------------------


def compress_transformer_cache(cache: dict, *, n_sub: int = 16,
                               lloyd_iters: int = 6, sample: int = 16384,
                               engine: Optional[ClusterEngine] = None,
                               order=None,
                               generator: Optional[torch.Generator] = None,
                               draws: Optional[Sequence[Draws]] = None
                               ) -> dict:
    """A dense cache {"k", "v": (L, B, S, KH, hd), "pos"} -> the PQ layout

        {"k_codes", "v_codes": (L, B, S, KH, n_sub) uint8,
         "k_cb", "v_cb": (L, KH, n_sub, 256, hd / n_sub) fp32, "pos"},

    codebooks per (layer, kv head), every L·KH·n_sub sub-space of one
    tensor in one ``kmeans_batched`` sweep over a sample of its rows as
    :func:`build_codebook` takes it. ``draws``: the k and the v sweep's
    batched draws."""
    out = {"pos": cache["pos"]}
    for i, name in enumerate(("k", "v")):
        kv = torch.as_tensor(cache[name])
        n_layers, batch, seq, kh, hd = kv.shape
        _check_subspaces(hd, n_sub, what="compress_transformer_cache")
        dsub = hd // n_sub
        groups = kv.movedim(3, 1).reshape(n_layers * kh, batch * seq, hd)
        take = min(sample, batch * seq)
        stride = max((batch * seq) // take, 1)
        sub = groups[:, ::stride][:, :take]
        problems = sub.reshape(n_layers * kh, take, n_sub, dsub).movedim(
            2, 1).reshape(n_layers * kh * n_sub, take, dsub).float()
        cents = _fit_codebooks(problems, n_codes=256,
                               lloyd_iters=lloyd_iters, engine=engine,
                               order=order, generator=generator,
                               draws=None if draws is None else draws[i])
        cbs = cents.reshape(n_layers, kh, n_sub, 256, dsub)
        codes = torch.stack([
            torch.stack([encode(kv[li, :, :, h], PQCodebook(cbs[li, h]))
                         for h in range(kh)], dim=2)
            for li in range(n_layers)])
        out[f"{name}_codes"] = codes
        out[f"{name}_cb"] = cbs
    return out


def cache_bytes(cache) -> int:
    """Bytes of every tensor in a (nested) cache dict."""
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if isinstance(cache, (list, tuple)):
        return sum(cache_bytes(v) for v in cache)
    t = torch.as_tensor(cache)
    return t.numel() * t.element_size()
