"""Semantic dedup of document embeddings (port of ``repro.data.semdedup``).

SemDeDup (Abbas et al. 2023) clusters document embeddings with k-means and
drops near-duplicate pairs *within* each cluster: the clustering makes the
O(N²) pairwise check tractable, and better seeds make tighter clusters,
so fewer duplicates escape across clusters at the same k.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

__all__ = ["DedupResult", "semdedup"]

BLOCK = 2048   # rows of the check's (BLOCK, n) similarity blocks


class DedupResult(NamedTuple):
    keep_mask: torch.Tensor    # (n,) bool
    assignment: torch.Tensor   # (n,) int32 cluster per doc
    n_kept: torch.Tensor       # () int64


@contextlib.contextmanager
def _fp32_products():
    """Full fp32 matmuls on the card for the duration: a TF32 product moves
    similarities by ~1e-3, across the threshold."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def semdedup(embeds, *, k: int, threshold: float = 0.95,
             init: str = "kmeans++", max_iters: int = 25,
             backend="cuda", generator: Optional[torch.Generator] = None,
             draws=None, device=None) -> DedupResult:
    """Drop every doc whose cosine similarity to an EARLIER doc in the SAME
    cluster exceeds ``threshold``. ``embeds`` (n, d) are normalized, then
    clustered by ``ClusterEngine(backend, device=device).kmeans(x, k,
    init=init, max_iters=max_iters)`` (``generator`` or ``draws`` as that
    call takes them); the check runs in blocks of (``BLOCK``, n) fp32
    similarities, TF32 off. ``device`` defaults to the card."""
    from repro_torch.core.engine import ClusterEngine

    eng = ClusterEngine(backend, device=device)
    x = torch.as_tensor(embeds, dtype=torch.float32, device=eng.device)
    x = x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + 1e-8)
    a = eng.kmeans(x, k, init=init, max_iters=max_iters, generator=generator,
                   draws=draws).assignment
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)
    dup = torch.empty(n, dtype=torch.bool, device=x.device)
    with _fp32_products():
        for s in range(0, n, BLOCK):
            e = min(s + BLOCK, n)
            sim = x[s:e] @ x.T                               # (block, n)
            same = a[s:e, None] == a[None, :]
            earlier = rows[None, :] < rows[s:e, None]
            dup[s:e] = ((sim > threshold) & same & earlier).any(dim=1)
    keep = ~dup
    return DedupResult(keep, a, keep.sum())
