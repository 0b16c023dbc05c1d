"""Spatial row orderings for tile-coherent clustering layouts (port of
``repro.data.ordering``).

The tile gates (``core.bounds``) prune whole point tiles, so they fire only
when nearby rows are nearby in space. These permutations make them so:

* :func:`morton_order` — Z-order over the coordinates quantized per
  dimension (``32 // d`` bits each, at most the first 16 dimensions);
* :func:`label_sort_order` — a stable sort by a caller's labels (blob
  labels, a previous fit's assignment, a coarse quantizer), optionally with
  the per-label offsets an inverted-file index stores.

Every ordering returns ``(perm, inv)`` int32 with ``ordered = x[perm]`` and
``ordered[inv] == x``. Each takes one problem (n, d) or, for
:func:`morton_order` and :func:`spatial_order`, a batch (B, n, d) ordered
problem by problem; row b of a batched call is the single call on problem
b. The permutations equal the reference's exactly: the quantization keeps
its fp32 operation order and the sorts are stable.
"""
from __future__ import annotations

from typing import Optional

import torch

_MAX_DIMS = 16   # morton interleaves at most this many leading dimensions


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[..., perm[..., i]] = i — the scatter that undoes a
    gather, along the last axis."""
    n = perm.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=perm.device)
    inv = torch.empty_like(perm, dtype=torch.int32)
    return inv.scatter_(-1, perm.long(), iota.expand(perm.shape).contiguous())


def morton_code(points: torch.Tensor, *, bits: Optional[int] = None
                ) -> torch.Tensor:
    """(..., n) Z-order code as int64 holding the reference's uint32 bits:
    per-dimension min-max quantization to ``bits`` bits (default ``32 //
    d``, capped at 16), then bit interleaving (dimension-major). Min and
    max are taken over the rows of each problem."""
    x = points.float()
    d = min(x.shape[-1], _MAX_DIMS)
    x = x[..., :d]
    if bits is None:
        bits = max(1, 32 // d)
    bits = max(1, min(bits, 32 // d, 16))
    lo = x.amin(dim=-2, keepdim=True)
    span = torch.clamp_min(x.amax(dim=-2, keepdim=True) - lo, 1e-30)
    q = ((x - lo) / span * float((1 << bits) - 1) + 0.5).to(torch.int64)
    code = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for b in range(bits):
        for j in range(d):
            code |= ((q[..., j] >> b) & 1) << (b * d + j)
    return code


def morton_order(points: torch.Tensor, *, bits: Optional[int] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows sorted by their Z-order code (stable): (perm, inv) int32."""
    perm = torch.argsort(morton_code(points, bits=bits), dim=-1,
                         stable=True).to(torch.int32)
    return perm, inverse_permutation(perm)


def label_sort_order(labels: torch.Tensor, *, nlist: Optional[int] = None,
                     return_offsets: bool = False):
    """Stable sort by label: (perm, inv) int32. With ``return_offsets``
    (needs ``nlist``, the number of label values) also ``(starts,
    counts)`` int32: after ``perm``, label l's rows are the run
    ``[starts[l], starts[l] + counts[l])``, ``starts`` the exclusive
    cumulative sum of ``counts``."""
    perm = torch.argsort(labels, dim=-1, stable=True).to(torch.int32)
    inv = inverse_permutation(perm)
    if not return_offsets:
        return perm, inv
    if nlist is None:
        raise ValueError("label_sort_order(return_offsets=True) needs "
                         "nlist=")
    counts = torch.bincount(labels.long(), minlength=nlist)[:nlist]
    starts = torch.cumsum(counts, 0) - counts
    return perm, inv, starts.to(torch.int32), counts.to(torch.int32)


def spatial_order(points: torch.Tensor, *, method: str = "morton",
                  labels: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The engine's ``order=`` names: 'morton' (coordinates only) or
    'label' (needs ``labels``)."""
    if method == "morton":
        return morton_order(points)
    if method == "label":
        if labels is None:
            raise ValueError("spatial_order(method='label') needs labels=")
        return label_sort_order(labels)
    raise ValueError(f"unknown ordering {method!r}; "
                     "expected 'morton' or 'label'")
