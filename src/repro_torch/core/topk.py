"""Blocked lexicographic top-k: the merge the IVF scan carries across tiles
(port of ``repro.core.topk``).

Every merge orders candidates by the key ``(value, index)``, the order of
``jax.lax.sort(num_keys=2)``. Indices are unique, so the order is total:
a merge is associative over candidate blocks, and a scan's carried top-k
equals the global sort's first k rows bitwise however the candidates were
blocked (the exactness ``serve.ivf`` pins at ``nprobe == nlist``).

Empty slots hold ``(+inf, INT32_MAX)``, which trails every real candidate.
The functions take a leading batch of rows (..., m) and merge each row on
its own.
"""
from __future__ import annotations

import torch

IDX_SENTINEL = torch.iinfo(torch.int32).max


def init_topk(k: int, lead: tuple = (), device=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Empty carried top-k, (*lead, k): (+inf values, INT32_MAX indices)."""
    return (torch.full(lead + (k,), torch.inf, device=device),
            torch.full(lead + (k,), IDX_SENTINEL, dtype=torch.int32,
                       device=device))


def lex_topk(vals: torch.Tensor, idxs: torch.Tensor,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest k of (vals, idxs) along the last axis under the
    lexicographic (value, index) order, in one ``topk`` of int64 keys: the
    value's fp32 bits, mapped so that integer order is float order (-0
    equal to +0 and every NaN equal and last, as ``jax.lax.sort`` orders
    them), above the index offset to unsigned. Equal values keep ascending
    indices; the values come back with their own bits."""
    vals, idxs = vals.float(), idxs.to(torch.int32)
    canon = torch.where(vals.isnan(), torch.nan, vals + 0.0)   # -0 + 0 = +0
    bits = canon.view(torch.int32).long()
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    keys = (bits << 32) | (idxs.long() + 2 ** 31)
    pos = torch.topk(keys, min(k, keys.shape[-1]), dim=-1, largest=False,
                     sorted=True).indices
    return vals.gather(-1, pos), idxs.gather(-1, pos)


def merge_topk(top_vals: torch.Tensor, top_idxs: torch.Tensor,
               cand_vals: torch.Tensor, cand_idxs: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One blocked-merge step: carried top-k + a candidate block -> new
    top-k; any blocking of the candidates gives :func:`lex_topk` of all of
    them bitwise."""
    return lex_topk(torch.cat([top_vals, cand_vals], -1),
                    torch.cat([top_idxs, cand_idxs], -1), k)
