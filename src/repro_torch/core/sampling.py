"""Weighted categorical sampling for k-means++ seeding (port of
``repro.core.sampling``: the inverse-CDF samplers).

* inverse-CDF (``cdf``) — cumsum + searchsorted over all n weights.
* two-level tiled (``tiled``) — inverse-CDF over the per-tile partial sums
  the seeding round already produced, then inside the chosen tile only:
  O(n_tiles + block_n) reads per draw, the same distribution.

Every function takes its uniform ``u`` and, where the degenerate-weight
guard needs one, its fallback index as ARGUMENTS. torch cannot reproduce
JAX's threefry stream, so randomness comes from a :class:`Draws` source:
sampled from a ``torch.Generator`` by default, or injected (the parity
tests replay the reference's key schedule through it).

Indices stay on the device as (1,) int64 tensors: no draw syncs the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Draws:
    """The random numbers one k-means++ seeding run consumes.

    ``first`` is the (1,) first-seed index; round m (1 <= m < k) draws with
    ``u[m-1]`` in [0, 1) and, when the weights are degenerate, takes
    ``fallback[m-1]`` (a uniform index, the reference's ``_guarded``)."""

    first: torch.Tensor        # (1,) int64
    u: torch.Tensor            # (k-1,) fp32 in [0, 1)
    fallback: torch.Tensor     # (k-1,) int64 in [0, n)

    @classmethod
    def sample(cls, n: int, k: int, *,
               generator: Optional[torch.Generator] = None,
               device="cpu") -> "Draws":
        """All of a run's draws in three calls on the generator's device,
        moved to ``device`` once."""
        gdev = "cpu" if generator is None else generator.device
        first = torch.randint(n, (1,), generator=generator, device=gdev)
        u = torch.rand(max(k - 1, 0), generator=generator, device=gdev)
        fb = torch.randint(n, (max(k - 1, 0),), generator=generator,
                           device=gdev)
        return cls(first, u, fb).to(device)

    def to(self, device) -> "Draws":
        return Draws(self.first.to(device=device, dtype=torch.int64),
                     self.u.to(device=device, dtype=torch.float32),
                     self.fallback.to(device=device, dtype=torch.int64))


def _search(cdf: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """First index with cdf[idx] > r (searchsorted, side='right'), clipped
    to the array; r is 0-d, the result (1,) int64."""
    idx = torch.searchsorted(cdf, r.reshape(1).to(cdf.dtype), right=True)
    return idx.clamp(0, cdf.shape[0] - 1)


def index_from_uniform(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Map u in [0, 1) to the idx with cumsum[idx-1] <= u * total <
    cumsum[idx] (the deterministic half of inverse-CDF sampling)."""
    cdf = torch.cumsum(weights, 0)
    return _search(cdf, u * cdf[-1])


def tile_window(weights: torch.Tensor, t: torch.Tensor,
                block_n: int) -> torch.Tensor:
    """The (block_n,) weight slice of tile t (zero past the last row) — the
    only O(block_n) read a two-level draw performs. ``t`` is a (1,) device
    index, gathered without a host sync."""
    n = weights.shape[0]
    rows = t * block_n + torch.arange(block_n, device=weights.device)
    win = weights[rows.clamp(max=n - 1)]
    return torch.where(rows < n, win, torch.zeros((), dtype=weights.dtype,
                                                   device=weights.device))


def tiled_index_from_uniform(u: torch.Tensor, weights: torch.Tensor,
                             partials: torch.Tensor, *,
                             block_n: int) -> torch.Tensor:
    """Two-level inverse-CDF: tile t via the n_tiles partial sums, then the
    offset inside tile t via a (block_n,)-slice of ``weights``; the level-2
    residual reuses the same uniform, which conditional on tile t is uniform
    on the tile's mass, so the composite is an exact draw."""
    n = weights.shape[0]
    tcdf = torch.cumsum(partials, 0)
    r = u.to(tcdf.dtype) * tcdf[-1]
    t = _search(tcdf, r)
    prev = tcdf[(t - 1).clamp(min=0)]
    r_local = r - torch.where(t > 0, prev, torch.zeros_like(prev))

    lcdf = torch.cumsum(tile_window(weights, t, block_n), 0)
    li = torch.searchsorted(lcdf, r_local, right=True).clamp(0, block_n - 1)
    # fp-underflow guard: level 1 can land on a tile whose window re-sums to
    # zero/non-finite although partials[t] > 0 (the partial came from the
    # kernel's own reduction tree). Fall back to a uniform offset within the
    # tile; conditional on t the residual r_local / partials[t] is uniform
    # on [0, 1), so the fallback costs no extra uniform.
    wtot = lcdf[block_n - 1]
    tiny = torch.finfo(tcdf.dtype).tiny
    frac = (r_local / partials[t].clamp_min(tiny)).clamp(0.0, 1.0)
    li_fb = (frac * block_n).to(torch.int64).clamp(max=block_n - 1)
    li = torch.where(torch.isfinite(wtot) & (wtot > 0), li, li_fb)
    return (t * block_n + li).clamp(max=n - 1)


def categorical_cdf(u: torch.Tensor, fallback: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw, idx with cumsum[idx-1] <= u·total < cumsum[idx].
    All-zero / non-finite weight mass takes the fallback index."""
    cdf = torch.cumsum(weights, 0)
    return _guarded(_search(cdf, u * cdf[-1]), fallback, cdf[-1])


def categorical_tiled(u: torch.Tensor, fallback: torch.Tensor,
                      weights: torch.Tensor, partials: torch.Tensor, *,
                      block_n: int) -> torch.Tensor:
    """Two-level tiled draw (see `tiled_index_from_uniform`). The degenerate
    guard reads only the n_tiles partials, keeping the draw sub-O(n)."""
    idx = tiled_index_from_uniform(u, weights, partials, block_n=block_n)
    return _guarded(idx, fallback, partials.sum())


def _guarded(idx: torch.Tensor, fallback: torch.Tensor,
             total: torch.Tensor) -> torch.Tensor:
    ok = torch.isfinite(total) & (total > 0)
    return torch.where(ok, idx, fallback.reshape(idx.shape).to(idx.dtype))


def tile_partials(x: torch.Tensor, block_n: int) -> torch.Tensor:
    """Per-tile sums of a (n,) array with tile height block_n (zero-padded
    tail) — the plain twin of the seeding kernel's per-tile partials."""
    pad = (-x.shape[0]) % block_n
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(-1, block_n).sum(dim=1)
