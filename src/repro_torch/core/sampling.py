"""Weighted categorical sampling for k-means++ seeding (port of
``repro.core.sampling``: the inverse-CDF samplers).

* inverse-CDF (``cdf``) — prefix sum + searchsorted over all n weights.
* two-level tiled (``tiled``) — inverse-CDF over the per-tile partial sums
  the seeding round already produced, then inside the chosen tile only:
  O(n_tiles + block_n) reads per draw, the same distribution.
* coarse-to-fine (``hier``) — super-tile -> tile -> row, the super level a
  stride of the tile CDF, so a healthy draw is bitwise the tiled one.
* rejection — truncated rejection from a stale dominating envelope, the
  proposal drawn by one of the above and accepted with probability p/q.

Every function takes its uniform ``u`` and, where the degenerate-weight
guard needs one, its fallback index as ARGUMENTS. torch cannot reproduce
JAX's threefry stream, so randomness comes from a :class:`Draws` source:
sampled from a ``torch.Generator`` by default, or injected (the parity
tests replay the reference's key schedule through it).

Indices stay on the device as (1,) int64 tensors: no draw syncs the host.

Batched problems: ``categorical_cdf``, ``categorical_tiled``, ``_guarded``,
``prefix_sum`` and ``tile_partials`` also take (B, ·) rows, one problem per
row, with ``u`` (B,) and ``fallback`` (B, 1), and return (B, 1) indices.
Row b is bitwise the 1-D call on problem b.

Every prefix sum goes through :func:`prefix_sum`, which adds in one fixed
order. A plain ``torch.cumsum`` over a long 1-D tensor on the card is a
single-pass scan whose tiles take their carry-in from whichever predecessor
has published first, so its float summation order, and with it the bits of
the cdf, may change from run to run.
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
    ``fallback[m-1]`` (a uniform index, the reference's ``_guarded``).

    The rejection sampler's schedule (None unless asked for): attempt 0 of
    round m proposes with ``u[m-1]``, attempt j >= 1 with
    ``propose_u[m-1, j-1]``; attempt j accepts with ``accept_u[m-1, j]``.
    A round whose attempts all reject takes the exact draw with
    ``exact_u[m-1]``, and with ``exact_fallback[m-1]`` when its weights
    are degenerate."""

    first: torch.Tensor        # (1,) int64
    u: torch.Tensor            # (k-1,) fp32 in [0, 1)
    fallback: torch.Tensor     # (k-1,) int64 in [0, n)
    # batched draws (``sample_batched``) carry a leading problem axis on
    # every field: first (B, 1), u and fallback (B, k-1); draws[b] is
    # problem b's
    propose_u: Optional[torch.Tensor] = None       # (k-1, A-1) fp32
    accept_u: Optional[torch.Tensor] = None        # (k-1, A) fp32
    exact_u: Optional[torch.Tensor] = None         # (k-1,) fp32
    exact_fallback: Optional[torch.Tensor] = None  # (k-1,) int64

    @property
    def max_attempts(self) -> int:
        """Rejection attempts per round the draws cover (0: none)."""
        return 0 if self.accept_u is None else self.accept_u.shape[-1]

    def __getitem__(self, b: int) -> "Draws":
        """Problem ``b`` of batched draws, as the single-problem ``Draws``."""
        return Draws(*(None if t is None else t[b] for t in (
            getattr(self, f.name) for f in dataclasses.fields(self))))

    @classmethod
    def sample(cls, n: int, k: int, *,
               generator: Optional[torch.Generator] = None,
               device="cpu", max_attempts: int = 0) -> "Draws":
        """All of a run's draws from ``generator`` on its device, moved to
        ``device`` once. ``max_attempts`` > 0 adds the rejection schedule
        for that many attempts per round; the first three draws are the
        same either way, so a run's cdf/tiled draws do not depend on it."""
        gdev = "cpu" if generator is None else generator.device
        r = max(k - 1, 0)
        first = torch.randint(n, (1,), generator=generator, device=gdev)
        u = torch.rand(r, generator=generator, device=gdev)
        fb = torch.randint(n, (r,), generator=generator, device=gdev)
        rej = {}
        if max_attempts > 0:
            rej = dict(
                propose_u=torch.rand((r, max_attempts - 1),
                                     generator=generator, device=gdev),
                accept_u=torch.rand((r, max_attempts), generator=generator,
                                    device=gdev),
                exact_u=torch.rand(r, generator=generator, device=gdev),
                exact_fallback=torch.randint(n, (r,), generator=generator,
                                             device=gdev))
        return cls(first, u, fb, **rej).to(device)

    @classmethod
    def sample_batched(cls, batch: int, n: int, k: int, *,
                       generator: Optional[torch.Generator] = None,
                       device="cpu") -> "Draws":
        """Draws for ``batch`` problems: problem b's are the ``sample(n, k)``
        the generator gives after b earlier problems' draws, so a loop of
        single runs fed ``draws[b]`` repeats the batched run problem by
        problem."""
        runs = [cls.sample(n, k, generator=generator) for _ in range(batch)]
        return Draws(*(torch.stack(ts) for ts in zip(
            *((r.first, r.u, r.fallback) for r in runs)))).to(device)

    def to(self, device) -> "Draws":
        def mv(t, dtype):
            return None if t is None else t.to(device=device, dtype=dtype)
        return Draws(mv(self.first, torch.int64), mv(self.u, torch.float32),
                     mv(self.fallback, torch.int64),
                     mv(self.propose_u, torch.float32),
                     mv(self.accept_u, torch.float32),
                     mv(self.exact_u, torch.float32),
                     mv(self.exact_fallback, torch.int64))


def _search(cdf: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """First index with cdf[idx] > r (searchsorted, side='right'), clipped
    to the array; r is 0-d, the result (1,) int64 (batched: cdf (B, n), r
    (B,), the result (B, 1))."""
    idx = torch.searchsorted(cdf, r.reshape(cdf.shape[:-1] + (1,))
                             .to(cdf.dtype), right=True)
    return idx.clamp(0, cdf.shape[-1] - 1)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the last axis, row by row when batched."""
    return torch.take_along_dim(x, idx, dim=-1)


SCAN_BLOCK = 128   # length of prefix_sum's sequential row scans


def _row_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of each row of a 2-D tensor, each row added left to
    right, as a (possibly strided) view. It runs as ``torch.cumsum`` along
    dim 0 of the transposed rows, a scan that gives each column to one
    thread adding its entries in order, so a row's bits depend on the row
    alone. (Along dim 1 the card picks a per-row thread layout from the
    tensor's shape, and a tensor with one column would go to the
    single-pass 1-D scan, whose order may change from run to run: a lone
    row is scanned beside a copy of itself.)"""
    rows, width = x.shape
    cols = x.t() if rows > 1 else x.reshape(width, 1).expand(width, 2)
    return torch.cumsum(cols.contiguous(), 0).t()[:rows]


def prefix_sum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis in a fixed order: a
    sequential scan inside each ``SCAN_BLOCK``-wide row, a prefix sum over
    the row totals (by the same rule), then each row's offset added to its
    entries. The same inputs give the same bits on every run, on the CPU
    and on the card.

    Leading axes are independent problems, each padded and scanned on its
    own, and no scan's order depends on how many rows it is given, so row b
    of a (B, n) call is bitwise the 1-D call on w[b] (``chip_smoke.py``
    phase 0 checks it on the card)."""
    return _prefix_sum(w).contiguous()


def _prefix_sum(w: torch.Tensor) -> torch.Tensor:
    n = w.shape[-1]
    lead = w.shape[:-1]
    if n <= SCAN_BLOCK:
        return _row_scan(w.reshape(-1, n)).reshape(w.shape)
    pad = (-n) % SCAN_BLOCK
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    local = _row_scan(w.reshape(-1, SCAN_BLOCK)).reshape(
        lead + (-1, SCAN_BLOCK))
    tot = _prefix_sum(local[..., -1])
    # row r's entries plus the rows before it, written in row order
    out = torch.empty(local.shape, dtype=local.dtype, device=local.device)
    out[..., 0, :] = local[..., 0, :]
    torch.add(local[..., 1:, :], tot[..., :-1, None], out=out[..., 1:, :])
    return out.reshape(lead + (-1,))[..., :n]


def fixed_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in a fixed order: the entries added in ascending
    order within each ``SCAN_BLOCK``-long block (the last entry of
    :func:`_row_scan`), then the block totals by the same rule. The order
    depends on the length of ``dim`` only, never on the other axes, so a
    batched problem's sum is bitwise the single problem's on every device
    (a torch reduction may split a 1-D sum across blocks and a batch of
    rows not)."""
    x = x.movedim(dim, -1)
    lead, n = x.shape[:-1], x.shape[-1]
    if n > SCAN_BLOCK and n % SCAN_BLOCK:
        x = torch.nn.functional.pad(x, (0, SCAN_BLOCK - n % SCAN_BLOCK))
    width = min(n, SCAN_BLOCK)
    tot = _row_scan(x.reshape(-1, width))[:, -1].reshape(lead + (-1,))
    return tot[..., 0] if tot.shape[-1] == 1 else fixed_sum(tot)


def index_from_uniform(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Map u in [0, 1) to the idx with cdf[idx-1] <= u * total < cdf[idx]
    (the deterministic half of inverse-CDF sampling); the total is the
    prefix sum's own last entry, as in the reference."""
    cdf = prefix_sum(weights)
    return _search(cdf, u * cdf[..., -1])


def tile_window(weights: torch.Tensor, t: torch.Tensor,
                block_n: int) -> torch.Tensor:
    """The (block_n,) weight slice of tile t (zero past the last row) — the
    only O(block_n) read a two-level draw performs. ``t`` is a (1,) device
    index (batched: (B, 1), one window per row), gathered without a host
    sync."""
    n = weights.shape[-1]
    rows = t * block_n + torch.arange(block_n, device=weights.device)
    win = _gather(weights, rows.clamp(max=n - 1))
    return torch.where(rows < n, win, torch.zeros((), dtype=weights.dtype,
                                                   device=weights.device))


def tiled_index_from_uniform(u: torch.Tensor, weights: torch.Tensor,
                             partials: torch.Tensor, *,
                             block_n: int) -> torch.Tensor:
    """Two-level inverse-CDF: tile t via the n_tiles partial sums, then the
    offset inside tile t via a (block_n,)-slice of ``weights``; the level-2
    residual reuses the same uniform, which conditional on tile t is uniform
    on the tile's mass, so the composite is an exact draw."""
    n = weights.shape[-1]
    tcdf = prefix_sum(partials)
    r = u.to(tcdf.dtype) * tcdf[..., -1]
    t = _search(tcdf, r)
    prev = _gather(tcdf, (t - 1).clamp(min=0))
    r_local = r[..., None] - torch.where(t > 0, prev, torch.zeros_like(prev))

    lcdf = prefix_sum(tile_window(weights, t, block_n))
    return _row_in_tile(lcdf, r_local, r_local, _gather(partials, t), t,
                        block_n=block_n, n=n)


def _row_in_tile(lcdf: torch.Tensor, r2: torch.Tensor, r_local: torch.Tensor,
                 part_t: torch.Tensor, t: torch.Tensor, *, block_n: int,
                 n: int) -> torch.Tensor:
    """Level 2 of a tiled draw: the row of tile t where the window's prefix
    sum ``lcdf`` first exceeds ``r2``.

    fp-underflow guard: level 1 can land on a tile whose window re-sums to
    zero/non-finite although ``part_t`` > 0 (the partial came from the
    kernel's own reduction tree). Fall back to a uniform offset within the
    tile; conditional on t the residual r_local / part_t is uniform on
    [0, 1), so the fallback costs no extra uniform."""
    li = torch.searchsorted(lcdf, r2, right=True).clamp(0, block_n - 1)
    wtot = lcdf[..., block_n - 1:block_n]
    tiny = torch.finfo(lcdf.dtype).tiny
    frac = (r_local / part_t.clamp_min(tiny)).clamp(0.0, 1.0)
    li_fb = (frac * block_n).to(torch.int64).clamp(max=block_n - 1)
    li = torch.where(torch.isfinite(wtot) & (wtot > 0), li, li_fb)
    return (t * block_n + li).clamp(max=n - 1)


def categorical_cdf(u: torch.Tensor, fallback: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw, idx with cdf[idx-1] <= u·total < cdf[idx].
    All-zero / non-finite weight mass takes the fallback index."""
    cdf = prefix_sum(weights)
    return _guarded(_search(cdf, u * cdf[..., -1]), fallback, cdf[..., -1])


def categorical_tiled(u: torch.Tensor, fallback: torch.Tensor,
                      weights: torch.Tensor, partials: torch.Tensor, *,
                      block_n: int) -> torch.Tensor:
    """Two-level tiled draw (see `tiled_index_from_uniform`). The degenerate
    guard reads only the n_tiles partials, keeping the draw sub-O(n)."""
    idx = tiled_index_from_uniform(u, weights, partials, block_n=block_n)
    return _guarded(idx, fallback, partials.sum(-1))


def super_cdf(tcdf: torch.Tensor, tps: int) -> torch.Tensor:
    """(n_super,) coarse-level CDF of the super -> tile -> row draw: the tile
    CDF GATHERED at each super's last tile, not a re-sum of the partials,
    so every boundary is bitwise a tile-CDF prefix (``scdf[-1] ==
    tcdf[-1]``) and the two-level search telescopes to the flat one."""
    n_tiles = tcdf.shape[0]
    n_super = -(-n_tiles // tps)
    ends = (torch.arange(n_super, device=tcdf.device) + 1) * tps - 1
    return tcdf[ends.clamp(max=n_tiles - 1)]


def hier_index_from_uniform(u: torch.Tensor, weights: torch.Tensor,
                            partials: torch.Tensor, tcdf: torch.Tensor,
                            scdf: torch.Tensor, *, block_n: int, tps: int,
                            cap: Optional[torch.Tensor] = None,
                            tight: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Coarse-to-fine three-level inverse CDF: super s via the gathered
    boundaries ``scdf`` (from :func:`super_cdf` of ``tcdf``, the prefix sum
    of ``partials``), tile t via the chosen super's (tps,) window of
    ``tcdf`` searched with the ABSOLUTE r (so t is the flat draw's tile),
    then the row inside t as in :func:`tiled_index_from_uniform`.

    ``cap``/``tight`` (the movement-tightened envelope) switch the row level
    of a tile with ``tight[t]`` to a capped window: rows drawn ∝
    ``min(weights_i, cap_t)``, the residual rescaled through the tightened
    tile mass ``partials[t]``. Untightened tiles run the flat row level
    bitwise.

    Super-level degenerate guard: a zero or non-finite coarse mass
    telescopes the one uniform through uniform super -> tile -> row picks
    instead of letting a clipped search steer the draw."""
    n = weights.shape[0]
    n_tiles = partials.shape[0]
    n_super = scdf.shape[0]
    stot = scdf[n_super - 1]                # == tcdf[-1] bitwise
    uf = u.to(tcdf.dtype)
    r = uf * stot
    s = _search(scdf, r)
    # the super's window of the tile CDF, +inf past the last tile so a pad
    # never wins a right-search against a finite r
    wid = s * tps + torch.arange(tps, device=tcdf.device)
    twin = torch.where(wid < n_tiles, tcdf[wid.clamp(max=n_tiles - 1)],
                       torch.inf)
    t = (s * tps + torch.searchsorted(twin, r.reshape(1), right=True)
         ).clamp(0, n_tiles - 1)
    prev = tcdf[(t - 1).clamp(min=0)]
    r_local = r - torch.where(t > 0, prev, torch.zeros_like(prev))

    win = tile_window(weights, t, block_n)
    ph_t = partials[t]
    use, r2 = win, r_local
    if cap is not None:
        cw, tight_t = cap[t], tight[t]
        # where-form: a NaN cap loses the comparison, leaving the window
        use = torch.where(tight_t, torch.where(cw < win, cw, win), win)
    lcdf = prefix_sum(use)
    if cap is not None:
        tiny = torch.finfo(tcdf.dtype).tiny
        r2 = torch.where(tight_t,
                         (r_local / ph_t.clamp_min(tiny)) * lcdf[block_n - 1],
                         r_local)
    idx = _row_in_tile(lcdf, r2, r_local, ph_t, t, block_n=block_n, n=n)

    # super-level guard: uniform super -> tile -> row from the one uniform
    us = uf * n_super
    s_fb = us.to(torch.int64).clamp(max=n_super - 1)
    ut = (us - s_fb) * tps
    t_fb = (s_fb * tps + ut.to(torch.int64)).clamp(max=n_tiles - 1)
    ur = (ut - torch.floor(ut)) * block_n
    idx_fb = (t_fb * block_n + ur.to(torch.int64).clamp(max=block_n - 1)
              ).clamp(max=n - 1)
    sok = torch.isfinite(stot) & (stot > 0)
    return torch.where(sok, idx, idx_fb.reshape(idx.shape))


def categorical_hier(u: torch.Tensor, fallback: torch.Tensor,
                     weights: torch.Tensor, partials: torch.Tensor, *,
                     block_n: int, tps: int) -> torch.Tensor:
    """Coarse-to-fine guarded draw (see :func:`hier_index_from_uniform`):
    the same uniform and degenerate discipline as :func:`categorical_tiled`,
    so a healthy draw is bitwise the tiled one."""
    tcdf = prefix_sum(partials)
    idx = hier_index_from_uniform(u, weights, partials, tcdf,
                                  super_cdf(tcdf, tps), block_n=block_n,
                                  tps=tps)
    return _guarded(idx, fallback, partials.sum())


def rejection_sample(propose_fn, pq_fn, propose_u: torch.Tensor,
                     accept_u: torch.Tensor, *, max_attempts: int,
                     valid: bool = True):
    """Truncated rejection draw from a target p via a dominating envelope q.

    ``propose_fn(u) -> idx`` draws an index from the envelope with uniform
    ``u``; ``pq_fn(idx) -> (p, q)`` returns the drawn row's exact weight and
    its envelope weight (exactness needs 0 <= p <= q). Attempt j proposes
    with ``propose_u[j]`` and accepts iff ``accept_u[j] * q < p`` — the
    strict test, so p = q = 0 rejects. One host sync per attempt reads the
    accept bit. Returns ``(idx, accepted, attempts)``; when no attempt
    accepts the caller MUST take an exact draw with independent uniforms
    (the truncated mixture stays exactly p). ``valid`` False skips the
    attempts outright (``attempts == 0``)."""
    idx = None
    if not valid:
        return idx, False, 0
    for j in range(max_attempts):
        idx = propose_fn(propose_u[j])
        p, q = pq_fn(idx)
        if bool(accept_u[j] * q < p):
            return idx, True, j + 1
    return idx, False, max_attempts


def _guarded(idx: torch.Tensor, fallback: torch.Tensor,
             total: torch.Tensor) -> torch.Tensor:
    """``idx`` where the weight mass ``total`` is finite and positive, else
    the fallback index. Only the sign and finiteness of ``total`` matter,
    which no summation order changes for non-negative weights (short of an
    overflow within rounding of the fp32 maximum)."""
    ok = (torch.isfinite(total) & (total > 0))[..., None]
    return torch.where(ok, idx, fallback.reshape(idx.shape).to(idx.dtype))


def tile_partials(x: torch.Tensor, block_n: int) -> torch.Tensor:
    """Per-tile sums along the last axis of a (..., n) array with tile
    height block_n (zero-padded tail) — the plain twin of the seeding
    kernel's per-tile partials."""
    lead = x.shape[:-1]
    pad = (-x.shape[-1]) % block_n
    if pad:
        x = torch.cat([x, x.new_zeros(lead + (pad,))], -1)
    return x.reshape(lead + (-1, block_n)).sum(dim=-1)
