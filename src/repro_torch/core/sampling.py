"""Weighted categorical sampling for k-means++ seeding (port of
``repro.core.sampling``).

* inverse-CDF (``cdf``) — prefix sum + searchsorted over all n weights.
* Gumbel-max (``gumbel``) — argmax(log w + Gumbel noise): no prefix sum;
  ``gumbel_topk`` draws k indices without replacement (k-means||).
* two-level tiled (``tiled``) — inverse-CDF over the per-tile partial sums
  the seeding round already produced, then inside the chosen tile only:
  O(n_tiles + block_n) reads per draw, the same distribution.
* coarse-to-fine (``hier``) — super-tile -> tile -> row, the super level a
  stride of the tile CDF, so a healthy draw is bitwise the tiled one.
* rejection — truncated rejection from a stale dominating envelope, the
  proposal drawn by one of the above and accepted with probability p/q.

Every function takes its uniform ``u`` (the Gumbel draws: their noise)
and, where the degenerate-weight guard needs one, its fallback index as
ARGUMENTS. torch cannot reproduce JAX's threefry stream, so randomness
comes from a :class:`Draws` source: sampled from a ``torch.Generator`` by
default, or injected (the parity tests replay the reference's key schedule
through it).

Indices stay on the device as (1,) int64 tensors: no draw syncs the host.

Many draws from one distribution: ``tiled_index_from_uniform`` and
``hier_index_from_uniform`` also take (A,) uniforms against 1-D weights
and return (A, 1) indices, row a bitwise the call on ``u[a]`` (the
rejection sampler proposes every attempt of a round at once).

Batched problems: ``categorical_cdf``, ``categorical_tiled``,
``categorical_hier``, ``_guarded``, ``prefix_sum``, ``super_cdf`` and
``tile_partials`` also take (B, ·) rows, one problem per row, with ``u``
(B,) and ``fallback`` (B, 1), and return (B, 1) indices; the many-draw
forms of ``tiled_index_from_uniform`` and ``hier_index_from_uniform`` take
(B, A) uniforms against (B, ·) rows and return (B, A, 1) indices, and
``rejection_sample`` draws for B problems at once (batched rejection
seeding). Row b is bitwise the 1-D call on problem b.

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
    are degenerate.

    A weighted run draws its first seed by the point weights with
    ``first_u`` in [0, 1), and takes ``first_fallback`` when the weights
    are degenerate (None unless asked for; batched draws leave them None,
    as batched problems take no weights).

    A Gumbel run (``sampler="gumbel"``) draws round m from (n,) Gumbel
    noise: ``gumbel[m-1]`` when injected (the parity tests fill it with the
    reference's ``jax.random.gumbel`` output), else the noise
    :func:`gumbel_noise` makes on the run's device from the seed
    ``gumbel_seed[m-1]``, so a run carries k-1 integers where the noise
    would take (k-1)·n floats, and a replayed or resumed run makes the same
    bits."""

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
    first_u: Optional[torch.Tensor] = None         # (1,) fp32
    first_fallback: Optional[torch.Tensor] = None  # (1,) int64
    gumbel_seed: Optional[torch.Tensor] = None     # (k-1,) int64
    gumbel: Optional[torch.Tensor] = None          # (k-1, n) fp32

    @property
    def max_attempts(self) -> int:
        """Rejection attempts per round the draws cover (0: none)."""
        return 0 if self.accept_u is None else self.accept_u.shape[-1]

    def __getitem__(self, b: int) -> "Draws":
        """Problem ``b`` of batched draws, as the single-problem ``Draws``."""
        return Draws(*(None if t is None else t[b] for t in (
            getattr(self, f.name) for f in dataclasses.fields(self))))

    def gumbel_round(self, m: int, n: int, device) -> torch.Tensor:
        """Round m's (n,) Gumbel noise on ``device`` ((B, n) for batched
        draws, row b problem b's): the injected ``gumbel[..., m-1, :]``, or
        made from ``gumbel_seed[..., m-1]``."""
        if self.gumbel is not None:
            return self.gumbel[..., m - 1, :]
        if self.gumbel_seed is None:
            raise ValueError("draws hold no Gumbel noise; sample them with "
                             "Draws.sample(..., gumbel=True)")
        return gumbel_noise(self.gumbel_seed[..., m - 1], n, device)

    @classmethod
    def sample(cls, n: int, k: int, *,
               generator: Optional[torch.Generator] = None,
               device="cpu", max_attempts: int = 0,
               weighted: bool = False, gumbel: bool = False) -> "Draws":
        """All of a run's draws from ``generator`` on its device, moved to
        ``device`` once. ``max_attempts`` > 0 adds the rejection schedule
        for that many attempts per round; the first three draws are the
        same either way, so a run's cdf/tiled draws do not depend on it.
        ``weighted`` adds the weighted first seed's two draws after all the
        others, so the rest do not depend on it either; ``gumbel`` adds the
        per-round noise seeds after those."""
        gdev = "cpu" if generator is None else generator.device
        r = max(k - 1, 0)
        first = torch.randint(n, (1,), generator=generator, device=gdev)
        u = torch.rand(r, generator=generator, device=gdev)
        fb = torch.randint(n, (r,), generator=generator, device=gdev)
        extra = {}
        if max_attempts > 0:
            extra = dict(
                propose_u=torch.rand((r, max_attempts - 1),
                                     generator=generator, device=gdev),
                accept_u=torch.rand((r, max_attempts), generator=generator,
                                    device=gdev),
                exact_u=torch.rand(r, generator=generator, device=gdev),
                exact_fallback=torch.randint(n, (r,), generator=generator,
                                             device=gdev))
        if weighted:
            extra.update(first_u=torch.rand(1, generator=generator,
                                          device=gdev),
                       first_fallback=torch.randint(
                           n, (1,), generator=generator, device=gdev))
        if gumbel:
            extra["gumbel_seed"] = torch.randint(
                2 ** 62, (r,), generator=generator, device=gdev)
        return cls(first, u, fb, **extra).to(device)

    @classmethod
    def sample_batched(cls, batch: int, n: int, k: int, *,
                       generator: Optional[torch.Generator] = None,
                       device="cpu", max_attempts: int = 0,
                       gumbel: bool = False) -> "Draws":
        """Draws for ``batch`` problems: problem b's are the ``sample(n, k,
        max_attempts=max_attempts, gumbel=gumbel)`` the generator gives
        after b earlier problems' draws, so a loop of single runs fed
        ``draws[b]`` repeats the batched run problem by problem."""
        runs = [cls.sample(n, k, generator=generator,
                           max_attempts=max_attempts, gumbel=gumbel)
                for _ in range(batch)]
        return Draws(*(None if ts[0] is None else torch.stack(ts)
                       for ts in zip(*(dataclasses.astuple(r)
                                       for r in runs)))).to(device)

    def to(self, device) -> "Draws":
        """The draws on ``device``."""
        def mv(t, dtype):
            return None if t is None else t.to(device=device, dtype=dtype)
        return Draws(mv(self.first, torch.int64), mv(self.u, torch.float32),
                     mv(self.fallback, torch.int64),
                     mv(self.propose_u, torch.float32),
                     mv(self.accept_u, torch.float32),
                     mv(self.exact_u, torch.float32),
                     mv(self.exact_fallback, torch.int64),
                     mv(self.first_u, torch.float32),
                     mv(self.first_fallback, torch.int64),
                     mv(self.gumbel_seed, torch.int64),
                     mv(self.gumbel, torch.float32))


# ---------------------------------------------------------------------------
# Gumbel-max
# ---------------------------------------------------------------------------


def safe_log(w: torch.Tensor) -> torch.Tensor:
    """log(w) with log(0) -> -inf (zero-weight entries can never be
    sampled)."""
    pos = w > 0
    return torch.where(pos, torch.log(torch.where(pos, w, 1.0)), -torch.inf)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise −log(−log(u)) from uniforms in [0, 1), each
    clamped up to the smallest normal fp32 (``jax.random.gumbel``'s
    interval)."""
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche hash (shift-xor-multiply, multipliers 0x21f0aaad
    and 0x735a2d97) of int64 values in [0, 2^32): both multipliers are
    below 2^31, so no product leaves int64 and every device gives the same
    bits."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def gumbel_noise(seeds: torch.Tensor, n: int, device) -> torch.Tensor:
    """(n,) fp32 Gumbel noise on ``device`` from one int64 seed ((B, n)
    from (B,) seeds, in one pass over all rows; row b the noise of seed b
    alone). Counter-based: entry i is a hash of i keyed by the seed, its
    top 24 bits the uniform, so the same seed gives the same bits on every
    run, and the same uniforms on every device."""
    s = seeds.reshape(-1, 1).to(device=device, dtype=torch.int64)
    key = _mix32((s & _M32) ^ _mix32(s >> 32))
    x = _mix32(_mix32(torch.arange(n, device=device)) ^ key)
    u = (x >> 8).to(torch.float32) * 2.0 ** -24
    return gumbel_from_uniform(u).reshape(tuple(seeds.shape) + (n,))


def gumbel_max(noise: torch.Tensor, log_weights: torch.Tensor) -> torch.Tensor:
    """argmax(log w + noise) along the last axis, the first index on a tie
    (``jnp.argmax``'s); (1,) int64, (B, 1) batched."""
    return (log_weights + noise).argmax(dim=-1, keepdim=True)


def gumbel_topk(noise: torch.Tensor, log_weights: torch.Tensor,
                k: int) -> torch.Tensor:
    """Exact weighted sampling of k indices WITHOUT replacement (Gumbel
    top-k): the k largest scores log w + noise, in ``lax.top_k``'s order —
    descending score, ties by the lower index — which a stable descending
    sort gives (``torch.topk`` orders ties otherwise, and the order sets
    which candidate k-means|| keeps). (k,) int64."""
    n = log_weights.shape[-1]
    if k > n:
        raise ValueError(f"gumbel_topk needs k <= n, got k={k}, n={n}")
    scores = log_weights + noise
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def gumbel_categorical(noise: torch.Tensor, fallback: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """One guarded draw ∝ ``weights`` from the (n,) Gumbel ``noise``: the
    :func:`gumbel_max` of the weights' :func:`safe_log`, guarded by the
    largest weight, the cheapest witness of positive mass (all-zero weights
    make every score -inf). Batched (B, n) weights take (B, n) noise and
    (B, 1) fallbacks."""
    return _guarded(gumbel_max(noise, safe_log(weights)), fallback,
                    weights.amax(dim=-1))


# ---------------------------------------------------------------------------
# inverse-CDF: global, tiled and coarse-to-fine
# ---------------------------------------------------------------------------


def _search(cdf: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """First index with cdf[idx] > r (searchsorted, side='right'), clipped
    to the array; r is 0-d, the result (1,) int64 (batched: cdf (B, n), r
    (B,), the result (B, 1); one cdf, many draws: r (A,), the result
    (A, 1); batched, many draws: r (B, A), the result (B, A, 1))."""
    if cdf.dim() > 1 and r.dim() >= cdf.dim():
        # each draw searches its own problem's cdf
        lead = cdf.shape[:-1]
        seq = cdf.reshape(lead + (1,) * (r.dim() - len(lead))
                          + cdf.shape[-1:]).expand(r.shape + cdf.shape[-1:])
        idx = torch.searchsorted(seq.contiguous(),
                                 r[..., None].to(cdf.dtype), right=True)
        return idx.clamp(0, cdf.shape[-1] - 1)
    lead = cdf.shape[:-1] if cdf.dim() > 1 else r.shape
    idx = torch.searchsorted(cdf, r.reshape(lead + (1,)).to(cdf.dtype),
                             right=True)
    return idx.clamp(0, cdf.shape[-1] - 1)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the last axis, row by row when batched (1-D ``x``:
    any shape of ``idx``; (B, ·) ``x`` with (B, A, ·) ``idx``: each draw's
    own problem's row)."""
    if x.dim() == 1:
        return x[idx]
    if idx.dim() > x.dim():
        x = x.reshape(x.shape[:-1] + (1,) * (idx.dim() - x.dim())
                      + x.shape[-1:])
    return torch.take_along_dim(x, idx, dim=-1)


def _per_problem(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-problem value ``x`` (0-d, or (B,)) shaped to broadcast against
    ``like``, whose leading axes are the problems'."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


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
    and on the card, each device its own (the CPU's ``cumsum`` adds fp32 in
    double precision, the card's in fp32).

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


def prefix_last(w: torch.Tensor) -> torch.Tensor:
    """``prefix_sum(w)[..., -1:]`` bitwise — the same row scans and the same
    last add — without writing the rest of the scan out."""
    n = w.shape[-1]
    lead = w.shape[:-1]
    if n <= SCAN_BLOCK:
        return _row_scan(w.reshape(-1, n))[:, -1:].reshape(lead + (1,))
    pad = (-n) % SCAN_BLOCK
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
    local = _row_scan(w.reshape(-1, SCAN_BLOCK))
    blocks = w.shape[-1] // SCAN_BLOCK
    tot = _prefix_sum(local[:, -1].reshape(lead + (blocks,)))
    last = local[blocks - 1::blocks, (n - 1) % SCAN_BLOCK].reshape(lead)
    return torch.add(last, tot[..., -2])[..., None]


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


def segment_sum(values: torch.Tensor, segments: torch.Tensor,
                k: int) -> torch.Tensor:
    """(k, c) sums of the rows of ``values`` (n, c) in each of k segments
    (``segments`` (n,) in [0, k)), in a fixed order: segment s's rows, in
    row order, added as :func:`fixed_sum` adds them (128-row blocks, then
    the block totals by the same rule), so the bits depend on that
    segment's rows alone. A stable sort by segment lays each segment's rows
    out contiguously; every segment is cut into 128-row chunks (zero
    padded), each chunk is scanned, and the chunk totals, again grouped by
    segment, go round the same way until every segment is one chunk. No
    float atomics, so the same inputs give the same bits on every run."""
    seg = segments.long()
    order = torch.argsort(seg, stable=True)
    vals, seg = values.float()[order], seg[order]
    c = vals.shape[1]
    while True:
        counts = torch.bincount(seg, minlength=k)
        chunks = (counts + SCAN_BLOCK - 1) // SCAN_BLOCK
        start = torch.cumsum(counts, 0) - counts
        first_chunk = torch.cumsum(chunks, 0) - chunks
        pos = torch.arange(seg.shape[0], device=seg.device) - start[seg]
        n_chunks = int(chunks.sum())
        blocks = vals.new_zeros((n_chunks, SCAN_BLOCK, c))
        blocks[first_chunk[seg] + pos // SCAN_BLOCK, pos % SCAN_BLOCK] = vals
        tot = _row_scan(blocks.transpose(1, 2).reshape(-1, SCAN_BLOCK))[
            :, -1].reshape(n_chunks, c)
        chunk_seg = torch.repeat_interleave(
            torch.arange(k, device=seg.device), chunks)
        if n_chunks == int((chunks > 0).sum()):   # one chunk per segment
            return vals.new_zeros((k, c)).index_copy_(0, chunk_seg, tot)
        vals, seg = tot, chunk_seg


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
    index in [0, n_tiles) (batched, or many draws from 1-D weights: (B, 1),
    one window per row; batched, many draws: (B, A, 1)), gathered without a
    host sync. Where the tiles are whole, each window is one row of the
    (..., n_tiles, block_n) view, gathered as is."""
    n = weights.shape[-1]
    if n % block_n == 0:
        tiles = weights.reshape(weights.shape[:-1] + (n // block_n, block_n))
        if weights.dim() == 1:
            return tiles[t][..., 0, :]
        tiles = tiles.reshape(weights.shape[:-1] + (1,) * (t.dim() - 2)
                              + tiles.shape[-2:])
        return torch.take_along_dim(tiles, t[..., None], dim=-2)[..., 0, :]
    rows = t * block_n + torch.arange(block_n, device=weights.device)
    win = gather(weights, rows.clamp(max=n - 1))
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
    r = u.to(tcdf.dtype) * _per_problem(tcdf[..., -1], u)
    t = _search(tcdf, r)
    prev = gather(tcdf, (t - 1).clamp(min=0))
    r_local = r[..., None] - torch.where(t > 0, prev, torch.zeros_like(prev))

    lcdf = prefix_sum(tile_window(weights, t, block_n))
    return _row_in_tile(lcdf, r_local, r_local, gather(partials, t), t,
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
    n_tiles = tcdf.shape[-1]
    n_super = -(-n_tiles // tps)
    ends = (torch.arange(n_super, device=tcdf.device) + 1) * tps - 1
    return tcdf[..., ends.clamp(max=n_tiles - 1)]


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

    ``u`` may be (A,): A draws from these weights, (A, 1) indices, row a
    bitwise the call on ``u[a]``. Batched: (B, ·) weights, partials, cdfs,
    caps and tight masks with ``u`` (B,) ((B, 1) indices) or (B, A)
    ((B, A, 1)), row b bitwise the call on problem b.

    Super-level degenerate guard: a zero or non-finite coarse mass
    telescopes the one uniform through uniform super -> tile -> row picks
    instead of letting a clipped search steer the draw."""
    n = weights.shape[-1]
    n_tiles = partials.shape[-1]
    n_super = scdf.shape[-1]
    stot = scdf[..., n_super - 1]           # == tcdf[-1] bitwise
    uf = u.to(tcdf.dtype)
    r = uf * _per_problem(stot, uf)
    s = _search(scdf, r)
    # the super's window of the tile CDF, +inf past the last tile so a pad
    # never wins a right-search against a finite r
    wid = s * tps + torch.arange(tps, device=tcdf.device)
    twin = torch.where(wid < n_tiles,
                       gather(tcdf, wid.clamp(max=n_tiles - 1)), torch.inf)
    t = (s * tps + torch.searchsorted(twin, r.reshape(s.shape), right=True)
         ).clamp(0, n_tiles - 1)
    prev = gather(tcdf, (t - 1).clamp(min=0))
    r_local = r.reshape(t.shape) - torch.where(t > 0, prev,
                                               torch.zeros_like(prev))

    win = tile_window(weights, t, block_n)
    ph_t = gather(partials, t)
    use, r2 = win, r_local
    if cap is not None:
        cw, tight_t = gather(cap, t), gather(tight, t)
        # where-form: a NaN cap loses the comparison, leaving the window
        use = torch.where(tight_t, torch.where(cw < win, cw, win), win)
    lcdf = prefix_sum(use)
    if cap is not None:
        tiny = torch.finfo(tcdf.dtype).tiny
        r2 = torch.where(tight_t, (r_local / ph_t.clamp_min(tiny))
                         * lcdf[..., block_n - 1:block_n], r_local)
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
    return torch.where(_per_problem(sok, idx), idx, idx_fb.reshape(idx.shape))


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
    return _guarded(idx, fallback, partials.sum(-1))


def rejection_sample(propose_fn, pq_fn, propose_u: torch.Tensor,
                     accept_u: torch.Tensor, *, max_attempts: int,
                     valid: bool = True):
    """Truncated rejection draw from a target p via a dominating envelope q.

    Attempt j proposes with ``propose_u[j]`` and accepts iff ``accept_u[j]
    * q < p`` — the strict test, so p = q = 0 rejects; the draw is the
    first accepting attempt's. Nothing an attempt reads depends on an
    earlier one, so all ``max_attempts`` are computed at once:
    ``propose_fn(u) -> idx`` draws an index from the envelope for each of
    the (A,) uniforms ``u`` (entry j bitwise a draw with ``u[j]`` alone),
    and ``pq_fn(idx) -> (p, q)`` returns every drawn row's exact weight and
    its envelope weight (exactness needs 0 <= p <= q). One host sync reads
    the first accepting attempt. Returns ``(idx, accepted, attempts)``:
    the (1,) index of the first accepting attempt (the last attempt's when
    none accepts) and the attempts that took, j + 1 or ``max_attempts``;
    when no attempt accepts the caller MUST take an exact draw with
    independent uniforms (the truncated mixture stays exactly p).
    ``valid`` False skips the attempts outright (``attempts == 0``).

    B problems at once: ``propose_u`` and ``accept_u`` (B, ≥ A), indices,
    p and q (B, A); the one host sync reads the (B,) first accepting
    attempts, and the result is ((B, 1) indices, B accept flags, B attempt
    counts), row b the single call on problem b."""
    if not valid or max_attempts < 1:
        return None, False, max_attempts if valid else 0
    u = propose_u[..., :max_attempts]
    shape = u.shape
    idx = propose_fn(u).reshape(shape)
    p, q = pq_fn(idx)
    ok = accept_u[..., :max_attempts] * q.reshape(shape) < p.reshape(shape)
    order = torch.arange(max_attempts, device=ok.device)
    first = torch.where(ok, order, max_attempts).amin(-1)
    if first.dim() == 0:
        f = int(first)                                          # one sync
        j = min(f, max_attempts - 1)
        return idx[j:j + 1], f < max_attempts, min(f + 1, max_attempts)
    pick = torch.take_along_dim(idx, first.clamp(max=max_attempts - 1)[
        ..., None], dim=-1)
    fs = first.tolist()                                         # one sync
    return (pick, [f < max_attempts for f in fs],
            [min(f + 1, max_attempts) for f in fs])


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
