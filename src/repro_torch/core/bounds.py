"""Exact two-level bound state shared by the seeding and assignment rounds
(port of ``repro.core.bounds``): per-tile ball/gap bounds at the coarse
level, per-point Hamerly bounds at the fine level, and a tile -> super-tile
-> global accumulator hierarchy.

Seeding bound. A seeding round folds the new centroid(s) ``c_new`` into every
point's D². A point x can only improve when ``d(x, c) < d(x,
nearest-so-far)``, so by the triangle inequality a whole *tile* of points
provably cannot change when

    d(center_t, c) - r_t  >=  sqrt(max_{x in tile} min_d2[x])

where ``center_t`` is the tile's ball center and ``r_t`` its radius.
Skipping such a tile is *exact*: its ``min_d2`` entries, and therefore its
per-tile partial sum, are bitwise what a full recompute would produce
(``min(md, d2)`` returns ``md`` whenever ``d2 >= md``), so the tiled sampler
composes unchanged.

Assignment (Lloyd) bound. Between iterations every centroid moves by
``delta_j = ‖c_j^{t+1} − c_j^t‖``. For a point x assigned to j0 with
second-best margin ``gap(x) = d(x, c_2nd) − d(x, c_j0)``, no label can change
as long as ``gap(x) >= delta_j0 + max_j delta_j``. The tile-level state
carries ``tile_gap = min_x gap(x)``. Skipping a tile keeps the carried
assignment AND the carried ``min_d2``/per-cluster sums bitwise exact only
when the centroids the tile is assigned to did not move at all — so the gate
additionally requires ``delta_j == 0`` for every cluster the tile's carried
counts mark as occupied. A skipped tile's carried gap is decayed by that
iteration's ``max_j delta_j`` (:func:`decay_gap`), which keeps it a valid
lower bound across consecutive skips.

Per-point (fine-level) bounds. Inside a tile the coarse gate keeps ACTIVE,
most points may still be provably stable:

* ASSIGNMENT: ``ub[i] = sqrt(min_d2[i])`` is the EXACT distance to the
  assigned centroid, and ``point_lb[i]`` is a lower bound on the
  second-nearest distance, decayed by each iteration's ``max_j delta_j``. A
  point short-circuits the k-way distance recomputation iff its OWN centroid
  is bitwise unmoved (``delta_{a(i)} == 0``) and ``point_lb[i] − ub[i] >=
  delta_max`` (with the fp32 margin): the label provably cannot change AND
  the carried ``min_d2[i]`` is bitwise what a recompute would produce. The
  decay is tracked LAZILY per tile (``lb_debt``): skipped tiles pay no O(n)
  update — the debt folds into the prune threshold and is absorbed into the
  stored ``point_lb`` the next time the tile computes.
* SEEDING (Raff-style): the prologue caches ``center_d[i] = d(x_i,
  center_{t(i)})`` once per call; a seed round with new centroid c has
  ``d(x_i, c) >= dc_t − center_d[i]``, so points with ``(dc_t −
  center_d[i])² >= min_d2[i]`` (plus margin) provably cannot improve and the
  min-update is skipped — a value-noop by construction.

Hierarchical accumulators. ``tiles_per_super ≈ √n_tiles`` consecutive tiles
share one per-cluster accumulator slot. A super-tile's accumulator block is
carried iff ALL its tiles are skipped, so the coarse gate is expanded to
whole super-tiles (``expand_active_supers``); a tile force-activated only by
its super is a value-noop, and its points are exactly the ones the per-point
gate prunes.

The bounds are evaluated in fp32, so small conservative slacks keep rounding
from ever skipping a tile (or point) the exact-arithmetic bound would keep.

On the card the gates are O(n_tiles) tensor ops and the gated kernels read
the active mask from device memory: nothing here syncs the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Head-room on the skip threshold. The kernels (and the bound itself)
# evaluate D^2 in the matmul form ||x||^2 - 2x.c + ||c||^2, whose fp32
# cancellation error is ABSOLUTE in the magnitude of the operands: about
# eps_f32 * (||x|| + ||c||)^2, NOT eps * d^2. A purely relative slack would
# therefore under-protect data far from the origin. _REL covers the relative
# rounding of the comparison chain; _ABS scales a per-tile magnitude term
# (||center|| + r + max||c||)^2 with ~80x head-room over eps_f32 = 1.2e-7,
# so a tile is only ever skipped when the kernel's OWN fp32 d2 provably
# cannot dip below the carried min_d2 (skipping stays bitwise exact; far
# from the origin the gate just prunes less — center your data for the best
# skip rate).
_REL = 1e-6
_ABS = 1e-5
# Distance-unit analogue of _ABS for the ASSIGNMENT gate: the per-point gap
# is a difference of square roots of matmul-form d2 values, and near-zero
# distances turn the absolute d2 error into ~sqrt(_ABS) of distance error —
# so the gap margin scales sqrt(_ABS)-sized head-room by the tile's
# distance-unit operand magnitude.
_ABS_GAP = 4e-3


class RoundCache(NamedTuple):
    """Per-dataset state computed ONCE per seed/fit call (the prologue).
    ``centers``/``radii``/``center_d`` are the tile balls the skip bounds
    need; they are ``None`` when bound gating is off."""

    norms: torch.Tensor                       # (n,) fp32 ||x||²
    centers: Optional[torch.Tensor] = None    # (n_tiles, d) fp32 tile means
    radii: Optional[torch.Tensor] = None      # (n_tiles,) fp32 ball radii
    center_d: Optional[torch.Tensor] = None   # (n,) fp32 d(x, tile center)


class BoundState(NamedTuple):
    """Loop-carried bound state, unified across the two round primitives.

    The SEEDING loop carries ``(partials, tile_max)``: the previous round's
    per-tile partial sums (reused verbatim for skipped tiles) and per-tile
    max of ``min_d2`` (the skip bound's RHS).

    The ASSIGNMENT loop carries ``(partials, tile_gap, tile_sums,
    tile_counts, assignment, min_d2, point_lb, lb_debt)``: per-tile inertia
    partials, the per-tile second-best margin (distance units), the
    per-super-tile per-cluster sums/counts, the per-point labels/D² that
    skipped tiles carry verbatim, the per-point Hamerly lower bound on the
    second-nearest distance, and the per-tile lazy movement debt the stored
    ``point_lb`` is stale by. The ungated assignment round fills only the
    first six."""

    partials: torch.Tensor                         # (n_tiles,) fp32
    tile_max: Optional[torch.Tensor] = None        # (n_tiles,) fp32
    tile_gap: Optional[torch.Tensor] = None        # (n_tiles,) fp32
    tile_sums: Optional[torch.Tensor] = None       # (n_super, k, d) fp32
    tile_counts: Optional[torch.Tensor] = None     # (n_super, k) fp32
    assignment: Optional[torch.Tensor] = None      # (n,) int32
    min_d2: Optional[torch.Tensor] = None          # (n,) fp32
    point_lb: Optional[torch.Tensor] = None        # (n,) fp32
    lb_debt: Optional[torch.Tensor] = None         # (n_tiles,) fp32


def point_norms(points: torch.Tensor) -> torch.Tensor:
    """fp32 ``||x||²`` per row, of one problem (n, d) or a batch (B, n, d)
    — THE quantity the prologue caches. The columns are added in ascending
    order, one rounded product and one rounded add each, so the K1
    prologue kernel reproduces it bitwise."""
    x = points.float()
    s = x[..., 0] * x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j] * x[..., j]
    return s


def tile_counts(n: int, block_n: int, device=None) -> torch.Tensor:
    """Valid-row count of each tile of a zero-padded (n,) -> (n_tiles, bn)."""
    n_tiles = -(-n // block_n)
    start = torch.arange(n_tiles, dtype=torch.int64, device=device) * block_n
    return (n - start).clamp(0, block_n).float()


def prologue(points: torch.Tensor, block_n: int, *,
             with_bounds: bool = True) -> RoundCache:
    """Plain prologue: cached norms (+ tile centers/radii/center_d for the
    bound). Padded tail rows are excluded from center/radius. The K1 kernel
    computes the same arrays in one pass; only the *norms* must agree
    bitwise — the bound geometry may differ in ulps without affecting
    results (the bound is a sufficient condition, never a value)."""
    pts = points.float()
    norms = point_norms(pts)
    if not with_bounds:   # (B, n, d) batched points take this path only
        return RoundCache(norms)
    n, d = pts.shape
    pad = (-n) % block_n
    xp = torch.cat([pts, pts.new_zeros((pad, d))]).reshape(-1, block_n, d)
    cnt = tile_counts(n, block_n, pts.device)
    centers = xp.sum(dim=1) / cnt.clamp_min(1.0)[:, None]
    d2c = ((xp - centers[:, None, :]) ** 2).sum(dim=-1)
    row = torch.arange(block_n, device=pts.device)[None, :] < cnt[:, None]
    radii = torch.where(row, d2c, 0.0).amax(dim=1).sqrt()
    center_d = d2c.clamp_min(0.0).sqrt().reshape(-1)[:n]
    return RoundCache(norms, centers, radii, center_d)


def seed_gate(c_new: torch.Tensor, cache: RoundCache,
              tile_max: torch.Tensor):
    """Both levels of the SEEDING gate, one O(n_tiles·m) pass. Returns
    ``(active, dc, margin)``: ``active`` (n_tiles,) bool, True where the
    tile MIGHT change this round (skipped only when ``(d(center_t, c) -
    r_t)^2 >= tile_max_t`` against its nearest new centroid, with the
    conservative fp32 margin); ``dc`` (n_tiles,) the distance of each tile
    center to its nearest new centroid (the per-point test's input);
    ``margin`` (n_tiles,) the ``_ABS``-scaled absolute slack."""
    c = c_new.float()
    cn = (c * c).sum(dim=-1)
    ctr = cache.centers
    ctr_n2 = (ctr * ctr).sum(dim=1)
    d2 = (ctr_n2[:, None] - 2.0 * (ctr @ c.T) + cn[None, :]).clamp_min(0.0)
    dc = d2.amin(dim=1).sqrt()                          # nearest new centroid
    lo = (dc - cache.radii).clamp_min(0.0)              # min dist to tile
    # magnitude of the operands feeding the kernels' matmul-form d2 for this
    # tile: every ||x|| is within ||center|| + r, every ||c|| within cmax
    cmax = cn.max().sqrt()
    margin = _ABS * (ctr_n2.sqrt() + cache.radii + cmax) ** 2
    skip = lo * lo >= tile_max * (1.0 + _REL) + margin
    return ~skip, dc, margin


def seed_point_prune(min_d2: torch.Tensor, center_d: torch.Tensor,
                     dc: torch.Tensor, margin: torch.Tensor) -> torch.Tensor:
    """Per-point SEEDING prune mask: True where the min-update provably
    cannot change ``min_d2`` (``min(md, d2)`` would return ``md`` bitwise).
    ``dc``/``margin`` are the tile's :func:`seed_gate` scalars, broadcast
    per point. The K5 kernel evaluates the same four rounded operations."""
    lo = (dc - center_d).clamp_min(0.0)
    return lo * lo >= min_d2 * (1.0 + _REL) + margin


def seed_envelope(min_d2: torch.Tensor) -> torch.Tensor:
    """The rejection sampler's stale proposal weights ``q_i`` (unweighted:
    the stale ``min_d2`` itself). Valid because seeding only ever ADDS
    centroids: every point's D² is non-increasing across rounds, so a stale
    copy (and the per-tile partials summed from it) dominates the current
    weights pointwise — ``q_i >= p_i``, the exactness precondition."""
    return min_d2


def expand_mask(active: torch.Tensor, block_n: int, n: int) -> torch.Tensor:
    """Per-tile values -> per-point values (first n entries)."""
    n_tiles = active.shape[0]
    return active[:, None].expand(n_tiles, block_n).reshape(-1)[:n]


def tile_reduce_max(x: torch.Tensor, block_n: int) -> torch.Tensor:
    """Per-tile max of a non-negative (n,) array (zero-padded tail) — the
    bound-state twin of ``sampling.tile_partials``."""
    pad = (-x.shape[0]) % block_n
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(-1, block_n).amax(dim=1)


def centroid_movement(new_c: torch.Tensor, old_c: torch.Tensor) -> torch.Tensor:
    """(k,) fp32 ``delta_j = ‖c_j^{t+1} − c_j^t‖``. Exactly zero iff the
    centroid did not move (a bitwise fixed point)."""
    diff = new_c.float() - old_c.float()
    return (diff * diff).sum(dim=-1).sqrt()


def tiles_per_super(n_tiles: int, tps: Optional[int] = None) -> int:
    """Static super-tile width: ~√n_tiles consecutive tiles share one
    accumulator slot (a power of two). Problems of ≤ 8 tiles keep the flat
    layout (tps = 1). ``tps`` overrides the heuristic; it is clamped to
    [1, next_pow2(n_tiles)] and floored to a power of two."""
    if tps is not None and tps > 0:
        cap = 1 << max(int(n_tiles - 1).bit_length(), 0) if n_tiles > 1 else 1
        t = 1 << (int(tps).bit_length() - 1)
        return max(1, min(t, cap))
    if n_tiles <= 8:
        return 1
    return 1 << ((int(n_tiles - 1).bit_length() + 1) // 2)


def n_supers(n_tiles: int, tps: Optional[int] = None) -> int:
    return -(-n_tiles // tiles_per_super(n_tiles, tps))


def _pad_tiles(active: torch.Tensor, tps: int) -> torch.Tensor:
    pad = (-active.shape[0]) % tps
    if pad:
        active = torch.cat([active, active.new_zeros(pad)])
    return active.reshape(-1, tps)


def expand_active_supers(active: torch.Tensor, tps: int) -> torch.Tensor:
    """Expand a per-tile active mask to whole super-tiles (floored at one
    active super). A super's sums/counts block is carried only when ALL its
    tiles skip, so any active tile force-activates its whole super — a
    value-noop for the individually-skippable tiles, whose points the
    per-point gate then prunes. The floor keeps one super computed, as
    :func:`n_active` counts one tile."""
    n_tiles = active.shape[0]
    sup = _pad_tiles(active, tps).any(dim=1)
    sup = torch.cat([sup[:1] | ~sup.any(), sup[1:]])
    return sup[:, None].expand(sup.shape[0], tps).reshape(-1)[:n_tiles]


def super_any(active: torch.Tensor, tps: int) -> torch.Tensor:
    """(n_super,) bool — True where ANY tile of the super-tile is active."""
    return _pad_tiles(active, tps).any(dim=1)


def super_reduce(tile_arr: torch.Tensor, tps: int) -> torch.Tensor:
    """Reduce a per-tile array over each super-tile's tiles (leading axis
    n_tiles -> n_super); the ragged last super is zero-padded."""
    n_tiles = tile_arr.shape[0]
    pad = (-n_tiles) % tps
    if pad:
        tile_arr = torch.cat([tile_arr, tile_arr.new_zeros(
            (pad,) + tuple(tile_arr.shape[1:]))])
    return tile_arr.reshape((-1, tps) + tuple(tile_arr.shape[1:])).sum(dim=1)


def assign_active_tiles(delta: torch.Tensor, centroids: torch.Tensor,
                        state: BoundState, cache: RoundCache,
                        tps: Optional[int] = None) -> torch.Tensor:
    """(n_tiles,) bool — True where an ASSIGNMENT tile might change labels.

    Tile t is skipped only when BOTH hold: ``tile_gap_t >= delta_max``
    (with the conservative fp32 margin), so no label in the tile can change;
    and every cluster the tile's SUPER-tile's carried counts mark occupied
    has ``delta_j == 0``, so the carried ``min_d2``/partial/sums are bitwise
    what a recompute would produce. The occupancy is tracked per super-tile
    — coarser than the true per-tile occupancy, so the check can only keep a
    tile active, never skip one whose own centroid moved."""
    n_tiles = state.partials.shape[0]
    tps = tiles_per_super(n_tiles, tps)
    dmax = delta.max()
    occupied = state.tile_counts > 0.0                      # (n_super, k)
    moved_sup = (occupied & (delta[None, :] > 0.0)).any(dim=1)
    moved = moved_sup[torch.arange(n_tiles, device=delta.device) // tps]
    skip = (state.tile_gap >= dmax * (1.0 + _REL)
            + _ABS_GAP * _distance_scale(centroids, cache)) & ~moved
    return ~skip


def _distance_scale(centroids: torch.Tensor,
                    cache: RoundCache) -> torch.Tensor:
    """(n_tiles,) distance-unit operand magnitude of each tile's d2 math —
    the scale both assignment-side absolute slacks multiply."""
    c = centroids.float()
    cmax = (c * c).sum(dim=-1).max().sqrt()
    return (cache.centers * cache.centers).sum(dim=1).sqrt() \
        + cache.radii + cmax


def assign_point_scalars(delta: torch.Tensor, centroids: torch.Tensor,
                         state: BoundState, cache: RoundCache):
    """The two per-tile scalars the fine-level ASSIGNMENT gate streams:
    ``thresh`` (the prune threshold with the tile's lazy ``lb_debt`` folded
    in: point i short-circuits iff its own centroid is bitwise unmoved and
    ``point_lb[i] − sqrt(min_d2[i]) >= thresh_t``) and ``absorb``
    (``lb_debt_t + delta_max``: what a computed tile subtracts from the
    stored ``point_lb`` of its pruned points, so the debt resets to zero)."""
    dmax = delta.max()
    thresh = (dmax * (1.0 + _REL)
              + _ABS_GAP * _distance_scale(centroids, cache)
              + state.lb_debt)
    return thresh, state.lb_debt + dmax


def assign_point_prune(prev_a: torch.Tensor, prev_md: torch.Tensor,
                       prev_lb: torch.Tensor, delta: torch.Tensor,
                       thresh: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """Per-point ASSIGNMENT prune mask: True where the point's label AND
    its exact ``min_d2`` provably cannot change, so the k-way distance
    recomputation short-circuits to the carried values. ``thresh`` is the
    tile's scalar broadcast per point. The K6 kernel evaluates the same
    rounded operations."""
    own_delta = delta[prev_a.long()]
    ub = prev_md.sqrt()
    return valid & (own_delta == 0.0) & (prev_lb - ub >= thresh)


def decay_gap(gap: torch.Tensor, active: torch.Tensor,
              fresh_gap: torch.Tensor, delta_max: torch.Tensor
              ) -> torch.Tensor:
    """Next iteration's carried gap: fresh for computed tiles,
    carried-minus-movement for skipped ones (a gap refreshed at iteration r
    stays a valid lower bound after any number of consecutive skips)."""
    return torch.where(active, fresh_gap, gap - delta_max)


def n_active(active: torch.Tensor) -> torch.Tensor:
    """() int32 count of active tiles, floored at 1: the floor the skip
    counters follow. The reference's ``compact_ids`` floors its compacted
    grid at one tile, so a seeding round with nothing active still
    recomputes one skippable tile (a value-noop) and counts it as computed.
    The port's gated kernels launch the full grid and read the mask itself,
    so no compacted id map is built; only its floor is kept, here."""
    return active.sum().clamp_min(1).to(torch.int32)
