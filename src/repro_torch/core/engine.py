"""ClusterEngine — k-means++ seeding and Lloyd over a pluggable Backend
(port of ``repro.core.engine``: the ungated and the bound-gated paths,
rejection seeding, and batched problems with bounds off).

A ``Backend`` provides the round primitives the algorithms are written
against:

  prologue(points, m, with_bounds) -> RoundCache: the once-per-call pass
      (cached norms, plus the tile balls the gates read).
  seed_round(points, c_new, min_d2, cache=, state=) -> SeedRound(min_d2',
      total, partials, tile_max, skipped, pruned): fold the new centroid
      block into every point's D² and return the sum (the paper's
      min-update kernel + thrust::reduce) plus the per-tile partial sums the
      ``tiled`` sampler draws from; with a carried ``state`` the round skips
      every tile (and point) the triangle-inequality bound proves unchanged.
  assign_update(points, centroids, cache=, state=, delta=) ->
      AssignRound(assignment, min_d2, sums, counts, state, skipped, pruned):
      one Lloyd half-step in the tiled form (per-tile inertia partials and
      gaps, per-super-tile cluster sums); with ``state`` and the centroid
      movement ``delta`` it skips what the movement bound proves unchanged.
  row_min_d2(points, idx, pending, count) / tile_cap(centers, radii,
      pending, count): the rejection sampler's D² of one drawn row, and the
      per-tile envelope caps, against the first ``count`` pending centroids.
  seed_round_batched / assign_update_batched: the ungated rounds of B
      independent problems at once, every tensor with a leading problem
      axis; row b is bitwise the single round on problem b.

Gating is exact: the fp32 results are bitwise those of ``bounds=False``.

``CudaBackend`` runs them through the hand-written kernels (K1 prologue, K2
and K5 seeding rounds, K3 and K6 assignment rounds, K7 and K10a for batched
problems, K11 and K12 for rejection seeding); ``FusedBackend`` runs the
kernels' plain torch twins; ``ReferenceBackend`` is the global-memory
(two-pass) seeding semantics.

Batched problems (``seed_batched``, ``fit_batched``, ``kmeans_batched``) run
through the same seeding and Lloyd loops as one problem, with the leading
problem axis on every carry; each problem stops Lloyd at its own
convergence test and is frozen from then on.
Loops are Python loops over device tensors: a sampled index, a gate mask
and a skip count never leave the device (the rejection loop reads one
validity bit per round and one accept bit per attempt).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, NamedTuple, Optional, Union

import torch

from repro_torch.core import bounds, guards, sampling
from repro_torch.core.bounds import BoundState, RoundCache
from repro_torch.core.sampling import Draws
from repro_torch.kernels import kmeans_distance, lloyd_assign, ops

# ---------------------------------------------------------------------------
# result contracts + distance helpers
# ---------------------------------------------------------------------------


class KmeansppResult(NamedTuple):
    # batched problems (seed_batched) put a leading (B,) axis on every field
    centroids: torch.Tensor    # (k, d)
    indices: torch.Tensor      # (k,) int64 — which data points were chosen
    min_d2: torch.Tensor       # (n,) final D² to the nearest seed
    skipped: Optional[torch.Tensor] = None    # (k,) int32 tiles skipped per
    #                                           round (None: gating off)
    pruned: Optional[torch.Tensor] = None     # (k,) int32 points pruned
    #                                           inside active tiles per round
    recovered: Optional[torch.Tensor] = None  # (k,) int32 0/1 per-round
    #                                           heal flags (None: guard off)
    proposals: Optional[torch.Tensor] = None  # (k,) int32 envelope draws of
    #                                           round m in slot m (rejection)
    accepts: Optional[torch.Tensor] = None    # (k,) int32 0/1 ratio-test
    #                                           accepts (0: exact fallback)
    tightened: Optional[torch.Tensor] = None  # (k,) int32 tiles the cap
    #                                           shrank (rejection, 'hier')
    supers: Optional[torch.Tensor] = None     # (k,) int32 super windows the
    #                                           hier draws visited
    # counter contract (the reference's, checked by core.telemetry): fixed
    # length (k,), one slot per round, zero where a round did not run the
    # counted event. skipped/pruned of round m sit in slot m-1 (the final
    # fold in slot k-1); the rejection counters of round m in slot m.


class SeedRound(NamedTuple):
    min_d2: torch.Tensor       # (n,) updated D² to the nearest centroid
    total: torch.Tensor        # () sum of min_d2 — the paper's phi
    partials: torch.Tensor     # (n_tiles,) per-tile partial sums
    tile_max: Optional[torch.Tensor] = None   # (n_tiles,) per-tile max of
    #                                           min_d2 (None: gating off)
    skipped: Union[torch.Tensor, int] = 0     # () tiles skipped this round
    pruned: Union[torch.Tensor, int] = 0      # () points pruned this round


class LloydResult(NamedTuple):
    # batched problems (fit_batched) put a leading (B,) axis on every field
    centroids: torch.Tensor    # (k, d)
    assignment: torch.Tensor   # (n,) int32
    inertia: torch.Tensor      # () sum of squared distances to assigned
    n_iters: Union[int, torch.Tensor]   # batched: (B,) int32, per problem
    skipped: Optional[torch.Tensor] = None    # (max_iters,) int32 tiles
    #                                           skipped per iteration
    pruned: Optional[torch.Tensor] = None     # (max_iters,) int32 points
    #                                           pruned per iteration
    recovered: Optional[torch.Tensor] = None  # (max_iters,) int32 0/1 heal
    #                                           flags (None: guard off)
    # same contract as KmeansppResult: slots past n_iters are zero, and all
    # three are None when gating is off


class AssignRound(NamedTuple):
    assignment: torch.Tensor   # (n,) int32
    min_d2: torch.Tensor       # (n,) D² to the assigned centroid
    sums: torch.Tensor         # (k, d) per-cluster sums
    counts: torch.Tensor       # (k,) per-cluster counts
    state: Optional[BoundState] = None
    skipped: Union[torch.Tensor, int] = 0     # () tiles skipped
    pruned: Union[torch.Tensor, int] = 0      # () points pruned


def pairwise_d2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (n, d) x (k, d) -> (n, k), matmul form."""
    xn = (x * x).sum(dim=-1, keepdim=True)
    cn = (c * c).sum(dim=-1)
    return torch.clamp_min(xn - 2.0 * (x @ c.T) + cn[None, :], 0.0)


def point_d2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distance of every point in x (n, d) to one centroid (d,)."""
    diff = x - c[None, :]
    return (diff * diff).sum(dim=-1)


def _min_d2_to(points: torch.Tensor, c_new: torch.Tensor) -> torch.Tensor:
    """D² of every point to its nearest centroid among c_new (m, d); m == 1
    keeps the diff-square form of the reference's serial baseline."""
    if c_new.shape[0] == 1:
        return point_d2(points, c_new[0])
    return pairwise_d2(points, c_new).amin(dim=1)


def segment_update(points: torch.Tensor, assignment: torch.Tensor,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums and counts of the rows of each label."""
    idx = assignment.long()
    pts = points.float()
    sums = pts.new_zeros((k, pts.shape[1])).index_add_(0, idx, pts)
    counts = pts.new_zeros(k).index_add_(0, idx, pts.new_ones(idx.shape[0]))
    return sums, counts


def centroid_means(sums: torch.Tensor, counts: torch.Tensor,
                   prev_centroids: Optional[torch.Tensor]) -> torch.Tensor:
    """Means from per-cluster sums/counts; empty clusters keep their
    previous centroid. A leading problem axis passes through."""
    means = sums / counts.clamp_min(1e-12)[..., None]
    if prev_centroids is not None:
        means = torch.where((counts > 0)[..., None], means,
                            prev_centroids.float())
    return means


def reseed_split_largest(means: torch.Tensor, counts: torch.Tensor, *,
                         rel: float = 1e-3) -> torch.Tensor:
    """Empty-cluster reseeding: each empty cluster jumps to a nudged copy of
    the largest cluster's centroid (the r-th empty one at a distinct
    rank-scaled offset), so the next assignment splits the donor. Batched
    problems (a leading axis) reseed each from its own largest cluster."""
    empty = counts <= 0
    target = torch.take_along_dim(
        means, counts.argmax(dim=-1, keepdim=True)[..., None], dim=-2)
    emp = empty.to(means.dtype)
    off = (rel * (torch.cumsum(emp, -1) * emp))[..., None]
    nudged = target * (1.0 + off) + off
    return torch.where(empty[..., None], nudged, means)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


def _gates(state: Optional[BoundState], cache: RoundCache) -> bool:
    """A round is gated when it carries bound state and the prologue made
    the tile balls."""
    return state is not None and cache.centers is not None


def _ungated_round(a, md, part, gap, ssums, scounts) -> AssignRound:
    """An ungated tiled round's outputs as an ``AssignRound``: the cluster
    sums and counts are the fixed-order sums of the per-super accumulators
    (``sampling.fixed_sum``), so a batched problem's update is bitwise the
    single problem's."""
    state = BoundState(part, tile_gap=gap, tile_sums=ssums,
                       tile_counts=scounts, assignment=a, min_d2=md)
    return AssignRound(a, md, sampling.fixed_sum(ssums, -3),
                       sampling.fixed_sum(scounts, -2), state)


def _problem(cache: RoundCache, b: int) -> RoundCache:
    """Problem b's slice of a batched prologue cache."""
    return RoundCache(*(None if f is None else f[b] for f in cache))


def _seed_skipped(active: torch.Tensor) -> torch.Tensor:
    """() int32 tiles a gated seeding round skipped, with the floor of one
    computed tile that ``bounds.n_active`` defines."""
    return active.shape[0] - bounds.n_active(active)


def _gate_model(new_md_full, min_d2, c_new, cache: RoundCache,
                state: BoundState, tile: int) -> SeedRound:
    """Plain model of the gated seeding kernel, shared by the reference and
    fused backends: tiles the bound proves unchanged take their ``min_d2``
    slice and partial/tile-max entries from the CARRIED state instead of the
    fresh compute, and inside ACTIVE tiles the per-point bound keeps every
    row whose min-update provably cannot fire — what K5's carried outputs
    and in-kernel prune do. In fp32 the selects are value-noops unless the
    bound were wrong."""
    active, dc, margin = bounds.seed_gate(c_new, cache, state.tile_max)
    md, partials, tile_max, pruned = kmeans_distance.gate_select(
        new_md_full, min_d2, cache.center_d, dc, margin, state.partials,
        state.tile_max, active, block_n=tile)
    return SeedRound(md, partials.sum(), partials, tile_max,
                     _seed_skipped(active), pruned.sum().to(torch.int32))


@dataclasses.dataclass(frozen=True)
class Backend:
    """Round-primitive provider.

    ``block_n``/``tps`` fix the tile height and the super-tile fan-in (0
    keeps the Hopper heuristics). Parity tests pass the reference's values
    so per-tile partials and super sums line up. ``tile_m`` floors the
    centroid count the tile pick budgets for, so a kmeans call's seeding and
    Lloyd phases share one geometry and one prologue."""

    name: ClassVar[str] = "base"

    tile_m: int = 0
    block_n: int = 0
    tps: int = 0

    def seed_round(self, points, c_new, min_d2, *, cache: RoundCache,
                   state: Optional[BoundState] = None) -> SeedRound:
        raise NotImplementedError

    def assign_update(self, points, centroids, *, cache: RoundCache,
                      state: Optional[BoundState] = None,
                      delta: Optional[torch.Tensor] = None) -> AssignRound:
        """One Lloyd half-step in the tiled form. With ``state`` and
        ``delta`` (the per-centroid movement since the last round) it gates
        on the movement bound: the skip mask is expanded to whole super-tiles
        (the accumulators are carried at super granularity), and inside
        active tiles the per-point Hamerly bound short-circuits provably
        stable points — both value-noops, counted in ``skipped``/``pruned``.
        """
        n = points.shape[0]
        tile = self.seed_tile(n, points.shape[1], centroids.shape[0])
        tps = self.tiles_per_super(-(-n // tile))
        if delta is not None and _gates(state, cache):
            return self._assign_update_gated(points, centroids, cache, state,
                                             delta, tile, tps)
        return _ungated_round(*self._assign_tiled(
            points, cache.norms, centroids, tile, tps))

    def seed_round_batched(self, points, c_new, min_d2, *,
                           cache: RoundCache) -> SeedRound:
        """One ungated seeding round of B independent problems: points
        (B, n, d), c_new (B, m, d), min_d2 and ``cache.norms`` (B, n). The
        fields of the ``SeedRound`` gain the leading axis; row b is bitwise
        ``seed_round`` on problem b (here: that round per problem)."""
        rounds = [self.seed_round(p, c, md, cache=_problem(cache, b))
                  for b, (p, c, md) in enumerate(zip(points, c_new, min_d2))]
        return SeedRound(*(torch.stack(f)
                           for f in zip(*(r[:3] for r in rounds))))

    def assign_update_batched(self, points, centroids, *,
                              cache: RoundCache) -> AssignRound:
        """One ungated Lloyd half-step of B independent problems: points
        (B, n, d), centroids (B, k, d), ``cache.norms`` (B, n), at the
        single problem's tile geometry. The fields of the ``AssignRound``
        gain the leading axis; row b is bitwise ``assign_update`` on
        problem b."""
        n, d = points.shape[-2:]
        tile = self.seed_tile(n, d, centroids.shape[-2])
        tps = self.tiles_per_super(-(-n // tile))
        return _ungated_round(*self._assign_tiled_batched(
            points, cache.norms, centroids, tile, tps))

    def _assign_tiled_batched(self, points, norms, centroids, tile, tps):
        return lloyd_assign.lloyd_assign_tiled_batched_torch(
            points, norms, centroids, block_n=tile, tps=tps)

    def _assign_update_gated(self, points, centroids, cache, state, delta,
                             tile, tps) -> AssignRound:
        dmax = delta.max()
        cand = bounds.assign_active_tiles(delta, centroids, state, cache,
                                          tps=tps)
        # expanded HERE (the kernel wrapper re-expands, idempotently) so the
        # gap decay and debt below see exactly the tiles the round rewrote
        active = bounds.expand_active_supers(cand, tps)
        thresh, absorb = bounds.assign_point_scalars(delta, centroids, state,
                                                     cache)
        a, md, lb, part, gap, ssums, scounts, pruned = self._assign_gated(
            points, cache.norms, centroids, delta, thresh, absorb, state,
            active, tile, tps)
        # skipped tiles' gaps are the carry: decay them by this step's
        # movement so they stay valid lower bounds across consecutive skips;
        # their stored per-point lb decays lazily instead (lb_debt)
        gap = bounds.decay_gap(gap, active, gap, dmax)
        debt = torch.where(active, 0.0, state.lb_debt + dmax)
        new_state = BoundState(part, tile_gap=gap, tile_sums=ssums,
                               tile_counts=scounts, assignment=a, min_d2=md,
                               point_lb=lb, lb_debt=debt)
        # the same fixed-order sums as the ungated round's
        return AssignRound(a, md, sampling.fixed_sum(ssums, -3),
                           sampling.fixed_sum(scounts, -2), new_state,
                           (~active).sum().to(torch.int32),
                           pruned.sum().to(torch.int32))

    def _assign_tiled(self, points, norms, centroids, tile, tps):
        return lloyd_assign.lloyd_assign_tiled_torch(
            points, norms, centroids, block_n=tile, tps=tps)

    def _assign_gated(self, points, norms, centroids, delta, thresh, absorb,
                      state, active, tile, tps):
        return lloyd_assign.lloyd_assign_gated_torch(
            points, norms, centroids, delta, thresh, absorb,
            state.assignment, state.min_d2, state.point_lb, state.partials,
            state.tile_gap, state.tile_sums, state.tile_counts, active,
            block_n=tile, tps=tps)

    def prologue(self, points, m: int = 1,
                 with_bounds: bool = True) -> RoundCache:
        """Once-per-call pass: the cached fp32 norms every round streams,
        plus the tile balls when bound gating is on. Batched points
        (B, n, d) take the norms only (bounds off)."""
        n, d = points.shape[-2:]
        return bounds.prologue(points, self.seed_tile(n, d, m),
                               with_bounds=with_bounds)

    def seed_tile(self, n: int, d: int, m: int = 1) -> int:
        """Tile height of the per-tile partials and of the assignment
        kernel's tiles: the explicit ``block_n`` when set, else the Hopper
        shared-memory pick for max(m, tile_m) centroids."""
        if self.block_n > 0:
            return self.block_n
        return ops.choose_block_n(n, d, max(m, self.tile_m, 1))

    def tiles_per_super(self, n_tiles: int) -> int:
        return bounds.tiles_per_super(n_tiles, self.tps or None)

    def row_min_d2(self, points, idx, pending, count) -> torch.Tensor:
        """0-d D² of row ``idx`` (a device index) to the nearest of
        ``pending[:count]``, +inf when count is 0 — the rejection sampler's
        exact p, O(P·d) work whatever n is."""
        return kmeans_distance.row_min_d2_torch(points, idx, pending, count)

    def tile_cap(self, centers, radii, pending, count) -> torch.Tensor:
        """(T,) per-tile envelope caps ``(d(center_t, pending) + r_t)²``
        against ``pending[:count]`` from the prologue's tile balls (never a
        row); +inf everywhere when count is 0."""
        return kmeans_distance.tile_cap_torch(centers, radii, pending, count)


@dataclasses.dataclass(frozen=True)
class ReferenceBackend(Backend):
    """The paper's global-memory variant: the min-update is materialized and
    re-read by a second reduction pass (the serial mode is not ported)."""

    name: ClassVar[str] = "reference"

    def seed_round(self, points, c_new, min_d2, *, cache, state=None):
        n, d = points.shape
        tile = self.seed_tile(n, d, c_new.shape[0])
        new_md = torch.minimum(min_d2, _min_d2_to(points, c_new))
        if _gates(state, cache):
            rnd = _gate_model(new_md, min_d2, c_new, cache, state, tile)
            # keep the two-pass total: a sum over the materialized array,
            # not over the partial tree
            return rnd._replace(total=rnd.min_d2.sum())
        return SeedRound(new_md, new_md.sum(),
                         sampling.tile_partials(new_md, tile))


@dataclasses.dataclass(frozen=True)
class FusedBackend(Backend):
    """The kernels' plain torch twins (cached-norm matmul form)."""

    name: ClassVar[str] = "fused"

    def seed_round(self, points, c_new, min_d2, *, cache, state=None):
        n, d = points.shape
        tile = self.seed_tile(n, d, c_new.shape[0])
        new_md, partials = kmeans_distance.distance_min_update_torch(
            points, cache.norms, c_new, min_d2, block_n=tile)
        if _gates(state, cache):
            return _gate_model(new_md, min_d2, c_new, cache, state, tile)
        return SeedRound(new_md, partials.sum(), partials)


@dataclasses.dataclass(frozen=True)
class CudaBackend(Backend):
    """The hand-written Hopper kernels: K1 for the prologue, K2 (K5 gated,
    K7 batched) for every seeding round, K3 (K6 gated, K10a batched) for
    every assignment round, K11 and K12 for the rejection sampler's row D²
    and tile caps.
    ``resident=False`` re-reads the centroid block from global memory
    (Fig. 2's variant) instead of staging it in shared memory."""

    name: ClassVar[str] = "cuda"
    resident: bool = True

    def row_min_d2(self, points, idx, pending, count) -> torch.Tensor:
        return kmeans_distance.row_min_d2(points, idx, pending, count)

    def tile_cap(self, centers, radii, pending, count) -> torch.Tensor:
        return kmeans_distance.tile_cap(centers, radii, pending, count)

    def prologue(self, points, m: int = 1,
                 with_bounds: bool = True) -> RoundCache:
        if not with_bounds:
            return RoundCache(bounds.point_norms(points))
        n, d = points.shape
        return RoundCache(*kmeans_distance.seed_prologue(
            points, self.seed_tile(n, d, m)))

    def seed_round(self, points, c_new, min_d2, *, cache, state=None):
        n, d = points.shape
        tile = self.seed_tile(n, d, c_new.shape[0])
        c = c_new.contiguous()
        if _gates(state, cache):
            # the gate is O(n_tiles) device ops; K5 reads the mask itself
            active, dc, margin = bounds.seed_gate(c, cache, state.tile_max)
            md, partials, tmax, pruned = \
                kmeans_distance.distance_min_update_gated(
                    points, cache.norms, c, min_d2, cache.center_d, dc,
                    margin, state.partials, state.tile_max, active,
                    block_n=tile, resident=self.resident)
            return SeedRound(md, partials.sum(), partials, tmax,
                             _seed_skipped(active),
                             pruned.sum().to(torch.int32))
        new_md, partials = kmeans_distance.distance_min_update(
            points, cache.norms, c, min_d2, block_n=tile,
            resident=self.resident)
        return SeedRound(new_md, partials.sum(), partials)

    def seed_round_batched(self, points, c_new, min_d2, *, cache):
        n, d = points.shape[-2:]
        new_md, partials = kmeans_distance.distance_min_update_batched(
            points, cache.norms, c_new.contiguous(), min_d2,
            block_n=self.seed_tile(n, d, c_new.shape[-2]),
            resident=self.resident)
        # the total only feeds finite/positive tests: any order will do
        return SeedRound(new_md, partials.sum(-1), partials)

    def _assign_tiled(self, points, norms, centroids, tile, tps):
        return lloyd_assign.lloyd_assign_tiled(
            points, norms, centroids.contiguous(), block_n=tile, tps=tps)

    def _assign_tiled_batched(self, points, norms, centroids, tile, tps):
        return lloyd_assign.lloyd_assign_tiled_batched(
            points, norms, centroids.contiguous(), block_n=tile, tps=tps)

    def _assign_gated(self, points, norms, centroids, delta, thresh, absorb,
                      state, active, tile, tps):
        return lloyd_assign.lloyd_assign_gated(
            points, norms, centroids.contiguous(), delta, thresh, absorb,
            state.assignment, state.min_d2, state.point_lb, state.partials,
            state.tile_gap, state.tile_sums, state.tile_counts, active,
            block_n=tile, tps=tps)


_BACKENDS: dict[str, Callable[..., Backend]] = {
    "reference": ReferenceBackend,
    "fused": FusedBackend,
    "cuda": CudaBackend,
}


def make_backend(name: Union[str, Backend], **opts) -> Backend:
    """Backend registry: 'reference' | 'fused' | 'cuda'."""
    if isinstance(name, Backend):
        if opts:
            raise ValueError("cannot pass options with a Backend instance")
        return name
    try:
        ctor = _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; expected one of "
                         f"{sorted(_BACKENDS)}") from None
    return ctor(**opts)


# ---------------------------------------------------------------------------
# the seeding loop
# ---------------------------------------------------------------------------


def _seed_parts(*, round_fn, init_min_d2, gated: bool, guard: bool,
                tile: int):
    """The round step of the k-means++ loop, ``checked_round(m, centroids,
    min_d2, state) -> (min_d2, partials, state, skipped, pruned,
    recovered)``: fold centroid m-1 in. ``round_fn(c, md, state)`` is one
    backend round; ``gated`` carries ``BoundState(partials, tile_max)``.

    ``guard`` arms in-flight corruption detection: every round's ``total``
    doubles as the finite flag. A non-finite total means the carry is
    untrusted, so the round DISCARDS min_d2 and the bound state and refolds
    rounds 0..m-1 UNGATED from the clean +inf carry; the refold applies the
    same min-folds in the same order, and gating is exact, so the healed
    carry (and its last round's partials) is the one an uncorrupted run has.
    The rebuilt tile_max is the healed min_d2's. Corruption in a tile the
    gate is skipping is not seen until that tile next activates."""

    def heal(m, centroids) -> SeedRound:
        md, rnd = init_min_d2, None
        for j in range(m):
            rnd = round_fn(centroids[..., j:j + 1, :], md, None)
            md = rnd.min_d2
        return rnd

    def checked_round(m, centroids, min_d2, state):
        rnd = round_fn(centroids[..., m - 1:m, :], min_d2, state)
        # one host sync per round: the guard's finite check
        if guard and not bool(torch.isfinite(rnd.total)):
            rnd = heal(m, centroids)
            st = (BoundState(rnd.partials,
                             bounds.tile_reduce_max(rnd.min_d2, tile))
                  if gated else None)
            return rnd.min_d2, rnd.partials, st, 0, 0, 1
        st = BoundState(rnd.partials, rnd.tile_max) if gated else None
        return rnd.min_d2, rnd.partials, st, rnd.skipped, rnd.pruned, 0

    return checked_round


def _take_rows(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (..., r) of ``pts`` (..., n, d), problem by problem."""
    return torch.take_along_dim(pts, idx[..., None], dim=-2)


def _seed_loop(draws: Draws, pts, k, *, round_fn, sample_fn, init_min_d2,
               init_state: Optional[BoundState], guard: bool, tile: int):
    """Generic k-means++ loop: round m folds centroid m-1 into min_d2 and
    draws seed m with ``draws.u[m-1]``; a final round folds the last seed,
    so the returned min_d2 covers all k. The sampled index stays on the
    device: seeds are gathered on the device, never read on the host.
    ``init_state`` turns on bound gating (round 1 starts from tile_max =
    +inf, nothing skippable); the per-round skip and prune counts stay on
    the device. Batched problems carry a leading axis on ``pts`` (B, n, d),
    the draws and every carry; one round serves all B. Returns (centroids,
    indices, min_d2, skipped, pruned, recovered)."""
    gated = init_state is not None
    checked_round = _seed_parts(round_fn=round_fn, init_min_d2=init_min_d2,
                                gated=gated, guard=guard, tile=tile)
    dev = pts.device
    lead = tuple(pts.shape[:-2])
    centroids = pts.new_zeros(lead + (k, pts.shape[-1]))
    indices = torch.zeros(lead + (k,), dtype=torch.int64, device=dev)
    skips = torch.zeros(k, dtype=torch.int32, device=dev) if gated else None
    prunes = torch.zeros(k, dtype=torch.int32, device=dev) if gated else None
    rec = [0] * k
    first = draws.first.reshape(lead + (1,))
    centroids[..., 0:1, :] = _take_rows(pts, first)
    indices[..., 0:1] = first
    min_d2, state = init_min_d2, init_state
    for m in range(1, k + 1):
        min_d2, partials, state, rs, rp, rec[m - 1] = checked_round(
            m, centroids, min_d2, state)
        if gated:
            skips[m - 1], prunes[m - 1] = rs, rp
        if m == k:
            break
        nxt = sample_fn(draws.u[..., m - 1], draws.fallback[..., m - 1:m],
                        min_d2, partials)
        centroids[..., m:m + 1, :] = _take_rows(pts, nxt)
        indices[..., m:m + 1] = nxt
    return (centroids, indices, min_d2, skips, prunes,
            torch.tensor(rec, dtype=torch.int32))


_REJECT_ATTEMPTS = 8   # default truncation depth of the rejection loop


def _envelope_fault(fault, m: int, partials: torch.Tensor) -> torch.Tensor:
    """The reference's two rejection-envelope faults at round
    ``fault.round``: ``neg_envelope`` makes the first tile partial -1,
    ``stale_super`` makes every partial of the last super-tile NaN (a torn
    coarse aggregate). Other kinds and rounds leave ``partials`` as is."""
    kind = getattr(fault, "kind", None)
    if fault is None or m != fault.round or kind not in (
            "neg_envelope", "stale_super"):
        return partials
    partials = partials.clone()
    if kind == "neg_envelope":
        partials[0] = -1.0
    else:
        n_tiles = partials.shape[0]
        partials[max(n_tiles - bounds.tiles_per_super(n_tiles), 0):] = \
            torch.nan
    return partials


def _seed_rejection_loop(draws: Draws, pts, k, *, round_fn, propose_fn,
                         pq_fn, fallback_fn, prep_fn, n_tiles: int,
                         refresh_block: int, max_attempts: int, init_min_d2,
                         init_state: Optional[BoundState], tile: int,
                         guard: bool, hier: bool, fault=None):
    """Rejection-sampling k-means++ loop (``sampler='rejection'``).

    A round does not refresh D². Chosen centroids collect in a (P, d)
    PENDING block (P = ``refresh_block``), and the (min_d2, partials) of the
    last refresh are the stale envelope ``q`` (``bounds.seed_envelope``),
    which dominates the current weights because seeding only adds
    centroids. A round draws from the envelope (``propose_fn(u, weight,
    partials, pstate)``), prices the drawn row exactly (``pq_fn(idx,
    weight, pending, count, pstate) -> (p, q)`` with ``p = min(q,
    row_min_d2)``) and accepts with probability p/q. The full refresh — the
    whole pending block folded through ``round_fn``, gated or not — runs
    when the block fills, when all ``max_attempts`` proposals reject (the
    round then takes an exact draw, ``fallback_fn``, from the refreshed
    weights, so the truncated mixture stays exactly D²-distributed), and
    once at the end, so the returned min_d2 is exact over all k seeds.

    The pending block starts as P copies of centroid 0 with count P - 1, so
    round 1's append forces the first refresh; it is never cleared (rows
    past the count were folded already, a value-noop under min). ``count``
    is a host integer: the refresh decision needs no sync, and the kernels
    read it as a 0-d device view.

    Uniforms: attempt 0 of round m proposes with ``draws.u[m-1]``, so with
    ``refresh_block=1`` (p == q bitwise, the first proposal accepts) the
    seeds are bitwise the tiled sampler's; the other attempts, the accepts
    and the exact draw take the rejection schedule of ``draws``.

    Envelope guard (always on): every round checks the partials for
    negative or non-finite entries, one host sync. A bad envelope is
    rebuilt BEFORE proposing by refolding, ungated from the clean +inf
    carry, the centroids it should cover (0..m-count-1, the rest of a (k, d)
    block padded with centroid 0); min-folds are exact, so the rebuilt
    envelope is bitwise the clean run's and the round replays identically,
    flagged in ``recovered[m]``. ``fault`` (``.kind``, ``.round``) injects
    the reference's ``neg_envelope``/``stale_super`` corruption. ``guard``
    also checks the settling refresh's total.

    ``prep_fn(partials, pending, count) -> (pstate, tightened)`` builds the
    hier proposal state once per round from the (healed) partials.

    Host syncs: one per round (the envelope check), one per attempt (the
    accept bit), one for the guard's final check.

    Returns (centroids, indices, min_d2, skipped, pruned, proposals,
    accepts, recovered, tightened, supers), all counters (k,) int32."""
    d = pts.shape[1]
    dev = pts.device
    P = max(int(refresh_block), 1)
    gated = init_state is not None
    counts = torch.arange(P + 1, dtype=torch.int32, device=dev)
    centroids = pts.new_zeros((k, d))
    indices = torch.zeros(k, dtype=torch.int64, device=dev)
    first = draws.first.reshape(1)
    centroids[0:1] = pts.index_select(0, first)
    indices[0:1] = first
    skips = torch.zeros(k, dtype=torch.int32, device=dev)
    prunes = torch.zeros(k, dtype=torch.int32, device=dev)
    tights = torch.zeros(k, dtype=torch.int32, device=dev)
    props, accs, sups, rec = [0] * k, [0] * k, [0] * k, [0] * k
    pending = centroids[0:1].expand(P, d).clone()
    count = P - 1
    md, state = init_min_d2, init_state
    partials = torch.zeros(n_tiles, device=dev)   # never drawn from

    def refresh(md, state):
        rnd = round_fn(pending, md, state)
        st = BoundState(rnd.partials, rnd.tile_max) if gated else None
        return rnd.min_d2, rnd.partials, st, rnd.skipped, rnd.pruned

    def heal_stale(m, count):
        block = centroids.clone()
        block[m - count:] = centroids[0]
        rnd = round_fn(block, init_min_d2, None)
        st = (BoundState(rnd.partials,
                         bounds.tile_reduce_max(rnd.min_d2, tile))
              if gated else None)
        return rnd.min_d2, rnd.partials, st

    for m in range(1, k):
        pending[count] = centroids[m - 1]
        count += 1
        rs, rp = n_tiles, 0          # an untouched round read no tile
        if count >= P:
            md, partials, state, rs, rp = refresh(md, state)
            count = 0
        partials = _envelope_fault(fault, m, partials)
        env_ok = not bool((~torch.isfinite(partials) | (partials < 0)).any())
        if not env_ok:
            md, partials, state = heal_stale(m, count)
        live = counts[count]
        pstate, tightened = prep_fn(partials, pending, live)
        weight = bounds.seed_envelope(md)
        idx, ok, att = sampling.rejection_sample(
            lambda u: propose_fn(u, weight, partials, pstate),
            lambda i: pq_fn(i, weight, pending, live, pstate),
            torch.cat([draws.u[m - 1:m], draws.propose_u[m - 1]]),
            draws.accept_u[m - 1], max_attempts=max_attempts)
        if not ok:
            md, partials, state, rs, rp2 = refresh(md, state)
            rp = rp + rp2
            count = 0
            idx = fallback_fn(draws.exact_u[m - 1],
                              draws.exact_fallback[m - 1:m],
                              bounds.seed_envelope(md), partials)
        centroids[m:m + 1] = pts.index_select(0, idx)
        indices[m:m + 1] = idx
        skips[m - 1], prunes[m - 1], tights[m] = rs, rp, tightened
        props[m], accs[m], rec[m] = att, int(ok), int(not env_ok)
        if hier:
            sups[m] = att + (0 if ok else 1)
    # settle: fold the last seed and every still-pending one
    pending[count] = centroids[k - 1]
    rnd = round_fn(pending, md, state)
    final_md = rnd.min_d2
    if guard and not bool(torch.isfinite(rnd.total)):
        final_md = round_fn(centroids, init_min_d2, None).min_d2
        rec[k - 1] = 1
    skips[k - 1], prunes[k - 1] = rnd.skipped, rnd.pruned

    def i32(xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    return (centroids, indices, final_md, skips, prunes, i32(props),
            i32(accs), i32(rec), tights, i32(sups))


def _seed_rejection(draws: Draws, pts, k, backend: Backend,
                    cache: RoundCache, tile: int,
                    init_state: Optional[BoundState], *, refresh_block: int,
                    proposal: str, max_attempts: int, guard: bool,
                    fault=None) -> KmeansppResult:
    """The rejection branch of :func:`seed_points`: the proposal, pricing,
    fallback and prep functions for ``proposal`` 'hier' or 'flat', then
    :func:`_seed_rejection_loop`."""
    n, d = pts.shape
    dev = pts.device
    n_tiles = -(-n // tile)
    tps = backend.tiles_per_super(n_tiles)
    hier = proposal == "hier"
    # the refresh folds P centroids at once: pin its tile height to the
    # sampler's, so its partials cover the rows the draws' windows cover
    be = dataclasses.replace(backend, block_n=tile)

    if hier:
        tiny = torch.finfo(torch.float32).tiny
        # per-tile row counts (the last tile short): the unweighted tile
        # mass the cap multiplies into a tile-level envelope bound
        tile_w = torch.full((n_tiles,), float(tile), device=dev)
        tile_w[-1] = float(n - (n_tiles - 1) * tile)

        def prep_fn(partials, pending, count):
            # rebuilt each round from the healed partials: cap_t bounds
            # every row's D² to the pending block from tile summaries
            # alone, so min(partials_t, cap_t * W_t) is a valid tile
            # envelope mass
            if cache.centers is not None:
                cap = be.tile_cap(cache.centers, cache.radii, pending, count)
            else:   # no balls without bounds: never tighten
                cap = torch.full((n_tiles,), torch.inf, device=dev)
            capw = cap * tile_w
            ph = torch.where(capw < partials, capw, partials)
            tight = ph < partials
            tcdf = sampling.prefix_sum(ph)
            return ((ph, tcdf, sampling.super_cdf(tcdf, tps), cap, tight),
                    tight.sum(dtype=torch.int32))

        def propose_fn(u, weight, partials, pstate):
            ph, tcdf, scdf, cap, tight = pstate
            return sampling.hier_index_from_uniform(
                u, weight, ph, tcdf, scdf, block_n=tile, tps=tps, cap=cap,
                tight=tight)

        def pq_fn(idx, weight, pending, count, pstate):
            # priced under the proposal's own association: a tightened
            # tile drew its row ∝ the capped window with tile mass ph_t,
            # so q = cwin[li] * ph_t / sum(cwin); other tiles keep the flat
            # q = weight[idx] bitwise
            ph, _, _, cap, tight = pstate
            rd2 = be.row_min_d2(pts, idx.reshape(()), pending, count)
            t = idx // tile
            li = idx - t * tile
            win = sampling.tile_window(weight, t, tile)
            cw = cap[t]
            cwin = torch.where(cw < win, cw, win)
            s_t = sampling.prefix_sum(cwin)[tile - 1]
            q = torch.where(tight[t],
                            cwin[li] * (ph[t] / s_t.clamp_min(tiny)),
                            weight[idx])
            return torch.minimum(q, rd2), q

        def fallback_fn(u, fb, weight, partials):
            return sampling.categorical_hier(u, fb, weight, partials,
                                             block_n=tile, tps=tps)
    else:
        def prep_fn(partials, pending, count):
            return None, 0

        def propose_fn(u, weight, partials, pstate):
            return sampling.tiled_index_from_uniform(u, weight, partials,
                                                     block_n=tile)

        def pq_fn(idx, weight, pending, count, pstate):
            q = weight[idx]
            rd2 = be.row_min_d2(pts, idx.reshape(()), pending, count)
            return torch.minimum(q, rd2), q

        def fallback_fn(u, fb, weight, partials):
            return sampling.categorical_tiled(u, fb, weight, partials,
                                              block_n=tile)

    (centroids, indices, min_d2, skips, prunes, props, accs, rec, tights,
     sups) = _seed_rejection_loop(
        draws, pts, k,
        round_fn=lambda c, md, st: be.seed_round(pts, c, md, cache=cache,
                                                 state=st),
        propose_fn=propose_fn, pq_fn=pq_fn, fallback_fn=fallback_fn,
        prep_fn=prep_fn, n_tiles=n_tiles, refresh_block=refresh_block,
        max_attempts=max_attempts,
        init_min_d2=torch.full((n,), torch.inf, device=dev),
        init_state=init_state, tile=tile, guard=guard, hier=hier,
        fault=fault)
    gated = init_state is not None
    return KmeansppResult(centroids, indices, min_d2,
                          skips if gated else None, prunes if gated else None,
                          recovered=rec if guard else None, proposals=props,
                          accepts=accs, tightened=tights, supers=sups)


def seed_points(draws: Draws, points: torch.Tensor, k: int,
                backend: Backend, sampler: str = "cdf", *,
                bound_gate: bool = True,
                cache: Optional[RoundCache] = None,
                guard: bool = False, refresh_block: int = 8,
                proposal: str = "hier",
                max_attempts: int = _REJECT_ATTEMPTS,
                fault=None) -> KmeansppResult:
    """Full k-means++ seeding through ``backend``. Samplers: 'cdf' (full
    inverse CDF, the serial algorithm), 'tiled' (two-level inverse CDF
    from the round's per-tile partials — O(n/tile + tile) reads per draw,
    the same distribution) and 'rejection' (exact rejection sampling from
    the stale envelope of the last refresh, which runs every
    ``refresh_block`` seeds: a round in between touches only the drawn
    row; ``refresh_block=1`` picks bitwise the 'tiled' seeds — see
    :func:`_seed_rejection_loop`). ``proposal`` (rejection only) is 'hier'
    (super-tile -> tile -> row, the per-tile envelope tightened between
    refreshes by the caps of ``Backend.tile_cap``) or 'flat' (the tiled
    draw); ``max_attempts`` truncates the attempts of a round, past which
    it takes one exact draw; ``fault`` injects an envelope fault (tests).
    The prologue runs once here unless a ``cache`` is passed in
    (``kmeans_points`` shares one across both phases). With ``bound_gate``
    the loop carries the per-tile bound state so each round skips every
    provably unchanged tile and prunes provably stable points inside
    active tiles; the results are bitwise those of the ungated loop (for
    'hier', which tightens only with the tile balls, the draws differ).

    ``points`` (B, n, d) seeds B independent problems in one loop, one
    ``seed_round_batched`` per round, from batched ``draws``
    (``Draws.sample_batched``): ungated, 'cdf' or 'tiled', with no in-flight
    guard (the reference turns it off under ``vmap``). Row b of every
    field is bitwise the single seeding of problem b with ``draws[b]``."""
    if proposal not in ("flat", "hier"):
        raise ValueError(f"unknown proposal {proposal!r}; "
                         "expected 'flat' or 'hier'")
    _check_sampler(sampler)
    lead = tuple(points.shape[:-2])
    if lead and (bound_gate or guard or sampler == "rejection"):
        raise NotImplementedError(
            "batched seeding runs ungated cdf or tiled rounds without the "
            "in-flight guard; the gated batched round (K8) and batched "
            "rejection seeding are not ported yet")
    n, d = points.shape[-2:]
    pts = points.float()
    if cache is None:
        cache = backend.prologue(pts, with_bounds=bound_gate)
    tile = backend.seed_tile(n, d)
    if draws.u.shape[-1] < k - 1 or draws.fallback.shape[-1] < k - 1:
        raise ValueError(f"draws hold {draws.u.shape[-1]} rounds, seeding "
                         f"k={k} needs {k - 1}")
    if tuple(draws.u.shape[:-1]) != lead:
        raise ValueError(f"draws for {tuple(draws.u.shape[:-1])} problems, "
                         f"points for {lead}")
    init_state = None
    if bound_gate and cache.centers is not None:
        n_tiles = -(-n // tile)
        init_state = BoundState(
            torch.zeros(n_tiles, device=pts.device),
            torch.full((n_tiles,), torch.inf, device=pts.device))

    if sampler == "rejection":
        if draws.exact_u is None or draws.max_attempts < max_attempts:
            raise ValueError(f"draws hold {draws.max_attempts} rejection "
                             f"attempts per round, max_attempts="
                             f"{max_attempts} needs them all")
        return _seed_rejection(draws.to(pts.device), pts, k, backend, cache,
                               tile, init_state, refresh_block=refresh_block,
                               proposal=proposal, max_attempts=max_attempts,
                               guard=guard, fault=fault)

    if sampler == "tiled":
        def sample_fn(u, fb, weight, partials):
            return sampling.categorical_tiled(u, fb, weight, partials,
                                              block_n=tile)
    else:
        # the cdf sampler normalizes by its OWN prefix sum's last entry, not
        # by the round's total: the two sum in different orders, and a
        # 1-ulp difference in the scale would flip boundary samples between
        # backends
        def sample_fn(u, fb, weight, partials):
            return sampling.categorical_cdf(u, fb, weight)

    if lead:
        def round_fn(c, md, st):
            return backend.seed_round_batched(pts, c, md, cache=cache)
    else:
        def round_fn(c, md, st):
            return backend.seed_round(pts, c, md, cache=cache, state=st)

    centroids, indices, min_d2, skips, prunes, rec = _seed_loop(
        draws.to(pts.device), pts, k, round_fn=round_fn,
        sample_fn=sample_fn,
        init_min_d2=torch.full(lead + (n,), torch.inf, device=pts.device),
        init_state=init_state, guard=guard, tile=tile)
    return KmeansppResult(centroids, indices, min_d2, skips, prunes,
                          recovered=rec if guard else None)


def _check_sampler(sampler: str) -> None:
    if sampler == "gumbel":
        raise NotImplementedError("sampler 'gumbel' is not ported yet; use "
                                  "'cdf', 'tiled' or 'rejection'")
    if sampler not in ("cdf", "tiled", "rejection"):
        raise ValueError(f"unknown sampler {sampler!r}; expected 'cdf', "
                         "'tiled' or 'rejection'")


# ---------------------------------------------------------------------------
# Lloyd
# ---------------------------------------------------------------------------


def _fit_loop(pts, init_centroids, backend: Backend, max_iters: int,
              tol: float, empty: str, cache: RoundCache, *, gated: bool,
              guard: bool):
    """Lloyd iterations until the relative inertia improvement falls below
    ``tol`` or ``max_iters`` is hit. Each iteration is one tiled
    ``assign_update``; the inertia is the sum of its per-tile partials, the
    centroid update the super-axis sum of its accumulators.

    ``gated`` (the port of ``_fit_gated_parts``) derives each iteration's
    per-centroid movement ``delta`` from the loop's own consecutive
    centroids and threads a ``BoundState`` through ``assign_update``, which
    skips every tile the movement bound proves unchanged — exactly, so the
    results are bitwise the ungated loop's.

    ``guard`` (gated loops only, as in the reference) adds the in-flight
    corruption detector: each iteration checks its inertia for finiteness
    and its count mass against n. On a trip the carried bound state is
    DISCARDED and the iteration re-runs ungated from the same centroids; the
    per-point bounds restart pessimistic (-inf point_lb, zero debt), so
    later iterations prune less but compute the same bits. ``recovered[i]``
    records the trip. The guard's checks and the next iteration's
    convergence test are read in one host sync.

    Batched problems (``pts`` (B, n, d), ungated) run one
    ``assign_update_batched`` per iteration for all B. Each problem takes
    its own convergence test, and a problem that has stopped keeps its
    centroids, assignment, inertia and ``n_iters`` from then on (what the
    reference's vmapped ``while_loop`` selects); the loop runs until every
    problem has stopped, one host sync per iteration reading the (B,)
    flags. The inertia is the fixed-order sum of the per-tile partials
    (``sampling.fixed_sum``), so row b's is bitwise the single problem's.

    Returns (centroids, assignment, inertia, n_iters, skipped, pruned,
    recovered); the counters are None when the loop is not gated, and
    ``recovered`` also when the guard is off. ``n_iters`` is an int, or
    (B,) int32 when batched."""
    n, d = pts.shape[-2:]
    lead = tuple(pts.shape[:-2])
    k = init_centroids.shape[-2]
    dev = pts.device
    guard = guard and gated
    bstate = skips = prunes = None
    if gated:
        tile = backend.seed_tile(n, d, k)
        n_tiles = -(-n // tile)
        n_super = -(-n_tiles // backend.tiles_per_super(n_tiles))

        def fresh_bounds(st: BoundState) -> BoundState:
            return st._replace(
                point_lb=torch.full((n,), -torch.inf, device=dev),
                lb_debt=torch.zeros(n_tiles, device=dev))

        bstate = fresh_bounds(BoundState(
            torch.zeros(n_tiles, device=dev),
            tile_gap=torch.full((n_tiles,), -torch.inf, device=dev),
            tile_sums=torch.zeros((n_super, k, d), device=dev),
            tile_counts=torch.zeros((n_super, k), device=dev),
            assignment=torch.zeros(n, dtype=torch.int32, device=dev),
            min_d2=torch.zeros(n, device=dev)))
        skips = torch.zeros(max_iters, dtype=torch.int32, device=dev)
        prunes = torch.zeros(max_iters, dtype=torch.int32, device=dev)
    cents = prev_cents = init_centroids.float()
    inertia = torch.full(lead, torch.inf, device=dev)
    a = torch.zeros(lead + (n,), dtype=torch.int32, device=dev)
    rec = [0] * max_iters
    live = n_iters = None
    if lead:   # the problems still iterating, and each one's count
        live = torch.ones(lead, dtype=torch.bool, device=dev)
        n_iters = torch.zeros(lead, dtype=torch.int32, device=dev)

    def improves(new_inertia) -> torch.Tensor:
        return (inertia - new_inertia) / inertia.clamp_min(1e-30) > tol

    i = 0
    while i < max_iters:
        if lead:
            rnd = backend.assign_update_batched(pts, cents, cache=cache)
        else:
            delta = (bounds.centroid_movement(cents, prev_cents) if gated
                     else None)
            rnd = backend.assign_update(pts, cents, cache=cache,
                                        state=bstate, delta=delta)
        new_inertia = sampling.fixed_sum(rnd.state.partials)
        flags = []
        if guard:
            flags.append(torch.isfinite(new_inertia)
                         & ((rnd.counts.sum() - n).abs() < 0.5))
        test = 2 <= i + 1 < max_iters     # does iteration i + 1 test?
        if test:
            go = improves(new_inertia)
            flags.append(go if live is None else live & go)
        # one host sync per iteration: the guard's checks + convergence
        got = (torch.cat([f.reshape(-1) for f in flags]).tolist()
               if flags else [])
        go_on = any(got[int(guard):]) if test else True
        if guard and not got[0]:
            r2 = backend.assign_update(pts, cents, cache=cache)
            rnd = AssignRound(r2.assignment, r2.min_d2, r2.sums, r2.counts,
                              fresh_bounds(r2.state))
            new_inertia = sampling.fixed_sum(r2.state.partials)
            go_on = bool(improves(new_inertia)) if test else True
            rec[i] = 1
        if gated:
            skips[i], prunes[i] = rnd.skipped, rnd.pruned
            bstate = rnd.state
        new_cents = centroid_means(rnd.sums, rnd.counts, cents)
        if empty == "reseed":
            new_cents = reseed_split_largest(new_cents, rnd.counts)
        if live is None:
            prev_cents, cents, inertia, a = (cents, new_cents, new_inertia,
                                             rnd.assignment)
        else:   # a problem that has stopped keeps its results
            cents = torch.where(live[..., None, None], new_cents, cents)
            inertia = torch.where(live, new_inertia, inertia)
            a = torch.where(live[..., None], rnd.assignment, a)
            n_iters = n_iters + live.int()
            if test:
                live = flags[-1]
        i += 1
        if not go_on:
            break
    return (cents, a, inertia, i if live is None else n_iters, skips, prunes,
            torch.tensor(rec, dtype=torch.int32) if guard else None)


def fit_points(points: torch.Tensor, init_centroids: torch.Tensor,
               backend: Backend, max_iters: int, tol: float,
               empty: str = "keep",
               cache: Optional[RoundCache] = None, *,
               bound_gate: bool = True, guard: bool = False) -> LloydResult:
    """Lloyd clustering through ``backend``. ``empty`` picks the
    empty-cluster policy: 'keep' (previous centroid survives) or 'reseed'
    (split the largest cluster). ``cache`` is an optional precomputed
    prologue. ``bound_gate`` runs the gated loop (bitwise the ungated
    results); ``guard`` arms its in-flight corruption detector.

    ``points`` (B, n, d) and ``init_centroids`` (B, k, d) fit B independent
    problems in one loop, ungated; every field of the result gains the
    leading axis and ``n_iters`` is (B,) int32, each problem's own."""
    if empty not in ("keep", "reseed"):
        raise ValueError(f"unknown empty-cluster policy {empty!r}; "
                         "expected 'keep' or 'reseed'")
    if points.dim() == 3 and bound_gate:
        raise NotImplementedError(
            "batched fits run ungated; the gated batched assignment round "
            "(K10b) is not ported yet")
    pts = points.float()
    k = init_centroids.shape[-2]
    if cache is None:
        cache = backend.prologue(pts, m=k, with_bounds=bound_gate)
    return LloydResult(*_fit_loop(
        pts, init_centroids, backend, max_iters, tol, empty, cache,
        gated=bound_gate and cache.centers is not None, guard=guard))


def kmeans_points(draws: Draws, points: torch.Tensor, k: int,
                  backend: Backend, sampler: str = "cdf",
                  max_iters: int = 50, tol: float = 1e-6,
                  empty: str = "keep", *, bound_gate: bool = True,
                  guard: bool = False, refresh_block: int = 8,
                  proposal: str = "hier",
                  max_attempts: int = _REJECT_ATTEMPTS) -> LloydResult:
    """End-to-end k-means++ seeding + Lloyd with ONE shared prologue: the
    backend's ``tile_m`` is pinned to k so both phases agree on one tile
    geometry, and the norms (and tile balls, with ``bound_gate``) are
    computed once."""
    be = dataclasses.replace(backend, tile_m=k)
    pts = points.float()
    cache = be.prologue(pts, m=k, with_bounds=bound_gate)
    seeds = seed_points(draws, pts, k, be, sampler, bound_gate=bound_gate,
                        cache=cache, guard=guard,
                        refresh_block=refresh_block, proposal=proposal,
                        max_attempts=max_attempts)
    return fit_points(pts, seeds.centroids, be, max_iters, tol, empty,
                      cache=cache, bound_gate=bound_gate, guard=guard)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device. Without a card
    and without ``device=`` this raises: nothing runs silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           "is available")
    return device


class ClusterEngine:
    """One engine for seeding + clustering over a pluggable Backend.

    >>> eng = ClusterEngine(device="cuda")
    >>> res = eng.kmeans(points, k=50, generator=torch.Generator().manual_seed(0))

    Backends: 'cuda' (the Hopper kernels, the default), 'fused' (their
    plain torch twins), 'reference' (global-memory seeding semantics).
    ``device`` defaults to the card. ``bounds`` (default True) carries the
    bound state through the seeding and Lloyd loops, so each round skips
    every tile (and point) the triangle-inequality or movement bound proves
    unchanged; skipping is exact, the fp32 results are bitwise those of
    ``bounds=False``, and the per-round counts come back in ``skipped`` and
    ``pruned``. ``validate`` is the entry guard policy ('raise', 'sanitize'
    or 'off'); any setting other than 'off' also arms the in-flight guards
    of the seeding loop and of the gated Lloyd loop, which heal a corrupted
    round and record it in ``recovered``.

    Samplers: 'cdf', 'tiled' and 'rejection' (with ``refresh_block``,
    ``proposal`` 'hier' or 'flat' and ``max_attempts``; see
    :func:`seed_points`).

    Randomness: ``generator`` seeds a :class:`Draws` source for the run;
    ``draws`` passes one in instead (to replay a run, or the reference's
    key schedule). A kernel that fails to build or launch raises
    ``KernelFailureError``; there is no fallback backend.

    Batched problems: ``seed_batched``, ``fit_batched`` and
    ``kmeans_batched`` take (B, n, d) points and return results with a
    leading (B,) axis, row b bitwise the single problem's; they need
    ``bounds=False`` and the cdf or tiled sampler (the gated batched
    kernels and batched rejection seeding are not ported yet).
    """

    def __init__(self, backend: Union[str, Backend] = "cuda", *,
                 device=None, bounds: bool = True, validate: str = "raise",
                 **backend_opts):
        self.backend = make_backend(backend, **backend_opts)
        self.bounds = bool(bounds)
        self.device = resolve_device(device)
        self.validate = guards.check_policy(validate)
        self._guard = validate != "off"

    def _points(self, points) -> torch.Tensor:
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        if pts.dim() != 2:
            raise guards.InvalidInputError(
                f"points must be (n, d), got {tuple(pts.shape)}")
        return guards.guard_points(pts.contiguous(), self.validate)

    def _draws(self, n, k, generator, draws, sampler,
               max_attempts) -> Draws:
        if draws is None:
            return Draws.sample(
                n, k, generator=generator, device=self.device,
                max_attempts=(max(int(max_attempts), 1)
                              if sampler == "rejection" else 0))
        return draws.to(self.device)

    def seed(self, points, k: int, *,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None,
             sampler: str = "cdf", refresh_block: int = 8,
             proposal: str = "hier",
             max_attempts: int = _REJECT_ATTEMPTS) -> KmeansppResult:
        """K-means++ seeding: k centroids chosen from ``points`` ∝ D².
        ``refresh_block``, ``proposal`` and ``max_attempts`` are the
        rejection sampler's (see :func:`seed_points`)."""
        pts = self._points(points)
        guards.check_shape(k, pts.shape[0])
        return seed_points(
            self._draws(pts.shape[0], k, generator, draws, sampler,
                        max_attempts),
            pts, k, self.backend, sampler, bound_gate=self.bounds,
            guard=self._guard, refresh_block=int(refresh_block),
            proposal=proposal, max_attempts=int(max_attempts))

    def fit(self, points, init_centroids, *, max_iters: int = 50,
            tol: float = 1e-6, empty: str = "keep") -> LloydResult:
        """Lloyd iterations from ``init_centroids`` until convergence."""
        pts = self._points(points)
        cents = torch.as_tensor(init_centroids, dtype=torch.float32,
                                device=self.device)
        cents = guards.guard_centroids(cents, pts.shape[1], self.validate)
        return fit_points(pts, cents, self.backend, max_iters, float(tol),
                          empty, bound_gate=self.bounds, guard=self._guard)

    def kmeans(self, points, k: int, *,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Draws] = None, sampler: str = "cdf",
               max_iters: int = 50, tol: float = 1e-6,
               empty: str = "keep", refresh_block: int = 8,
               proposal: str = "hier",
               max_attempts: int = _REJECT_ATTEMPTS) -> LloydResult:
        """End to end: k-means++ seeding (the paper's phase) + Lloyd, sharing
        one prologue."""
        pts = self._points(points)
        guards.check_shape(k, pts.shape[0])
        return kmeans_points(
            self._draws(pts.shape[0], k, generator, draws, sampler,
                        max_attempts),
            pts, k, self.backend, sampler, max_iters, float(tol), empty,
            bound_gate=self.bounds, guard=self._guard,
            refresh_block=int(refresh_block), proposal=proposal,
            max_attempts=int(max_attempts))

    # -- batched multi-problem clustering ---------------------------------

    def _batched(self, points, sampler: str = "cdf") -> torch.Tensor:
        """The (B, n, d) points of a batched call, after the entry guard;
        raises for what the batched path does not run yet."""
        _check_sampler(sampler)
        if self.bounds:
            raise NotImplementedError(
                "batched problems with bounds=True need the gated batched "
                "kernels K8 and K10b, which the next port slice brings; "
                "pass bounds=False")
        if sampler == "rejection":
            raise NotImplementedError(
                "batched rejection seeding is not ported yet (it follows "
                "the gated batched slice); use sampler='cdf' or 'tiled'")
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        if pts.dim() != 3:
            raise guards.InvalidInputError(
                f"points must be (B, n, d), got {tuple(pts.shape)}")
        return guards.guard_points(pts.contiguous(), self.validate)

    def seed_batched(self, points, k: int, *,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Draws] = None,
                     sampler: str = "cdf") -> KmeansppResult:
        """Seed B independent (n, d) problems, one seeding round for all B
        per round (K7 on the card). ``draws`` are batched
        (``Draws.sample_batched``); problem b picks exactly the seeds
        ``seed`` picks with ``draws[b]``. No in-flight guard, as in the
        reference under ``vmap``; the entry guard covers all B."""
        pts = self._batched(points, sampler)
        bsz, n, _ = pts.shape
        guards.check_shape(k, n)
        if draws is None:
            draws = Draws.sample_batched(bsz, n, k, generator=generator)
        return seed_points(draws.to(self.device), pts, k, self.backend,
                           sampler, bound_gate=False)

    def fit_batched(self, points, init_centroids, *, max_iters: int = 50,
                    tol: float = 1e-6, empty: str = "keep") -> LloydResult:
        """Lloyd over B independent problems: points (B, n, d), inits
        (B, k, d), one assignment round for all B per iteration (K10a on
        the card). Each problem stops at its own convergence test and keeps
        its results from then on; ``n_iters`` is (B,), each problem's
        own."""
        pts = self._batched(points)
        cents = torch.as_tensor(init_centroids, dtype=torch.float32,
                                device=self.device)
        if cents.dim() != 3 or cents.shape[0] != pts.shape[0]:
            raise guards.InvalidInputError(
                f"init_centroids must be ({pts.shape[0]}, k, d), got "
                f"{tuple(cents.shape)}")
        cents = guards.guard_centroids(cents, pts.shape[-1], self.validate)
        return fit_points(pts, cents, self.backend, max_iters, float(tol),
                          empty, bound_gate=False)

    def kmeans_batched(self, points, k: int, *,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Draws] = None, max_iters: int = 50,
                       tol: float = 1e-6, sampler: str = "cdf",
                       empty: str = "keep") -> LloydResult:
        """``seed_batched`` then ``fit_batched``, each with its own prologue
        and tile geometry, as in the reference (unlike ``kmeans``, which
        shares one prologue at the fit's tile height)."""
        seeds = self.seed_batched(points, k, generator=generator,
                                  draws=draws, sampler=sampler)
        return self.fit_batched(points, seeds.centroids, max_iters=max_iters,
                                tol=tol, empty=empty)
