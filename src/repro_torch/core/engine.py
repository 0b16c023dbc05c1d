"""ClusterEngine — k-means++ seeding and Lloyd over a pluggable Backend
(port of ``repro.core.engine``: the ungated and the bound-gated paths,
rejection seeding, batched problems, gated or not, and the weighted and
mini-batch fits).

A ``Backend`` provides the round primitives the algorithms are written
against:

  prologue(points, m, with_bounds) -> RoundCache: the once-per-call pass
      (cached norms, plus the tile balls the gates read).
  seed_round(points, c_new, min_d2, cache=, state=, consume=) ->
      SeedRound(min_d2', total, partials, tile_max, skipped, pruned): fold
      the new centroid block into every point's D² and return the sum (the
      paper's min-update kernel + thrust::reduce) plus the per-tile partial
      sums the ``tiled`` sampler draws from; with a carried ``state`` the
      round skips every tile (and point) the triangle-inequality bound
      proves unchanged. ``consume`` says the caller never reads ``min_d2``
      again, so the round may write the new D² into it (the card's gated
      rounds do: the TPU kernel's aliasing).
  assign_update(points, centroids, cache=, state=, delta=) ->
      AssignRound(assignment, min_d2, sums, counts, state, skipped, pruned):
      one Lloyd half-step in the tiled form (per-tile inertia partials and
      gaps, per-super-tile cluster sums); with ``state`` and the centroid
      movement ``delta`` it skips what the movement bound proves unchanged.
      Without a cache it is the untiled round of the weighted and
      mini-batch fits: labels, D², and the (weighted) cluster sums and
      counts over all rows.
  row_min_d2(points, idx, pending, count) / tile_envelope(centers, radii,
      pending, count, partials, tile_w): the rejection sampler's D² of the
      drawn rows (every attempt of a round at once), and a hier round's
      tile envelope (cap, ph, tight, n_tight): the per-tile caps against
      the first ``count`` pending centroids and the capped tile masses
      (one launch on the card).
  seed_round_batched / assign_update_batched: the rounds of B independent
      problems at once, every tensor with a leading problem axis, gated
      like the single rounds when given a carried state (each problem by
      its own masks); row b is bitwise the single round on problem b.
  seed_round_listed: the batched seeding round on a list of the batch's
      problems only, in place into the carries (batched rejection
      seeding's refreshes; one K8 or K7 launch on the card).

Gating is exact: the fp32 results are bitwise those of ``bounds=False``.

Precision: ``precision="bf16"`` streams a bf16 copy of the points, made
once per call (``_stream_of``), through every seeding and assignment round,
each round's centroids rounded to bf16 with it; the kernels widen both
exactly and keep fp32 arithmetic. The norms (from the prologue, over the
fp32 points), D², the bound state, the accumulators and the centroid carry
stay fp32, seeds are taken from the fp32 points, the rejection sampler's
row D² reads them, and the centroids come back fp32, as in the reference.
Under bf16 the gate suppresses bf16-noise updates that its bound proves
spurious, so gated and ungated results may differ there, as the
reference's do; the bitwise gated == ungated guarantee is fp32's.

``CudaBackend`` runs them through the hand-written kernels (K1 prologue, K2
and K5 seeding rounds, K3 and K6 assignment rounds, K4 the untiled one;
for batched problems K1's batched form, K7 and K8 (also over a list of the
batch's problems), K10a and K10b; K11 and K12 for rejection seeding, single
or batched); ``FusedBackend`` runs the kernels' plain torch
twins; ``ReferenceBackend`` is the global-memory (two-pass) seeding
semantics.

Weights (``weights=`` on seeding, fit and kmeans) weigh each point's D²
in the seeding draws, first seed included, and its entry in the Lloyd
update. A weighted fit runs the untiled round, ungated, as the reference's
does; a weighted seeding round on the card runs K2 ungated and skips
nothing, as the reference's Pallas backend does, while the plain backends
gate it through the gate model with the weights.

Batched problems (``seed_batched``, ``fit_batched``, ``kmeans_batched``) run
through the same seeding and Lloyd loops as one problem, with the leading
problem axis on every carry, the bound state and the skip/prune counters
included; each problem stops Lloyd at its own convergence test and is
frozen from then on. Batched rejection seeding refreshes each problem on
its own schedule (``seed_round_listed``: one launch over the problems whose
pending block filled, in place).
Loops are Python loops over device tensors: a sampled index, a gate mask
and a skip count never leave the device (the rejection loop reads one
validity bit and one first accepting attempt per round, a (B,) vector of
each when batched).

Robustness: the seeding and Lloyd loops are built as parts
(``_seed_parts``: make_init, body, finish over a :class:`SeedCarry`;
``_fit_parts``: make_init, step, stopped, finish over a
:class:`FitCarry`), which the one-shot loops run to the end and
``seed``/``fit(..., checkpoint_dir=)`` run in chunks, saving the carry
between chunks (``repro_torch.checkpoint``), so a checkpointed or resumed
run is bitwise the plain one. ``_fault=`` on ``seed``/``fit`` poisons the
loops' carries at one round (``repro_torch.testing.FaultSpec``), which the
in-flight guards heal.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Callable, ClassVar, Iterable, NamedTuple, Optional, Union

import torch

from repro_torch.core import bounds, guards, sampling
from repro_torch.core.bounds import BoundState, RoundCache
from repro_torch.core.sampling import Draws
from repro_torch.data import ordering
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
    reorder: Optional[torch.Tensor] = None    # (n,) int32 row permutation
    #                                           the kernels saw (None:
    #                                           natural order)
    # same contract as KmeansppResult: slots past n_iters are zero, and all
    # three counters are None when gating is off; ``assignment`` is always
    # in the caller's row order


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


def segment_update(points: torch.Tensor, assignment: torch.Tensor, k: int,
                   weights: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster (weighted) sums and counts of the rows of each label,
    each cluster's rows added in one fixed order (``sampling.segment_sum``),
    so the bits are the same on every run."""
    pts = points.float()
    w = (pts.new_ones(pts.shape[0]) if weights is None
         else weights.to(pts))
    tot = sampling.segment_sum(torch.cat([pts * w[:, None], w[:, None]], 1),
                               assignment, k)
    return tot[:, :-1], tot[:, -1]


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


def _weigh(md: torch.Tensor, weights: Optional[torch.Tensor]):
    """D² weighted by point (the sampling weights of a weighted run)."""
    return md if weights is None else md * weights


def _weighted(weights: Optional[torch.Tensor]) -> dict:
    """The ``weights=`` keyword of a weighted round, none for an unweighted
    one (so a backend written before weights still serves it)."""
    return {} if weights is None else {"weights": weights}


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


def _problem(x, b: int):
    """Problem b's slice of a batched ``RoundCache`` or ``BoundState``
    (None stays None)."""
    return None if x is None else type(x)(
        *(None if f is None else f[b] for f in x))


def _seed_skipped(active: torch.Tensor) -> torch.Tensor:
    """() int32 tiles a gated seeding round skipped ((B,) when batched),
    with the floor of one computed tile per problem that
    ``bounds.n_active`` defines."""
    return active.shape[-1] - bounds.n_active(active)


def _gate_model(new_md_full, min_d2, c_new, cache: RoundCache,
                state: BoundState, tile: int, weights=None) -> SeedRound:
    """Plain model of the gated seeding kernel, shared by the reference and
    fused backends: tiles the bound proves unchanged take their ``min_d2``
    slice and partial/tile-max entries from the CARRIED state instead of the
    fresh compute, and inside ACTIVE tiles the per-point bound keeps every
    row whose min-update provably cannot fire — what K5's carried outputs
    and in-kernel prune do. In fp32 the selects are value-noops unless the
    bound were wrong. ``weights`` weigh the partials."""
    active, dc, margin = bounds.seed_gate(c_new, cache, state.tile_max)
    md, partials, tile_max, pruned = kmeans_distance.gate_select(
        new_md_full, min_d2, cache.center_d, dc, margin, state.partials,
        state.tile_max, active, block_n=tile, weights=weights)
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
                   state: Optional[BoundState] = None,
                   weights: Optional[torch.Tensor] = None,
                   consume: bool = False) -> SeedRound:
        """One seeding round; ``weights`` (n,) weigh the partials (and the
        total) by point; ``consume``: the caller never reads ``min_d2``
        again, so the round may overwrite it."""
        raise NotImplementedError

    def assign_update(self, points, centroids, *,
                      cache: Optional[RoundCache] = None,
                      state: Optional[BoundState] = None,
                      delta: Optional[torch.Tensor] = None,
                      weights: Optional[torch.Tensor] = None,
                      norms: Optional[torch.Tensor] = None) -> AssignRound:
        """One Lloyd half-step in the tiled form. With ``state`` and
        ``delta`` (the per-centroid movement since the last round) it gates
        on the movement bound: the skip mask is expanded to whole super-tiles
        (the accumulators are carried at super granularity), and inside
        active tiles the per-point Hamerly bound short-circuits provably
        stable points — both value-noops, counted in ``skipped``/``pruned``.

        Without a ``cache`` it is the untiled round (``_assign_plain``) of
        the weighted and mini-batch fits, on ``norms`` (computed when
        absent), the sums and counts over all rows weighted by ``weights``.
        """
        if cache is None:
            if norms is None:
                norms = bounds.point_norms(points)
            return AssignRound(*self._assign_plain(points, centroids,
                                                   weights, norms))
        n = points.shape[0]
        tile = self.seed_tile(n, points.shape[1], centroids.shape[0])
        tps = self.tiles_per_super(-(-n // tile))
        if delta is not None and _gates(state, cache):
            return self._assign_update_gated(points, centroids, cache, state,
                                             delta, tile, tps,
                                             self._assign_gated)
        return _ungated_round(*self._assign_tiled(
            points, cache.norms, centroids, tile, tps))

    def seed_round_batched(self, points, c_new, min_d2, *,
                           cache: RoundCache,
                           state: Optional[BoundState] = None,
                           consume: bool = False) -> SeedRound:
        """One seeding round of B independent problems: points (B, n, d),
        c_new (B, m, d), min_d2 and ``cache.norms`` (B, n), and with a
        carried ``state`` (B, T) the gated round, each problem by its own
        masks. The fields of the ``SeedRound`` gain the leading axis; row b
        is bitwise ``seed_round`` on problem b (here: that round per
        problem)."""
        rounds = [self.seed_round(p, c, md, cache=_problem(cache, b),
                                  state=_problem(state, b), consume=consume)
                  for b, (p, c, md) in enumerate(zip(points, c_new, min_d2))]
        width = 6 if _gates(state, cache) else 3
        return SeedRound(*(torch.stack(f)
                           for f in zip(*(r[:width] for r in rounds))))

    def seed_round_listed(self, points, c_new, min_d2, partials, *,
                          cache: RoundCache, problems: torch.Tensor,
                          state: Optional[BoundState] = None) -> SeedRound:
        """One seeding round of the LISTED problems of a batch, in place:
        ``problems`` (R,) int32 device indices into the batch (each at most
        once), the other arguments those of :meth:`seed_round_batched`,
        and ``partials`` the (B, T) carry (gated: ``state.partials``
        itself). The listed problems' rows of ``min_d2``, ``partials`` and
        (gated) ``state.tile_max`` are rewritten, bitwise the batched round
        on them; the other rows are not touched. Returns the carries as a
        ``SeedRound`` (no total), gated with (B,) skipped and pruned counts
        (0 off the list). Here: the batched round on the listed problems'
        slices, written back."""
        rows = problems.long()

        def sub(x):
            return None if x is None else type(x)(
                *(None if f is None else f.index_select(0, rows) for f in x))

        st = None if state is None else BoundState(
            state.partials.index_select(0, rows),
            state.tile_max.index_select(0, rows))
        rnd = self.seed_round_batched(
            points.index_select(0, rows), c_new.index_select(0, rows),
            min_d2.index_select(0, rows), cache=sub(cache), state=st)
        min_d2.index_copy_(0, rows, rnd.min_d2)
        partials.index_copy_(0, rows, rnd.partials)
        if not _gates(state, cache):
            return SeedRound(min_d2, None, partials)
        state.tile_max.index_copy_(0, rows, rnd.tile_max)
        zero = torch.zeros(min_d2.shape[:1], dtype=torch.int32,
                           device=min_d2.device)
        return SeedRound(min_d2, None, partials, state.tile_max,
                         zero.index_copy(0, rows, rnd.skipped),
                         zero.index_copy(0, rows, rnd.pruned))

    def assign_update_batched(self, points, centroids, *, cache: RoundCache,
                              state: Optional[BoundState] = None,
                              delta: Optional[torch.Tensor] = None,
                              live: Optional[torch.Tensor] = None
                              ) -> AssignRound:
        """One Lloyd half-step of B independent problems: points (B, n, d),
        centroids (B, k, d), ``cache.norms`` (B, n), at the single problem's
        tile geometry. With a carried ``state`` and the movement ``delta``
        (B, k) it gates as ``assign_update`` does, each problem on its own
        masks; ``live`` (B,) bool marks the problems still iterating, and a
        problem that is not computes no tile (its carries stay). The fields
        of the ``AssignRound`` gain the leading axis; row b of a live
        problem is bitwise ``assign_update`` on problem b."""
        n, d = points.shape[-2:]
        tile = self.seed_tile(n, d, centroids.shape[-2])
        tps = self.tiles_per_super(-(-n // tile))
        if delta is not None and _gates(state, cache):
            return self._assign_update_gated(points, centroids, cache, state,
                                             delta, tile, tps,
                                             self._assign_gated_batched, live)
        return _ungated_round(*self._assign_tiled_batched(
            points, cache.norms, centroids, tile, tps))

    def _assign_tiled_batched(self, points, norms, centroids, tile, tps):
        return lloyd_assign.lloyd_assign_tiled_batched_torch(
            points, norms, centroids, block_n=tile, tps=tps)

    def _assign_plain(self, points, centroids, weights, norms):
        """(labels, min_d2, sums, counts) of the untiled round: K4's plain
        twin."""
        return lloyd_assign.lloyd_assign_torch(points, norms, centroids,
                                               weights)

    @staticmethod
    def _assign_update_gated(points, centroids, cache, state, delta, tile,
                             tps, assign_gated, live=None) -> AssignRound:
        """The gated round, one problem or B (every array and the movement
        ``delta`` with a leading axis; each problem's own maximum movement,
        masks, floor and counters). ``assign_gated`` is the kernel call."""
        dmax = delta.amax(dim=-1, keepdim=True)
        cand = bounds.assign_active_tiles(delta, centroids, state, cache,
                                          tps=tps)
        # expanded HERE (the kernel wrapper re-aligns, idempotently) so the
        # gap decay and debt below see exactly the tiles the round rewrote
        active = bounds.expand_active_supers(cand, tps)
        if live is not None:   # a stopped problem computes nothing
            active = active & live[..., None]
        thresh, absorb = bounds.assign_point_scalars(delta, centroids, state,
                                                     cache)
        a, md, lb, part, gap, ssums, scounts, pruned = assign_gated(
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
                           (~active).sum(dim=-1).to(torch.int32),
                           pruned.sum(dim=-1).to(torch.int32))

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

    def _assign_gated_batched(self, points, norms, centroids, delta, thresh,
                              absorb, state, active, tile, tps):
        return lloyd_assign.lloyd_assign_gated_batched_torch(
            points, norms, centroids, delta, thresh, absorb,
            state.assignment, state.min_d2, state.point_lb, state.partials,
            state.tile_gap, state.tile_sums, state.tile_counts, active,
            block_n=tile, tps=tps)

    def prologue(self, points, m: int = 1,
                 with_bounds: bool = True) -> RoundCache:
        """Once-per-call pass: the cached fp32 norms every round streams,
        plus the tile balls when bound gating is on. Batched points
        (B, n, d) give every field a leading problem axis."""
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
        """D² of each row ``idx`` (device indices, 0-d or (A,), the result
        the same shape) to the nearest of ``pending[:count]``, +inf when
        count is 0 — the rejection sampler's exact p, O(A·P·d) work
        whatever n is."""
        return kmeans_distance.row_min_d2_torch(points, idx, pending, count)

    def tile_envelope(self, centers, radii, pending, count, partials,
                      tile_w):
        """A hier round's tile envelope: ``(cap, ph, tight, n_tight)``,
        the (T,) caps ``(d(center_t, pending) + r_t)²`` against
        ``pending[:count]`` from the prologue's tile balls (never a row;
        +inf everywhere when count is 0), the tile masses ``ph = min(cap ·
        tile_w, partials)`` (a NaN product keeps the partial), ``tight = ph
        < partials`` and its (0-d int32) count."""
        return kmeans_distance.tile_envelope_torch(centers, radii, pending,
                                                   count, partials, tile_w)


@dataclasses.dataclass(frozen=True)
class ReferenceBackend(Backend):
    """The paper's global-memory variant: the min-update is materialized and
    re-read by a second reduction pass (the serial mode is not ported)."""

    name: ClassVar[str] = "reference"

    def seed_round(self, points, c_new, min_d2, *, cache, state=None,
                   weights=None, consume=False):
        n, d = points.shape
        tile = self.seed_tile(n, d, c_new.shape[0])
        new_md = torch.minimum(min_d2, _min_d2_to(points, c_new))
        if _gates(state, cache):
            rnd = _gate_model(new_md, min_d2, c_new, cache, state, tile,
                              weights)
            # keep the two-pass total: a sum over the materialized array,
            # not over the partial tree
            return rnd._replace(total=_weigh(rnd.min_d2, weights).sum())
        wmd = _weigh(new_md, weights)
        return SeedRound(new_md, wmd.sum(), sampling.tile_partials(wmd, tile))

    def _assign_plain(self, points, centroids, weights, norms):
        d2 = pairwise_d2(points.float(), centroids.float())
        a = d2.argmin(dim=1)
        sums, counts = segment_update(points, a, centroids.shape[0], weights)
        return a.int(), d2.amin(dim=1), sums, counts


@dataclasses.dataclass(frozen=True)
class FusedBackend(Backend):
    """The kernels' plain torch twins (cached-norm matmul form)."""

    name: ClassVar[str] = "fused"

    def seed_round(self, points, c_new, min_d2, *, cache, state=None,
                   weights=None, consume=False):
        n, d = points.shape
        tile = self.seed_tile(n, d, c_new.shape[0])
        new_md, partials = kmeans_distance.distance_min_update_torch(
            points, cache.norms, c_new, min_d2, block_n=tile)
        if _gates(state, cache):
            return _gate_model(new_md, min_d2, c_new, cache, state, tile,
                               weights)
        if weights is not None:
            partials = sampling.tile_partials(new_md * weights, tile)
        return SeedRound(new_md, partials.sum(), partials)


@dataclasses.dataclass(frozen=True)
class CudaBackend(Backend):
    """The hand-written Hopper kernels: K1 (and its batched form) for the
    prologue, K2 (K5 gated, K7 batched, K8 gated and batched) for every
    seeding round, K3 (K6 gated, K10a batched, K10b gated and batched) for
    every assignment round, K11 and K12 for the rejection sampler's row D²
    and tile caps.
    ``resident=False`` re-reads the centroid block from global memory
    (Fig. 2's variant) instead of staging it in shared memory."""

    name: ClassVar[str] = "cuda"
    resident: bool = True

    def row_min_d2(self, points, idx, pending, count) -> torch.Tensor:
        return kmeans_distance.row_min_d2(points, idx, pending, count)

    def tile_envelope(self, centers, radii, pending, count, partials,
                      tile_w):
        return kmeans_distance.tile_envelope(centers, radii, pending, count,
                                             partials, tile_w)

    def prologue(self, points, m: int = 1,
                 with_bounds: bool = True) -> RoundCache:
        if not with_bounds:
            return RoundCache(bounds.point_norms(points))
        n, d = points.shape[-2:]
        fn = (kmeans_distance.seed_prologue_batched if points.dim() == 3
              else kmeans_distance.seed_prologue)
        return RoundCache(*fn(points, self.seed_tile(n, d, m)))

    def seed_round(self, points, c_new, min_d2, *, cache, state=None,
                   weights=None, consume=False):
        n, d = points.shape
        tile = self.seed_tile(n, d, c_new.shape[0])
        c = c_new.contiguous()
        if weights is not None:
            # as the reference's Pallas backend: a weighted round is K2,
            # ungated (skipping nothing), its partials re-summed weighted;
            # a gated caller gets the carry's tile maxima
            new_md, _ = kmeans_distance.distance_min_update(
                points, cache.norms, c, min_d2, block_n=tile,
                resident=self.resident)
            partials = sampling.tile_partials(new_md * weights, tile)
            tmax = (None if state is None
                    else bounds.tile_reduce_max(new_md, tile))
            return SeedRound(new_md, partials.sum(), partials, tmax)
        if _gates(state, cache):
            # the gate is O(n_tiles) device ops; K5 reads the mask itself
            active, dc, margin = bounds.seed_gate(c, cache, state.tile_max)
            md, partials, tmax, pruned = \
                kmeans_distance.distance_min_update_gated(
                    points, cache.norms, c, min_d2, cache.center_d, dc,
                    margin, state.partials, state.tile_max, active,
                    block_n=tile, resident=self.resident, inplace=consume)
            return SeedRound(md, partials.sum(), partials, tmax,
                             _seed_skipped(active),
                             pruned.sum().to(torch.int32))
        new_md, partials = kmeans_distance.distance_min_update(
            points, cache.norms, c, min_d2, block_n=tile,
            resident=self.resident)
        return SeedRound(new_md, partials.sum(), partials)

    def seed_round_batched(self, points, c_new, min_d2, *, cache,
                           state=None, consume=False):
        n, d = points.shape[-2:]
        tile = self.seed_tile(n, d, c_new.shape[-2])
        c = c_new.contiguous()
        # the total only feeds finite/positive tests: any order will do
        if _gates(state, cache):
            # each problem's gate: (B, T) device ops; K8 reads the masks
            active, dc, margin = bounds.seed_gate(c, cache, state.tile_max)
            md, partials, tmax, pruned = \
                kmeans_distance.distance_min_update_gated_batched(
                    points, cache.norms, c, min_d2, cache.center_d, dc,
                    margin, state.partials, state.tile_max, active,
                    block_n=tile, resident=self.resident, inplace=consume)
            return SeedRound(md, partials.sum(-1), partials, tmax,
                             _seed_skipped(active),
                             pruned.sum(-1).to(torch.int32))
        new_md, partials = kmeans_distance.distance_min_update_batched(
            points, cache.norms, c, min_d2, block_n=tile,
            resident=self.resident)
        return SeedRound(new_md, partials.sum(-1), partials)

    def seed_round_listed(self, points, c_new, min_d2, partials, *, cache,
                          problems, state=None):
        # one K8 (gated) or K7 launch over the listed problems' tiles, in
        # place; each problem's gate is (B, T) device ops, read only on the
        # list
        n, d = points.shape[-2:]
        tile = self.seed_tile(n, d, c_new.shape[-2])
        c = c_new.contiguous()
        if _gates(state, cache):
            active, dc, margin = bounds.seed_gate(c, cache, state.tile_max)
            _, _, _, pruned = kmeans_distance.distance_min_update_gated_batched(
                points, cache.norms, c, min_d2, cache.center_d, dc, margin,
                state.partials, state.tile_max, active, block_n=tile,
                resident=self.resident, problems=problems)
            return SeedRound(min_d2, None, partials, state.tile_max,
                             _seed_skipped(active),
                             pruned.sum(-1).to(torch.int32))
        kmeans_distance.distance_min_update_batched(
            points, cache.norms, c, min_d2, block_n=tile,
            resident=self.resident, problems=problems, partials=partials)
        return SeedRound(min_d2, None, partials)

    def _assign_tiled(self, points, norms, centroids, tile, tps):
        return lloyd_assign.lloyd_assign_tiled(
            points, norms, centroids.contiguous(), block_n=tile, tps=tps)

    def _assign_plain(self, points, centroids, weights, norms):
        return ops.lloyd_assign(points, centroids.contiguous(), norms=norms,
                                weights=weights)

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

    def _assign_gated_batched(self, points, norms, centroids, delta, thresh,
                              absorb, state, active, tile, tps):
        return lloyd_assign.lloyd_assign_gated_batched(
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


def _inject_seed_fault(fault, m: int, min_d2=None, state=None,
                       envelope=None):
    """The reference's seeding faults (``testing.FaultSpec``) at round
    ``fault.round``, each written into a copy (the clean +inf carry a heal
    refolds from must stay clean): ``nan_tile`` NaNs the first min(64, n)
    rows of the carried D² ``min_d2``, ``nan_state`` the first carried tile
    partial of the bound ``state``; on the rejection loop's stale
    ``envelope`` (its tile partials) ``neg_envelope`` makes the first -1
    and ``stale_super`` every partial of the last super-tile NaN (a torn
    coarse aggregate). Batched, every problem's (the reference's ``vmap``
    of the single fault). Other rounds, and a kind whose target is not
    passed, leave all three as they are. Returns (min_d2, state,
    envelope)."""
    kind = getattr(fault, "kind", None)
    if fault is None or m != fault.round:
        return min_d2, state, envelope
    if kind == "nan_tile" and min_d2 is not None:
        min_d2 = min_d2.clone()
        min_d2[..., :64] = torch.nan
    elif kind == "nan_state" and state is not None:
        partials = state.partials.clone()
        partials[..., 0] = torch.nan
        state = state._replace(partials=partials)
    elif kind == "neg_envelope" and envelope is not None:
        envelope = envelope.clone()
        envelope[..., 0] = -1.0
    elif kind == "stale_super" and envelope is not None:
        envelope = envelope.clone()
        n_tiles = envelope.shape[-1]
        envelope[..., max(n_tiles - bounds.tiles_per_super(n_tiles), 0):] = \
            torch.nan
    return min_d2, state, envelope


class SeedCarry(NamedTuple):
    """What the k-means++ loop carries from round to round, and what a
    checkpointed seeding saves. Batched problems put a leading axis on
    every tensor but ``recovered``."""
    m: int                           # the next round
    draws: Draws                     # the run's random numbers
    centroids: torch.Tensor          # (k, d): seeds 0..m-1 set
    indices: torch.Tensor            # (k,) int64
    min_d2: torch.Tensor             # (n,) D² to seeds 0..m-2
    state: Optional[BoundState]      # gated: (partials, tile_max)
    skipped: Optional[torch.Tensor]  # (k,) int32 (gated)
    pruned: Optional[torch.Tensor]   # (k,) int32 (gated)
    recovered: torch.Tensor          # (k,) int32 heal flags, host memory


def _seed_parts(pts, k, *, round_fn, sample_fn, first_fn, init_min_d2,
                init_state: Optional[BoundState], guard: bool, tile: int,
                w: Optional[torch.Tensor] = None, fault=None):
    """The k-means++ loop as ``(make_init, body, finish)``, so the one-shot
    :func:`_seed_loop` and the checkpointed seeding run the same rounds:
    ``make_init(draws)`` is the carry before round 1 (seed 0 is
    ``first_fn(draws)``), ``body(carry)`` runs round ``carry.m`` (fold
    centroid m-1 into min_d2, draw seed m with ``draws.u[m-1]`` ∝
    min_d2·``w``), and ``finish(carry)`` the final round, which folds the
    last seed, so the returned min_d2 covers all k: (centroids, indices,
    min_d2, skipped, pruned, recovered). ``round_fn(c, md, state,
    consume=)`` is one backend round (``consume``: ``md`` may be
    overwritten); ``init_state`` turns on gating, the carry then holding
    ``BoundState(partials, tile_max)``. ``fault`` poisons the carried
    round inputs at its round (:func:`_inject_seed_fault`), before the
    round and before the final one.

    ``guard`` arms in-flight corruption detection: every round's ``total``
    doubles as the finite flag. A non-finite total means the carry is
    untrusted, so the round DISCARDS min_d2 and the bound state and refolds
    rounds 0..m-1 UNGATED from the clean +inf carry; the refold applies the
    same min-folds in the same order, and gating is exact, so the healed
    carry (and its last round's partials) is the one an uncorrupted run has.
    The rebuilt tile_max is the healed min_d2's. Corruption in a tile the
    gate is skipping is not seen until that tile next activates."""
    gated = init_state is not None
    lead = tuple(pts.shape[:-2])
    dev = pts.device

    def heal(m, centroids) -> SeedRound:
        md, rnd = init_min_d2, None
        for j in range(m):
            rnd = round_fn(centroids[..., j:j + 1, :], md, None)
            md = rnd.min_d2
        return rnd

    def checked_round(m, centroids, min_d2, state):
        # the loop never reads a round's min_d2 again after the next round,
        # so every carry but the clean one (which heal refolds from) may be
        # overwritten in place
        rnd = round_fn(centroids[..., m - 1:m, :], min_d2, state,
                       consume=min_d2 is not init_min_d2)
        # one host sync per round: the guard's finite check
        if guard and not bool(torch.isfinite(rnd.total)):
            rnd = heal(m, centroids)
            st = (BoundState(rnd.partials,
                             bounds.tile_reduce_max(rnd.min_d2, tile))
                  if gated else None)
            return rnd.min_d2, rnd.partials, st, 0, 0, 1
        st = BoundState(rnd.partials, rnd.tile_max) if gated else None
        return rnd.min_d2, rnd.partials, st, rnd.skipped, rnd.pruned, 0

    def make_init(draws: Draws) -> SeedCarry:
        draws = draws.to(dev)
        centroids = pts.new_zeros(lead + (k, pts.shape[-1]))
        indices = torch.zeros(lead + (k,), dtype=torch.int64, device=dev)
        first = first_fn(draws).reshape(lead + (1,))
        centroids[..., 0:1, :] = _take_rows(pts, first)
        indices[..., 0:1] = first
        skips = prunes = None
        if gated:
            skips = torch.zeros(lead + (k,), dtype=torch.int32, device=dev)
            prunes = torch.zeros(lead + (k,), dtype=torch.int32, device=dev)
        return SeedCarry(1, draws, centroids, indices, init_min_d2,
                         init_state, skips, prunes,
                         torch.zeros(k, dtype=torch.int32))

    def fold(c: SeedCarry, m: int):
        # round m into the carry's counters: (min_d2, partials, state)
        min_d2, state, _ = _inject_seed_fault(fault, m, c.min_d2, c.state)
        min_d2, partials, state, rs, rp, c.recovered[m - 1] = checked_round(
            m, c.centroids, min_d2, state)
        if gated:
            c.skipped[..., m - 1], c.pruned[..., m - 1] = rs, rp
        return min_d2, partials, state

    def body(c: SeedCarry) -> SeedCarry:
        m = c.m
        min_d2, partials, state = fold(c, m)
        nxt = sample_fn(c.draws.u[..., m - 1], c.draws.fallback[..., m - 1:m],
                        _weigh(min_d2, w), partials)
        c.centroids[..., m:m + 1, :] = _take_rows(pts, nxt)
        c.indices[..., m:m + 1] = nxt
        return c._replace(m=m + 1, min_d2=min_d2, state=state)

    def finish(c: SeedCarry):
        min_d2, _, _ = fold(c, k)
        return (c.centroids, c.indices, min_d2, c.skipped, c.pruned,
                c.recovered)

    return make_init, body, finish


def _take_rows(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (..., r) of ``pts`` (..., n, d), problem by problem."""
    return torch.take_along_dim(pts, idx[..., None], dim=-2)


def _seed_loop(draws: Draws, pts, k, **parts):
    """Generic k-means++ loop (:func:`_seed_parts`' parts run to the end):
    seed 0 is ``first_fn(draws)``; round m folds centroid m-1 into min_d2
    and draws seed m with ``draws.u[m-1]`` ∝ min_d2·``w``; a final round
    folds the last seed, so the returned min_d2 covers all k. The sampled
    index stays on the device: seeds are gathered on the device, never read
    on the host. ``init_state`` turns on bound gating (round 1 starts from
    tile_max = +inf, nothing skippable); the per-round skip and prune
    counts stay on the device. Batched problems carry a leading axis on
    ``pts`` (B, n, d), the draws, every carry and the counters (B, k); one
    round serves all B. Returns (centroids, indices, min_d2, skipped,
    pruned, recovered)."""
    make_init, body, finish = _seed_parts(pts, k, **parts)
    carry = make_init(draws)
    while carry.m < k:
        carry = body(carry)
    return finish(carry)


_REJECT_ATTEMPTS = 8   # default truncation depth of the rejection loop


def _put(dst: torch.Tensor, value) -> None:
    """``dst[...] = value`` for a tensor or a host number (by ``fill_``, no
    host sync)."""
    if isinstance(value, torch.Tensor):
        dst.copy_(value)
    else:
        dst.fill_(value)


def _ints(values, device) -> torch.Tensor:
    """Host integers as an int32 tensor on ``device``; on the card through
    pinned memory, so the copy queues behind the work before it and the
    host does not wait."""
    t = torch.tensor(values, dtype=torch.int32)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _seed_rejection_loop(draws: Draws, pts, k, *, round_fn, propose_fn,
                         pq_fn, fallback_fn, prep_fn, n_tiles: int,
                         refresh_block: int, max_attempts: int, init_min_d2,
                         init_state: Optional[BoundState], tile: int,
                         guard: bool, hier: bool, first: torch.Tensor,
                         w: Optional[torch.Tensor] = None, fault=None):
    """Rejection-sampling k-means++ loop (``sampler='rejection'``).

    A round does not refresh D². Chosen centroids collect in a (P, d)
    PENDING block (P = ``refresh_block``), and the (min_d2, partials) of the
    last refresh are the stale envelope ``q`` (``bounds.seed_envelope``),
    which dominates the current weights because seeding only adds
    centroids. A round draws from the envelope (``propose_fn(u, weight,
    partials, pstate)``), prices the drawn row exactly (``pq_fn(idx,
    weight, pending, count, pstate) -> (p, q)`` with ``p = min(q,
    row_min_d2)``) and accepts with probability p/q; every attempt of the
    round is proposed and priced at once (``u`` and ``idx`` (A,), one K11
    launch on the card), since nothing an attempt reads depends on an
    earlier one. The full refresh — the
    whole pending block folded through ``round_fn``, gated or not — runs
    when the block fills, when all ``max_attempts`` proposals reject (the
    round then takes an exact draw, ``fallback_fn``, from the refreshed
    weights, so the truncated mixture stays exactly D²-distributed), and
    once at the end, so the returned min_d2 is exact over all k seeds.

    The pending block starts as P copies of centroid 0 with count P - 1, so
    round 1's append forces the first refresh; it is never cleared (rows
    past the count were folded already, a value-noop under min). The count
    is a host integer: the refresh decision needs no sync, and the kernels
    read it as a 0-d device view.

    Seed 0 is ``first``; with point weights ``w`` the envelope and the
    target are min_d2·w. Uniforms: attempt 0 of round m proposes with
    ``draws.u[m-1]``, so with ``refresh_block=1`` (p == q bitwise, the
    first proposal accepts) the seeds are bitwise the tiled sampler's; the
    other attempts, the accepts and the exact draw take the rejection
    schedule of ``draws``.

    Envelope guard (always on): every round checks the partials for
    negative or non-finite entries, one host sync. A bad envelope is
    rebuilt BEFORE proposing by refolding, ungated from the clean +inf
    carry, the centroids it should cover (0..m-count-1, the rest of a (k, d)
    block padded with centroid 0); min-folds are exact, so the rebuilt
    envelope is bitwise the clean run's and the round replays identically,
    flagged in ``recovered[m]``. ``fault`` (``.kind``, ``.round``) injects
    the reference's ``neg_envelope``/``stale_super`` corruption
    (:func:`_inject_seed_fault`). ``guard`` also checks the settling
    refresh's total.

    ``prep_fn(partials, pending, live, counts) -> (pstate, tightened)``
    builds the hier proposal state once per round from the (healed)
    partials; ``live`` is the count as a device view (what the kernels
    read), the host ``counts`` let a round with no live pending centroid
    launch nothing.

    Batched problems (``pts`` (B, n, d), the draws, ``first`` and the
    carries with a leading axis) run through this same loop, problem b
    bitwise the single loop on problem b, counters included. Problems fall
    out of step (a round whose attempts all reject refreshes its problem
    early), so each keeps its own host count, and the kernels read the
    (B,) counts, uploaded once a round without a host sync. ``round_fn(c,
    md, state, problems, partials)`` is then one round over the listed
    problems only, writing in place into the carries (``init_min_d2``, the
    (B, T) partials, ``init_state``): the refresh of the problems whose
    block filled, the heal of those whose envelope is bad (their D² reset
    to +inf, then the ungated refold), the refresh of those whose attempts
    all rejected (before their exact draws, on their rows only), and the
    settle of all B. Nothing is launched for an empty list. ``propose_fn``,
    ``pq_fn`` and ``prep_fn`` take every problem at once ((B, A) uniforms,
    one K11 and at most one K12 launch a round), and ``fallback_fn`` the
    listed problems' rows.

    Host syncs: two per round whatever B is (the envelope check, the first
    accepting attempts), one for the guard's final check.

    Returns (centroids, indices, min_d2, skipped, pruned, proposals,
    accepts, recovered, tightened, supers), all counters (k,) int32
    ((B, k) batched)."""
    lead = tuple(pts.shape[:-2])
    bsz = lead[0] if lead else 1
    d = pts.shape[-1]
    dev = pts.device
    P = max(int(refresh_block), 1)
    gated = init_state is not None
    centroids = pts.new_zeros(lead + (k, d))
    indices = torch.zeros(lead + (k,), dtype=torch.int64, device=dev)
    first = first.reshape(lead + (1,))
    centroids[..., 0:1, :] = _take_rows(pts, first)
    indices[..., 0:1] = first
    skips = torch.zeros(lead + (k,), dtype=torch.int32, device=dev)
    prunes = torch.zeros(lead + (k,), dtype=torch.int32, device=dev)
    tights = torch.zeros(lead + (k,), dtype=torch.int32, device=dev)
    props, accs, sups, rec = ([[0] * bsz for _ in range(k)]
                              for _ in range(4))
    pending = centroids[..., 0:1, :].expand(lead + (P, d)).clone()
    counts = [P - 1] * bsz
    md, state = init_min_d2, init_state
    if lead:
        # the carries the listed rounds write into
        carry = (state.partials if gated
                 else torch.zeros(lead + (n_tiles,), device=dev))
        every = torch.arange(bsz, dtype=torch.int32, device=dev)
        full = torch.full(lead, n_tiles, dtype=torch.int32, device=dev)
    else:
        count_views = torch.arange(P + 1, dtype=torch.int32, device=dev)
        carry = torch.zeros(n_tiles, device=dev)   # never drawn from
    partials = carry

    def refresh(problems, listed, rs, rp):
        # fold the pending blocks (batched: of ``problems``, ``listed`` their
        # mask, None for all); rs/rp: the round's skipped/pruned so far
        # (None: none). Returns them updated, and the round
        nonlocal md, partials, state
        if lead:
            rnd = round_fn(pending, md, state, problems, carry)
            if not gated:
                return rs, rp, rnd
            rs = rnd.skipped if listed is None else torch.where(
                listed, rnd.skipped, full if rs is None else rs)
        else:
            rnd = round_fn(pending, md, state)
            md, partials = rnd.min_d2, rnd.partials
            state = BoundState(rnd.partials, rnd.tile_max) if gated else None
            rs = rnd.skipped
        return rs, rnd.pruned if rp is None else rp + rnd.pruned, rnd

    def refold(problems, block):
        # D² of ``problems`` refolded ungated from the clean +inf carry
        nonlocal md, partials, state
        if lead:
            rows = problems.long()
            md.index_fill_(0, rows, torch.inf)
            round_fn(block, md, None, problems, carry)
            partials = carry
            if gated:
                state.tile_max.index_copy_(0, rows, bounds.tile_reduce_max(
                    md.index_select(0, rows), tile))
            return
        rnd = round_fn(block, init_min_d2, None)
        md, partials = rnd.min_d2, rnd.partials
        state = (BoundState(rnd.partials,
                            bounds.tile_reduce_max(rnd.min_d2, tile))
                 if gated else None)

    def append(j, slots, tail):
        # centroid j into each problem's pending slot; batched, uploads the
        # slots and the host ints ``tail`` at once, and returns tail's view
        if not lead:
            pending[slots[0]] = centroids[j]
            return None
        buf = _ints([b * P + c for b, c in enumerate(slots)] + tail, dev)
        pending.view(-1, d).index_copy_(0, buf[:bsz].long(),
                                        centroids[:, j])
        return buf[bsz:]

    for m in range(1, k):
        slots = counts
        counts = [c + 1 for c in counts]
        due = [b for b, c in enumerate(counts) if c >= P]
        for b in due:
            counts[b] = 0
        sent = append(m - 1, slots, counts + due)
        live = sent[:bsz] if lead else count_views[counts[0]]
        rs = rp = None
        if due:
            rs, rp, _ = refresh(sent[bsz:] if lead else None,
                                live == 0 if lead and gated else None, rs,
                                rp)
        partials = _inject_seed_fault(fault, m, envelope=partials)[2]
        bad = (~torch.isfinite(partials) | (partials < 0)).any(-1)
        healed = ([b for b, x in enumerate(bad.tolist()) if x] if lead
                  else [0] * bool(bad))                        # one sync
        if healed:
            if lead:
                keep = (torch.arange(k, device=dev)
                        < (m - live)[:, None])[..., None]
                refold(_ints(healed, dev),
                       torch.where(keep, centroids, centroids[:, :1]))
            else:
                block = centroids.clone()
                block[m - counts[0]:] = centroids[0]
                refold(None, block)
        pstate, tightened = prep_fn(partials, pending, live, counts)
        weight = bounds.seed_envelope(md, w)
        idx, ok, att = sampling.rejection_sample(
            lambda u: propose_fn(u, weight, partials, pstate),
            lambda i: pq_fn(i, weight, pending, live, pstate),
            torch.cat([draws.u[..., m - 1:m], draws.propose_u[..., m - 1, :]],
                      -1),
            draws.accept_u[..., m - 1, :], max_attempts=max_attempts)
        if not lead:
            ok, att = [ok], [att]
        failed = [b for b in range(bsz) if not ok[b]]
        if failed:
            for b in failed:
                counts[b] = 0
            exact_u = draws.exact_u[..., m - 1]
            exact_fb = draws.exact_fallback[..., m - 1:m]
            if lead:
                sent = _ints([int(not x) for x in ok] + failed, dev)
                rows = sent[bsz:].long()
                rs, rp, _ = refresh(sent[bsz:], sent[:bsz].bool() if gated
                                    else None, rs, rp)
                picked = fallback_fn(
                    exact_u.index_select(0, rows),
                    exact_fb.index_select(0, rows),
                    bounds.seed_envelope(md, w).index_select(0, rows),
                    partials.index_select(0, rows))
                idx = idx.index_copy(0, rows, picked)
            else:
                rs, rp, _ = refresh(None, None, rs, rp)
                idx = fallback_fn(exact_u, exact_fb,
                                  bounds.seed_envelope(md, w), partials)
        if lead:
            centroids[:, m:m + 1] = _take_rows(pts, idx)
        else:
            centroids[m:m + 1] = pts.index_select(0, idx)
        indices[..., m:m + 1] = idx
        # a host number goes in by fill_: assigned, it would be copied
        # from pageable memory, a host sync
        if gated:
            _put(skips[..., m - 1], n_tiles if rs is None else rs)
            _put(prunes[..., m - 1], 0 if rp is None else rp)
        _put(tights[..., m], tightened)
        for b in range(bsz):
            props[m][b], accs[m][b] = att[b], int(ok[b])
            if hier:
                sups[m][b] = att[b] + (0 if ok[b] else 1)
        for b in healed:
            rec[m][b] = 1
    # settle: fold the last seed and every still-pending one
    append(k - 1, counts, [])
    rs, rp, rnd = refresh(every if lead else None, None, None, None)
    final_md = md
    if guard:
        total = carry.sum(-1) if lead else rnd.total
        redo = [b for b, x in enumerate(
            (~torch.isfinite(total)).reshape(-1).tolist()) if x]
        if redo:
            refold(_ints(redo, dev) if lead else None, centroids)
            final_md = md
        for b in redo:
            rec[k - 1][b] = 1
    if gated:
        skips[..., k - 1], prunes[..., k - 1] = rs, rp

    def i32(xs):
        t = _ints(xs, dev)
        return t.T.contiguous() if lead else t[:, 0]

    return (centroids, indices, final_md, skips, prunes, i32(props),
            i32(accs), i32(rec), tights, i32(sups))


def _seed_rejection(draws: Draws, pts, k, backend: Backend,
                    cache: RoundCache, tile: int,
                    init_state: Optional[BoundState], *, refresh_block: int,
                    proposal: str, max_attempts: int, guard: bool,
                    first: torch.Tensor, stream: torch.Tensor,
                    w: Optional[torch.Tensor] = None,
                    fault=None) -> KmeansppResult:
    """The rejection branch of :func:`seed_points`: the proposal, pricing,
    fallback and prep functions for ``proposal`` 'hier' or 'flat', then
    :func:`_seed_rejection_loop`. With point weights ``w`` a drawn row's
    exact weight is ``w_i · row_min_d2`` and the hier cap bounds a tile's
    mass through the weights' own tile sums. The refreshes fold through
    ``stream`` (the rounds' points); the drawn row's D² reads ``pts``.
    Batched points (B, n, d) fold through ``Backend.seed_round_listed`` and
    give every function a leading problem axis (no weights)."""
    n, d = pts.shape[-2:]
    lead = tuple(pts.shape[:-2])
    dev = pts.device
    n_tiles = -(-n // tile)
    tps = backend.tiles_per_super(n_tiles)
    hier = proposal == "hier"
    # the refresh folds P centroids at once: pin its tile height to the
    # sampler's, so its partials cover the rows the draws' windows cover
    be = dataclasses.replace(backend, block_n=tile)
    take = sampling.gather

    if hier:
        tiny = torch.finfo(torch.float32).tiny
        # the tile mass the cap multiplies into a tile-level envelope
        # bound: the weights' tile sums (unweighted: the row counts)
        tile_w = sampling.tile_partials(
            pts.new_ones(n) if w is None else w, tile)

        # the envelope of a round with no live pending centroid, or with
        # no balls (no bounds): +inf caps, which tighten no tile (the
        # bits the computed envelope gives there)
        no_cap = torch.full(lead + (n_tiles,), torch.inf, device=dev)
        no_tight = torch.zeros(lead + (n_tiles,), dtype=torch.bool,
                               device=dev)
        none_tight = torch.zeros(lead, dtype=torch.int32, device=dev)

        def prep_fn(partials, pending, live, counts):
            # rebuilt each round from the healed partials: cap_t bounds
            # every row's D² to the pending block from tile summaries
            # alone, so min(partials_t, cap_t * W_t) is a valid tile
            # envelope mass; batched, one launch covers every problem (a
            # problem at count 0 gets the +inf caps' bits)
            if not any(counts) or cache.centers is None:
                cap, ph, tight, n_tight = no_cap, partials, no_tight, \
                    none_tight
            else:
                cap, ph, tight, n_tight = be.tile_envelope(
                    cache.centers, cache.radii, pending, live, partials,
                    tile_w)
            tcdf = sampling.prefix_sum(ph)
            return ((ph, tcdf, sampling.super_cdf(tcdf, tps), cap, tight),
                    n_tight)

        def propose_fn(u, weight, partials, pstate):
            ph, tcdf, scdf, cap, tight = pstate
            return sampling.hier_index_from_uniform(
                u, weight, ph, tcdf, scdf, block_n=tile, tps=tps, cap=cap,
                tight=tight)

        def pq_fn(idx, weight, pending, count, pstate):
            # priced under the proposal's own association: a tightened
            # tile drew its row ∝ the capped window with tile mass ph_t,
            # so q = cwin[li] * ph_t / sum(cwin); other tiles keep the flat
            # q = weight[idx] bitwise. idx (A,) or (B, A): every attempt at
            # once, each window a row
            ph, _, _, cap, tight = pstate
            rd2 = be.row_min_d2(pts, idx, pending, count)
            t = (idx // tile)[..., None]
            li = idx[..., None] - t * tile
            win = sampling.tile_window(weight, t, tile)
            cw = (take(cap, t) if w is None
                  else take(cap, t) * sampling.tile_window(w, t, tile))
            cwin = torch.where(cw < win, cw, win)
            s_t = sampling.prefix_last(cwin)
            q = torch.where(take(tight, t),
                            torch.take_along_dim(cwin, li, dim=-1)
                            * (take(ph, t) / s_t.clamp_min(tiny)),
                            take(weight, idx[..., None]))[..., 0]
            return torch.minimum(q, rd2 if w is None else take(w, idx)
                                 * rd2), q

        def fallback_fn(u, fb, weight, partials):
            return sampling.categorical_hier(u, fb, weight, partials,
                                             block_n=tile, tps=tps)
    else:
        def prep_fn(partials, pending, live, counts):
            return None, 0

        def propose_fn(u, weight, partials, pstate):
            return sampling.tiled_index_from_uniform(u, weight, partials,
                                                     block_n=tile)

        def pq_fn(idx, weight, pending, count, pstate):
            q = take(weight, idx)
            rd2 = be.row_min_d2(pts, idx, pending, count)
            return torch.minimum(q, rd2 if w is None else take(w, idx)
                                 * rd2), q

        def fallback_fn(u, fb, weight, partials):
            return sampling.categorical_tiled(u, fb, weight, partials,
                                              block_n=tile)

    if lead:
        def round_fn(c, md, st, problems, partials):
            return be.seed_round_listed(stream, c.to(stream.dtype), md,
                                        partials, cache=cache,
                                        problems=problems, state=st)
    else:
        def round_fn(c, md, st):
            return be.seed_round(stream, c.to(stream.dtype), md, cache=cache,
                                 state=st, **_weighted(w))

    (centroids, indices, min_d2, skips, prunes, props, accs, rec, tights,
     sups) = _seed_rejection_loop(
        draws, pts, k, round_fn=round_fn, propose_fn=propose_fn,
        pq_fn=pq_fn, fallback_fn=fallback_fn, prep_fn=prep_fn,
        n_tiles=n_tiles, refresh_block=refresh_block,
        max_attempts=max_attempts,
        init_min_d2=torch.full(lead + (n,), torch.inf, device=dev),
        init_state=init_state, tile=tile, guard=guard, hier=hier,
        first=first, w=w, fault=fault)
    gated = init_state is not None
    return KmeansppResult(centroids, indices, min_d2,
                          skips if gated else None, prunes if gated else None,
                          recovered=rec if guard else None, proposals=props,
                          accepts=accs, tightened=tights, supers=sups)


def _first_seed(draws: Draws, w: Optional[torch.Tensor], sampler: str,
                proposal: str, tile: int, tps: int) -> torch.Tensor:
    """Seed 0: ``draws.first``, or with point weights ``w`` a draw ∝ w with
    ``draws.first_u`` (fallback ``draws.first_fallback``), as the
    reference's: inverse CDF for cdf, the two-level draw over the weights'
    tile sums for tiled and rejection flat, the super -> tile -> row draw
    for rejection hier."""
    if w is None:
        return draws.first
    if draws.first_u is None:
        raise ValueError("draws hold no weighted first-seed draws; sample "
                         "them with Draws.sample(..., weighted=True)")
    u, fb = draws.first_u.reshape(()), draws.first_fallback.reshape(1)
    if sampler == "cdf":
        return sampling.categorical_cdf(u, fb, w)
    parts = sampling.tile_partials(w, tile)
    if sampler == "rejection" and proposal == "hier":
        return sampling.categorical_hier(u, fb, w, parts, block_n=tile,
                                         tps=tps)
    return sampling.categorical_tiled(u, fb, w, parts, block_n=tile)


def _check_precision(precision: str) -> None:
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}; "
                         "expected 'fp32' or 'bf16'")


def _stream_of(pts: torch.Tensor, precision: str) -> torch.Tensor:
    """The points the seeding and assignment rounds stream: a bf16 copy
    under ``precision='bf16'`` (norms, D², accumulators and the bound state
    stay fp32), the fp32 points themselves under 'fp32'."""
    _check_precision(precision)
    return pts.to(torch.bfloat16) if precision == "bf16" else pts


def seed_points(draws: Draws, points: torch.Tensor, k: int,
                backend: Backend, sampler: str = "cdf", *,
                weights: Optional[torch.Tensor] = None,
                bound_gate: bool = True,
                cache: Optional[RoundCache] = None,
                guard: bool = False, refresh_block: int = 8,
                proposal: str = "hier",
                max_attempts: int = _REJECT_ATTEMPTS,
                fault=None,
                stream: Optional[torch.Tensor] = None,
                parts: bool = False):
    """Full k-means++ seeding through ``backend``. Samplers: 'cdf' (full
    inverse CDF, the serial algorithm), 'tiled' (two-level inverse CDF
    from the round's per-tile partials — O(n/tile + tile) reads per draw,
    the same distribution) and 'rejection' (exact rejection sampling from
    the stale envelope of the last refresh, which runs every
    ``refresh_block`` seeds: a round in between touches only the drawn
    row; ``refresh_block=1`` picks bitwise the 'tiled' seeds — see
    :func:`_seed_rejection_loop`). ``proposal`` (rejection only) is 'hier'
    (super-tile -> tile -> row, the per-tile envelope tightened between
    refreshes by the caps of ``Backend.tile_envelope``) or 'flat' (the tiled
    draw); ``max_attempts`` truncates the attempts of a round, past which
    it takes one exact draw. ``fault`` (a ``testing.FaultSpec``) injects
    the reference's seeding faults (tests; :func:`_inject_seed_fault`):
    ``nan_tile`` and ``nan_state`` on 'cdf' and 'tiled', the envelope
    faults on 'rejection'. ``weights`` (n,) draw every seed ∝ D²·w, the
    first ∝ w (see :func:`_first_seed`; the draws need ``first_u``).
    ``stream`` is the points the rounds read, the fp32 points by default;
    :func:`_stream_of`'s bf16 copy under ``precision='bf16'``, each round's
    centroids then rounded to bf16 (see the module's Precision note).
    Seeds are taken from the fp32 points and the centroids come back fp32.
    The prologue runs once here unless a ``cache`` is passed in
    (``kmeans_points`` shares one across both phases). With ``bound_gate``
    the loop carries the per-tile bound state so each round skips every
    provably unchanged tile and prunes provably stable points inside
    active tiles; the results are bitwise those of the ungated loop (for
    'hier', which tightens only with the tile balls, the draws differ).

    ``points`` (B, n, d) seeds B independent problems in one loop from
    batched ``draws`` (``Draws.sample_batched``), gated or not: 'cdf' and
    'tiled' with one ``seed_round_batched`` per round and no in-flight
    guard (the reference turns it off under ``vmap``); 'rejection' through
    the same rejection loop as one problem, each refresh one
    ``seed_round_listed`` over the problems that need it (``guard`` there
    only checks the settling refresh, problem by problem). The counters are
    (B, k). Row b of every field is bitwise the single seeding of problem b
    with ``draws[b]``.

    ``parts`` ('cdf' and 'tiled') returns the loop's ``(make_init, body,
    finish)`` (:func:`_seed_parts`; ``make_init`` takes the draws) instead
    of running it: what the checkpointed seeding drives in chunks."""
    if proposal not in ("flat", "hier"):
        raise ValueError(f"unknown proposal {proposal!r}; "
                         "expected 'flat' or 'hier'")
    _check_sampler(sampler)
    lead = tuple(points.shape[:-2])
    if lead and guard and sampler != "rejection":
        raise NotImplementedError(
            "batched seeding runs without the in-flight guard, as the "
            "reference does under vmap")
    if lead and weights is not None:
        raise ValueError("batched problems take no weights, as in the "
                         "reference")
    n, d = points.shape[-2:]
    pts = points.float()
    if stream is None:
        stream = pts
    if cache is None:
        cache = backend.prologue(pts, with_bounds=bound_gate)
    tile = backend.seed_tile(n, d)
    if draws.u.shape[-1] < k - 1 or draws.fallback.shape[-1] < k - 1:
        raise ValueError(f"draws hold {draws.u.shape[-1]} rounds, seeding "
                         f"k={k} needs {k - 1}")
    if tuple(draws.u.shape[:-1]) != lead:
        raise ValueError(f"draws for {tuple(draws.u.shape[:-1])} problems, "
                         f"points for {lead}")
    draws = draws.to(pts.device)
    w = None if weights is None else weights.to(pts)
    tps = backend.tiles_per_super(-(-n // tile))

    def first_fn(draws):
        return _first_seed(draws, w, sampler, proposal, tile, tps)

    init_state = None
    if bound_gate and cache.centers is not None:
        n_tiles = lead + (-(-n // tile),)
        init_state = BoundState(
            torch.zeros(n_tiles, device=pts.device),
            torch.full(n_tiles, torch.inf, device=pts.device))

    if sampler == "rejection":
        if draws.exact_u is None or draws.max_attempts < max_attempts:
            raise ValueError(f"draws hold {draws.max_attempts} rejection "
                             f"attempts per round, max_attempts="
                             f"{max_attempts} needs them all")
        return _seed_rejection(draws, pts, k, backend, cache, tile,
                               init_state, refresh_block=refresh_block,
                               proposal=proposal, max_attempts=max_attempts,
                               guard=guard, first=first_fn(draws),
                               stream=stream, w=w, fault=fault)

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
        def round_fn(c, md, st, consume=False):
            return backend.seed_round_batched(
                stream, c.to(stream.dtype), md, cache=cache, state=st,
                consume=consume)
    else:
        def round_fn(c, md, st, consume=False):
            return backend.seed_round(
                stream, c.to(stream.dtype), md, cache=cache, state=st,
                consume=consume, **_weighted(w))

    loop = dict(round_fn=round_fn, sample_fn=sample_fn, first_fn=first_fn,
                init_min_d2=torch.full(lead + (n,), torch.inf,
                                       device=pts.device),
                init_state=init_state, guard=guard, tile=tile, w=w,
                fault=fault)
    if parts:
        return _seed_parts(pts, k, **loop)
    centroids, indices, min_d2, skips, prunes, rec = _seed_loop(
        draws, pts, k, **loop)
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


def _inject_fit_fault(fault, i: int, rnd: AssignRound) -> AssignRound:
    """The reference's fit faults (``testing.FaultSpec``) on iteration
    ``fault.round``'s outputs, before the guard reads them: ``zero_counts``
    halves the cluster sums and counts (a lost contribution: the count
    mass check trips), ``nan_state`` NaNs the first tile partial of the
    iteration's bound state, in a copy (the finite check trips). Other
    iterations and kinds leave ``rnd`` as it is."""
    kind = getattr(fault, "kind", None)
    if fault is None or i != fault.round:
        return rnd
    if kind == "zero_counts":
        return rnd._replace(sums=rnd.sums * 0.5, counts=rnd.counts * 0.5)
    if kind == "nan_state" and rnd.state is not None:
        partials = rnd.state.partials.clone()
        partials[..., 0] = torch.nan
        return rnd._replace(state=rnd.state._replace(partials=partials))
    return rnd


class FitCarry(NamedTuple):
    """What the Lloyd loop carries from iteration to iteration, and what a
    checkpointed fit saves. Batched problems put a leading axis on every
    tensor but ``recovered``."""
    i: int                              # iterations run
    centroids: torch.Tensor             # (k, d) fp32
    prev_centroids: torch.Tensor        # (k, d) fp32, the movement's base
    inertia: torch.Tensor               # () of the last iteration
    assignment: torch.Tensor            # (n,) int32
    state: Optional[BoundState]         # gated
    skipped: Optional[torch.Tensor]     # (max_iters,) int32 (gated)
    pruned: Optional[torch.Tensor]      # (max_iters,) int32 (gated)
    recovered: torch.Tensor             # (max_iters,) int32, host memory
    live: Optional[torch.Tensor]        # (B,) bool: batched, still going
    n_iters: Optional[torch.Tensor]     # (B,) int32: batched, each's count
    go_on: bool                         # the last stop test's verdict


def _fit_parts(pts, init_centroids, backend: Backend, max_iters: int,
               tol: float, empty: str, cache: RoundCache, *, gated: bool,
               guard: bool, stream: torch.Tensor,
               w: Optional[torch.Tensor] = None, fault=None):
    """The Lloyd loop as ``(make_init, step, stopped, finish)``, so the
    one-shot :func:`_fit_loop` and the checkpointed fit run the same
    iterations: ``make_init()`` is the carry before iteration 0,
    ``step(carry)`` runs one iteration, ``stopped(carry)`` is the loop's
    exit test (``max_iters`` run, or the convergence test failed) and
    ``finish(carry)`` the loop's return. Iterations stop when the relative
    inertia improvement falls below ``tol`` or ``max_iters`` is hit. Each
    iteration is one tiled ``assign_update``; the inertia is the sum of its
    per-tile partials, the centroid update the super-axis sum of its
    accumulators.

    With point weights ``w`` (the reference's weighted branch) each
    iteration is instead the untiled round on ``cache.norms`` (no tiles,
    no gate: ``gated`` must be off), its sums and counts weighted, and the
    inertia the fixed-order sum of min_d2·w.

    Every round streams ``stream`` (``pts`` itself, or its bf16 copy) with
    the fp32 centroid carry rounded to its dtype; the movement ``delta``,
    the norms and the update stay fp32.

    ``gated`` (the port of ``_fit_gated_parts``) derives each iteration's
    per-centroid movement ``delta`` from the loop's own consecutive
    centroids and threads a ``BoundState`` through ``assign_update``, which
    skips every tile the movement bound proves unchanged — exactly, so the
    results are bitwise the ungated loop's. ``fault`` poisons a gated
    iteration's outputs (:func:`_inject_fit_fault`).

    ``guard`` (gated loops only, as in the reference) adds the in-flight
    corruption detector: each iteration checks its inertia for finiteness
    and its count mass against n. On a trip the carried bound state is
    DISCARDED and the iteration re-runs ungated from the same centroids; the
    per-point bounds restart pessimistic (-inf point_lb, zero debt), so
    later iterations prune less but compute the same bits. ``recovered[i]``
    records the trip. The guard's checks and the next iteration's
    convergence test are read in one host sync, so the carry holds the
    test's verdict (``go_on``), not its inputs.

    Batched problems (``pts`` (B, n, d)) run one ``assign_update_batched``
    per iteration for all B, gated or not. Each problem takes its own
    convergence test, and a problem that has stopped keeps its centroids,
    assignment, inertia and ``n_iters`` from then on, and reads 0 in its
    skip and prune counters (what the reference's vmapped ``while_loop``
    selects); the loop runs until every problem has stopped, one host sync
    per iteration reading the (B,) flags. A stopped problem's bound state
    is frozen too: it gets zero movement and no active tile, so the gated
    round computes none of its tiles and leaves its carries as they are.
    The inertia is the fixed-order sum of the per-tile partials
    (``sampling.fixed_sum``), so row b's is bitwise the single problem's.

    ``finish`` returns (centroids, assignment, inertia, n_iters, skipped,
    pruned, recovered); the counters are None when the loop is not gated,
    and ``recovered`` also when the guard is off. ``n_iters`` is an int, or
    (B,) int32 when batched (the counters (B, max_iters))."""
    n, d = pts.shape[-2:]
    lead = tuple(pts.shape[:-2])
    k = init_centroids.shape[-2]
    dev = pts.device
    guard = guard and gated
    if gated:
        tile = backend.seed_tile(n, d, k)
        n_tiles = -(-n // tile)
        n_super = -(-n_tiles // backend.tiles_per_super(n_tiles))

        def fresh_bounds(st: BoundState) -> BoundState:
            return st._replace(
                point_lb=torch.full(lead + (n,), -torch.inf, device=dev),
                lb_debt=torch.zeros(lead + (n_tiles,), device=dev))

    def make_init() -> FitCarry:
        bstate = skips = prunes = live = n_iters = None
        if gated:
            bstate = fresh_bounds(BoundState(
                torch.zeros(lead + (n_tiles,), device=dev),
                tile_gap=torch.full(lead + (n_tiles,), -torch.inf,
                                    device=dev),
                tile_sums=torch.zeros(lead + (n_super, k, d), device=dev),
                tile_counts=torch.zeros(lead + (n_super, k), device=dev),
                assignment=torch.zeros(lead + (n,), dtype=torch.int32,
                                       device=dev),
                min_d2=torch.zeros(lead + (n,), device=dev)))
            skips = torch.zeros(lead + (max_iters,), dtype=torch.int32,
                                device=dev)
            prunes = torch.zeros(lead + (max_iters,), dtype=torch.int32,
                                 device=dev)
        if lead:   # the problems still iterating, and each one's count
            live = torch.ones(lead, dtype=torch.bool, device=dev)
            n_iters = torch.zeros(lead, dtype=torch.int32, device=dev)
        cents = init_centroids.float()
        return FitCarry(0, cents, cents, torch.full(lead, torch.inf,
                                                    device=dev),
                        torch.zeros(lead + (n,), dtype=torch.int32,
                                    device=dev),
                        bstate, skips, prunes,
                        torch.zeros(max_iters, dtype=torch.int32), live,
                        n_iters, True)

    def stopped(c: FitCarry) -> bool:
        return c.i >= max_iters or not c.go_on

    def step(c: FitCarry) -> FitCarry:
        i, cents, live = c.i, c.centroids, c.live

        def improves(new_inertia) -> torch.Tensor:
            return (c.inertia - new_inertia) / c.inertia.clamp_min(1e-30) \
                > tol

        delta = (bounds.centroid_movement(cents, c.prev_centroids) if gated
                 else None)
        c_round = cents.to(stream.dtype)
        if w is not None:
            rnd = backend.assign_update(stream, c_round, weights=w,
                                        norms=cache.norms)
            new_inertia = sampling.fixed_sum(rnd.min_d2 * w)
        else:
            if lead:
                if gated:   # a stopped problem does not move
                    delta = torch.where(live[..., None], delta, 0.0)
                rnd = backend.assign_update_batched(
                    stream, c_round, cache=cache, state=c.state, delta=delta,
                    live=live)
            else:
                rnd = backend.assign_update(stream, c_round, cache=cache,
                                            state=c.state, delta=delta)
            if gated:
                rnd = _inject_fit_fault(fault, i, rnd)
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
            r2 = backend.assign_update(stream, c_round, cache=cache)
            rnd = AssignRound(r2.assignment, r2.min_d2, r2.sums, r2.counts,
                              fresh_bounds(r2.state))
            new_inertia = sampling.fixed_sum(r2.state.partials)
            go_on = bool(improves(new_inertia)) if test else True
            c.recovered[i] = 1
        bstate = c.state
        if gated:
            rs, rp = rnd.skipped, rnd.pruned
            if live is not None:
                rs, rp = torch.where(live, rs, 0), torch.where(live, rp, 0)
            c.skipped[..., i], c.pruned[..., i] = rs, rp
            bstate = rnd.state
        new_cents = centroid_means(rnd.sums, rnd.counts, cents)
        if empty == "reseed":
            new_cents = reseed_split_largest(new_cents, rnd.counts)
        if live is None:
            return c._replace(i=i + 1, centroids=new_cents,
                              prev_centroids=cents, inertia=new_inertia,
                              assignment=rnd.assignment, state=bstate,
                              go_on=go_on)
        # a problem that has stopped keeps its results
        return c._replace(
            i=i + 1,
            centroids=torch.where(live[..., None, None], new_cents, cents),
            prev_centroids=cents,
            inertia=torch.where(live, new_inertia, c.inertia),
            assignment=torch.where(live[..., None], rnd.assignment,
                                   c.assignment),
            state=bstate, live=flags[-1] if test else live,
            n_iters=c.n_iters + live.int(), go_on=go_on)

    def finish(c: FitCarry):
        return (c.centroids, c.assignment, c.inertia,
                c.i if c.live is None else c.n_iters, c.skipped, c.pruned,
                c.recovered if guard else None)

    return make_init, step, stopped, finish


def _fit_loop(pts, init_centroids, backend: Backend, max_iters: int,
              tol: float, empty: str, cache: RoundCache, **parts):
    """Lloyd iterations (:func:`_fit_parts`' parts run to the end)."""
    make_init, step, stopped, finish = _fit_parts(
        pts, init_centroids, backend, max_iters, tol, empty, cache, **parts)
    carry = make_init()
    while not stopped(carry):
        carry = step(carry)
    return finish(carry)


def fit_points(points: torch.Tensor, init_centroids: torch.Tensor,
               backend: Backend, max_iters: int, tol: float,
               empty: str = "keep",
               cache: Optional[RoundCache] = None, *,
               weights: Optional[torch.Tensor] = None,
               bound_gate: bool = True, guard: bool = False,
               stream: Optional[torch.Tensor] = None, fault=None,
               parts: bool = False):
    """Lloyd clustering through ``backend``. ``empty`` picks the
    empty-cluster policy: 'keep' (previous centroid survives) or 'reseed'
    (split the largest cluster). ``cache`` is an optional precomputed
    prologue. ``bound_gate`` runs the gated loop (bitwise the ungated
    results); ``guard`` arms its in-flight corruption detector, and
    ``fault`` (a ``testing.FaultSpec``: ``zero_counts`` or ``nan_state``)
    poisons one gated iteration (tests; :func:`_inject_fit_fault`).
    ``parts`` returns the loop's ``(make_init, step, stopped, finish)``
    (:func:`_fit_parts`) instead of running it: what the checkpointed fit
    drives in chunks.

    ``weights`` (n,) weigh each point in the update and the inertia. A
    weighted fit runs the untiled round on the cached norms (computed here,
    without a prologue, when no ``cache`` is passed), ungated and
    unguarded, with ``skipped``/``pruned``/``recovered`` None, as the
    reference's.

    ``stream`` is the points every round reads, the fp32 points by
    default (:func:`_stream_of`'s bf16 copy under ``precision='bf16'``);
    the norms, the accumulators, the bound state and the centroids stay
    fp32.

    ``points`` (B, n, d) and ``init_centroids`` (B, k, d) fit B independent
    problems in one loop, gated or not, without the in-flight guard (as the
    reference under ``vmap``); every field of the result gains the leading
    axis and ``n_iters`` is (B,) int32, each problem's own."""
    if empty not in ("keep", "reseed"):
        raise ValueError(f"unknown empty-cluster policy {empty!r}; "
                         "expected 'keep' or 'reseed'")
    if points.dim() == 3 and guard:
        raise NotImplementedError(
            "batched fits run without the in-flight guard, as the "
            "reference does under vmap")
    pts = points.float()
    if stream is None:
        stream = pts
    k = init_centroids.shape[-2]
    if weights is not None:
        if points.dim() == 3:
            raise ValueError("batched problems take no weights, as in the "
                             "reference")
        norms = bounds.point_norms(pts) if cache is None else cache.norms
        cache = RoundCache(norms)
        loop = dict(gated=False, guard=False, w=weights.to(pts))
    else:
        if cache is None:
            cache = backend.prologue(pts, m=k, with_bounds=bound_gate)
        loop = dict(gated=bound_gate and cache.centers is not None,
                    guard=guard, fault=fault)
    args = (pts, init_centroids, backend, max_iters, tol, empty, cache)
    if parts:
        return _fit_parts(*args, stream=stream, **loop)
    return LloydResult(*_fit_loop(*args, stream=stream, **loop))


def kmeans_points(draws: Draws, points: torch.Tensor, k: int,
                  backend: Backend, sampler: str = "cdf",
                  max_iters: int = 50, tol: float = 1e-6,
                  empty: str = "keep", *,
                  weights: Optional[torch.Tensor] = None,
                  bound_gate: bool = True,
                  guard: bool = False, refresh_block: int = 8,
                  proposal: str = "hier",
                  max_attempts: int = _REJECT_ATTEMPTS,
                  precision: str = "fp32") -> LloydResult:
    """End-to-end k-means++ seeding + Lloyd with ONE shared prologue: the
    backend's ``tile_m`` is pinned to k so both phases agree on one tile
    geometry, and the norms (and tile balls, with ``bound_gate``) are
    computed once, as is the rounds' stream (a bf16 copy under
    ``precision='bf16'``). ``weights`` go to both phases."""
    be = dataclasses.replace(backend, tile_m=k)
    pts = points.float()
    stream = _stream_of(pts, precision)
    cache = be.prologue(pts, m=k, with_bounds=bound_gate)
    seeds = seed_points(draws, pts, k, be, sampler, weights=weights,
                        bound_gate=bound_gate, cache=cache, guard=guard,
                        refresh_block=refresh_block, proposal=proposal,
                        max_attempts=max_attempts, stream=stream)
    return fit_points(pts, seeds.centroids, be, max_iters, tol, empty,
                      cache=cache, weights=weights, bound_gate=bound_gate,
                      guard=guard, stream=stream)


# ---------------------------------------------------------------------------
# mini-batch Lloyd (streaming)
# ---------------------------------------------------------------------------


def minibatch_step(cents: torch.Tensor, counts: torch.Tensor,
                   batch: torch.Tensor, backend: Backend,
                   precision: str = "fp32"):
    """One mini-batch Lloyd step (Sculley 2010, batch form): per-center
    counts give each center a 1/t-decaying learning rate, so centers
    converge to the running mean of every point ever assigned to them.

        c_j <- c_j + eta_j * (batch_mean_j - c_j),  eta_j = m_j / (N_j + m_j)

    The batch's sums and counts come from the untiled round (K4 on the
    card) on norms computed per batch from the fp32 rows; under
    ``precision='bf16'`` the round streams the batch's bf16 copy, made
    once per batch, and the centroids rounded to bf16. Returns (centroids,
    counts, the batch's inertia (fixed-order sum), the batch's labels)."""
    pts = batch.float()
    stream = _stream_of(pts, precision)
    rnd = backend.assign_update(stream, cents.to(stream.dtype),
                                norms=bounds.point_norms(pts))
    bcounts = rnd.counts
    new_counts = counts + bcounts
    eta = torch.where(new_counts > 0,
                      bcounts / new_counts.clamp_min(1.0), 0.0)
    bmeans = rnd.sums / bcounts.clamp_min(1e-12)[:, None]
    new_cents = torch.where((bcounts > 0)[:, None],
                            cents + eta[:, None] * (bmeans - cents), cents)
    return (new_cents, new_counts, sampling.fixed_sum(rnd.min_d2),
            rnd.assignment)


BatchSource = Union[Iterable, Callable[[int], object]]


def _iter_batches(batches: BatchSource, n_batches: Optional[int], device):
    """A batch source as an iterator of fp32 tensors on ``device``: a
    callable ``read_fn(step) -> array`` (driven through a prefetching
    :class:`~repro_torch.data.pipeline.DataPipeline`, stopped when the
    iterator is closed), a ``DataPipeline`` (yielding ``(step, batch)``),
    or any iterable of arrays or ``(step, array)`` pairs; a dict batch
    gives its ``"points"``."""
    from repro_torch.data.pipeline import DataPipeline

    pipe = None
    if callable(batches) and not hasattr(batches, "__iter__"):
        if n_batches is None:
            raise ValueError("n_batches is required with a read_fn source")
        pipe = DataPipeline(batches, device=device)
        batches = iter(pipe)
    elif isinstance(batches, DataPipeline) and n_batches is None:
        # a pipeline streams forever; without a count the loop never ends
        raise ValueError("n_batches is required with a DataPipeline source")
    try:
        # islice stops before reading a batch past the count
        for item in itertools.islice(batches, n_batches):
            if isinstance(item, tuple) and len(item) == 2:
                item = item[1]
            if isinstance(item, dict):
                item = item["points"]
            yield torch.as_tensor(item, dtype=torch.float32, device=device)
    finally:
        if pipe is not None:
            pipe.stop()


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

    Precision: ``precision`` 'fp32' (the default) or 'bf16'. Under 'bf16'
    every seeding and assignment round, on every entry point (batched,
    weighted and mini-batch included), streams a bf16 copy of the points
    made once per call (per batch in ``fit_minibatch``), and the round's
    centroids rounded to bf16: the kernels' bf16 instances on the card.
    The norms, D², the bound state, the accumulators and the centroid carry
    stay fp32; seeds are taken from the fp32 points and the centroids come
    back fp32. IVF serving and KV-cache PQ build their own engines and stay
    fp32.

    Weights: ``seed``, ``fit`` and ``kmeans`` take ``weights`` (n,), one
    non-negative weight per point (a coreset's multiplicities), checked by
    the entry guard. A weighted fit runs the untiled round (K4 on the
    card), ungated, its counters None. ``fit_minibatch`` streams batches
    through the same round.

    Order: ``fit``, ``kmeans``, ``fit_batched``, ``kmeans_batched`` and
    ``fit_minibatch`` take ``order`` ('morton' or a precomputed
    permutation): the kernels see that row layout, the assignment comes
    back in the caller's order and ``LloydResult.reorder`` holds the
    permutation.

    Randomness: ``generator`` seeds a :class:`Draws` source for the run;
    ``draws`` passes one in instead (to replay a run, or the reference's
    key schedule). A kernel that fails to build or launch raises
    ``KernelFailureError``; there is no fallback backend.

    Batched problems: ``seed_batched``, ``fit_batched`` and
    ``kmeans_batched`` take (B, n, d) points and return results with a
    leading (B,) axis, row b bitwise the single problem's, counters
    included; they take ``bounds`` on or off and every sampler. They run
    without the in-flight guards, as the reference does under ``vmap``.
    """

    def __init__(self, backend: Union[str, Backend] = "cuda", *,
                 device=None, precision: str = "fp32", bounds: bool = True,
                 validate: str = "raise", **backend_opts):
        _check_precision(precision)
        self.precision = precision
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

    def _weights(self, weights, n: int) -> Optional[torch.Tensor]:
        if weights is None:
            return None
        w = torch.as_tensor(weights, dtype=torch.float32, device=self.device)
        return guards.guard_weights(w, n, self.validate)

    def _draws(self, n, k, generator, draws, sampler, max_attempts,
               weighted: bool = False) -> Draws:
        if draws is None:
            return Draws.sample(
                n, k, generator=generator, device=self.device,
                max_attempts=(max(int(max_attempts), 1)
                              if sampler == "rejection" else 0),
                weighted=weighted)
        return draws.to(self.device)

    # -- row ordering (order=) -------------------------------------------

    def _resolve_order(self, points: torch.Tensor, order, *,
                       batched: bool = False):
        """order: None (natural), 'auto' (natural: the port has no tuner),
        an ordering name ('morton', see ``data.ordering``), or a
        precomputed permutation ((n,), or (B, n) for batched problems).
        Returns (perm, inv) int32 or (None, None)."""
        if order is None or (isinstance(order, str) and order == "auto"):
            return None, None
        if isinstance(order, str):
            return ordering.spatial_order(points, method=order)
        perm = torch.as_tensor(order, device=points.device).to(torch.int32)
        want = tuple(points.shape[:-1]) if batched else (points.shape[0],)
        if tuple(perm.shape) != want:
            raise guards.InvalidInputError(
                f"order permutation shape {tuple(perm.shape)} != {want}")
        return perm, ordering.inverse_permutation(perm)

    def _order_in(self, points, order, weights=None, *, batched=False):
        """Permute on entry: (points', weights', perm, inv)."""
        perm, inv = self._resolve_order(points, order, batched=batched)
        if perm is not None:
            idx = perm.long()
            if batched:
                points = torch.take_along_dim(points, idx[..., None], dim=1)
            else:
                points = points[idx]
                if weights is not None:
                    weights = weights[idx]
        return points, weights, perm, inv

    @staticmethod
    def _order_out(res: LloydResult, perm, inv) -> LloydResult:
        """Invert on exit: the assignment back in the caller's row order,
        the permutation recorded in ``reorder``."""
        if perm is None:
            return res
        a = torch.take_along_dim(res.assignment, inv.long(), dim=-1)
        return res._replace(assignment=a, reorder=perm)

    def seed(self, points, k: int, *,
             weights=None,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None,
             sampler: str = "cdf", refresh_block: int = 8,
             proposal: str = "hier",
             max_attempts: int = _REJECT_ATTEMPTS,
             checkpoint_dir=None, checkpoint_every: int = 1,
             _fault=None) -> KmeansppResult:
        """K-means++ seeding: k centroids chosen from ``points`` ∝ D² (∝
        D²·w with ``weights``, the first ∝ w). ``refresh_block``,
        ``proposal`` and ``max_attempts`` are the rejection sampler's (see
        :func:`seed_points`).

        ``checkpoint_dir`` (a directory or a
        ``checkpoint.CheckpointManager``) runs the loop in resumable chunks
        of ``checkpoint_every`` rounds, saving the whole carry after each
        (:class:`SeedCarry`: the round counter, the run's ``Draws``,
        centroids, indices, min_d2, the bound state and the counters); a
        checkpoint already in the directory resumes the run there, with
        the saved draws, and the finished result is bitwise the
        uninterrupted one. 'cdf' and 'tiled' only. ``_fault`` is the
        fault-injection hook (a ``testing.FaultSpec``; tests only)."""
        pts = self._points(points)
        n = pts.shape[0]
        guards.check_shape(k, n)
        w = self._weights(weights, n)
        if checkpoint_dir is not None and sampler == "rejection":
            raise guards.CheckpointError(
                "checkpointed seeding needs a per-round refresh; the "
                "rejection sampler's stale-envelope carry is not saved: use "
                "sampler='tiled' (the same distribution)")
        drawn = self._draws(n, k, generator, draws, sampler, max_attempts,
                            w is not None)
        kw = dict(weights=w, bound_gate=self.bounds, guard=self._guard,
                  fault=_fault, stream=_stream_of(pts, self.precision))
        if checkpoint_dir is not None:
            return self._seed_checkpointed(drawn, pts, k, sampler, kw,
                                           checkpoint_dir, checkpoint_every)
        return seed_points(drawn, pts, k, self.backend, sampler,
                           refresh_block=int(refresh_block),
                           proposal=proposal,
                           max_attempts=int(max_attempts), **kw)

    def fit(self, points, init_centroids, *, max_iters: int = 50,
            tol: float = 1e-6, weights=None, empty: str = "keep",
            order=None, checkpoint_dir=None, checkpoint_every: int = 1,
            _fault=None) -> LloydResult:
        """Lloyd iterations from ``init_centroids`` until convergence, each
        point weighted by ``weights`` when given. ``order`` feeds the
        kernels a tile-coherent row layout ('morton', or a precomputed (n,)
        permutation; None and 'auto' keep the caller's order): applied on
        the way in and inverted on the way out, so ``assignment`` is in the
        caller's row order, with the permutation in ``reorder``.

        ``checkpoint_dir`` (a directory or a
        ``checkpoint.CheckpointManager``) runs the loop in resumable chunks
        of ``checkpoint_every`` iterations, saving the whole carry after
        each (:class:`FitCarry`: the iteration counter, the centroid pair,
        the inertia, the bound state, the counters and the stop test's
        verdict); a checkpoint already in the directory resumes the fit
        there (one restored from a converged run runs no iteration), and
        the result is bitwise the uninterrupted one. Unweighted and
        ``bounds=True`` only. ``_fault`` is the fault-injection hook (a
        ``testing.FaultSpec``; tests only)."""
        pts = self._points(points)
        w = self._weights(weights, pts.shape[0])
        cents = torch.as_tensor(init_centroids, dtype=torch.float32,
                                device=self.device)
        cents = guards.guard_centroids(cents, pts.shape[1], self.validate)
        if checkpoint_dir is not None and (w is not None or not self.bounds):
            raise guards.CheckpointError(
                "checkpointed fit needs unweighted points and bounds=True "
                "(the saved carry is the gated loop's)")
        pts, w, perm, inv = self._order_in(pts, order, w)
        kw = dict(weights=w, bound_gate=self.bounds, guard=self._guard,
                  stream=_stream_of(pts, self.precision), fault=_fault)
        if checkpoint_dir is not None:
            res = self._fit_checkpointed(pts, cents, max_iters, float(tol),
                                         empty, kw, checkpoint_dir,
                                         checkpoint_every)
        else:
            res = fit_points(pts, cents, self.backend, max_iters, float(tol),
                             empty, **kw)
        return self._order_out(res, perm, inv)

    # -- checkpointed runs ------------------------------------------------

    def _ckpt_meta(self, kind: str, n: int, d: int, k: int, **extra) -> dict:
        """What decides a checkpointed run's bits: the problem, the
        engine's precision, gating, backend and device, and the tile
        geometry (the kernels are not bitwise their plain twins, and a
        bound state read under another tile height describes other rows)."""
        tile = self.backend.seed_tile(n, d, k if kind == "fit" else 1)
        meta = {"kind": kind, "n": int(n), "d": int(d), "k": int(k),
                "precision": self.precision, "bounds": self.bounds,
                "backend": self.backend.name, "device": self.device.type,
                "block_n": int(tile),
                "tps": int(self.backend.tiles_per_super(-(-n // tile)))}
        meta.update(extra)
        return meta

    @staticmethod
    def _check_meta(mgr, want: dict) -> Optional[int]:
        """The latest resumable step, or None for a fresh start. A
        checkpoint written by an incompatible call raises
        ``CheckpointError``, never a silent restore."""
        step = mgr.latest_step()
        if step is None:
            return None
        got = mgr.read_manifest(step).get("meta")
        if got != want:
            raise guards.CheckpointError(
                f"checkpoint under {mgr.dir} was written by an incompatible "
                f"call: saved meta {got} != expected {want}")
        return step

    @staticmethod
    def _manager(checkpoint_dir):
        from repro_torch.checkpoint.manager import CheckpointManager
        if isinstance(checkpoint_dir, CheckpointManager):
            return checkpoint_dir
        return CheckpointManager(checkpoint_dir, async_save=False)

    def _seed_checkpointed(self, draws, pts, k, sampler, kw, checkpoint_dir,
                           checkpoint_every) -> KmeansppResult:
        """seed() with a checkpoint: :func:`_seed_parts`' rounds (the
        one-shot loop's) in chunks of ``checkpoint_every``, the carry saved
        after each chunk (a host snapshot taken before the next round's
        first launch: the rounds write min_d2 in place)."""
        n, d = pts.shape
        mgr = self._manager(checkpoint_dir)
        make_init, body, finish = seed_points(draws, pts, k, self.backend,
                                              sampler, parts=True, **kw)
        meta = self._ckpt_meta("seed", n, d, k, sampler=sampler,
                               weighted=kw["weights"] is not None)
        step = self._check_meta(mgr, meta)
        carry = make_init(draws)
        if step is not None:
            _, carry = mgr.restore(carry, step=step)
        every = max(int(checkpoint_every), 1)
        while carry.m < k:
            stop = min(carry.m + every, k)
            while carry.m < stop:
                carry = body(carry)
            mgr.save(carry.m, carry, blocking=True, meta=meta)
        centroids, indices, min_d2, skips, prunes, rec = finish(carry)
        return KmeansppResult(centroids, indices, min_d2, skips, prunes,
                              recovered=rec if self._guard else None)

    def _fit_checkpointed(self, pts, cents, max_iters, tol, empty, kw,
                          checkpoint_dir, checkpoint_every) -> LloydResult:
        """fit() with a checkpoint: :func:`_fit_parts`' iterations (the
        one-shot loop's) in chunks of ``checkpoint_every``, the carry saved
        after each chunk. The assignment is saved once, as the bound
        state's (the carry's two are one tensor after an iteration); a
        carry restored from a converged run runs no iteration and saves no
        step again."""
        n, d = pts.shape
        mgr = self._manager(checkpoint_dir)
        make_init, step_fn, stopped, finish = fit_points(
            pts, cents, self.backend, max_iters, tol, empty, parts=True,
            **kw)
        meta = self._ckpt_meta("fit", n, d, cents.shape[0],
                               max_iters=int(max_iters), tol=float(tol),
                               empty=empty)
        step = self._check_meta(mgr, meta)
        carry = make_init()
        if step is not None:
            _, saved = mgr.restore(carry._replace(assignment=None),
                                   step=step)
            carry = saved._replace(assignment=saved.state.assignment)
        every = max(int(checkpoint_every), 1)
        while not stopped(carry):
            stop = carry.i + every
            while carry.i < stop and not stopped(carry):
                carry = step_fn(carry)
            mgr.save(carry.i, carry._replace(assignment=None), blocking=True,
                     meta=meta)
        return LloydResult(*finish(carry))

    def kmeans(self, points, k: int, *,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Draws] = None, sampler: str = "cdf",
               max_iters: int = 50, tol: float = 1e-6,
               empty: str = "keep", weights=None, refresh_block: int = 8,
               proposal: str = "hier", max_attempts: int = _REJECT_ATTEMPTS,
               order=None) -> LloydResult:
        """End to end: k-means++ seeding (the paper's phase) + Lloyd, sharing
        one prologue; ``weights`` go to both phases. ``order`` reorders the
        rows once up front (see :meth:`fit`), so both phases see that
        layout; the draws index the reordered rows."""
        pts = self._points(points)
        n = pts.shape[0]
        w = self._weights(weights, n)
        guards.check_shape(k, n)
        pts, w, perm, inv = self._order_in(pts, order, w)
        return self._order_out(kmeans_points(
            self._draws(n, k, generator, draws, sampler, max_attempts,
                        w is not None),
            pts, k, self.backend, sampler, max_iters, float(tol), empty,
            weights=w, bound_gate=self.bounds, guard=self._guard,
            refresh_block=int(refresh_block), proposal=proposal,
            max_attempts=int(max_attempts), precision=self.precision),
            perm, inv)

    # -- streaming mini-batch Lloyd ---------------------------------------

    def fit_minibatch(self, init_centroids, batches: BatchSource, *,
                      n_batches: Optional[int] = None, tol: float = 0.0,
                      patience: int = 5, order=None) -> LloydResult:
        """Streaming mini-batch k-means over fixed-size batches (Sculley
        2010; see :func:`minibatch_step`), one untiled round (K4 on the
        card) per batch.

        ``batches`` is a ``read_fn(step) -> (b, d) array`` (driven through a
        prefetching :class:`~repro_torch.data.pipeline.DataPipeline` that
        moves each batch to the engine's device once), a ``DataPipeline``,
        or any iterable of batches. Each batch passes the engine's
        ``validate`` guard before its step, and a read that keeps failing
        past the pipeline's retries raises ``guards.PipelineError`` with the
        failing step.

        Early stop: with ``tol`` > 0, the run stops after ``patience``
        consecutive batches whose smoothed per-point inertia improves by
        less than ``tol`` (relative). The result's assignment and inertia
        are the LAST batch's; ``n_iters`` is the number of batches used.
        ``order`` ('morton') reorders each batch before its step, and the
        last batch's assignment comes back in that batch's own row order
        (the step carries no bound state, so this is layout only)."""
        init = torch.as_tensor(init_centroids)
        cents = guards.guard_centroids(
            init.to(device=self.device, dtype=torch.float32),
            init.shape[-1], self.validate)
        counts = torch.zeros(cents.shape[0], device=self.device)
        a = torch.zeros(0, dtype=torch.int32, device=self.device)
        last_inertia = torch.tensor(torch.inf, device=self.device)
        seen, stale, ema, inv = 0, 0, None, None
        with contextlib.closing(_iter_batches(batches, n_batches,
                                              self.device)) as stream:
            for batch in stream:
                batch = guards.guard_points(batch, self.validate,
                                            name=f"batch {seen}")
                batch, _, _, inv = self._order_in(batch, order)
                cents, counts, last_inertia, a = minibatch_step(
                    cents, counts, batch, self.backend, self.precision)
                seen += 1
                if tol > 0.0:
                    per_point = float(last_inertia) / max(batch.shape[0], 1)
                    prev = ema
                    ema = (per_point if ema is None
                           else 0.7 * ema + 0.3 * per_point)
                    if (prev is not None
                            and prev - ema <= tol * max(prev, 1e-30)):
                        stale += 1
                        if stale >= patience:
                            break
                    else:
                        stale = 0
        if seen == 0:
            raise ValueError("empty batch source")
        if inv is not None:
            a = a[inv.long()]
        return LloydResult(cents.to(init.dtype), a, last_inertia, seen)

    # -- batched multi-problem clustering ---------------------------------

    def _batched(self, points, sampler: str = "cdf") -> torch.Tensor:
        """The (B, n, d) points of a batched call, after the entry guard."""
        _check_sampler(sampler)
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        if pts.dim() != 3:
            raise guards.InvalidInputError(
                f"points must be (B, n, d), got {tuple(pts.shape)}")
        return guards.guard_points(pts.contiguous(), self.validate)

    def seed_batched(self, points, k: int, *,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Draws] = None,
                     sampler: str = "cdf", refresh_block: int = 8,
                     proposal: str = "hier",
                     max_attempts: int = _REJECT_ATTEMPTS) -> KmeansppResult:
        """Seed B independent (n, d) problems, one seeding round for all B
        per round (K8 on the card, K7 with ``bounds=False``), the counters
        (B, k). ``draws`` are batched
        (``Draws.sample_batched``, with ``max_attempts`` for 'rejection');
        problem b picks exactly the seeds ``seed`` picks with ``draws[b]``.
        'rejection' (``refresh_block``, ``proposal`` and ``max_attempts``
        as for :meth:`seed`, with the reference's defaults) refreshes only
        the problems that need it, one K8 (K7) launch over their list, and
        prices every problem's attempts in one K11 launch a round. No
        in-flight guard, as in the reference under ``vmap``; the entry
        guard covers all B."""
        pts = self._batched(points, sampler)
        bsz, n, _ = pts.shape
        guards.check_shape(k, n)
        if draws is None:
            draws = Draws.sample_batched(
                bsz, n, k, generator=generator,
                max_attempts=(max(int(max_attempts), 1)
                              if sampler == "rejection" else 0))
        return seed_points(draws.to(self.device), pts, k, self.backend,
                           sampler, bound_gate=self.bounds,
                           refresh_block=int(refresh_block),
                           proposal=proposal, max_attempts=int(max_attempts),
                           stream=_stream_of(pts, self.precision))

    def fit_batched(self, points, init_centroids, *, max_iters: int = 50,
                    tol: float = 1e-6, empty: str = "keep",
                    order=None) -> LloydResult:
        """Lloyd over B independent problems: points (B, n, d), inits
        (B, k, d), one assignment round for all B per iteration (K10b on
        the card, K10a with ``bounds=False``). Each problem stops at its own
        convergence test and keeps its results from then on, its counters
        reading 0; ``n_iters`` is (B,), each problem's own. ``order``
        reorders each problem's rows on its own (see :meth:`fit`); the
        (B, n) permutations come back in ``reorder``."""
        pts = self._batched(points)
        pts, _, perm, inv = self._order_in(pts, order, batched=True)
        cents = torch.as_tensor(init_centroids, dtype=torch.float32,
                                device=self.device)
        if cents.dim() != 3 or cents.shape[0] != pts.shape[0]:
            raise guards.InvalidInputError(
                f"init_centroids must be ({pts.shape[0]}, k, d), got "
                f"{tuple(cents.shape)}")
        cents = guards.guard_centroids(cents, pts.shape[-1], self.validate)
        return self._order_out(fit_points(
            pts, cents, self.backend, max_iters, float(tol), empty,
            bound_gate=self.bounds,
            stream=_stream_of(pts, self.precision)), perm, inv)

    def kmeans_batched(self, points, k: int, *,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Draws] = None, max_iters: int = 50,
                       tol: float = 1e-6, sampler: str = "cdf",
                       empty: str = "keep", order=None) -> LloydResult:
        """``seed_batched`` then ``fit_batched``, each with its own prologue
        (the batched K1 on the card, with ``bounds``) and tile geometry, as
        in the reference (unlike ``kmeans``, which shares one prologue at the
        fit's tile height). Rejection seeding takes ``seed_batched``'s
        defaults (``refresh_block=8``, ``proposal='hier'``,
        ``max_attempts=8``), as the reference's, which passes only the
        sampler. The result carries the fit's counters.
        ``order`` reorders each problem once up front, so both phases see
        that layout; assignments map back to the caller's rows."""
        pts = self._batched(points, sampler)
        pts, _, perm, inv = self._order_in(pts, order, batched=True)
        seeds = self.seed_batched(pts, k, generator=generator,
                                  draws=draws, sampler=sampler)
        return self._order_out(self.fit_batched(
            pts, seeds.centroids, max_iters=max_iters, tol=tol, empty=empty),
            perm, inv)
