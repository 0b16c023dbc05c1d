"""ClusterEngine — k-means++ seeding and Lloyd over a pluggable Backend
(port of ``repro.core.engine``: the ungated and the bound-gated paths).

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

Gating is exact: the fp32 results are bitwise those of ``bounds=False``.

``CudaBackend`` runs them through the hand-written kernels (K1 prologue, K2
and K5 seeding rounds, K3 and K6 assignment rounds); ``FusedBackend`` runs
the kernels' plain torch twins; ``ReferenceBackend`` is the global-memory
(two-pass) seeding semantics. Loops are Python loops over device tensors: a
sampled index, a gate mask and a skip count never leave the device.
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
    centroids: torch.Tensor    # (k, d)
    indices: torch.Tensor      # (k,) int64 — which data points were chosen
    min_d2: torch.Tensor       # (n,) final D² to the nearest seed
    skipped: Optional[torch.Tensor] = None    # (k,) int32 tiles skipped per
    #                                           round (None: gating off)
    pruned: Optional[torch.Tensor] = None     # (k,) int32 points pruned
    #                                           inside active tiles per round
    recovered: Optional[torch.Tensor] = None  # (k,) int32 0/1 per-round
    #                                           heal flags (None: guard off)
    # counter contract (the reference's): fixed length (k,), one slot per
    # round (round m in slot m-1, the final fold in slot k-1), zero where a
    # round did not run the counted event


class SeedRound(NamedTuple):
    min_d2: torch.Tensor       # (n,) updated D² to the nearest centroid
    total: torch.Tensor        # () sum of min_d2 — the paper's phi
    partials: torch.Tensor     # (n_tiles,) per-tile partial sums
    tile_max: Optional[torch.Tensor] = None   # (n_tiles,) per-tile max of
    #                                           min_d2 (None: gating off)
    skipped: Union[torch.Tensor, int] = 0     # () tiles skipped this round
    pruned: Union[torch.Tensor, int] = 0      # () points pruned this round


class LloydResult(NamedTuple):
    centroids: torch.Tensor    # (k, d)
    assignment: torch.Tensor   # (n,) int32
    inertia: torch.Tensor      # () sum of squared distances to assigned
    n_iters: int
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
    previous centroid."""
    means = sums / counts.clamp_min(1e-12)[:, None]
    if prev_centroids is not None:
        means = torch.where((counts > 0)[:, None], means,
                            prev_centroids.float())
    return means


def reseed_split_largest(means: torch.Tensor, counts: torch.Tensor, *,
                         rel: float = 1e-3) -> torch.Tensor:
    """Empty-cluster reseeding: each empty cluster jumps to a nudged copy of
    the largest cluster's centroid (the r-th empty one at a distinct
    rank-scaled offset), so the next assignment splits the donor."""
    empty = counts <= 0
    target = means[counts.argmax()]
    emp = empty.to(means.dtype)
    off = (rel * (torch.cumsum(emp, 0) * emp))[:, None]
    nudged = target[None, :] * (1.0 + off) + off
    return torch.where(empty[:, None], nudged, means)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


def _gates(state: Optional[BoundState], cache: RoundCache) -> bool:
    """A round is gated when it carries bound state and the prologue made
    the tile balls."""
    return state is not None and cache.centers is not None


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
        a, md, part, gap, ssums, scounts = self._assign_tiled(
            points, cache.norms, centroids, tile, tps)
        state = BoundState(part, tile_gap=gap, tile_sums=ssums,
                           tile_counts=scounts, assignment=a, min_d2=md)
        return AssignRound(a, md, ssums.sum(dim=0), scounts.sum(dim=0),
                           state)

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
        # the per-tile counts are int32: the sum stays exact past 2^24
        return AssignRound(a, md, ssums.sum(dim=0), scounts.sum(dim=0),
                           new_state, (~active).sum().to(torch.int32),
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
        plus the tile balls when bound gating is on."""
        n, d = points.shape
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
    """The hand-written Hopper kernels: K1 for the prologue, K2 (K5 gated)
    for every seeding round, K3 (K6 gated) for every assignment round.
    ``resident=False`` re-reads the centroid block from global memory
    (Fig. 2's variant) instead of staging it in shared memory."""

    name: ClassVar[str] = "cuda"
    resident: bool = True

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

    def _assign_tiled(self, points, norms, centroids, tile, tps):
        return lloyd_assign.lloyd_assign_tiled(
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
            rnd = round_fn(centroids[j:j + 1], md, None)
            md = rnd.min_d2
        return rnd

    def checked_round(m, centroids, min_d2, state):
        rnd = round_fn(centroids[m - 1:m], min_d2, state)
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


def _seed_loop(draws: Draws, pts, k, *, round_fn, sample_fn, init_min_d2,
               init_state: Optional[BoundState], guard: bool, tile: int):
    """Generic k-means++ loop: round m folds centroid m-1 into min_d2 and
    draws seed m with ``draws.u[m-1]``; a final round folds the last seed,
    so the returned min_d2 covers all k. The sampled index stays on the
    device: seeds are gathered with index_select, never read on the host.
    ``init_state`` turns on bound gating (round 1 starts from tile_max =
    +inf, nothing skippable); the per-round skip and prune counts stay on
    the device. Returns (centroids, indices, min_d2, skipped, pruned,
    recovered)."""
    gated = init_state is not None
    checked_round = _seed_parts(round_fn=round_fn, init_min_d2=init_min_d2,
                                gated=gated, guard=guard, tile=tile)
    dev = pts.device
    centroids = pts.new_zeros((k, pts.shape[1]))
    indices = torch.zeros(k, dtype=torch.int64, device=dev)
    skips = torch.zeros(k, dtype=torch.int32, device=dev) if gated else None
    prunes = torch.zeros(k, dtype=torch.int32, device=dev) if gated else None
    rec = [0] * k
    first = draws.first.reshape(1)
    centroids[0:1] = pts.index_select(0, first)
    indices[0:1] = first
    min_d2, state = init_min_d2, init_state
    for m in range(1, k + 1):
        min_d2, partials, state, rs, rp, rec[m - 1] = checked_round(
            m, centroids, min_d2, state)
        if gated:
            skips[m - 1], prunes[m - 1] = rs, rp
        if m == k:
            break
        nxt = sample_fn(draws.u[m - 1], draws.fallback[m - 1:m], min_d2,
                        partials)
        centroids[m:m + 1] = pts.index_select(0, nxt)
        indices[m:m + 1] = nxt
    return (centroids, indices, min_d2, skips, prunes,
            torch.tensor(rec, dtype=torch.int32))


def seed_points(draws: Draws, points: torch.Tensor, k: int,
                backend: Backend, sampler: str = "cdf", *,
                bound_gate: bool = True,
                cache: Optional[RoundCache] = None,
                guard: bool = False) -> KmeansppResult:
    """Full k-means++ seeding through ``backend``. Samplers: 'cdf' (full
    inverse CDF, the serial algorithm) and 'tiled' (two-level inverse CDF
    from the round's per-tile partials — O(n/tile + tile) reads per draw,
    the same distribution). The prologue runs once here unless a ``cache``
    is passed in (``kmeans_points`` shares one across both phases). With
    ``bound_gate`` the loop carries the per-tile bound state so each round
    skips every provably unchanged tile and prunes provably stable points
    inside active tiles; the results are bitwise those of the ungated
    loop."""
    _check_sampler(sampler)
    n, d = points.shape
    pts = points.float()
    if cache is None:
        cache = backend.prologue(pts, with_bounds=bound_gate)
    tile = backend.seed_tile(n, d)
    if draws.u.shape[0] < k - 1 or draws.fallback.shape[0] < k - 1:
        raise ValueError(f"draws hold {draws.u.shape[0]} rounds, seeding "
                         f"k={k} needs {k - 1}")
    init_state = None
    if bound_gate and cache.centers is not None:
        n_tiles = -(-n // tile)
        init_state = BoundState(
            torch.zeros(n_tiles, device=pts.device),
            torch.full((n_tiles,), torch.inf, device=pts.device))

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

    centroids, indices, min_d2, skips, prunes, rec = _seed_loop(
        draws.to(pts.device), pts, k,
        round_fn=lambda c, md, st: backend.seed_round(pts, c, md,
                                                      cache=cache, state=st),
        sample_fn=sample_fn,
        init_min_d2=torch.full((n,), torch.inf, device=pts.device),
        init_state=init_state, guard=guard, tile=tile)
    return KmeansppResult(centroids, indices, min_d2, skips, prunes,
                          recovered=rec if guard else None)


def _check_sampler(sampler: str) -> None:
    if sampler in ("gumbel", "rejection"):
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet; "
                                  "use 'cdf' or 'tiled'")
    if sampler not in ("cdf", "tiled"):
        raise ValueError(f"unknown sampler {sampler!r}; expected 'cdf' or "
                         "'tiled'")


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

    Returns (centroids, assignment, inertia, n_iters, skipped, pruned,
    recovered); the counters are None when the loop is not gated, and
    ``recovered`` also when the guard is off."""
    n, d = pts.shape
    k = init_centroids.shape[0]
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
    inertia = torch.tensor(torch.inf, device=dev)
    a = torch.zeros(n, dtype=torch.int32, device=dev)
    rec = [0] * max_iters

    def improves(new_inertia) -> torch.Tensor:
        return (inertia - new_inertia) / inertia.clamp_min(1e-30) > tol

    i = 0
    while i < max_iters:
        delta = bounds.centroid_movement(cents, prev_cents) if gated else None
        rnd = backend.assign_update(pts, cents, cache=cache, state=bstate,
                                    delta=delta)
        new_inertia = rnd.state.partials.sum()
        flags = []
        if guard:
            flags.append(torch.isfinite(new_inertia)
                         & ((rnd.counts.sum() - n).abs() < 0.5))
        test = 2 <= i + 1 < max_iters     # does iteration i + 1 test?
        if test:
            flags.append(improves(new_inertia))
        # one host sync per iteration: the guard's checks + convergence
        got = torch.stack(flags).tolist() if flags else []
        go_on = got[-1] if test else True
        if guard and not got[0]:
            r2 = backend.assign_update(pts, cents, cache=cache)
            rnd = AssignRound(r2.assignment, r2.min_d2, r2.sums, r2.counts,
                              fresh_bounds(r2.state))
            new_inertia = r2.state.partials.sum()
            go_on = bool(improves(new_inertia)) if test else True
            rec[i] = 1
        if gated:
            skips[i], prunes[i] = rnd.skipped, rnd.pruned
            bstate = rnd.state
        new_cents = centroid_means(rnd.sums, rnd.counts, cents)
        if empty == "reseed":
            new_cents = reseed_split_largest(new_cents, rnd.counts)
        prev_cents, cents, inertia, a = (cents, new_cents, new_inertia,
                                         rnd.assignment)
        i += 1
        if not go_on:
            break
    return (cents, a, inertia, i, skips, prunes,
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
    results); ``guard`` arms its in-flight corruption detector."""
    if empty not in ("keep", "reseed"):
        raise ValueError(f"unknown empty-cluster policy {empty!r}; "
                         "expected 'keep' or 'reseed'")
    pts = points.float()
    k = init_centroids.shape[0]
    if cache is None:
        cache = backend.prologue(pts, m=k, with_bounds=bound_gate)
    return LloydResult(*_fit_loop(
        pts, init_centroids, backend, max_iters, tol, empty, cache,
        gated=bound_gate and cache.centers is not None, guard=guard))


def kmeans_points(draws: Draws, points: torch.Tensor, k: int,
                  backend: Backend, sampler: str = "cdf",
                  max_iters: int = 50, tol: float = 1e-6,
                  empty: str = "keep", *, bound_gate: bool = True,
                  guard: bool = False) -> LloydResult:
    """End-to-end k-means++ seeding + Lloyd with ONE shared prologue: the
    backend's ``tile_m`` is pinned to k so both phases agree on one tile
    geometry, and the norms (and tile balls, with ``bound_gate``) are
    computed once."""
    be = dataclasses.replace(backend, tile_m=k)
    pts = points.float()
    cache = be.prologue(pts, m=k, with_bounds=bound_gate)
    seeds = seed_points(draws, pts, k, be, sampler, bound_gate=bound_gate,
                        cache=cache, guard=guard)
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

    Randomness: ``generator`` seeds a :class:`Draws` source for the run;
    ``draws`` passes one in instead (to replay a run, or the reference's
    key schedule). A kernel that fails to build or launch raises
    ``KernelFailureError``; there is no fallback backend.
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

    def _draws(self, n, k, generator, draws) -> Draws:
        if draws is None:
            return Draws.sample(n, k, generator=generator, device=self.device)
        return draws.to(self.device)

    def seed(self, points, k: int, *,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None,
             sampler: str = "cdf") -> KmeansppResult:
        """K-means++ seeding: k centroids chosen from ``points`` ∝ D²."""
        pts = self._points(points)
        guards.check_shape(k, pts.shape[0])
        return seed_points(self._draws(pts.shape[0], k, generator, draws),
                           pts, k, self.backend, sampler,
                           bound_gate=self.bounds, guard=self._guard)

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
               empty: str = "keep") -> LloydResult:
        """End to end: k-means++ seeding (the paper's phase) + Lloyd, sharing
        one prologue."""
        pts = self._points(points)
        guards.check_shape(k, pts.shape[0])
        return kmeans_points(self._draws(pts.shape[0], k, generator, draws),
                             pts, k, self.backend, sampler, max_iters,
                             float(tol), empty, bound_gate=self.bounds,
                             guard=self._guard)
