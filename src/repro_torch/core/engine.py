"""ClusterEngine — k-means++ seeding and Lloyd over a pluggable Backend
(port of ``repro.core.engine``, the ungated path: ``bounds=False``).

A ``Backend`` provides the two round primitives the algorithms are written
against:

  seed_round(points, c_new, min_d2, cache=) -> SeedRound(min_d2', total,
      partials): fold the new centroid block into every point's D² and
      return the sum (the paper's min-update kernel + thrust::reduce) plus
      the per-tile partial sums the ``tiled`` sampler draws from.
  assign_update(points, centroids, cache=) -> AssignRound(assignment,
      min_d2, sums, counts, state): one Lloyd half-step in the tiled form
      (per-tile inertia partials and gaps, per-super-tile cluster sums).

``CudaBackend`` runs them through the hand-written kernels K2 and K3;
``FusedBackend`` runs the kernels' plain torch twins; ``ReferenceBackend``
is the global-memory (two-pass) seeding semantics. Loops are Python loops
over device tensors: a sampled index never leaves the device.
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
    recovered: Optional[torch.Tensor] = None  # (k,) int32 0/1 per-round
    #                                           heal flags (None: guard off)


class SeedRound(NamedTuple):
    min_d2: torch.Tensor       # (n,) updated D² to the nearest centroid
    total: torch.Tensor        # () sum of min_d2 — the paper's phi
    partials: torch.Tensor     # (n_tiles,) per-tile partial sums


class LloydResult(NamedTuple):
    centroids: torch.Tensor    # (k, d)
    assignment: torch.Tensor   # (n,) int32
    inertia: torch.Tensor      # () sum of squared distances to assigned
    n_iters: int


class AssignRound(NamedTuple):
    assignment: torch.Tensor   # (n,) int32
    min_d2: torch.Tensor       # (n,) D² to the assigned centroid
    sums: torch.Tensor         # (k, d) per-cluster sums
    counts: torch.Tensor       # (k,) per-cluster counts
    state: Optional[BoundState] = None


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

    def seed_round(self, points, c_new, min_d2, *,
                   cache: RoundCache) -> SeedRound:
        raise NotImplementedError

    def assign_update(self, points, centroids, *,
                      cache: RoundCache) -> AssignRound:
        """One ungated Lloyd half-step in the tiled form."""
        n = points.shape[0]
        tile = self.seed_tile(n, points.shape[1], centroids.shape[0])
        tps = self.tiles_per_super(-(-n // tile))
        a, md, part, gap, ssums, scounts = self._assign_tiled(
            points, cache.norms, centroids, tile, tps)
        state = BoundState(part, tile_gap=gap, tile_sums=ssums,
                           tile_counts=scounts, assignment=a, min_d2=md)
        return AssignRound(a, md, ssums.sum(dim=0), scounts.sum(dim=0),
                           state)

    def _assign_tiled(self, points, norms, centroids, tile, tps):
        return lloyd_assign.lloyd_assign_tiled_torch(
            points, norms, centroids, block_n=tile, tps=tps)

    def prologue(self, points) -> RoundCache:
        """Once-per-call pass: the cached fp32 norms every round streams."""
        return RoundCache(bounds.point_norms(points))

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

    def seed_round(self, points, c_new, min_d2, *, cache):
        n, d = points.shape
        new_md = torch.minimum(min_d2, _min_d2_to(points, c_new))
        return SeedRound(new_md, new_md.sum(), sampling.tile_partials(
            new_md, self.seed_tile(n, d, c_new.shape[0])))


@dataclasses.dataclass(frozen=True)
class FusedBackend(Backend):
    """The kernels' plain torch twins (cached-norm matmul form)."""

    name: ClassVar[str] = "fused"

    def seed_round(self, points, c_new, min_d2, *, cache):
        n, d = points.shape
        new_md, partials = kmeans_distance.distance_min_update_torch(
            points, cache.norms, c_new, min_d2,
            block_n=self.seed_tile(n, d, c_new.shape[0]))
        return SeedRound(new_md, partials.sum(), partials)


@dataclasses.dataclass(frozen=True)
class CudaBackend(Backend):
    """The hand-written Hopper kernels: K2 for every seeding round, K3 for
    every assignment round. ``resident=False`` re-reads the centroid block
    from global memory (Fig. 2's variant) instead of staging it in shared
    memory."""

    name: ClassVar[str] = "cuda"
    resident: bool = True

    def seed_round(self, points, c_new, min_d2, *, cache):
        n, d = points.shape
        new_md, partials = kmeans_distance.distance_min_update(
            points, cache.norms, c_new.contiguous(), min_d2,
            block_n=self.seed_tile(n, d, c_new.shape[0]),
            resident=self.resident)
        return SeedRound(new_md, partials.sum(), partials)

    def _assign_tiled(self, points, norms, centroids, tile, tps):
        return lloyd_assign.lloyd_assign_tiled(
            points, norms, centroids.contiguous(), block_n=tile, tps=tps)


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


def _seed_parts(*, round_fn, init_min_d2, guard: bool, tile: int):
    """The round step of the k-means++ loop, ``checked_round(m, centroids,
    min_d2) -> (min_d2, partials, recovered)``: fold centroid m-1 in.

    ``guard`` arms in-flight corruption detection: every round's ``total``
    doubles as the finite flag. A non-finite total means the carried min_d2
    is untrusted, so the round DISCARDS it and refolds rounds 0..m-1 from
    the clean +inf carry; the refold applies the same min-folds in the same
    order, so the healed carry is the one an uncorrupted run has."""

    def heal_min_d2(m, centroids):
        md = init_min_d2
        for j in range(m):
            md = round_fn(centroids[j:j + 1], md).min_d2
        return md

    def checked_round(m, centroids, min_d2):
        rnd = round_fn(centroids[m - 1:m], min_d2)
        # one host sync per round: the guard's finite check
        if not guard or bool(torch.isfinite(rnd.total)):
            return rnd.min_d2, rnd.partials, 0
        md = heal_min_d2(m, centroids)
        return md, sampling.tile_partials(md, tile), 1

    return checked_round


def _seed_loop(draws: Draws, pts, k, *, round_fn, sample_fn, init_min_d2,
               guard: bool, tile: int):
    """Generic k-means++ loop: round m folds centroid m-1 into min_d2 and
    draws seed m with ``draws.u[m-1]``; a final round folds the last seed,
    so the returned min_d2 covers all k. The sampled index stays on the
    device: seeds are gathered with index_select, never read on the host."""
    checked_round = _seed_parts(round_fn=round_fn, init_min_d2=init_min_d2,
                                guard=guard, tile=tile)
    centroids = pts.new_zeros((k, pts.shape[1]))
    indices = torch.zeros(k, dtype=torch.int64, device=pts.device)
    rec = [0] * k
    first = draws.first.reshape(1)
    centroids[0:1] = pts.index_select(0, first)
    indices[0:1] = first
    min_d2 = init_min_d2
    for m in range(1, k):
        min_d2, partials, rec[m - 1] = checked_round(m, centroids, min_d2)
        nxt = sample_fn(draws.u[m - 1], draws.fallback[m - 1:m], min_d2,
                        partials)
        centroids[m:m + 1] = pts.index_select(0, nxt)
        indices[m:m + 1] = nxt
    min_d2, _, rec[k - 1] = checked_round(k, centroids, min_d2)
    return centroids, indices, min_d2, torch.tensor(rec, dtype=torch.int32)


def seed_points(draws: Draws, points: torch.Tensor, k: int,
                backend: Backend, sampler: str = "cdf", *,
                cache: Optional[RoundCache] = None,
                guard: bool = False) -> KmeansppResult:
    """Full k-means++ seeding through ``backend``. Samplers: 'cdf' (full
    inverse CDF, the serial algorithm) and 'tiled' (two-level inverse CDF
    from the round's per-tile partials — O(n/tile + tile) reads per draw,
    the same distribution). The prologue runs once here unless a ``cache``
    is passed in (``kmeans_points`` shares one across both phases)."""
    _check_sampler(sampler)
    n, d = points.shape
    pts = points.float()
    if cache is None:
        cache = backend.prologue(pts)
    tile = backend.seed_tile(n, d)
    if draws.u.shape[0] < k - 1 or draws.fallback.shape[0] < k - 1:
        raise ValueError(f"draws hold {draws.u.shape[0]} rounds, seeding "
                         f"k={k} needs {k - 1}")

    if sampler == "tiled":
        def sample_fn(u, fb, weight, partials):
            return sampling.categorical_tiled(u, fb, weight, partials,
                                              block_n=tile)
    else:
        # the cdf sampler normalizes by its OWN cumsum's last entry, not by
        # the round's total: the two sum in different orders, and a 1-ulp
        # difference in the scale would flip boundary samples between
        # backends
        def sample_fn(u, fb, weight, partials):
            return sampling.categorical_cdf(u, fb, weight)

    centroids, indices, min_d2, rec = _seed_loop(
        draws.to(pts.device), pts, k,
        round_fn=lambda c, md: backend.seed_round(pts, c, md, cache=cache),
        sample_fn=sample_fn,
        init_min_d2=torch.full((n,), torch.inf, device=pts.device),
        guard=guard, tile=tile)
    return KmeansppResult(centroids, indices, min_d2,
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
              tol: float, empty: str, cache: RoundCache):
    """Lloyd iterations until the relative inertia improvement falls below
    ``tol`` or ``max_iters`` is hit. Each iteration is one tiled
    ``assign_update``; the inertia is the sum of its per-tile partials, the
    centroid update the super-axis sum of its accumulators."""
    cents = init_centroids.float()
    prev_inertia = inertia = torch.tensor(torch.inf, device=pts.device)
    a = torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)
    i = 0
    while i < max_iters:
        if i >= 2:
            rel = (prev_inertia - inertia) / prev_inertia.clamp_min(1e-30)
            # one host sync per iteration: the convergence test
            if not bool(rel > tol):
                break
        rnd = backend.assign_update(pts, cents, cache=cache)
        new_inertia = rnd.state.partials.sum()
        new_cents = centroid_means(rnd.sums, rnd.counts, cents)
        if empty == "reseed":
            new_cents = reseed_split_largest(new_cents, rnd.counts)
        i += 1
        cents, prev_inertia, inertia, a = (new_cents, inertia, new_inertia,
                                           rnd.assignment)
    return cents, a, inertia, i


def fit_points(points: torch.Tensor, init_centroids: torch.Tensor,
               backend: Backend, max_iters: int, tol: float,
               empty: str = "keep",
               cache: Optional[RoundCache] = None) -> LloydResult:
    """Lloyd clustering through ``backend``. ``empty`` picks the
    empty-cluster policy: 'keep' (previous centroid survives) or 'reseed'
    (split the largest cluster). ``cache`` is an optional precomputed
    prologue."""
    if empty not in ("keep", "reseed"):
        raise ValueError(f"unknown empty-cluster policy {empty!r}; "
                         "expected 'keep' or 'reseed'")
    pts = points.float()
    if cache is None:
        cache = backend.prologue(pts)
    cents, a, inertia, i = _fit_loop(pts, init_centroids, backend,
                                     max_iters, tol, empty, cache)
    return LloydResult(cents, a, inertia, i)


def kmeans_points(draws: Draws, points: torch.Tensor, k: int,
                  backend: Backend, sampler: str = "cdf",
                  max_iters: int = 50, tol: float = 1e-6,
                  empty: str = "keep", guard: bool = False) -> LloydResult:
    """End-to-end k-means++ seeding + Lloyd with ONE shared prologue: the
    backend's ``tile_m`` is pinned to k so both phases agree on one tile
    geometry, and the norms are computed once."""
    be = dataclasses.replace(backend, tile_m=k)
    pts = points.float()
    cache = be.prologue(pts)
    seeds = seed_points(draws, pts, k, be, sampler, cache=cache, guard=guard)
    return fit_points(pts, seeds.centroids, be, max_iters, tol, empty,
                      cache=cache)


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
    ``device`` defaults to the card. ``bounds=True`` (bound-gated rounds) is
    the next slice of the port and raises here. ``validate`` is the entry
    guard policy ('raise', 'sanitize' or 'off'); any setting other than
    'off' also arms the seeding loop's finite check.

    Randomness: ``generator`` seeds a :class:`Draws` source for the run;
    ``draws`` passes one in instead (to replay a run, or the reference's
    key schedule). A kernel that fails to build or launch raises
    ``KernelFailureError``; there is no fallback backend.
    """

    def __init__(self, backend: Union[str, Backend] = "cuda", *,
                 device=None, bounds: bool = False, validate: str = "raise",
                 **backend_opts):
        if bounds:
            raise NotImplementedError(
                "bounds=True (bound-gated seeding and Lloyd) is slice 2 of "
                "the port; use bounds=False")
        self.backend = make_backend(backend, **backend_opts)
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
                           pts, k, self.backend, sampler, guard=self._guard)

    def fit(self, points, init_centroids, *, max_iters: int = 50,
            tol: float = 1e-6, empty: str = "keep") -> LloydResult:
        """Lloyd iterations from ``init_centroids`` until convergence."""
        pts = self._points(points)
        cents = torch.as_tensor(init_centroids, dtype=torch.float32,
                                device=self.device)
        cents = guards.guard_centroids(cents, pts.shape[1], self.validate)
        return fit_points(pts, cents, self.backend, max_iters, float(tol),
                          empty)

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
                             float(tol), empty, guard=self._guard)
