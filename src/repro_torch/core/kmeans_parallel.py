"""k-means|| (Bahmani et al., VLDB 2012) — the scalable k-means++ the paper
cites (port of ``repro.core.kmeans_parallel``). Instead of k sequential
rounds it runs a few rounds that each oversample l candidates at once,
then reduces the rounds·l + 1 candidates to k seeds with a weighted
k-means++.

As in the reference, each round draws exactly l candidates by Gumbel top-l
(weighted, without replacement) and folds all of them into every point's D²
in one gated multi-centroid seeding round (K5 at m = l on the card), the
rounds always gated and fp32. Departing from the reference's (n, n_cand)
distance matrix, the candidates' weights are the counts of the backend's
untiled assignment round against the candidates (K4 on the card), and the
final D² is the same round against the k seeds: O(n) memory at any l.

Randomness comes from a :class:`ParallelDraws`, sampled from a
``torch.Generator`` or injected (the parity tests replay the reference's
key schedule through it).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core import bounds, guards, sampling
from repro_torch.core.bounds import BoundState
from repro_torch.core.engine import (Backend, KmeansppResult, make_backend,
                                     point_d2, resolve_device, seed_points)
from repro_torch.core.sampling import Draws
from repro_torch.kernels import ops

__all__ = ["ParallelDraws", "Candidates", "oversample_candidates",
           "reduce_candidates", "kmeans_parallel_init"]

# the candidates' weights are fp32 counts, exact while no candidate is the
# nearest of more rows than fp32 counts exactly
MAX_ROWS = 2 ** 24


@dataclasses.dataclass(frozen=True)
class ParallelDraws:
    """The random numbers one k-means|| run consumes, in the order of the
    reference's key schedule: the first candidate's index ``first`` (1,),
    each round's (n,) Gumbel noise ``noise`` (rounds, n), and the weighted
    reduce's draws ``reduce`` over the rounds·l + 1 candidates (a weighted
    :class:`Draws`: its first seed ∝ the weights, then one uniform and one
    fallback index a round)."""

    first: torch.Tensor     # (1,) int64
    noise: torch.Tensor     # (rounds, n) fp32
    reduce: Draws

    @classmethod
    def sample(cls, n: int, k: int, *, rounds: int = 5, oversample: int = 0,
               generator: Optional[torch.Generator] = None,
               device="cpu") -> "ParallelDraws":
        """A run's draws from ``generator`` on its device, moved to
        ``device`` once; ``oversample`` (l) defaults to 2k."""
        gdev = "cpu" if generator is None else generator.device
        l = oversample or 2 * k
        first = torch.randint(n, (1,), generator=generator, device=gdev)
        noise = sampling.gumbel_from_uniform(
            torch.rand((rounds, n), generator=generator, device=gdev))
        red = Draws.sample(rounds * l + 1, k, generator=generator,
                           weighted=True)
        return cls(first, noise, red).to(device)

    def to(self, device) -> "ParallelDraws":
        return ParallelDraws(self.first.to(device=device, dtype=torch.int64),
                             self.noise.to(device=device,
                                           dtype=torch.float32),
                             self.reduce.to(device))


class Candidates(NamedTuple):
    indices: torch.Tensor   # (rounds*l + 1,) int64 rows of the candidates
    weights: torch.Tensor   # (rounds*l + 1,) fp32 rows nearest each one
    min_d2: torch.Tensor    # (n,) D² to the nearest candidate


def _inputs(points, k: int, rounds: int, oversample: int, backend, draws,
            generator, device):
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    if pts.dim() != 2:
        raise guards.InvalidInputError(
            f"points must be (n, d), got {tuple(pts.shape)}")
    n = pts.shape[0]
    guards.check_shape(k, n)
    if n > MAX_ROWS:
        raise ValueError(f"k-means|| weighs its candidates by fp32 counts, "
                         f"exact up to {MAX_ROWS} rows; got n={n}")
    l = oversample or 2 * k
    if draws is None:
        draws = ParallelDraws.sample(n, k, rounds=rounds, oversample=l,
                                     generator=generator, device=dev)
    draws = draws.to(dev)
    if tuple(draws.noise.shape) != (rounds, n):
        raise ValueError(f"draws hold noise {tuple(draws.noise.shape)}, "
                         f"{rounds} rounds over {n} rows need ({rounds}, "
                         f"{n})")
    return pts.contiguous(), l, make_backend(backend), draws


def _oversample(pts, l: int, rounds: int, be: Backend,
                draws: ParallelDraws):
    """The candidate rounds, then the candidates' weights: (the prologue's
    cache, :class:`Candidates`)."""
    n, d = pts.shape
    # one prologue at the l-candidate round's tile height; every round is
    # gated on the carried bound state, whatever the caller's engine does
    cache = be.prologue(pts, m=l)
    tile = be.seed_tile(n, d, l)
    first = draws.first
    cand = torch.empty(rounds * l + 1, dtype=torch.int64, device=pts.device)
    cand[0:1] = first
    min_d2 = point_d2(pts, pts.index_select(0, first)[0])
    state = BoundState(sampling.tile_partials(min_d2, tile),
                       bounds.tile_reduce_max(min_d2, tile))
    for r in range(rounds):
        # l candidates ∝ D², without replacement
        idx = sampling.gumbel_topk(draws.noise[r], sampling.safe_log(min_d2),
                                   l)
        cand[1 + r * l:1 + (r + 1) * l] = idx
        # all l folded into D² in one multi-centroid round; the old D² is
        # never read again, so the round may write the new one into it
        rnd = be.seed_round(pts, pts.index_select(0, idx), min_d2,
                            cache=cache, state=state, consume=True)
        state = BoundState(rnd.partials, rnd.tile_max)
        min_d2 = rnd.min_d2
    weights = be.assign_update(pts, pts.index_select(0, cand),
                               norms=cache.norms).counts
    return cache, Candidates(cand, weights, min_d2)


def _reduce(pts, norms, cand: Candidates, k: int, be: Backend,
            draws: ParallelDraws) -> KmeansppResult:
    """The weighted reduce of the candidates to k seeds, then every row's
    D² to the nearest seed."""
    cands = pts.index_select(0, cand.indices)
    # the reduce's tile: the candidate set's own pick, never above the
    # backend's (an explicit block_n caps it, as the reference's does)
    n_cand, d = cands.shape
    red_be = dataclasses.replace(
        be, block_n=min(be.seed_tile(n_cand, d),
                        ops.choose_block_n(n_cand, d, 1)))
    red = seed_points(draws.reduce, cands, k, red_be, "tiled",
                      weights=cand.weights)
    final = be.assign_update(pts, red.centroids, norms=norms)
    return KmeansppResult(red.centroids,
                          cand.indices.index_select(0, red.indices),
                          final.min_d2)


def oversample_candidates(points, k: int, *, rounds: int = 5,
                          oversample: int = 0,
                          backend: Union[str, Backend] = "cuda",
                          draws: Optional[ParallelDraws] = None,
                          generator: Optional[torch.Generator] = None,
                          device=None) -> Candidates:
    """k-means||'s oversampling phase (the arguments of
    :func:`kmeans_parallel_init`): the rounds·l + 1 candidates (the first
    by ``draws.first``, then l a round by Gumbel top-l), each weighed by
    the rows nearest it (the counts of the backend's untiled assignment
    round against them; an exact duplicate weighs 0, as the argmin takes
    the first of equal distances), and every row's D² to its nearest
    candidate after the last round."""
    pts, l, be, draws = _inputs(points, k, rounds, oversample, backend,
                                draws, generator, device)
    return _oversample(pts, l, rounds, be, draws)[1]


def reduce_candidates(points, candidates: Candidates, k: int, *,
                      draws: ParallelDraws,
                      backend: Union[str, Backend] = "cuda",
                      device=None) -> KmeansppResult:
    """k-means||'s reduce phase on given ``candidates`` (from
    :func:`oversample_candidates`, with ``draws.reduce``): the k seeds, their
    rows and every row's D² to the nearest seed, as
    :func:`kmeans_parallel_init` returns them."""
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32,
                          device=dev).contiguous()
    cand = Candidates(*(t.to(dev) for t in candidates))
    return _reduce(pts, bounds.point_norms(pts), cand, k,
                   make_backend(backend), draws.to(dev))


def kmeans_parallel_init(points, k: int, *, rounds: int = 5,
                         oversample: int = 0,
                         backend: Union[str, Backend] = "cuda",
                         draws: Optional[ParallelDraws] = None,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> KmeansppResult:
    """k seeds by k-means||: ``rounds`` rounds of ``oversample`` (l,
    default 2k) candidates each (:func:`oversample_candidates`), then the
    weighted reduce of the candidates to k seeds by the port's weighted
    'tiled' seeding, its first seed ∝ the weights
    (:func:`reduce_candidates`), as reference ``kmeans_parallel.py:29-88``.
    Returns the seeds, their rows, and every row's D² to the nearest seed
    (the untiled assignment round against the seeds; K4 on the card).

    ``backend`` ('cuda' — the Hopper kernels — 'fused' or 'reference')
    runs the rounds, the counts and the reduce; ``draws`` replays a run,
    else ``generator`` draws one. ``device`` defaults to the card."""
    pts, l, be, draws = _inputs(points, k, rounds, oversample, backend,
                                draws, generator, device)
    cache, cand = _oversample(pts, l, rounds, be, draws)
    return _reduce(pts, cache.norms, cand, k, be, draws)
