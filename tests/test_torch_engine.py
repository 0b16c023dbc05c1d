"""The port's seeding, Lloyd and kmeans against ``repro.core.engine``.

The reference runs ``ClusterEngine(<backend>)`` on the CPU, its Pallas
kernels in interpret mode, ungated (``bounds=False``) or bound-gated (its
default). The port gets the reference's random draws (replayed from its key
schedule, see ``test_torch_jaxref``) and its tile geometry
(``convert.with_geometry``), and its ``cuda`` backend runs the kernels'
plain versions, since the tensors lie on the CPU. Inside the port, the
gated loops are held bitwise to the ungated ones.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_jaxref import (EPS32, ROOT, assert_labels_match,
                               assert_same_draw, cdf_tol, d2_tol, draws_for,
                               exact_d2, key_schedule, ref_geometry,
                               ref)  # noqa: F401  (ref is a fixture)
from repro_torch import convert
from repro_torch.configs import FULL, SMOKE
from repro_torch.core import ClusterEngine, Draws, FusedBackend, make_backend
from repro_torch.core import bounds, engine, sampling
from repro_torch.core.kmeanspp import kmeanspp
from repro_torch.core.lloyd import kmeans, lloyd
from repro_torch.core.quality import cluster_sizes, inertia
from repro_torch.data import blobs

# (port backend, reference backend) pairs computing the same round math
PAIRS = [("cuda", "pallas"), ("fused", "fused"), ("reference", "reference")]
N, D, K = 3000, 8, 6


def _ref_engine(ref, backend):
    return ref.engine.ClusterEngine(backend, bounds=False)


def _port(backend, block_n, tps):
    return convert.with_geometry(make_backend(backend), block_n, tps)


# ---------------------------------------------------------------------------
# seeding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("port_be,ref_be", PAIRS)
def test_seed_rounds_pick_the_reference_index(ref, sampler, port_be, ref_be):
    """Fed the reference's seeds and uniforms, every round of the port picks
    the reference's next seed (a boundary draw may differ, and the test
    checks that it is one); the port's own run picks the same seeds, and
    its final D² agrees within the D² tolerance."""
    pts, _ = blobs(N, D, K, seed=0)
    seed = 4
    want = _ref_engine(ref, ref_be).seed(jax.random.PRNGKey(seed),
                                         jnp.asarray(pts), K,
                                         sampler=sampler)
    ridx = np.asarray(want.indices)
    first, u, fb = key_schedule(seed, N, K)
    assert ridx[0] == first
    bn = ref.engine.make_backend(ref_be).seed_tile(N, D)
    be = _port(port_be, bn, 1)
    x = torch.from_numpy(pts)
    cache = be.prologue(x)
    md = torch.full((N,), torch.inf)
    # two fp32 prefix sums, plus N rows of D² error between the two sides
    dtol = N * d2_tol(pts, pts)
    weights = {}
    for m in range(1, K):
        rnd = be.seed_round(x, x[int(ridx[m - 1])][None], md, cache=cache)
        md = rnd.min_d2
        weights[m] = md.numpy().copy()
        ut, fbt = torch.tensor(u[m - 1]), torch.tensor(fb[m - 1:m])
        if sampler == "cdf":
            idx = sampling.categorical_cdf(ut, fbt, md)
        else:
            idx = sampling.categorical_tiled(ut, fbt, md, rnd.partials,
                                             block_n=bn)
        assert_same_draw(int(idx), int(ridx[m]), u[m - 1], weights[m],
                         cdf_tol(weights[m]) + dtol)

    got = ClusterEngine(be, device="cpu").seed(
        pts, K, draws=draws_for(seed, N, K), sampler=sampler)
    gidx = got.indices.numpy()
    assert got.centroids.shape == (K, D) and got.recovered.sum() == 0
    for m in range(1, K):
        if gidx[m] != ridx[m]:   # later rounds follow the other seed
            assert_same_draw(int(gidx[m]), int(ridx[m]), u[m - 1],
                             weights[m], cdf_tol(weights[m]) + dtol)
            break
    else:
        np.testing.assert_array_equal(got.centroids.numpy(), pts[ridx])
        np.testing.assert_allclose(got.min_d2.numpy(),
                                   np.asarray(want.min_d2), rtol=0,
                                   atol=d2_tol(pts, pts))


def test_seed_guard_heals_a_poisoned_round():
    """A round whose carried D² turns NaN is detected by the finite check on
    its total, refolded from the clean carry, and the run goes on to the
    seeds an unpoisoned run picks; the heal is flagged in ``recovered``.
    The ungated loop here; ``test_torch_bounds`` heals the gated one."""

    @dataclasses.dataclass(frozen=True)
    class Poisoned(FusedBackend):
        calls: list = dataclasses.field(default_factory=list)

        def seed_round(self, points, c_new, min_d2, *, cache, state=None,
                       consume=False):
            self.calls.append(1)
            if len(self.calls) == 3:
                min_d2 = min_d2.clone()
                min_d2[:5] = torch.nan
            return super().seed_round(points, c_new, min_d2, cache=cache,
                                      state=state, consume=consume)

    pts, _ = blobs(2000, 3, 5, seed=1)
    draws = draws_for(0, 2000, 5)
    clean = ClusterEngine("fused", device="cpu", bounds=False).seed(
        pts, 5, draws=draws)
    healed = ClusterEngine(Poisoned(), device="cpu", bounds=False).seed(
        pts, 5, draws=draws)
    assert torch.equal(healed.indices, clean.indices)
    assert torch.equal(healed.min_d2, clean.min_d2)
    assert healed.recovered.tolist() == [0, 0, 1, 0, 0]
    off = ClusterEngine(Poisoned(), device="cpu", bounds=False,
                        validate="off").seed(pts, 5, draws=draws)
    assert off.recovered is None


# ---------------------------------------------------------------------------
# Lloyd and kmeans
# ---------------------------------------------------------------------------


def _assert_fit_matches(got, want, pts, prev_centroids):
    """n_iters equal; labels equal outside near-ties against the centroids
    the last assignment saw; centroids within n·eps of the largest
    coordinate (fp32 cluster sums of up to n rows in two orders); inertia
    within n D² errors plus n·eps of itself."""
    n = pts.shape[0]
    assert got.n_iters == want.n_iters
    assert got.assignment.dtype == torch.int32
    tol = d2_tol(pts, prev_centroids)
    assert_labels_match(got.assignment.numpy(), want.assignment.numpy(),
                        exact_d2(pts, prev_centroids), tol)
    np.testing.assert_allclose(got.centroids.numpy(),
                               want.centroids.numpy(), rtol=0,
                               atol=n * EPS32 * float(np.abs(pts).max()))
    inertia_tol = n * tol + n * EPS32 * float(want.inertia)
    assert abs(float(got.inertia) - float(want.inertia)) <= inertia_tol


@pytest.mark.parametrize("port_be,ref_be", PAIRS)
def test_lloyd_from_reference_seeds_matches(ref, port_be, ref_be):
    """Started from the reference's seeds (carried over by ``convert``),
    the port's Lloyd loop takes the reference's steps."""
    pts, _ = blobs(N, D, K, seed=2)
    reng = _ref_engine(ref, ref_be)
    rseed = reng.seed(jax.random.PRNGKey(1), jnp.asarray(pts), K)
    rfit = reng.fit(jnp.asarray(pts), rseed.centroids, max_iters=25)
    seeds = convert.kmeanspp_result(rseed.centroids, rseed.indices,
                                    rseed.min_d2)
    want = convert.lloyd_result(rfit.centroids, rfit.assignment,
                                rfit.inertia, rfit.n_iters)
    assert 2 < want.n_iters < 25
    prev = np.asarray(reng.fit(jnp.asarray(pts), rseed.centroids,
                               max_iters=want.n_iters - 1).centroids)
    bn, tps = ref_geometry(ref, N, D, K, ref_be)
    got = ClusterEngine(_port(port_be, bn, tps), device="cpu").fit(
        pts, seeds.centroids, max_iters=25)
    _assert_fit_matches(got, want, pts, prev)


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("n,d,k,seed", [(5000, 2, 8, 1), (2500, 16, 16, 2)])
def test_kmeans_matches_reference_end_to_end(ref, sampler, n, d, k, seed):
    """``ClusterEngine.kmeans`` on blobs, the paper's path: the port (cuda
    backend, plain versions on the CPU) against the reference's Pallas
    backend, with the reference's draws and geometry. More than one tile
    (and super-tiles at tps > 1) whenever the reference's geometry has
    them."""
    pts, _ = blobs(n, d, k, seed=seed)
    reng = _ref_engine(ref, "pallas")
    want_seed = reng.seed(jax.random.PRNGKey(seed), jnp.asarray(pts), k,
                          sampler=sampler)
    want = reng.kmeans(jax.random.PRNGKey(seed), jnp.asarray(pts), k,
                       sampler=sampler, max_iters=25)
    bn, tps = ref_geometry(ref, n, d, k)
    be = _port("cuda", bn, tps)
    eng = ClusterEngine(be, device="cpu")
    seeds = eng.seed(pts, k, draws=draws_for(seed, n, k), sampler=sampler)
    np.testing.assert_array_equal(seeds.indices.numpy(),
                                  np.asarray(want_seed.indices))
    got = eng.kmeans(pts, k, draws=draws_for(seed, n, k), sampler=sampler,
                     max_iters=25)
    prev = np.asarray(reng.fit(jnp.asarray(pts), want_seed.centroids,
                               max_iters=int(want.n_iters) - 1).centroids)
    _assert_fit_matches(got, convert.lloyd_result(*want[:4]), pts, prev)


def test_kmeans_shares_one_geometry_and_matches_seed_then_fit():
    """kmeans = seed then fit, bit for bit, with the seeding tile pinned to
    the fit's (``tile_m = k``)."""
    pts, _ = blobs(3000, 4, 10, seed=3)
    eng = ClusterEngine("cuda", device="cpu")
    be = dataclasses.replace(eng.backend, tile_m=10)
    draws = draws_for(3, 3000, 10)
    got = eng.kmeans(pts, 10, draws=draws, sampler="tiled")
    two = ClusterEngine(be, device="cpu")
    seeds = two.seed(pts, 10, draws=draws, sampler="tiled")
    fit = two.fit(pts, seeds.centroids)
    assert torch.equal(got.centroids, fit.centroids)
    assert torch.equal(got.assignment, fit.assignment)
    assert got.n_iters == fit.n_iters


def test_generator_runs_are_reproducible_and_sane():
    pts, _ = blobs(4000, 2, 8, seed=5)
    runs = [ClusterEngine("cuda", device="cpu").kmeans(
        pts, 8, generator=torch.Generator().manual_seed(7), max_iters=25)
        for _ in range(2)]
    assert torch.equal(runs[0].centroids, runs[1].centroids)
    r = runs[0]
    assert r.centroids.shape == (8, 2) and torch.isfinite(r.centroids).all()
    assert 0 <= int(r.assignment.min()) and int(r.assignment.max()) < 8
    # the loop's inertia is the one the final assignment reaches
    np.testing.assert_allclose(
        float(r.inertia), float(((torch.from_numpy(pts) - r.centroids[
            r.assignment.long()]) ** 2).sum()), rtol=1e-3)


def test_shims_route_through_the_engine():
    pts, _ = blobs(1000, 2, 4, seed=6)
    draws = draws_for(0, 1000, 4)
    s = kmeanspp(pts, 4, draws=draws, device="cpu")
    s2 = ClusterEngine("cuda", device="cpu").seed(pts, 4, draws=draws)
    assert torch.equal(s.indices, s2.indices)
    f = lloyd(pts, s.centroids, device="cpu", max_iters=10)
    f2 = ClusterEngine("cuda", device="cpu").fit(pts, s.centroids,
                                                 max_iters=10)
    assert torch.equal(f.centroids, f2.centroids)
    km = kmeans(pts, 4, generator=torch.Generator().manual_seed(0),
                device="cpu")
    assert km.centroids.shape == (4, 2)


def test_reseed_and_empty_clusters_match_reference(ref):
    """The empty-cluster policies: a centroid far from every point keeps
    its place under 'keep' and jumps next to the largest cluster's under
    'reseed', as in the reference."""
    pts, _ = blobs(1000, 2, 3, seed=7)
    init = np.concatenate([pts[:3], [[50.0, 50.0]]]).astype(np.float32)
    for empty in ("keep", "reseed"):
        want = _ref_engine(ref, "fused").fit(jnp.asarray(pts),
                                             jnp.asarray(init), max_iters=5,
                                             empty=empty)
        bn, tps = ref_geometry(ref, 1000, 2, 4, "fused")
        got = ClusterEngine(_port("fused", bn, tps), device="cpu").fit(
            pts, init, max_iters=5, empty=empty)
        np.testing.assert_allclose(got.centroids.numpy(),
                                   np.asarray(want.centroids), rtol=0,
                                   atol=1000 * EPS32 * 50)
        assert got.n_iters == int(want.n_iters)


# ---------------------------------------------------------------------------
# bound gating: gated == ungated inside the port, and against the reference
# ---------------------------------------------------------------------------


def _coherent(n=8192, d=2, k=6, seed=0, spread=0.03, offset=0.0):
    """Label-sorted blobs: tiles become spatially coherent, so the gates
    have something to skip."""
    pts, labels = blobs(n, d, k, seed=seed, spread=spread)
    return pts[np.argsort(labels, kind="stable")] + np.float32(offset)


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x == y) if isinstance(x, int) else torch.equal(x, y), f


@pytest.mark.parametrize("offset", [0.0, 100.0, -3000.0])
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("backend", ["reference", "fused", "cuda"])
def test_gated_seed_is_bitwise_the_ungated_seed(backend, sampler, offset):
    """Same draws: seeds, centroids and final D² bitwise equal with and
    without bounds, while the gated run skips tiles (near the origin) and
    prunes points; far from the origin the margin keeps more work but the
    bits still agree. Counters are (k,) int32 and None without bounds."""
    pts = _coherent(offset=offset)
    draws = draws_for(3, pts.shape[0], 12)
    on = ClusterEngine(backend, device="cpu", block_n=512).seed(
        pts, 12, draws=draws, sampler=sampler)
    off = ClusterEngine(backend, device="cpu", block_n=512,
                        bounds=False).seed(pts, 12, draws=draws,
                                           sampler=sampler)
    _same(on, off, ("indices", "centroids", "min_d2"))
    assert off.skipped is None and off.pruned is None
    assert on.skipped.shape == on.pruned.shape == (12,)
    assert on.skipped.dtype == torch.int32
    assert int(on.skipped[0]) == 0          # round 1 starts from +inf
    if offset == 0.0:
        assert int(on.skipped.sum()) > 0 and int(on.pruned.sum()) > 0


@pytest.mark.parametrize("offset", [0.0, 100.0, -3000.0])
@pytest.mark.parametrize("empty", ["keep", "reseed"])
@pytest.mark.parametrize("backend", ["reference", "fused", "cuda"])
def test_gated_fit_is_bitwise_the_ungated_fit(backend, empty, offset):
    """From the same seeds (one far outside the data under 'reseed', so a
    cluster empties and jumps): centroids, assignment, inertia and n_iters
    bitwise equal with and without bounds; near the origin the gated fit
    skips tiles and prunes points."""
    pts = _coherent(offset=offset, seed=1)
    init = pts[[0, 2000, 4000, 6000, 8000, 1000]].copy()
    if empty == "reseed":
        init[5] = pts.max(0) + 50.0
    kw = dict(max_iters=10, tol=-1.0, empty=empty)
    on = ClusterEngine(backend, device="cpu", block_n=512, tps=4).fit(
        pts, init, **kw)
    off = ClusterEngine(backend, device="cpu", block_n=512, tps=4,
                        bounds=False).fit(pts, init, **kw)
    _same(on, off, ("centroids", "assignment", "inertia", "n_iters"))
    assert off.skipped is None and on.skipped.shape == (10,)
    assert on.recovered.tolist() == [0] * 10
    if offset == 0.0 and empty == "keep":
        assert int(on.skipped.sum()) > 0 and int(on.pruned.sum()) > 0


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
def test_gated_kmeans_matches_reference_gated_kmeans(ref, sampler):
    """The port's gated kmeans (cuda backend, plain versions on the CPU)
    against the reference's gated Pallas kmeans, on label-sorted blobs with
    the reference's draws and geometry: seeds equal, the fit as
    ``test_kmeans_matches_reference_end_to_end`` holds it; skip counts per
    round within ±1 tile (the two prologues agree only to ulps) and, in
    every round where they are equal, the same pruned count."""
    n, d, k, seed = 6000, 2, 8, 5
    pts = _coherent(n, d, k, seed=seed)
    rbe = dataclasses.replace(ref.engine.make_backend("pallas", block_n=512),
                              tile_m=k)
    bn = rbe.seed_tile(n, d)
    tps = rbe.tiles_per_super(-(-n // bn))
    reng = ref.engine.ClusterEngine(rbe)
    want_seed = reng.seed(jax.random.PRNGKey(seed), jnp.asarray(pts), k,
                          sampler=sampler)
    want = reng.kmeans(jax.random.PRNGKey(seed), jnp.asarray(pts), k,
                       sampler=sampler, max_iters=25)
    eng = ClusterEngine(_port("cuda", bn, tps), device="cpu")
    seeds = eng.seed(pts, k, draws=draws_for(seed, n, k), sampler=sampler)
    np.testing.assert_array_equal(seeds.indices.numpy(),
                                  np.asarray(want_seed.indices))
    got = eng.kmeans(pts, k, draws=draws_for(seed, n, k), sampler=sampler,
                     max_iters=25)
    prev = np.asarray(reng.fit(
        jnp.asarray(pts), want_seed.centroids,
        max_iters=int(want.n_iters) - 1).centroids)
    _assert_fit_matches(got, convert.lloyd_result(*want[:4]), pts, prev)
    for mine, theirs in ((seeds, want_seed), (got, want)):
        gs, ws = mine.skipped.numpy(), np.asarray(theirs.skipped)
        assert gs.shape == ws.shape
        assert (np.abs(gs - ws) <= 1).all(), (gs, ws)
        eq = gs == ws
        np.testing.assert_array_equal(mine.pruned.numpy()[eq],
                                      np.asarray(theirs.pruned)[eq])
    assert int(seeds.skipped.sum()) > 0 and int(got.pruned.sum()) > 0


def test_gated_seed_guard_heals_a_poisoned_carry():
    """A round whose carried partials turn NaN (a skipped tile's carry
    reaches the total) is detected, refolded ungated from the clean carry,
    and the run goes on bitwise the clean run; the heal is flagged."""

    @dataclasses.dataclass(frozen=True)
    class Poisoned(FusedBackend):
        calls: list = dataclasses.field(default_factory=list)

        def seed_round(self, points, c_new, min_d2, *, cache, state=None,
                       consume=False):
            if state is not None:
                self.calls.append(1)
                if len(self.calls) == 3:
                    state = state._replace(
                        partials=torch.full_like(state.partials, torch.nan))
            return super().seed_round(points, c_new, min_d2, cache=cache,
                                      state=state, consume=consume)

    pts = _coherent(seed=2)
    draws = draws_for(1, pts.shape[0], 8)
    clean = ClusterEngine("fused", device="cpu", block_n=512).seed(
        pts, 8, draws=draws, sampler="tiled")
    healed = ClusterEngine(Poisoned(block_n=512), device="cpu").seed(
        pts, 8, draws=draws, sampler="tiled")
    _same(healed, clean, ("indices", "centroids", "min_d2"))
    assert healed.recovered.tolist() == [0, 0, 1, 0, 0, 0, 0, 0]
    assert int(healed.skipped[2]) == 0 and int(clean.skipped[2]) > 0


@pytest.mark.parametrize("fault", ["nan_state", "zero_counts"])
def test_gated_fit_guard_heals_a_poisoned_iteration(fault):
    """An iteration whose inertia turns NaN, or whose counts lose half
    their mass, is re-run ungated; the fit ends bitwise the clean fit, the
    trip is flagged in ``recovered``, and with validate='off' nothing is
    checked."""

    @dataclasses.dataclass(frozen=True)
    class Poisoned(FusedBackend):
        calls: list = dataclasses.field(default_factory=list)

        def assign_update(self, points, centroids, *, cache, state=None,
                          delta=None):
            rnd = super().assign_update(points, centroids, cache=cache,
                                        state=state, delta=delta)
            if delta is None:
                return rnd
            self.calls.append(1)
            if len(self.calls) != 3:
                return rnd
            if fault == "zero_counts":
                return rnd._replace(sums=rnd.sums * 0.5,
                                    counts=rnd.counts * 0.5)
            parts = rnd.state.partials.clone()
            parts[0] = torch.nan
            return rnd._replace(state=rnd.state._replace(partials=parts))

    pts = _coherent(seed=3)
    init = pts[[0, 2000, 4000, 6000, 8000, 1000]]
    kw = dict(max_iters=8, tol=-1.0)
    clean = ClusterEngine("fused", device="cpu", block_n=512).fit(
        pts, init, **kw)
    healed = ClusterEngine(Poisoned(block_n=512), device="cpu").fit(
        pts, init, **kw)
    _same(healed, clean, ("centroids", "assignment", "inertia", "n_iters"))
    assert healed.recovered.tolist() == [0, 0, 1, 0, 0, 0, 0, 0]
    off = ClusterEngine(Poisoned(block_n=512), device="cpu",
                        validate="off").fit(pts, init, **kw)
    assert off.recovered is None


def test_gated_kmeans_runs_one_prologue_with_bounds():
    """kmeans shares one prologue with tile balls between its two phases,
    and its gated result is seed-then-fit's, bit for bit."""
    pts = _coherent(seed=4)
    draws = draws_for(2, pts.shape[0], 6)
    calls = []

    @dataclasses.dataclass(frozen=True)
    class Counting(FusedBackend):
        def prologue(self, points, m=1, with_bounds=True):
            calls.append(with_bounds)
            return super().prologue(points, m, with_bounds)

    got = ClusterEngine(Counting(), device="cpu").kmeans(pts, 6, draws=draws)
    assert calls == [True]
    two = ClusterEngine(Counting(tile_m=6), device="cpu")
    fit = two.fit(pts, two.seed(pts, 6, draws=draws).centroids)
    _same(got, fit, ("centroids", "assignment", "inertia", "n_iters"))


# ---------------------------------------------------------------------------
# building blocks the port keeps its own copies of
# ---------------------------------------------------------------------------


def test_own_copies_match_reference_modules(ref):
    from repro.configs import kmeans_paper
    from repro.data import synthetic
    for a, b in ((FULL, kmeans_paper.FULL), (SMOKE, kmeans_paper.SMOKE)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for args in ((100, 3, 4), (57, 2, 9)):
        for p, q in zip(blobs(*args, seed=3), synthetic.blobs(*args, seed=3)):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("n_tiles,tps", [(1, None), (8, None), (9, None),
                                         (977, None), (25, None), (10, 3),
                                         (4, 64), (100, 16)])
def test_bounds_geometry_matches_reference(ref, n_tiles, tps):
    assert bounds.tiles_per_super(n_tiles, tps) == \
        ref.bounds.tiles_per_super(n_tiles, tps)
    assert bounds.n_supers(n_tiles, tps) == ref.bounds.n_supers(n_tiles, tps)


def test_bounds_helpers_match_reference(ref):
    x = np.random.default_rng(0).normal(size=(130, 4)).astype(np.float32)
    np.testing.assert_allclose(bounds.point_norms(torch.from_numpy(x)),
                               np.asarray(ref.bounds.point_norms(
                                   jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_array_equal(bounds.tile_counts(130, 32).numpy(),
                                  np.asarray(ref.bounds.tile_counts(130, 32)))
    t = np.random.default_rng(1).normal(size=(7, 3, 2)).astype(np.float32)
    np.testing.assert_allclose(
        bounds.super_reduce(torch.from_numpy(t), 4).numpy(),
        np.asarray(ref.bounds.super_reduce(jnp.asarray(t), 4)), rtol=1e-6)


def test_distance_helpers_and_quality_match_reference(ref):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(500, 5)).astype(np.float32)
    c = rng.normal(size=(7, 5)).astype(np.float32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    tol = d2_tol(x, c)
    np.testing.assert_allclose(engine.pairwise_d2(xt, ct).numpy(),
                               np.asarray(ref.engine.pairwise_d2(
                                   jnp.asarray(x), jnp.asarray(c))),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(engine.point_d2(xt, ct[0]).numpy(),
                               np.asarray(ref.engine.point_d2(
                                   jnp.asarray(x), jnp.asarray(c[0]))),
                               rtol=1e-6)
    from repro.core import quality
    want = float(quality.inertia(jnp.asarray(x), jnp.asarray(c), block=128))
    assert abs(float(inertia(xt, ct, block=128)) - want) <= \
        500 * tol + 500 * EPS32 * want
    a = torch.from_numpy(rng.integers(0, 7, 500).astype(np.int32))
    np.testing.assert_array_equal(
        cluster_sizes(a, 7).numpy(),
        np.asarray(quality.cluster_sizes(jnp.asarray(a.numpy()), 7)))
    sums, counts = engine.segment_update(xt, a, 7)
    rs, rc = ref.engine.segment_update(jnp.asarray(x), jnp.asarray(a.numpy()),
                                       7, None)
    np.testing.assert_allclose(sums.numpy(), np.asarray(rs), rtol=0,
                               atol=500 * EPS32 * 5)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))


@pytest.mark.parametrize("policy", ["raise", "sanitize", "off"])
@pytest.mark.parametrize("case", ["clean", "nan_rows", "neg_weight",
                                  "zero_weights", "bad_shape"])
def test_guards_match_reference(ref, policy, case):
    """Same input, same policy: both sides raise InvalidInputError, or both
    return the same sanitized array."""
    from repro.core import guards as rguards
    from repro_torch.core import guards
    x = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    w = np.abs(x[:, 0]) + 0.5
    if case == "nan_rows":
        x[[2, 7], 1] = np.nan
        x[4, 0] = np.inf
    elif case == "neg_weight":
        w[3] = -1.0
    elif case == "zero_weights":
        w[:] = 0.0
    elif case == "bad_shape":
        w = w[:-1]

    def run(mod, arr):
        try:
            return (mod.guard_points(arr(x), policy),
                    mod.guard_weights(arr(w), 20, policy))
        except mod.InvalidInputError:
            return "raised"

    want = run(rguards, jnp.asarray)
    got = run(guards, torch.from_numpy)
    if want == "raised":
        assert got == "raised"
    else:
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    c = x[:3].copy()
    c[1, 2] = np.nan
    for mod, arr in ((rguards, jnp.asarray), (guards, torch.from_numpy)):
        with pytest.raises(mod.InvalidInputError):
            mod.guard_centroids(arr(c), 3, "sanitize")
        with pytest.raises(mod.InvalidInputError):
            mod.guard_centroids(arr(c[:, :2]), 3, "off")
    for k, n in ((0, 5), (6, 5), (5, 5)):
        for mod in (rguards, guards):
            if k == 5:
                mod.check_shape(k, n)
            else:
                with pytest.raises(mod.InvalidInputError):
                    mod.check_shape(k, n)


# ---------------------------------------------------------------------------
# the port's rules
# ---------------------------------------------------------------------------


def test_entry_points_need_a_card_or_device_cpu():
    """Without a card and without ``device=``, nothing runs on the CPU in
    its place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    pts, _ = blobs(100, 2, 3, seed=0)
    for call in (lambda: ClusterEngine(),
                 lambda: ClusterEngine("fused"),
                 lambda: ClusterEngine(device="cuda"),
                 lambda: kmeanspp(pts, 3),
                 lambda: kmeans(pts, 3),
                 lambda: lloyd(pts, pts[:3])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_unported_options_raise():
    pts, _ = blobs(100, 2, 3, seed=0)
    eng = ClusterEngine(device="cpu")
    # the gumbel sampler is ported (tests/test_torch_init.py): it runs
    assert eng.seed(pts, 3, sampler="gumbel",
                    generator=torch.Generator().manual_seed(0)
                    ).indices.shape == (3,)
    with pytest.raises(ValueError):
        make_backend("pallas")
    # order= is ported (tests/test_torch_ordering.py); an unknown ordering
    # name raises instead of running in the natural order
    with pytest.raises(ValueError, match="ordering"):
        eng.fit_minibatch(pts[:3], [pts], order="zorder")
    # batched problems: rejection seeding runs, with bounds on (the
    # default) and off (tests/test_torch_batched_rejection.py), and asks for
    # the rejection schedule in its draws; the in-flight guard of the cdf
    # and tiled loops raises, as the batched loops do not run it (as the
    # reference's vmap)
    many = np.stack([pts, pts])
    off = ClusterEngine(device="cpu", bounds=False)
    gen = torch.Generator().manual_seed(0)
    for e in (eng, off):
        res = e.seed_batched(many, 3, sampler="rejection", generator=gen)
        assert tuple(res.indices.shape) == (2, 3)
        fit = e.kmeans_batched(many, 3, sampler="rejection", generator=gen)
        assert tuple(fit.centroids.shape) == (2, 3, 2)
    for gate in (True, False):
        with pytest.raises(ValueError, match="attempts"):
            engine.seed_points(Draws.sample_batched(2, 100, 3),
                               torch.from_numpy(many), 3,
                               make_backend("fused"), "rejection",
                               bound_gate=gate)
        with pytest.raises(NotImplementedError, match="guard"):
            engine.seed_points(Draws.sample_batched(2, 100, 3),
                               torch.from_numpy(many), 3,
                               make_backend("fused"), bound_gate=gate,
                               guard=True)
        with pytest.raises(NotImplementedError, match="guard"):
            engine.fit_points(torch.from_numpy(many),
                              torch.from_numpy(many[:, :3]),
                              make_backend("fused"), 5, 0.0,
                              bound_gate=gate, guard=True)


def test_port_imports_neither_jax_nor_repro():
    """Every module of ``repro_torch``, and ``chip_smoke.py``, imported in a
    fresh process, leave ``jax`` and ``repro`` out of ``sys.modules``."""
    code = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
assert not bad, bad
assert len(names) >= 15, names
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
