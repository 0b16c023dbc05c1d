"""Batched multi-problem clustering in the port against ``repro.core.engine``.

``ClusterEngine.seed_batched``, ``fit_batched`` and ``kmeans_batched`` with
``bounds=False`` cluster B independent problems in one loop: one seeding
round (K7 ``distance_min_update_batched`` on the card) per round and one
assignment round (K10a ``lloyd_assign_tiled_batched``) per Lloyd iteration
for all B. The reference vmaps its single-problem loops, and its Pallas
backend's ``custom_vmap`` rules send the rounds to its batch-grid kernels
(``repro/kernels/kmeans_distance.py:466``, ``lloyd_assign.py:530``), run
here in interpret mode. The port gets problem b's draws from the
reference's ``split(PRNGKey(seed), B)[b]`` key schedule
(``test_torch_jaxref.batched_draws_for``) and the reference's tile
geometry (``convert.with_geometry``).

Inside the port, row b of every batched result is held bitwise to the
single-problem ``seed`` and ``fit`` with ``draws[b]``, on all three
backends, and the plain twins of K7/K10a row by row to those of K2/K3.
Tests marked ``cuda`` hold K7 and K10a against their plain twins and row b
bitwise against K2/K3 on the card.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_jaxref import (EPS32, assert_labels_match, batched_draws_for,
                               d2_tol, exact_d2, np32,
                               ref)  # noqa: F401  (ref is a fixture)
from repro_torch import convert
from repro_torch.configs import KVQUANT_SMOKE
from repro_torch.core import (ClusterEngine, Draws, InvalidInputError,
                              bounds, make_backend, sampling)
from repro_torch.data import blobs, blobs_batched
from repro_torch.kernels import kmeans_distance as kd
from repro_torch.kernels import lloyd_assign as la
from repro_torch.kernels import ops

B, N, K, SEED = 3, 1500, 6, 3     # N is not a multiple of any tile height
PAIRS = [("cuda", "pallas"), ("fused", "fused")]   # (port, reference)


def _problems(d, n=N, k=K, seed=0):
    return np.stack([blobs(n, d, k, seed=seed + 7 * b)[0] for b in range(B)])


def _engines(ref, port_be, ref_be, n, d, block_n):
    """The reference's ungated engine at tile height ``block_n`` and a port
    engine at its geometry (the same tiles for the seeding and the fit
    phase: ``block_n`` is below both phases' Hopper and VMEM picks)."""
    rbe = ref.engine.make_backend(ref_be, block_n=block_n)
    tile = rbe.seed_tile(n, d)
    assert tile == rbe.seed_tile(n, d, K) == block_n
    tps = rbe.tiles_per_super(-(-n // tile))
    be = convert.with_geometry(make_backend(port_be), tile, tps)
    return (ref.engine.ClusterEngine(rbe, bounds=False),
            ClusterEngine(be, device="cpu", bounds=False))


def _assert_rows_fit(got, want, pts, prev):
    """Per problem b: n_iters equal; labels equal outside near-ties against
    the centroids its last assignment saw (``prev[b]``); centroids within
    n·eps of the largest coordinate; inertia within n D² errors plus n·eps
    of itself (the fp32 sums of two orders)."""
    n = pts.shape[1]
    np.testing.assert_array_equal(got.n_iters.numpy(),
                                  np.asarray(want.n_iters))
    assert got.assignment.dtype == torch.int32
    for b in range(pts.shape[0]):
        tol = d2_tol(pts[b], prev[b])
        assert_labels_match(got.assignment[b].numpy(),
                            np.asarray(want.assignment)[b],
                            exact_d2(pts[b], prev[b]), tol)
        np.testing.assert_allclose(
            got.centroids[b].numpy(), np.asarray(want.centroids)[b], rtol=0,
            atol=n * EPS32 * float(np.abs(pts[b]).max()))
        w = float(np.asarray(want.inertia)[b])
        assert abs(float(got.inertia[b]) - w) <= n * tol + n * EPS32 * w


def _prev_centroids(reng, ref, pts, init, n_iters, **kw):
    """Each problem's centroids one iteration before its fit stopped: the
    reference's single fit of problem b, which its batched row equals."""
    jnp = ref.jnp
    return np.stack([np.asarray(reng.fit(jnp.asarray(pts[b]),
                                         jnp.asarray(init[b]),
                                         max_iters=int(it) - 1, **kw)
                                .centroids)
                     for b, it in enumerate(np.asarray(n_iters))])


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("port_be,ref_be", PAIRS)
def test_seed_batched_matches_reference(ref, sampler, d, port_be, ref_be):
    """Every problem's seeds are the reference's, exactly; the centroids are
    those rows bitwise and the final D² agree within the D² tolerance."""
    pts = _problems(d)
    reng, eng = _engines(ref, port_be, ref_be, N, d, 256)
    want = reng.seed_batched(ref.jax.random.PRNGKey(SEED),
                             ref.jnp.asarray(pts), K, sampler=sampler)
    got = eng.seed_batched(pts, K, draws=batched_draws_for(SEED, B, N, K),
                           sampler=sampler)
    idx = got.indices.numpy()
    np.testing.assert_array_equal(idx, np.asarray(want.indices))
    assert got.centroids.shape == (B, K, d) and got.min_d2.shape == (B, N)
    for b in range(B):
        np.testing.assert_array_equal(got.centroids[b].numpy(),
                                      pts[b][idx[b]])
        np.testing.assert_allclose(got.min_d2[b].numpy(),
                                   np.asarray(want.min_d2)[b], rtol=0,
                                   atol=d2_tol(pts[b], pts[b][idx[b]]))


@pytest.mark.parametrize("empty", ["keep", "reseed"])
@pytest.mark.parametrize("port_be,ref_be", PAIRS)
def test_fit_batched_matches_reference(ref, empty, port_be, ref_be):
    """From the reference's seeds (one problem's last centroid moved far
    outside its data under 'reseed', so a cluster empties and jumps), with
    ``tol`` > 0 so the problems stop at different iterations: each
    problem's ``n_iters`` is the reference's (the vmapped loop counts per
    problem), labels up to near-ties, centroids and inertia within
    tolerance. More than one tile and more than one super-tile per
    problem."""
    d, tol = 5, 1e-4
    pts = _problems(d, seed=1)
    reng, eng = _engines(ref, port_be, ref_be, N, d, 128)
    init = np.asarray(reng.seed_batched(ref.jax.random.PRNGKey(SEED),
                                        ref.jnp.asarray(pts), K).centroids)
    init = init.copy()
    if empty == "reseed":
        init[1, -1] = pts[1].max(0) + 50.0
    kw = dict(max_iters=25, tol=tol, empty=empty)
    want = reng.fit_batched(ref.jnp.asarray(pts), ref.jnp.asarray(init),
                            **kw)
    got = eng.fit_batched(pts, init, **kw)
    assert eng.backend.tiles_per_super(-(-N // 128)) > 1
    if empty == "keep":
        assert len(set(np.asarray(want.n_iters).tolist())) > 1
    prev = _prev_centroids(reng, ref, pts, init, want.n_iters, tol=tol,
                           empty=empty)
    _assert_rows_fit(got, convert.lloyd_result(*want[:4]), pts, prev)


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("port_be,ref_be", PAIRS)
def test_kmeans_batched_matches_reference(ref, sampler, port_be, ref_be):
    """``kmeans_batched`` end to end: seed_batched's seeds exactly, then the
    fit as ``test_fit_batched_matches_reference`` holds it."""
    d = 5
    pts = _problems(d, seed=2)
    reng, eng = _engines(ref, port_be, ref_be, N, d, 256)
    key = ref.jax.random.PRNGKey(SEED)
    want_seed = reng.seed_batched(key, ref.jnp.asarray(pts), K,
                                  sampler=sampler)
    want = reng.kmeans_batched(key, ref.jnp.asarray(pts), K, sampler=sampler,
                               max_iters=25)
    draws = batched_draws_for(SEED, B, N, K)
    seeds = eng.seed_batched(pts, K, draws=draws, sampler=sampler)
    np.testing.assert_array_equal(seeds.indices.numpy(),
                                  np.asarray(want_seed.indices))
    got = eng.kmeans_batched(pts, K, draws=draws, sampler=sampler,
                             max_iters=25)
    prev = _prev_centroids(reng, ref, pts, np.asarray(want_seed.centroids),
                           want.n_iters)
    _assert_rows_fit(got, convert.lloyd_result(*want[:4]), pts, prev)


@pytest.mark.parametrize("n,d,block_n,m", [(1000, 3, 128, 1),
                                           (777, 16, 256, 4)])
def test_distance_min_update_batched_matches_reference(ref, n, d, block_n,
                                                       m):
    """K7's plain version against the reference's batch-grid Pallas kernel
    (interpreted): D² within ``d2_tol``, partials within block_n D² errors
    plus two summation orders, problem by problem."""
    rng = np.random.default_rng(n + d)
    x = rng.normal(size=(B, n, d)).astype(np.float32)
    c = np.stack([x[b][rng.choice(n, m, replace=False)] for b in range(B)])
    md = np.stack([exact_d2(x[b], x[b][:2]).min(1) for b in range(B)]
                  ).astype(np.float32)
    norms = (x ** 2).sum(-1, dtype=np.float32)
    jnp = ref.jnp
    want_md, want_p = ref.ops.distance_min_update_batched(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(md),
        norms=jnp.asarray(norms), block_n=block_n, interpret=True)
    xt = torch.from_numpy(x)
    got_md, got_p = kd.distance_min_update_batched(
        xt, bounds.point_norms(xt), torch.from_numpy(c),
        torch.from_numpy(md), block_n=block_n)
    assert got_p.shape == (B, -(-n // block_n))
    for b in range(B):
        tol = d2_tol(x[b], c[b])
        np.testing.assert_allclose(got_md[b].numpy(), np32(want_md)[b],
                                   rtol=0, atol=tol)
        wp = np32(want_p)[b]
        assert (np.abs(got_p[b].numpy() - wp)
                <= block_n * tol + 2 * block_n * EPS32 * np.abs(wp)).all()


@pytest.mark.parametrize("n,d,k,block_n,tps", [(1000, 2, 5, 128, 4),
                                               (777, 16, 9, 128, 2)])
def test_lloyd_assign_tiled_batched_matches_reference(ref, n, d, k, block_n,
                                                      tps):
    """K10a's plain version against the reference's batch-grid Pallas
    kernel (the ``custom_vmap`` rule of ``ops.lloyd_assign_tiled``,
    interpreted): per problem, labels outside near-ties, D², partials and
    gaps within tolerance; counts exact and sums within 1e-5 of the rows'
    absolute sum where the labels agree."""
    rng = np.random.default_rng(k + d)
    x = rng.normal(size=(B, n, d)).astype(np.float32)
    c = np.stack([x[b][rng.choice(n, k, replace=False)] + 0.01
                  for b in range(B)])
    norms = (x ** 2).sum(-1, dtype=np.float32)
    jax, jnp = ref.jax, ref.jnp
    want = jax.vmap(lambda p, cc, nr: ref.ops.lloyd_assign_tiled(
        p, cc, norms=nr, block_n=block_n, tps=tps, interpret=True))(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(norms))
    xt = torch.from_numpy(x)
    got = la.lloyd_assign_tiled_batched(xt, bounds.point_norms(xt),
                                        torch.from_numpy(c),
                                        block_n=block_n, tps=tps)
    n_super = -(-(-(-n // block_n)) // tps)
    assert got[4].shape == (B, n_super, k, d)
    for b in range(B):
        a, md, part, gap, ssums, scounts = (t[b].numpy() for t in got)
        wa, wmd, wpart, wgap, wsums, wcounts = (np.asarray(v)[b]
                                                for v in want)
        tol = d2_tol(x[b], c[b])
        assert_labels_match(a, wa, exact_d2(x[b], c[b]), tol)
        np.testing.assert_allclose(md, wmd, rtol=0, atol=tol)
        assert (np.abs(part - wpart)
                <= block_n * tol + 2 * block_n * EPS32 * np.abs(wpart)).all()
        np.testing.assert_allclose(gap, wgap, rtol=0, atol=2 * np.sqrt(tol))
        if (a == wa).all():
            np.testing.assert_array_equal(scounts, wcounts)
            s_of = np.arange(n) // (tps * block_n)
            abs_sum = np.zeros((n_super, k, d))
            np.add.at(abs_sum, (s_of, wa), np.abs(x[b]))
            assert (np.abs(ssums - wsums) <= 1e-5 * abs_sum + 1e-6).all()


# ---------------------------------------------------------------------------
# inside the port: row b is the single problem, bitwise
# ---------------------------------------------------------------------------


def _row(res, b):
    """Problem b of a batched result, as the single result type."""
    return type(res)(*(None if f is None else f[b] for f in res))


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "n_iters":   # an int, or a tensor when batched
            x, y = (torch.as_tensor(v).long().cpu() for v in (x, y))
        assert torch.equal(x, y), f


@pytest.mark.parametrize("empty", ["keep", "reseed"])
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("backend", ["reference", "fused", "cuda"])
def test_batched_rows_are_the_single_runs(backend, sampler, empty):
    """Row b of seed_batched / fit_batched / kmeans_batched is bitwise the
    single ``seed`` then ``fit`` of problem b with ``draws[b]``: seeds, D²,
    centroids, assignment, inertia and n_iters, on every backend, with the
    problems stopping at different iterations (``tol`` > 0)."""
    d, tol = 5, 1e-4
    pts = _problems(d, seed=3)
    eng = ClusterEngine(backend, device="cpu", bounds=False, block_n=128)
    draws = Draws.sample_batched(B, N, K,
                                 generator=torch.Generator().manual_seed(5))
    seeds = eng.seed_batched(pts, K, draws=draws, sampler=sampler)
    init = seeds.centroids.clone()
    if empty == "reseed":
        init[2, 0] = torch.from_numpy(pts[2].max(0) + 50.0)
    kw = dict(max_iters=25, tol=tol, empty=empty)
    fit = eng.fit_batched(pts, init, **kw)
    assert fit.n_iters.dtype == torch.int32 and fit.n_iters.shape == (B,)
    km = eng.kmeans_batched(pts, K, draws=draws, sampler=sampler, **kw)
    fields = ("centroids", "assignment", "inertia", "n_iters")
    for b in range(B):
        one = eng.seed(pts[b], K, draws=draws[b], sampler=sampler)
        _same(one, _row(seeds, b), ("indices", "centroids", "min_d2"))
        _same(eng.fit(pts[b], init[b], **kw), _row(fit, b), fields)
        _same(eng.fit(pts[b], one.centroids, **kw), _row(km, b), fields)


@pytest.mark.parametrize("d", [2, 16])
def test_batched_twins_are_the_single_twins_row_by_row(d):
    """K7's and K10a's plain twins are K2's and K3's on each problem,
    bitwise, and the CPU wrappers run them."""
    rng = np.random.default_rng(d)
    n, k, bn = 700, 7, 128
    x = torch.from_numpy(rng.normal(size=(B, n, d)).astype(np.float32))
    norms = bounds.point_norms(x)
    c = x[:, :k].contiguous()
    md = torch.from_numpy(rng.exponential(size=(B, n)).astype(np.float32))
    seeded = kd.distance_min_update_batched_torch(x, norms, c[:, :2], md,
                                                  block_n=bn)
    assigned = la.lloyd_assign_tiled_batched_torch(x, norms, c, block_n=bn,
                                                   tps=2)
    for b in range(B):
        one = kd.distance_min_update_torch(x[b], norms[b], c[b, :2], md[b],
                                           block_n=bn)
        assert all(torch.equal(u[b], v) for u, v in zip(seeded, one))
        one = la.lloyd_assign_tiled_torch(x[b], norms[b], c[b], block_n=bn,
                                          tps=2)
        assert all(torch.equal(u[b], v) for u, v in zip(assigned, one))
    ops.reset_launches()
    wrapped = kd.distance_min_update_batched(x, norms, c[:, :2], md,
                                             block_n=bn)
    assert all(torch.equal(u, v) for u, v in zip(wrapped, seeded))
    wrapped = la.lloyd_assign_tiled_batched(x, norms, c, block_n=bn, tps=2)
    assert all(torch.equal(u, v) for u, v in zip(wrapped, assigned))
    assert not any(ops.LAUNCHES.values())
    # the batched norms are the single norms, row by row
    assert torch.equal(norms[1], bounds.point_norms(x[1]))


@pytest.mark.parametrize("n", [1, 32, 33, 4097, 20_000])
def test_batched_samplers_rows_are_the_single_draws(n):
    """prefix_sum, fixed_sum, tile_partials and both samplers on (B, n) rows
    give each row's 1-D result bitwise; an all-zero row takes its fallback
    index while the others draw."""
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.exponential(size=(4, n)).astype(np.float32))
    w[2] = 0.0
    u = torch.from_numpy(rng.uniform(size=4).astype(np.float32))
    fb = torch.arange(4, dtype=torch.int64)[:, None] % n
    bn = 128
    parts = sampling.tile_partials(w, bn)
    cdf = sampling.prefix_sum(w)
    got_cdf = sampling.categorical_cdf(u, fb, w)
    got_tiled = sampling.categorical_tiled(u, fb, w, parts, block_n=bn)
    assert got_cdf.shape == got_tiled.shape == (4, 1)
    for b in range(4):
        assert torch.equal(cdf[b], sampling.prefix_sum(w[b]))
        assert torch.equal(parts[b], sampling.tile_partials(w[b], bn))
        assert torch.equal(sampling.fixed_sum(parts)[b],
                           sampling.fixed_sum(parts[b]))
        assert torch.equal(got_cdf[b],
                           sampling.categorical_cdf(u[b], fb[b], w[b]))
        assert torch.equal(got_tiled[b], sampling.categorical_tiled(
            u[b], fb[b], w[b], parts[b], block_n=bn))
    assert int(got_cdf[2]) == int(got_tiled[2]) == 2 % n
    exact = w.double().sum(-1)
    assert (sampling.fixed_sum(w).double() - exact).abs().max() \
        <= n * EPS32 * float(exact.max())


@pytest.mark.parametrize("n", [1, 7, 128, 300])
def test_fixed_sum_order_ignores_the_other_axes(n):
    """fixed_sum adds in ascending order inside blocks of SCAN_BLOCK
    entries, then the block totals: the same bits along any axis and for
    any batch shape, within n roundings of the float64 sum."""
    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(5, n, 3)).astype(np.float32))
    got = sampling.fixed_sum(x, 1)
    assert got.shape == (5, 3)
    assert torch.equal(sampling.fixed_sum(x.transpose(0, 1), 0), got)
    assert torch.equal(sampling.fixed_sum(x[2], 0), got[2])
    assert torch.equal(sampling.fixed_sum(x[2, :, 1]), got[2, 1])
    tol = n * EPS32 * x.abs().double().sum(1)
    assert ((got.double() - x.double().sum(1)).abs() <= tol).all()


def test_draws_sample_batched_rows_are_single_draws():
    """Problem b's draws are the single draws the generator gives after b
    problems', and ``draws[b]`` is a single ``Draws``."""
    a = Draws.sample_batched(4, 1000, 8,
                             generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    assert a.first.shape == (4, 1) and a.u.shape == a.fallback.shape == (4, 7)
    for b in range(4):
        one = Draws.sample(1000, 8, generator=g)
        for x, y in ((a[b].first, one.first), (a[b].u, one.u),
                     (a[b].fallback, one.fallback)):
            assert torch.equal(x, y)
    assert a[1].max_attempts == 0 and a[1].u.shape == (7,)


def test_kmeans_batched_is_seed_then_fit_and_sane():
    """kmeans_batched = seed_batched then fit_batched, each with its own
    prologue and tile height (not kmeans' shared one); on the CPU-sized
    kvquant workload its results have the right shapes, are finite, and
    each problem's inertia is the one its final assignment reaches."""
    cfg = KVQUANT_SMOKE
    pts = blobs_batched(cfg.batch, cfg.n_points, cfg.dim, cfg.k,
                        generator=torch.Generator().manual_seed(0))
    eng = ClusterEngine(device="cpu", bounds=False)
    draws = Draws.sample_batched(cfg.batch, cfg.n_points, cfg.k,
                                 generator=torch.Generator().manual_seed(1))
    got = eng.kmeans_batched(pts, cfg.k, draws=draws,
                             max_iters=cfg.max_iters)
    two = eng.fit_batched(pts, eng.seed_batched(pts, cfg.k,
                                                draws=draws).centroids,
                          max_iters=cfg.max_iters)
    _same(got, two, ("centroids", "assignment", "inertia", "n_iters"))
    assert got.centroids.shape == (cfg.batch, cfg.k, cfg.dim)
    assert got.assignment.shape == (cfg.batch, cfg.n_points)
    assert bool(torch.isfinite(got.centroids).all())
    assert ((got.n_iters >= 1) & (got.n_iters <= cfg.max_iters)).all()
    assert 0 <= int(got.assignment.min()) and \
        int(got.assignment.max()) < cfg.k
    # the inertia is the last assignment's, against the centroids it saw:
    # close to the final centroids' (one Lloyd step further)
    final = ((pts - torch.take_along_dim(
        got.centroids, got.assignment.long()[..., None], dim=1)) ** 2
    ).sum((1, 2))
    np.testing.assert_allclose(got.inertia.numpy(), final.numpy(),
                               rtol=2e-2)


def test_batched_entry_guards():
    """Shape abuse and non-finite rows are typed errors at the batched
    entries, as at the single ones; draws for another problem count are a
    ValueError."""
    pts = _problems(2, n=300)
    eng = ClusterEngine(device="cpu", bounds=False)
    with pytest.raises(InvalidInputError):
        eng.seed_batched(pts[0], 4)
    with pytest.raises(InvalidInputError):
        eng.seed_batched(pts, 301)
    with pytest.raises(InvalidInputError):
        eng.fit_batched(pts, pts[0, :4])
    bad = pts.copy()
    bad[1, 7, 0] = np.nan
    with pytest.raises(InvalidInputError):
        eng.kmeans_batched(bad, 4)
    with pytest.raises(ValueError):
        eng.seed_batched(pts, 4, draws=Draws.sample_batched(2, 300, 4))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_tol(norms, cents) -> float:
    d = cents.shape[-1]
    return 2 * (d + 4) * EPS32 * (float(norms.max())
                                  + float((cents * cents).sum(-1).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(2, 1), (16, 1), (16, 8), (33, 3)])
def test_k7_matches_plain_and_is_k2_row_by_row_on_the_card(card, d, m):
    """K7: two launches give the same bits; D² and partials within the
    tolerances of K2's test; and row b bitwise K2 on problem b's slice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(d + m)
    bsz, n, bn = 5, 10_007, 1024
    x = torch.rand((bsz, n, d), generator=g, device=card)
    norms = bounds.point_norms(x)
    c = x[:, :m].contiguous()
    md = kd.distance_min_update_batched_torch(
        x, norms, x[:, m:m + 2].contiguous(),
        torch.full((bsz, n), torch.inf, device=card), block_n=bn)[0]
    for resident in (True, False):
        one = kd.distance_min_update_batched(x, norms, c, md, block_n=bn,
                                             resident=resident)
        two = kd.distance_min_update_batched(x, norms, c, md, block_n=bn,
                                             resident=resident)
        assert all(torch.equal(u, v) for u, v in zip(one, two))
        plain = kd.distance_min_update_batched_torch(x, norms, c, md,
                                                     block_n=bn)
        tol = _card_tol(norms, c)
        assert float((one[0] - plain[0]).abs().max()) <= tol
        assert bool(((one[1] - plain[1]).abs()
                     <= bn * tol + 2 * bn * EPS32 * plain[1].abs()).all())
        for b in (0, 1, bsz - 1):
            k2 = kd.distance_min_update(x[b], norms[b], c[b], md[b],
                                        block_n=bn, resident=resident)
            assert all(torch.equal(u[b], v) for u, v in zip(one, k2))


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(2, 6), (16, 256), (33, 7)])
def test_k10a_matches_plain_and_is_k3_row_by_row_on_the_card(card, d, k):
    """K10a: two launches give the same bits; labels outside near-ties, D²
    within tolerance against the plain twin; counts exact over the
    kernel's own labels; and row b bitwise K3 on problem b's slice (d = 2
    and d = 16 take the register-tiled path, d = 33 the runtime-d loop)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(d + k)
    bsz, n = 4, 20_011
    bn = ops.choose_block_n(n, d, k)
    tps = bounds.tiles_per_super(-(-n // bn))
    x = torch.rand((bsz, n, d), generator=g, device=card)
    norms = bounds.point_norms(x)
    c = x[:, :k].contiguous() + 0.001
    one = la.lloyd_assign_tiled_batched(x, norms, c, block_n=bn, tps=tps)
    two = la.lloyd_assign_tiled_batched(x, norms, c, block_n=bn, tps=tps)
    assert all(torch.equal(u, v) for u, v in zip(one, two))
    plain = la.lloyd_assign_tiled_batched_torch(x, norms, c, block_n=bn,
                                                tps=tps)
    tol = _card_tol(norms, c)
    assert float((one[1] - plain[1]).abs().max()) <= tol
    for b in range(bsz):
        d2 = kd.tile_d2(x[b], c[b], norms[b])
        diff = one[0][b] != plain[0][b]
        gap = (d2.gather(1, one[0][b].long()[:, None])
               - d2.gather(1, plain[0][b].long()[:, None])).abs()[:, 0]
        assert bool((gap[diff] <= tol).all())
        s_of = torch.arange(n, device=card) // (bn * tps)
        want = torch.zeros_like(one[5][b]).index_put_(
            (s_of, one[0][b].long()), torch.ones(n, device=card),
            accumulate=True)
        assert torch.equal(one[5][b], want)
    for b in (0, 1, bsz - 1):
        k3 = la.lloyd_assign_tiled(x[b], norms[b], c[b], block_n=bn, tps=tps)
        assert all(torch.equal(u[b], v) for u, v in zip(one, k3))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
def test_batched_engine_is_the_single_engine_on_the_card(card, sampler):
    """On the card kmeans_batched launches K7 once per round and K10a once
    per iteration of the slowest problem, nothing else, and row b is
    bitwise the single seed then fit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bsz, n, d, k = 4, 5000, 16, 16
    pts = blobs_batched(bsz, n, d, k,
                        generator=torch.Generator(device=card).manual_seed(0))
    eng = ClusterEngine(device=card, bounds=False)
    draws = Draws.sample_batched(bsz, n, k,
                                 generator=torch.Generator().manual_seed(1))
    ops.reset_launches()
    got = eng.kmeans_batched(pts, k, draws=draws, sampler=sampler,
                             max_iters=8, tol=1e-4)
    counts = dict(ops.LAUNCHES)
    assert counts.pop("distance_min_update_batched") == k
    assert counts.pop("lloyd_assign_tiled_batched") == int(got.n_iters.max())
    assert not any(counts.values()), counts
    for b in (0, 1, bsz - 1):
        seeds = eng.seed(pts[b], k, draws=draws[b], sampler=sampler)
        fit = eng.fit(pts[b], seeds.centroids, max_iters=8, tol=1e-4)
        _same(fit, _row(got, b), ("centroids", "assignment", "inertia",
                                  "n_iters"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [977, 4096, 16_384])
def test_prefix_sum_rows_are_the_single_scans_on_the_card(card, n):
    """On the card a row of a (B, n) prefix_sum is bitwise the 1-D call on
    it, for a few problems and for the codebook sweep's 1664: the row scans
    have a width at which torch.cumsum's order ignores the row count."""
    for bsz in (3, 1664):
        w = torch.rand((bsz, n), generator=torch.Generator(
            device=card).manual_seed(n), device=card)
        got = sampling.prefix_sum(w)
        for b in (0, 1, bsz - 1):
            assert torch.equal(got[b], sampling.prefix_sum(w[b]))
