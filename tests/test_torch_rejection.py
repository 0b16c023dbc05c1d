"""The port's rejection seeding (``sampler='rejection'``, ``proposal`` 'hier'
and 'flat') against ``repro.core.engine``'s.

The reference runs on the CPU with its ``pallas`` backend in interpret mode
(``test_torch_jaxref``), at an explicit tile geometry of 16 tiles of 128
rows in 4 super-tiles, so the coarse-to-fine draw has several supers of
several tiles. The port gets the reference's random numbers, the rejection
schedule included (``draws_for(..., max_attempts)``), and the same geometry
(``convert.with_geometry``); on the CPU its ``cuda`` backend runs the plain
versions of K11 and K12. Discrete outputs (seeds and every counter) must
match exactly; D² to the stated tolerance.

Inside the port, the pins of the reference's ``tests/test_rejection_sampler
.py``: ``refresh_block=1`` is bitwise the tiled sampler, the returned D² is
exact over all k seeds, refreshes are fewer than rounds, duplicate points
terminate, ``max_attempts`` truncates and is reported, and the draws follow
the tiled sampler's distribution.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_jaxref import (EPS32, d2_tol, draws_for, exact_d2, np32,
                               ref)  # noqa: F401  (ref is a fixture)
from repro_torch import convert
from repro_torch.core import (ClusterEngine, Draws, FusedBackend, bounds,
                              engine, make_backend, sampling, telemetry)
from repro_torch.data import blobs
from repro_torch.kernels import kmeans_distance as kd

N, D, K, BN, TPS = 2000, 2, 12, 128, 4      # 16 tiles in 4 supers
A = 8                                       # max_attempts (the default)
BACKENDS = ["cuda", "fused", "reference"]
COUNTERS = ("indices", "proposals", "accepts", "tightened", "supers")


def _sorted_blobs(n=N, d=D, k=6, seed=0):
    """Blobs in label order: tiles are spatially coherent, so the caps
    tighten and stale envelopes reject (both paths get exercised)."""
    pts, lab = blobs(n, d, k, seed=seed)
    return pts[np.argsort(lab, kind="stable")]


def _port_be(name):
    return convert.with_geometry(make_backend(name), BN, TPS)


def _port_seed(pts, draws, backend="cuda", **kw):
    kw.setdefault("guard", True)
    return engine.seed_points(draws, torch.from_numpy(pts), K,
                              _port_be(backend), "rejection", **kw)


def _ref_seed(ref, pts, seed, *, bounds_on, backend="pallas", fault=None,
              **kw):
    eng = ref.engine.ClusterEngine(backend, bounds=bounds_on, block_n=BN,
                                   tps=TPS)
    return eng.seed(ref.jax.random.PRNGKey(seed), ref.jnp.asarray(pts), K,
                    sampler="rejection", _fault=fault, **kw)


def _assert_counters_equal(got, want, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# K11 and K12: plain versions against the Pallas kernels and the oracles
# ---------------------------------------------------------------------------


def _pending(x, p, seed):
    rng = np.random.default_rng(seed)
    return x[rng.choice(x.shape[0], p, replace=False)] + np32(0.01)


@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("count", [0, 1, 8])
def test_row_min_d2_matches_reference(ref, d, count):
    """K11's plain version against ``row_min_d2_pallas`` (interpreted) and
    the oracle ``row_min_d2_ref``, every row of a small set: +inf at count
    0, else within 2d + 4 roundings of the diff-square sum (each side
    rounds d differences, d products and d - 1 adds)."""
    jnp = ref.jnp
    x = np.random.default_rng(d).normal(size=(300, d)).astype(np.float32)
    pend = _pending(x, 8, seed=count)
    xt, pt = torch.from_numpy(x), torch.from_numpy(pend)
    for i in (0, 17, 299):
        got = float(kd.row_min_d2(xt, torch.tensor(i), pt, count))
        kern = float(ref.ops.row_min_d2(jnp.asarray(x), jnp.asarray(i),
                                        jnp.asarray(pend), jnp.asarray(count),
                                        interpret=True))
        oracle = float(ref.ref.row_min_d2_ref(jnp.asarray(x), i,
                                              jnp.asarray(pend), count))
        if count == 0:
            assert got == kern == oracle == np.inf
            continue
        tol = (2 * d + 4) * EPS32 * kern
        assert abs(got - kern) <= tol and abs(got - oracle) <= tol
        want = exact_d2(x[i:i + 1], pend[:count]).min()
        assert abs(got - want) <= tol


@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("count", [0, 1, 8])
def test_tile_cap_matches_reference(ref, d, count):
    """K12's plain version against ``tile_cap_pallas`` (interpreted; the
    diff-square form) within d + 4 roundings of the cap, and against the
    oracle ``tile_cap_ref`` (matmul form, clamped): its D² may be off by
    ``d2_tol``, which a square root turns into at most √d2_tol of distance
    error before the cap squares it again. +inf everywhere at count 0."""
    jnp = ref.jnp
    x = _sorted_blobs(1000, d, 5, seed=d)
    cache = bounds.prologue(torch.from_numpy(x), 64)
    ctr, rad = cache.centers.numpy(), cache.radii.numpy()
    pend = _pending(x, 8, seed=count)
    got = kd.tile_cap(cache.centers, cache.radii, torch.from_numpy(pend),
                      torch.tensor(count)).numpy()
    args = (jnp.asarray(ctr), jnp.asarray(rad), jnp.asarray(pend),
            jnp.asarray(count))
    kern = np32(ref.ops.tile_cap(*args, interpret=True))
    oracle = np32(ref.ref.tile_cap_ref(*args))
    if count == 0:
        assert np.isinf(got).all() and np.isinf(kern).all()
        assert np.isinf(oracle).all()
        return
    np.testing.assert_allclose(got, kern, rtol=2 * (d + 4) * EPS32, atol=0)
    t = d2_tol(ctr, pend)
    root = np.sqrt(np.maximum(kern, 0))
    np.testing.assert_array_less(
        np.abs(got - oracle), np.sqrt(t) * (2 * root + np.sqrt(t))
        + 8 * EPS32 * kern + 1e-30)
    dc = np.sqrt(exact_d2(ctr, pend[:count]).min(1))
    np.testing.assert_allclose(got, (dc + rad) ** 2, rtol=2 * (d + 4) * EPS32)


def test_kernel_wrappers_reject_bad_shapes():
    x = torch.zeros(50, 3)
    with pytest.raises(ValueError):
        kd.row_min_d2(x, torch.tensor(1), torch.zeros(4, 2), 2)
    # idx is 0-d or (A,): one row or every attempt of a round
    with pytest.raises(ValueError):
        kd.row_min_d2(x, torch.tensor([[1, 2]]), torch.zeros(4, 3), 2)
    with pytest.raises(ValueError):
        kd.row_min_d2(x, torch.zeros(0, dtype=torch.int64),
                      torch.zeros(4, 3), 2)
    with pytest.raises(ValueError):
        kd.tile_cap(torch.zeros(5, 3), torch.zeros(4), torch.zeros(4, 3), 1)
    with pytest.raises(ValueError):
        kd.tile_cap(torch.zeros(5, 3), torch.zeros(5), torch.zeros(4, 2), 1)


@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("count", [0, 1, 8])
def test_row_min_d2_on_many_rows_is_each_single_row(ref, d, count):
    """K11's (A,) form, one call for every attempt of a round: entry a
    bitwise the 0-d call on ``idx[a]`` (A = 1 and 8, repeated rows among
    them), each within the single-row test's roundings of the interpreted
    ``row_min_d2_pallas`` at that index (+inf at count 0), and NaN for an
    index outside [0, n)."""
    jnp = ref.jnp
    x = np.random.default_rng(d).normal(size=(300, d)).astype(np.float32)
    pend = _pending(x, 8, seed=count)
    xt, pt = torch.from_numpy(x), torch.from_numpy(pend)
    for idx in (torch.tensor([123]),
                torch.tensor([0, 17, 299, 17, 5, 123, 250, 1])):
        got = kd.row_min_d2(xt, idx, pt, count)
        assert got.shape == idx.shape and got.dtype == torch.float32
        for a, i in enumerate(idx.tolist()):
            one = kd.row_min_d2(xt, torch.tensor(i), pt, count)
            assert one.shape == ()
            assert got[a].view(torch.int32) == one.view(torch.int32)
            kern = float(ref.ops.row_min_d2(
                jnp.asarray(x), jnp.asarray(i), jnp.asarray(pend),
                jnp.asarray(count), interpret=True))
            if count == 0:
                assert float(got[a]) == kern == np.inf
            else:
                assert abs(float(got[a]) - kern) <= (2 * d + 4) * EPS32 * kern
    out = kd.row_min_d2(xt, torch.tensor([3, -1, 300, 299]), pt, count)
    assert torch.isnan(out[1]) and torch.isnan(out[2])
    for a, i in ((0, 3), (3, 299)):
        assert out[a].view(torch.int32) == kd.row_min_d2(
            xt, torch.tensor(i), pt, count).view(torch.int32)


def _prep_ops(centers, radii, pending, count, partials, tile_w):
    """The hier round's envelope as the engine's prep wrote it before
    ``tile_envelope``: K12's caps, then the elementwise ops and the sum."""
    cap = kd.tile_cap_torch(centers, radii, pending, count)
    capw = cap * tile_w
    ph = torch.where(capw < partials, capw, partials)
    tight = ph < partials
    return cap, ph, tight, tight.sum(dtype=torch.int32)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _envelope_inputs(tile_w_kind, seed=0):
    """Tile balls of sorted blobs (16 tiles of 128 rows), a pending block
    of 8 rows near the data, the partials of a fold of its first row, and
    tile masses: the row counts, weighted tile sums with a zero, or masses
    with NaN, +inf and 0 among them; the partials then carry a NaN and a
    +inf of their own."""
    x = torch.from_numpy(_sorted_blobs(N, D, 6, seed=seed))
    cache = bounds.prologue(x, BN)
    pend = torch.from_numpy(_pending(x.numpy(), 8, seed=seed))
    md = kd.diff_sq(x[:, None, :], pend[None, :1, :]).amin(dim=1)
    partials = sampling.tile_partials(md, BN)
    n_tiles = partials.shape[0]
    if tile_w_kind == "counts":
        tile_w = sampling.tile_partials(torch.ones(N), BN)
    elif tile_w_kind == "weighted":
        w = torch.from_numpy(np.random.default_rng(seed).uniform(
            size=N).astype(np.float32))
        w[:BN] = 0.0                          # a tile of weight 0
        tile_w = sampling.tile_partials(w, BN)
    else:
        tile_w = torch.linspace(0.5, 40.0, n_tiles)
        tile_w[[1, 4, 9]] = torch.tensor([torch.nan, torch.inf, 0.0])
        partials = partials.clone()
        partials[[2, 9]] = torch.tensor([torch.nan, torch.inf])
    return cache, pend, partials, tile_w


@pytest.mark.parametrize("tile_w_kind", ["counts", "weighted", "special"])
def test_tile_envelope_is_the_prep_composition(tile_w_kind):
    """``tile_envelope`` (its plain twin, through the wrapper and the
    backends) is bitwise K12's caps followed by the elementwise ops the
    hier prep ran, at every count 0..P, with +inf, NaN and zero tile
    masses and a NaN and +inf partial (a NaN product or partial loses
    every compare)."""
    cache, pend, partials, tile_w = _envelope_inputs(tile_w_kind)
    for count in range(9):
        want = _prep_ops(cache.centers, cache.radii, pend,
                         torch.tensor(count), partials, tile_w)
        for got in (kd.tile_envelope(cache.centers, cache.radii, pend,
                                     torch.tensor(count), partials, tile_w),
                    make_backend("cuda").tile_envelope(
                        cache.centers, cache.radii, pend, count, partials,
                        tile_w)):
            assert [g.dtype for g in got] == [torch.float32, torch.float32,
                                              torch.bool, torch.int32]
            assert got[3].shape == ()
            for g, w in zip(got, want):
                assert torch.equal(_bits(g), _bits(w))
        if count == 8 and tile_w_kind != "special":
            assert int(want[3]) > 0   # the caps tighten some tile


@pytest.mark.parametrize("tile_w_kind", ["counts", "weighted", "special"])
def test_tile_envelope_shortcut_at_count_0_is_the_computed_one(tile_w_kind):
    """What the hier prep uses when no pending centroid is live (+inf
    caps, the partials, no tight tile, 0) is bitwise the envelope computed
    at count 0."""
    cache, pend, partials, tile_w = _envelope_inputs(tile_w_kind, seed=1)
    n_tiles = partials.shape[0]
    cap, ph, tight, n_tight = kd.tile_envelope(
        cache.centers, cache.radii, pend, torch.tensor(0), partials, tile_w)
    assert torch.equal(_bits(cap), _bits(torch.full((n_tiles,), torch.inf)))
    assert torch.equal(_bits(ph), _bits(partials))
    assert torch.equal(tight, torch.zeros(n_tiles, dtype=torch.bool))
    assert int(n_tight) == 0


def _live_rounds(accepts, k, p):
    """Rounds of a rejection seeding that start with a live pending
    centroid (count > 0 after the round's append and any refresh): the
    hier rounds that compute their tile envelope."""
    count, live = p - 1, 0
    for m in range(1, k):
        count += 1
        if count >= p:
            count = 0
        live += count > 0
        if not accepts[m]:
            count = 0
    return live


@pytest.mark.parametrize("weighted", [False, True])
def test_hier_round_computes_its_envelope_once_when_live(weighted):
    """A backend double counts ``tile_envelope``: one call per hier round
    with a live pending centroid, each with count > 0, none in a round
    after a refresh; the seeds are those of the plain backend."""

    @dataclasses.dataclass(frozen=True)
    class Counting(FusedBackend):
        counts: list = dataclasses.field(default_factory=list)

        def tile_envelope(self, centers, radii, pending, count, partials,
                          tile_w):
            self.counts.append(int(count))
            return super().tile_envelope(centers, radii, pending, count,
                                         partials, tile_w)

    k = 24
    pts = torch.from_numpy(_sorted_blobs(4096, 2, 8, seed=2))
    w = (torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 2.0, size=4096).astype(np.float32)) if weighted else None)
    draws = draws_for(8, 4096, k, A, weighted=weighted)
    be = Counting(block_n=BN, tps=TPS)
    res = engine.seed_points(draws, pts, k, be, "rejection",
                             refresh_block=8, weights=w)
    assert len(be.counts) == _live_rounds(res.accepts.tolist(), k, 8)
    assert 0 < len(be.counts) < k - 1
    assert min(be.counts) > 0
    plain = engine.seed_points(draws, pts, k, FusedBackend(block_n=BN,
                                                           tps=TPS),
                               "rejection", refresh_block=8, weights=w)
    for f in COUNTERS + ("centroids", "min_d2"):
        assert torch.equal(getattr(res, f), getattr(plain, f)), f


def _one_at_a_time(propose_fn, pq_fn, propose_u, accept_u, max_attempts,
                   valid=True):
    """The sequential rejection loop: attempt j proposes with
    ``propose_u[j]`` alone, prices that one row and reads its accept bit,
    stopping at the first accept."""
    if not valid:
        return None, False, 0
    idx = None
    for j in range(max_attempts):
        idx = propose_fn(propose_u[j])
        p, q = pq_fn(idx)
        if bool(accept_u[j] * q < p):
            return idx, True, j + 1
    return idx, False, max_attempts


def _proposal(kind, seed):
    """(weights, propose_fn) of a tiled draw or a hier draw (tightened
    windows, or none) over one weight vector."""
    w, parts, tcdf, cap, tight = _hier_inputs(
        seed, tightened=kind == "hier tightened")
    wt = torch.from_numpy(w)
    if kind == "tiled":
        return wt, lambda u: sampling.tiled_index_from_uniform(
            u, wt, parts, block_n=BN)
    scdf = sampling.super_cdf(tcdf, TPS)
    return wt, lambda u: sampling.hier_index_from_uniform(
        u, wt, parts, tcdf, scdf, block_n=BN, tps=TPS, cap=cap, tight=tight)


@pytest.mark.parametrize("kind", ["tiled", "hier", "hier tightened"])
def test_many_draws_are_each_single_draw(kind):
    """(A,) uniforms against one weight vector: row a of the draw is
    bitwise the draw with ``u[a]`` alone (the rejection sampler proposes
    every attempt of a round in one call)."""
    _, propose = _proposal(kind, seed=5)
    u = torch.from_numpy(np.random.default_rng(6).random(64)
                         .astype(np.float32))
    u[:3] = torch.tensor([0.0, 0.999999, 0.5])
    many = propose(u)
    assert many.shape == (64, 1)
    for a in range(64):
        assert torch.equal(many[a], propose(u[a]))


@pytest.mark.parametrize("max_attempts", range(1, 9))
@pytest.mark.parametrize("kind", ["tiled", "hier tightened"])
def test_rejection_sample_is_the_sequential_loop(kind, max_attempts):
    """All attempts at once against the one-at-a-time loop, on accept
    patterns from every attempt accepting to none (p = 0), with NaN p on
    some rows and ``valid=False``: the index, the accept bit and the
    attempt count are equal."""
    w, propose = _proposal(kind, seed=max_attempts)
    rng = np.random.default_rng(100 + max_attempts)
    for trial in range(12):
        shrink = rng.choice(np.array([0.0, 0.3, 1.0, np.nan], np.float32),
                            size=w.shape[0],
                            p=[[0.25, 0.25, 0.25, 0.25], [0.9, 0.05, 0.0,
                                                          0.05],
                               [0.0, 0.0, 1.0, 0.0]][trial % 3])
        p = w * torch.from_numpy(shrink)
        pu = torch.from_numpy(rng.random(max_attempts).astype(np.float32))
        au = torch.from_numpy(rng.random(max_attempts).astype(np.float32))
        pq = lambda i: (p[i], w[i])   # noqa: E731
        for valid in (True, False):
            got = sampling.rejection_sample(propose, pq, pu, au,
                                            max_attempts=max_attempts,
                                            valid=valid)
            want = _one_at_a_time(propose, pq, pu, au, max_attempts, valid)
            assert got[1:] == want[1:]
            if valid:
                assert got[0].shape == (1,)
                assert torch.equal(got[0], want[0].reshape(1))
            else:
                assert got[0] is None


# ---------------------------------------------------------------------------
# the samplers against the reference, on the same uniforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_tiles,tps", [(16, 4), (17, 4), (5, 8), (9, 1)])
def test_super_cdf_matches_reference(ref, n_tiles, tps):
    """Gathered boundaries: bitwise the reference's on the same tile CDF,
    and the last equals the tile CDF's last bitwise."""
    tcdf = np.cumsum(np.random.default_rng(n_tiles).exponential(
        size=n_tiles)).astype(np.float32)
    got = sampling.super_cdf(torch.from_numpy(tcdf), tps).numpy()
    want = np32(ref.sampling.super_cdf(ref.jnp.asarray(tcdf), tps))
    np.testing.assert_array_equal(got, want)
    assert got[-1] == tcdf[-1]


def _hier_inputs(seed, n=2000, bn=BN, tightened=False):
    rng = np.random.default_rng(seed)
    w = rng.exponential(size=n).astype(np.float32)
    w[rng.random(n) < 0.2] = 0.0
    parts = sampling.tile_partials(torch.from_numpy(w), bn)
    tcdf = sampling.prefix_sum(parts)
    cap = tight = None
    if tightened:
        cap = torch.from_numpy(rng.exponential(size=parts.shape[0])
                               .astype(np.float32))
        capw = cap * bn
        ph = torch.where(capw < parts, capw, parts)
        tight = ph < parts
        tight[::3] = False
        ph = torch.where(tight, ph, parts)
        parts, tcdf = ph, sampling.prefix_sum(ph)
    return w, parts, tcdf, cap, tight


@pytest.mark.parametrize("tightened", [False, True])
def test_hier_index_from_uniform_matches_reference(ref, tightened):
    """The three-level draw picks the reference's index on a grid of
    uniforms, with and without capped windows (the prefix sums are taken
    as the port computes them and handed to both sides); untightened, it
    is bitwise the tiled draw."""
    jnp = ref.jnp
    w, parts, tcdf, cap, tight = _hier_inputs(1, tightened=tightened)
    if tightened:
        assert 0 < int(tight.sum()) < tight.shape[0]
    scdf = sampling.super_cdf(tcdf, TPS)
    wj = jnp.asarray(w)
    kw = {}
    if tightened:
        kw = dict(cap=jnp.asarray(cap.numpy()), tight=jnp.asarray(
            tight.numpy()))
    for u in np.linspace(0.0, 0.999, 97, dtype=np.float32):
        got = int(sampling.hier_index_from_uniform(
            torch.tensor(u), torch.from_numpy(w), parts, tcdf, scdf,
            block_n=BN, tps=TPS, cap=cap, tight=tight))
        want = int(ref.sampling.hier_index_from_uniform(
            jnp.float32(u), wj, jnp.asarray(parts.numpy()),
            jnp.asarray(tcdf.numpy()), jnp.asarray(scdf.numpy()),
            block_n=BN, tps=TPS, **kw))
        assert got == want, u
        assert w[got] > 0
        if not tightened:
            assert got == int(sampling.tiled_index_from_uniform(
                torch.tensor(u), torch.from_numpy(w), parts, block_n=BN))


@pytest.mark.parametrize("mass", [0.0, np.nan])
def test_hier_degenerate_super_mass_takes_the_uniform_path(ref, mass):
    """Zero or NaN coarse mass: the one uniform telescopes into a uniform
    super -> tile -> row pick, the reference's index exactly."""
    jnp = ref.jnp
    n = 1000
    w = np.zeros(n, np.float32)
    if np.isnan(mass):
        w[5] = np.nan
    parts = sampling.tile_partials(torch.from_numpy(w), BN)
    tcdf = sampling.prefix_sum(parts)
    scdf = sampling.super_cdf(tcdf, TPS)
    for u in np.linspace(0.0, 0.999, 41, dtype=np.float32):
        got = int(sampling.hier_index_from_uniform(
            torch.tensor(u), torch.from_numpy(w), parts, tcdf, scdf,
            block_n=BN, tps=TPS))
        want = int(ref.sampling.hier_index_from_uniform(
            jnp.float32(u), jnp.asarray(w), jnp.asarray(parts.numpy()),
            jnp.asarray(tcdf.numpy()), jnp.asarray(scdf.numpy()),
            block_n=BN, tps=TPS))
        assert got == want and 0 <= got < n


def test_categorical_hier_matches_reference_draw_for_draw(ref):
    """Guarded hier draws from replayed round keys: the reference's
    ``categorical_hier`` index, healthy and degenerate."""
    jax, jnp = ref.jax, ref.jnp
    for w in (_hier_inputs(2)[0], np.zeros(2000, np.float32)):
        parts = sampling.tile_partials(torch.from_numpy(w), BN)
        key = jax.random.PRNGKey(11)
        for _ in range(10):
            key, ks = jax.random.split(key)
            want = int(ref.sampling.categorical_hier(
                ks, jnp.asarray(w), jnp.asarray(parts.numpy()), block_n=BN,
                tps=TPS))
            u = float(jax.random.uniform(ks, (), jnp.float32))
            fb = int(jax.random.randint(jax.random.fold_in(ks, 0x0DD), (),
                                        0, 2000, dtype=jnp.int32))
            got = int(sampling.categorical_hier(
                torch.tensor(u, dtype=torch.float32), torch.tensor([fb]),
                torch.from_numpy(w), parts, block_n=BN, tps=TPS))
            assert got == want


@pytest.mark.parametrize("shrink", [1.0, 0.3, 1e-6])
def test_rejection_sample_matches_reference(ref, shrink):
    """Proposals from an envelope q, target p = shrink·q: the index, the
    accept bit and the attempt count are the reference's on the same keys;
    at shrink 1 the first attempt accepts, at 1e-6 every attempt
    rejects."""
    jax, jnp = ref.jax, ref.jnp
    n, bn = 500, 64
    rng = np.random.default_rng(3)
    q = rng.exponential(size=n).astype(np.float32)
    p = (q * np32(shrink)).astype(np.float32)
    parts = sampling.tile_partials(torch.from_numpy(q), bn)
    qj, pj, partj = jnp.asarray(q), jnp.asarray(p), jnp.asarray(
        parts.numpy())
    qt, pt = torch.from_numpy(q), torch.from_numpy(p)
    for seed in range(12):
        draws = draws_for(seed, n, 2, A)   # round 1's numbers are ks's
        got = sampling.rejection_sample(
            lambda u: sampling.tiled_index_from_uniform(u, qt, parts,
                                                        block_n=bn),
            lambda i: (pt[i], qt[i]),
            torch.cat([draws.u[:1], draws.propose_u[0]]), draws.accept_u[0],
            max_attempts=A)
        # draws_for(seed) derives round 1's key by splitting PRNGKey(seed)
        # twice; replay the same key on the reference side
        key, _ = jax.random.split(jax.random.PRNGKey(seed))
        _, ks = jax.random.split(key)
        want = ref.sampling.rejection_sample(
            ks,
            lambda kj: ref.sampling.tiled_index_from_uniform(
                jax.random.uniform(kj, (), jnp.float32), qj, partj,
                block_n=bn),
            lambda i: (pj[i], qj[i]), max_attempts=A)
        assert (int(got[0]), got[1], got[2]) == (
            int(want[0]), bool(want[1]), int(want[2]))
        if shrink == 1.0:
            assert got[1] and got[2] == 1
        if shrink == 1e-6:
            assert not got[1] and got[2] == A
    skipped = sampling.rejection_sample(None, None, None, None,
                                        max_attempts=A, valid=False)
    assert skipped == (None, False, 0)


def test_rejection_schedule_replays_reference_draws(ref):
    """The replayed schedule reproduces the reference's own draws: attempt
    j's proposal index and accept uniform from ``fold_in`` keys, and the
    exact draw's index from ``fold_in(ks, 0xFB)`` (healthy and
    degenerate)."""
    jax, jnp = ref.jax, ref.jnp
    n, k = 300, 5
    w = np.random.default_rng(4).exponential(size=n).astype(np.float32)
    parts = sampling.tile_partials(torch.from_numpy(w), 64)
    draws = draws_for(9, n, k, A)
    key, _ = jax.random.split(jax.random.PRNGKey(9))
    for m in range(1, k):
        key, ks = jax.random.split(key)
        for j in range(A):
            kj = ks if j == 0 else jax.random.fold_in(ks, j)
            u = draws.u[m - 1] if j == 0 else draws.propose_u[m - 1, j - 1]
            assert float(u) == float(jax.random.uniform(kj, (), jnp.float32))
            assert float(draws.accept_u[m - 1, j]) == float(
                jax.random.uniform(jax.random.fold_in(kj, 0xACC), (),
                                   jnp.float32))
        kf = jax.random.fold_in(ks, 0xFB)
        for wt in (w, np.zeros(n, np.float32)):
            pt = sampling.tile_partials(torch.from_numpy(wt), 64)
            want = int(ref.sampling.categorical_tiled(
                kf, jnp.asarray(wt), jnp.asarray(pt.numpy()), block_n=64))
            got = int(sampling.categorical_tiled(
                draws.exact_u[m - 1], draws.exact_fallback[m - 1:m],
                torch.from_numpy(wt), pt, block_n=64))
            assert got == want
    assert parts.shape[0] == 5


# ---------------------------------------------------------------------------
# the seeding loop against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bounds_on", [True, False])
@pytest.mark.parametrize("refresh_block", [1, 2, 8])
@pytest.mark.parametrize("proposal", ["hier", "flat"])
def test_rejection_seed_matches_reference(ref, proposal, refresh_block,
                                          bounds_on):
    """Every port backend picks the reference's (interpreted Pallas) seeds
    with its proposals, accepts, tightened tiles, visited supers, skipped
    tiles and pruned rows exactly, and its final D² within the matmul-form
    tolerance."""
    pts = _sorted_blobs()
    want = _ref_seed(ref, pts, 3, bounds_on=bounds_on,
                     refresh_block=refresh_block, proposal=proposal)
    draws = draws_for(3, N, K, A)
    fields = COUNTERS + (("skipped", "pruned") if bounds_on else ())
    for backend in BACKENDS:
        got = _port_seed(pts, draws, backend, bound_gate=bounds_on,
                         refresh_block=refresh_block, proposal=proposal)
        _assert_counters_equal(got, want, fields)
        if not bounds_on:
            assert got.skipped is None and got.pruned is None
        np.testing.assert_allclose(got.min_d2.numpy(),
                                   np.asarray(want.min_d2), rtol=0,
                                   atol=d2_tol(pts, pts))
        assert got.recovered.sum() == 0
    if proposal == "hier" and bounds_on and refresh_block == 8:
        # this input reaches the capped windows and the exact fallback
        assert int(got.tightened.sum()) > 0
        assert int((got.accepts[1:] == 0).sum()) > 0


@pytest.mark.parametrize("proposal", ["hier", "flat"])
def test_rejection_seed_matches_reference_d5(ref, proposal):
    """A second shape (d = 5, unsorted normal data, n not a tile
    multiple): the same exact agreement, gated, refresh_block 8."""
    pts = np.random.default_rng(5).normal(size=(1900, 5)).astype(np.float32)
    want = _ref_seed(ref, pts, 6, bounds_on=True, proposal=proposal)
    draws = draws_for(6, 1900, K, A)
    for backend in BACKENDS:
        got = _port_seed(pts, draws, backend, proposal=proposal)
        _assert_counters_equal(got, want, COUNTERS + ("skipped", "pruned"))
        np.testing.assert_allclose(got.min_d2.numpy(),
                                   np.asarray(want.min_d2), rtol=0,
                                   atol=d2_tol(pts, pts))


@pytest.mark.parametrize("kind", ["neg_envelope", "stale_super"])
@pytest.mark.parametrize("at", [1, 4])
@pytest.mark.parametrize("proposal", ["hier", "flat"])
def test_envelope_fault_heals_like_the_reference(ref, kind, at, proposal):
    """A corrupted stale envelope at round ``at`` is rebuilt before the
    round proposes: the seeds, D² and counters are bitwise the clean run's,
    ``recovered`` flags that round only, and all of it matches the
    reference's run with the same ``FaultSpec``."""
    from repro.testing.faults import FaultSpec
    pts = _sorted_blobs()
    draws = draws_for(3, N, K, A)
    fault = SimpleNamespace(kind=kind, round=at)
    clean = _port_seed(pts, draws, proposal=proposal)
    healed = _port_seed(pts, draws, proposal=proposal, fault=fault)
    for f in ("indices", "min_d2", "proposals", "accepts", "tightened",
              "supers", "skipped", "pruned"):
        assert torch.equal(getattr(healed, f), getattr(clean, f)), f
    expect = np.zeros(K, np.int32)
    expect[at] = 1
    telemetry.check_recovered(healed.recovered, K, expect=expect)
    want = _ref_seed(ref, pts, 3, bounds_on=True, proposal=proposal,
                     fault=FaultSpec(kind, at))
    _assert_counters_equal(healed, want,
                           COUNTERS + ("recovered", "skipped", "pruned"))
    # the envelope check is always on; only the report needs the guard
    quiet = _port_seed(pts, draws, proposal=proposal, fault=fault,
                       guard=False)
    assert torch.equal(quiet.indices, clean.indices)
    assert quiet.recovered is None


def test_reference_backends_pick_the_pallas_hier_seeds(ref):
    """The reference's own reference/fused backends pick its interpreted
    Pallas backend's hier seeds on this input (K12's oracle is the matmul
    form, the kernel the diff-square form; here no cap or accept sits at a
    tie)."""
    pts = _sorted_blobs()
    want = _ref_seed(ref, pts, 3, bounds_on=True, proposal="hier")
    for backend in ("reference", "fused"):
        got = _ref_seed(ref, pts, 3, bounds_on=True, proposal="hier",
                        backend=backend)
        for f in COUNTERS:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)))


# ---------------------------------------------------------------------------
# pins inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bounds_on", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_block_1_is_bitwise_tiled(backend, bounds_on):
    """With refresh_block=1 every envelope is fresh, p == q and the first
    proposal accepts with the round's own uniform: hier and flat pick the
    tiled sampler's seeds bitwise, one proposal and one accept a round."""
    pts = _sorted_blobs()
    draws = draws_for(3, N, K, A)
    be = _port_be(backend)
    x = torch.from_numpy(pts)
    tiled = engine.seed_points(draws, x, K, be, "tiled",
                               bound_gate=bounds_on)
    for proposal in ("hier", "flat"):
        got = engine.seed_points(draws, x, K, be, "rejection",
                                 bound_gate=bounds_on, refresh_block=1,
                                 proposal=proposal)
        assert torch.equal(got.indices, tiled.indices)
        assert torch.equal(got.centroids, tiled.centroids)
        assert (got.proposals[1:] == 1).all() and (got.accepts[1:] == 1).all()
        assert not got.tightened.any()


@pytest.mark.parametrize("refresh_block", [2, 8])
@pytest.mark.parametrize("backend", BACKENDS)
def test_flat_gated_is_bitwise_ungated(backend, refresh_block):
    """Under ``proposal='flat'`` gating only saves work: seeds, D² and the
    counters both report are bitwise those of ``bounds=False``."""
    pts = _sorted_blobs()
    draws = draws_for(3, N, K, A)
    on = _port_seed(pts, draws, backend, refresh_block=refresh_block,
                    proposal="flat")
    off = _port_seed(pts, draws, backend, bound_gate=False,
                     refresh_block=refresh_block, proposal="flat")
    for f in ("indices", "min_d2", "proposals", "accepts", "supers"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert int(on.skipped.sum()) > 0


@pytest.mark.parametrize("refresh_block", [2, 8])
@pytest.mark.parametrize("proposal", ["hier", "flat"])
def test_returned_min_d2_is_exact_over_all_seeds(proposal, refresh_block):
    """Rounds skip the refresh, but the loop settles its debt: the
    returned D² is one fold of all k seeds from +inf (within the
    matmul-form tolerance of the plain round, whose matmul may block
    differently for another centroid count) and within the D² tolerance of
    the float64 distances; the seeds are distinct."""
    pts = _sorted_blobs()
    res = _port_seed(pts, draws_for(7, N, K, A), refresh_block=refresh_block,
                     proposal=proposal)
    x = torch.from_numpy(pts)
    fold, _ = kd.distance_min_update(x, bounds.point_norms(x),
                                     res.centroids, torch.full((N,),
                                                               torch.inf),
                                     block_n=BN)
    tol = d2_tol(pts, pts)
    np.testing.assert_allclose(res.min_d2.numpy(), fold.numpy(), rtol=0,
                               atol=tol)
    want = exact_d2(pts, res.centroids.numpy()).min(1)
    np.testing.assert_allclose(res.min_d2.numpy(), want, rtol=0, atol=tol)
    assert len(set(res.indices.tolist())) == K
    telemetry.check_rejection_counters(res.proposals, res.accepts, K, A,
                                       res.recovered)
    telemetry.check_hier_counters(res.tightened, res.supers, res.proposals,
                                  K, n_tiles=-(-N // BN),
                                  hier=proposal == "hier")


def test_rejection_refreshes_fewer_times_than_rounds():
    """With refresh_block=8 only the refreshes, the exact fallbacks and
    the settle touch the dataset: round calls are far fewer than k, and
    every untouched round reports all tiles skipped."""

    @dataclasses.dataclass(frozen=True)
    class Counting(FusedBackend):
        calls: list = dataclasses.field(default_factory=list)

        def seed_round(self, points, c_new, min_d2, *, cache, state=None,
                       consume=False):
            self.calls.append(c_new.shape[0])
            return super().seed_round(points, c_new, min_d2, cache=cache,
                                      state=state, consume=consume)

    k = 24
    pts = _sorted_blobs(4096, 2, 8, seed=2)
    be = Counting(block_n=BN, tps=TPS)
    res = engine.seed_points(draws_for(8, 4096, k, A), torch.from_numpy(pts),
                             k, be, "rejection", refresh_block=8)
    falls = int((res.accepts[1:] == 0).sum())
    assert len(be.calls) <= k // 8 + 2 + falls < k
    assert set(be.calls) == {8}
    # a round that refreshed (once or twice) reports the round kernel's
    # skips, at most n_tiles - 1 (one tile is always computed)
    n_tiles = -(-4096 // BN)
    untouched = int((res.skipped == n_tiles).sum())
    assert k - len(be.calls) <= untouched < k
    assert int(res.accepts.sum()) == k - 1 - falls


@pytest.mark.parametrize("max_attempts", [3, 8])
@pytest.mark.parametrize("proposal", ["hier", "flat"])
def test_duplicate_points_exhaust_attempts_and_terminate(proposal,
                                                         max_attempts):
    """All-identical points: after the first seed every D² is 0, p = q = 0
    fails the strict test, every round reports exactly ``max_attempts``
    proposals and no accept, and the exact fallback's uniform guard still
    picks valid indices."""
    pts = np.full((300, 3), 2.5, np.float32)
    k = 5
    res = engine.seed_points(draws_for(10, 300, k, 8), torch.from_numpy(pts),
                             k, _port_be("cuda"), "rejection",
                             refresh_block=4, proposal=proposal,
                             max_attempts=max_attempts)
    idx = res.indices.numpy()
    assert ((0 <= idx) & (idx < 300)).all()
    assert float(res.min_d2.max()) < 1e-6
    assert (res.proposals[1:] == max_attempts).all()
    assert not res.accepts.any()
    telemetry.check_rejection_counters(res.proposals, res.accepts, k,
                                       max_attempts)
    telemetry.check_hier_counters(res.tightened, res.supers, res.proposals,
                                  k, hier=proposal == "hier")


def _chi_square(a, b, n, bins):
    c_a = np.bincount(a // (n // bins), minlength=bins).astype(float)
    c_b = np.bincount(b // (n // bins), minlength=bins).astype(float)
    tot = c_a + c_b
    return float(np.sum(np.where(tot > 0, (c_a - c_b) ** 2
                                 / np.maximum(tot, 1.0), 0.0)))


@pytest.mark.parametrize("proposal,refresh_block,slot", [
    ("flat", 4, 1), ("hier", 8, 2)])
def test_rejection_matches_tiled_distribution(proposal, refresh_block, slot):
    """Beyond the shared-uniform pin: over B independent generators, the
    marginal of seed ``slot`` (stale envelopes; at slot 2 two centroids are
    pending, so hier caps are live) matches the tiled sampler's. Both are
    exact, so the two-sample statistic is chi-square with 15 degrees of
    freedom; P(> 60) is about 2e-7."""
    n, d, k, B, bins = 64, 2, 4, 400, 16
    pts = torch.from_numpy(np.random.default_rng(11).normal(
        size=(n, d)).astype(np.float32))
    be = convert.with_geometry(make_backend("fused"), 16, 2)
    t, r = [], []
    for b in range(B):
        draws = Draws.sample(n, k, generator=torch.Generator().manual_seed(b),
                             max_attempts=A)
        t.append(int(engine.seed_points(draws, pts, k, be,
                                        "tiled").indices[slot]))
        r.append(int(engine.seed_points(
            draws, pts, k, be, "rejection", refresh_block=refresh_block,
            proposal=proposal).indices[slot]))
    stat = _chi_square(np.asarray(t), np.asarray(r), n, bins)
    assert stat < 60.0, stat


def test_engine_runs_rejection_end_to_end():
    """``ClusterEngine.seed``/``kmeans`` take ``sampler='rejection'`` with
    the reference's defaults, draw their own schedule from the generator
    (reproducibly), and report the counters under the contract."""
    pts, _ = blobs(3000, 2, 8, seed=4)
    eng = ClusterEngine(device="cpu")
    a = eng.seed(pts, 9, generator=torch.Generator().manual_seed(1),
                 sampler="rejection")
    b = eng.seed(pts, 9, generator=torch.Generator().manual_seed(1),
                 sampler="rejection")
    assert torch.equal(a.indices, b.indices)
    assert torch.equal(a.min_d2, b.min_d2)
    telemetry.check_rejection_counters(a.proposals, a.accepts, 9, A,
                                       a.recovered)
    telemetry.check_hier_counters(a.tightened, a.supers, a.proposals, 9)
    telemetry.check_counter(a.skipped, 9, "skipped")
    fit = eng.kmeans(pts, 9, generator=torch.Generator().manual_seed(1),
                     sampler="rejection", proposal="flat", max_iters=5)
    off = ClusterEngine(device="cpu", bounds=False).kmeans(
        pts, 9, generator=torch.Generator().manual_seed(1),
        sampler="rejection", proposal="flat", max_iters=5)
    assert torch.equal(fit.centroids, off.centroids)
    assert torch.equal(fit.assignment, off.assignment)
    tiled = eng.seed(pts, 9, generator=torch.Generator().manual_seed(1),
                     sampler="tiled")
    assert tiled.proposals is None and tiled.tightened is None


def test_draws_sample_adds_the_rejection_schedule():
    """``max_attempts`` adds the schedule's shapes without changing the
    first three draws, so cdf/tiled runs from one generator are the same
    with or without it."""
    plain = Draws.sample(100, 6, generator=torch.Generator().manual_seed(2))
    rej = Draws.sample(100, 6, generator=torch.Generator().manual_seed(2),
                       max_attempts=5)
    assert plain.max_attempts == 0 and rej.max_attempts == 5
    for f in ("first", "u", "fallback"):
        assert torch.equal(getattr(plain, f), getattr(rej, f))
    assert tuple(rej.propose_u.shape) == (5, 4)
    assert tuple(rej.accept_u.shape) == (5, 5)
    assert tuple(rej.exact_u.shape) == (5,)
    assert ((rej.exact_fallback >= 0) & (rej.exact_fallback < 100)).all()
    assert ((rej.accept_u >= 0) & (rej.accept_u < 1)).all()


def test_bad_rejection_options_raise():
    pts, _ = blobs(200, 2, 3, seed=0)
    eng = ClusterEngine(device="cpu")
    with pytest.raises(ValueError, match="proposal"):
        eng.seed(pts, 3, sampler="rejection", proposal="tree")
    with pytest.raises(ValueError, match="proposal"):
        eng.kmeans(pts, 3, proposal="tree")
    # the gumbel sampler is ported: draws without its noise raise
    with pytest.raises(ValueError, match="Gumbel"):
        eng.seed(pts, 3, sampler="gumbel", draws=Draws.sample(200, 3))
    with pytest.raises(ValueError, match="sampler"):
        eng.seed(pts, 3, sampler="rejected")
    short = Draws.sample(200, 3, max_attempts=2)
    with pytest.raises(ValueError, match="attempts"):
        eng.seed(pts, 3, draws=short, sampler="rejection")
    with pytest.raises(ValueError, match="attempts"):
        eng.seed(pts, 3, draws=Draws.sample(200, 3), sampler="rejection")
    res = eng.seed(pts, 3, draws=short, sampler="rejection", max_attempts=2)
    telemetry.check_rejection_counters(res.proposals, res.accepts, 3, 2)


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("proposal", ["hier", "flat"])
def test_rejection_on_the_card_goes_through_k11_and_k12(card, proposal):
    """``ClusterEngine(device='cuda')`` rejection seeding launches K11 once
    per round that proposes (every attempt of the round priced in that
    launch) and K12 (the tile envelope) once per round with a live pending
    centroid under 'hier' (never under 'flat');
    refresh_block=1 is bitwise the tiled seeds, two runs are bitwise equal,
    and flat gated is bitwise ungated."""
    from repro_torch.kernels import ops
    k = 16
    pts = torch.from_numpy(_sorted_blobs(20_000, 2, 8)).to(card)
    draws = Draws.sample(20_000, k, generator=torch.Generator().manual_seed(0),
                         device=card, max_attempts=A)
    eng = ClusterEngine(device="cuda")
    ops.reset_launches()
    res = eng.seed(pts, k, draws=draws, sampler="rejection",
                   proposal=proposal)
    got = dict(ops.LAUNCHES)
    assert got["row_min_d2"] == int((res.proposals > 0).sum()) == k - 1
    # one tile envelope (counted as K12) a hier round with a live pending
    # centroid
    assert got["tile_cap"] == (_live_rounds(res.accepts.tolist(), k, 8)
                               if proposal == "hier" else 0)
    assert got["distance_min_update_gated"] >= 2
    telemetry.check_rejection_counters(res.proposals, res.accepts, k, A,
                                       res.recovered)
    again = eng.seed(pts, k, draws=draws, sampler="rejection",
                     proposal=proposal)
    assert torch.equal(res.indices, again.indices)
    assert torch.equal(res.min_d2, again.min_d2)
    tiled = eng.seed(pts, k, draws=draws, sampler="tiled")
    one = eng.seed(pts, k, draws=draws, sampler="rejection", refresh_block=1,
                   proposal=proposal)
    assert torch.equal(one.indices, tiled.indices)
    if proposal == "flat":
        off = ClusterEngine(device="cuda", bounds=False).seed(
            pts, k, draws=draws, sampler="rejection", proposal="flat")
        assert torch.equal(res.indices, off.indices)
        assert torch.equal(res.min_d2, off.min_d2)
