"""Batched rejection seeding in the port against ``repro.core.engine``.

``ClusterEngine.seed_batched(sampler="rejection")`` and ``kmeans_batched``
seed B independent problems through the rejection loop of one problem
(``engine._seed_rejection_loop``) with a leading problem axis: each problem
keeps its own pending-block count, a round refreshes only the problems whose
block filled or whose attempts all rejected (``Backend.seed_round_listed``:
one K8 or K7 launch over their list on the card, in place), and every
problem's attempts are priced at once (the batched K11) and its tile
envelope built at once (the batched K12).

The reference vmaps its single-problem loop (``src/repro/core/engine.py:
2141-2151``), its Pallas backend sending K11 and K12 to their jnp twins under
``vmap``; it runs here in interpret mode on an explicit tile geometry (4
tiles of 128 rows in 2 super-tiles), and the port gets its draws, the
rejection schedule included (``batched_draws_for(..., max_attempts)``).
Indices and every counter must be the reference's exactly, D² within the
matmul-form tolerance. Inside the port, row b of every output is held
bitwise to the single ``seed_points`` with ``draws[b]``, counters included.

Tests marked ``cuda`` hold the problem-list forms of K7 and K8 and the
batched K11 and K12 to their plain twins and to the full-batch and single
launches on the card, and the card engine's batched rejection seeding to
its single seedings.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_jaxref import (batched_draws_for, d2_tol,
                               ref)  # noqa: F401  (ref is a fixture)
from repro_torch import convert
from repro_torch.core import (ClusterEngine, Draws, bounds, engine,
                              make_backend, sampling, telemetry)
from repro_torch.data import blobs
from repro_torch.kernels import kmeans_distance as kd
from repro_torch.kernels import ops

B, N, K, BN, TPS, SEED = 3, 512, 8, 128, 2, 3  # 4 tiles in 2 supers
A = 8                                          # max_attempts (the default)
COUNTERS = ("indices", "proposals", "accepts", "tightened", "supers")
FIELDS = ("centroids", "indices", "min_d2", "skipped", "pruned",
          "proposals", "accepts", "recovered", "tightened", "supers")


def _problems(d=2, n=N, seed=0):
    """B blob problems, rows sorted by blob but for problem 1: the sorted
    ones' tiles are coherent, so caps tighten and stale envelopes reject."""
    out = []
    for b in range(B):
        x, lab = blobs(n, d, 4, seed=seed + 7 * b)
        out.append(x if b == 1 else x[np.argsort(lab, kind="stable")])
    return np.stack(out)


def _port_be(name="cuda"):
    return convert.with_geometry(make_backend(name), BN, TPS)


def _ref_engine(ref, bounds_on):
    rbe = ref.engine.make_backend("pallas", block_n=BN, tps=TPS)
    return ref.engine.ClusterEngine(rbe, bounds=bounds_on), rbe


def _draws(n=N, k=K):
    return batched_draws_for(SEED, B, n, k, A)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_rows_single(got, draws, pts, backend, **kw):
    """Row b of every field bitwise the single ``seed_points`` on problem b
    with ``draws[b]``."""
    x = torch.as_tensor(pts)
    for b in range(x.shape[0]):
        one = engine.seed_points(draws[b], x[b], K, backend, "rejection",
                                 **kw)
        for f in FIELDS:
            g, o = getattr(got, f), getattr(one, f)
            if o is None:
                assert g is None, f
                continue
            assert torch.equal(_bits(g[b]), _bits(o)), (b, f)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refresh_block", [1, 3, 8])
@pytest.mark.parametrize("bounds_on", [True, False])
@pytest.mark.parametrize("proposal", ["hier", "flat"])
def test_batched_rejection_matches_reference(ref, proposal, bounds_on,
                                             refresh_block):
    """Every problem's seeds, proposals, accepts, tightened tiles, visited
    supers and (gated) skipped tiles and pruned rows are the reference's
    ``seed_batched(sampler="rejection")``'s exactly, D² within the
    matmul-form tolerance; and row b is bitwise the port's single seeding
    of problem b."""
    pts = _problems()
    reng, _ = _ref_engine(ref, bounds_on)
    want = reng.seed_batched(ref.jax.random.PRNGKey(SEED),
                             ref.jnp.asarray(pts), K, sampler="rejection",
                             refresh_block=refresh_block, proposal=proposal)
    draws = _draws()
    eng = ClusterEngine(_port_be(), device="cpu", bounds=bounds_on)
    got = eng.seed_batched(pts, K, draws=draws, sampler="rejection",
                           refresh_block=refresh_block, proposal=proposal)
    fields = COUNTERS + (("skipped", "pruned") if bounds_on else ())
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.recovered is None
    if not bounds_on:
        assert got.skipped is None and got.pruned is None
    for b in range(B):
        idx = got.indices[b].numpy()
        np.testing.assert_array_equal(got.centroids[b].numpy(),
                                      pts[b][idx])
        np.testing.assert_allclose(got.min_d2[b].numpy(),
                                   np.asarray(want.min_d2)[b], rtol=0,
                                   atol=d2_tol(pts[b], pts[b][idx]))
    _assert_rows_single(got, draws, pts, _port_be(), bound_gate=bounds_on,
                        refresh_block=refresh_block, proposal=proposal)
    if refresh_block == 8 and proposal == "hier" and bounds_on:
        # this input reaches the capped windows and the exact fallback
        assert int(got.tightened.sum()) > 0
        assert int((got.accepts[:, 1:] == 0).sum()) > 0


@pytest.mark.parametrize("proposal", ["hier", "flat"])
def test_batched_rejection_d5_matches_reference(ref, proposal):
    """A second shape (d = 5, unsorted normal data, n not a tile multiple,
    k = 7): the same exact agreement, gated, refresh_block 8."""
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(B, 500, 5)).astype(np.float32)
    reng, _ = _ref_engine(ref, True)
    want = reng.seed_batched(ref.jax.random.PRNGKey(SEED),
                             ref.jnp.asarray(pts), 7, sampler="rejection",
                             proposal=proposal)
    got = ClusterEngine(_port_be(), device="cpu").seed_batched(
        pts, 7, draws=batched_draws_for(SEED, B, 500, 7, A),
        sampler="rejection", proposal=proposal)
    for f in COUNTERS + ("skipped", "pruned"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.min_d2.numpy(), np.asarray(want.min_d2),
                               rtol=0, atol=d2_tol(pts[0], pts[0]))


@pytest.mark.parametrize("kind", ["neg_envelope", "stale_super"])
@pytest.mark.parametrize("proposal", ["hier", "flat"])
def test_batched_envelope_fault_heals_every_problem(ref, kind, proposal):
    """A corrupted envelope at round 3 in every problem is rebuilt, problem
    by problem, before the round proposes: every row is bitwise its clean
    run, ``recovered`` flags round 3 in every row, and all of it matches
    the reference's ``jax.vmap`` of ``seed_points`` with the same
    ``FaultSpec``."""
    from repro.testing.faults import FaultSpec
    jax = ref.jax
    pts = _problems()
    draws = _draws()
    be = _port_be()
    x = torch.from_numpy(pts)
    kw = dict(refresh_block=8, proposal=proposal, guard=True)
    clean = engine.seed_points(draws, x, K, be, "rejection", **kw)
    healed = engine.seed_points(draws, x, K, be, "rejection",
                                fault=SimpleNamespace(kind=kind, round=3),
                                **kw)
    for f in FIELDS:
        if f != "recovered":
            assert torch.equal(_bits(getattr(healed, f)),
                               _bits(getattr(clean, f))), f
    expect = np.zeros((B, K), np.int32)
    expect[:, 3] = 1
    np.testing.assert_array_equal(healed.recovered.numpy(), expect)
    assert int(clean.recovered.sum()) == 0
    _, rbe = _ref_engine(ref, True)
    keys = jax.random.split(jax.random.PRNGKey(SEED), B)
    want = jax.jit(jax.vmap(lambda kk, pp: ref.engine.seed_points(
        kk, pp, K, None, rbe, "rejection", refresh_block=8,
        proposal=proposal, guard=True, fault=FaultSpec(kind, 3))))(
        keys, ref.jnp.asarray(pts))
    for f in COUNTERS + ("recovered", "skipped", "pruned"):
        np.testing.assert_array_equal(getattr(healed, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for b in range(B):
        one = engine.seed_points(draws[b], x[b], K, be, "rejection",
                                 fault=SimpleNamespace(kind=kind, round=3),
                                 **kw)
        for f in FIELDS:
            assert torch.equal(_bits(getattr(healed, f)[b]),
                               _bits(getattr(one, f))), (b, f)


def test_kmeans_batched_rejection_matches_reference(ref):
    """``kmeans_batched(sampler="rejection")`` seeds with the reference's
    defaults (refresh_block 8, hier, 8 attempts) and fits: labels and
    per-problem n_iters the reference's, centroids and inertia within fp32
    roundings; the port's result is bitwise its own ``seed_batched`` then
    ``fit_batched``."""
    pts = _problems()
    reng, _ = _ref_engine(ref, True)
    want = reng.kmeans_batched(ref.jax.random.PRNGKey(SEED),
                               ref.jnp.asarray(pts), K, sampler="rejection",
                               max_iters=10)
    eng = ClusterEngine(_port_be(), device="cpu")
    draws = _draws()
    got = eng.kmeans_batched(pts, K, draws=draws, sampler="rejection",
                             max_iters=10)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_array_equal(got.n_iters.numpy(),
                                  np.asarray(want.n_iters))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.inertia.numpy(), np.asarray(want.inertia),
                               rtol=1e-5)
    seeds = eng.seed_batched(pts, K, draws=draws, sampler="rejection")
    fit = eng.fit_batched(pts, seeds.centroids, max_iters=10)
    for f in ("centroids", "assignment", "inertia", "n_iters"):
        assert torch.equal(getattr(got, f), getattr(fit, f)), f


# ---------------------------------------------------------------------------
# pins inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bounds_on", [True, False])
@pytest.mark.parametrize("backend", ["cuda", "fused", "reference"])
def test_batched_refresh_block_1_is_bitwise_tiled(backend, bounds_on):
    """With refresh_block=1 every problem's first proposal accepts with its
    round's own uniform: batched hier and flat pick the batched tiled
    sampler's seeds bitwise (``tests/test_rejection_sampler.py:59``'s
    pin)."""
    pts = _problems()
    draws = _draws()
    eng = ClusterEngine(_port_be(backend), device="cpu", bounds=bounds_on)
    tiled = eng.seed_batched(pts, K, draws=draws, sampler="tiled")
    for proposal in ("hier", "flat"):
        one = eng.seed_batched(pts, K, draws=draws, sampler="rejection",
                               refresh_block=1, proposal=proposal)
        assert torch.equal(one.indices, tiled.indices), proposal
        assert torch.equal(one.min_d2, tiled.min_d2), proposal
        assert (one.proposals[:, 1:] == 1).all()
        assert (one.accepts[:, 1:] == 1).all()


@pytest.mark.parametrize("max_attempts", [1, 3, 8])
@pytest.mark.parametrize("backend", ["cuda", "fused", "reference"])
def test_problems_out_of_step_stay_bitwise(backend, max_attempts):
    """Problems fall out of step: in some round one problem takes its exact
    fallback (refreshing early, its count restarting) while another
    accepts. Every row stays bitwise its single seeding, counters
    included, gated and not, and the counters keep the contract."""
    pts = _problems()
    draws = batched_draws_for(SEED, B, N, K, max_attempts)
    be = _port_be(backend)
    x = torch.from_numpy(pts)
    for gate in (True, False):
        got = engine.seed_points(draws, x, K, be, "rejection",
                                 bound_gate=gate, refresh_block=8,
                                 max_attempts=max_attempts)
        acc = got.accepts[:, 1:]
        assert bool(((acc == 0).any(0) & (acc == 1).any(0)).any()), acc
        _assert_rows_single(got, draws, pts, be, bound_gate=gate,
                            refresh_block=8, max_attempts=max_attempts)
        for b in range(B):
            telemetry.check_rejection_counters(
                got.proposals[b], got.accepts[b], K, max_attempts)


def test_batched_refreshes_only_the_problems_due():
    """A counting backend: each listed round covers exactly the problems
    whose pending block filled (at round 1 all of them), whose attempts all
    rejected, or (the settle) all; a problem's listed rounds are the
    refreshes its single seeding counts."""
    pts = _problems()
    draws = _draws()
    lists = []

    class Counting(type(_port_be())):
        def seed_round_listed(self, *args, problems, **kw):
            lists.append(problems.tolist())
            return super().seed_round_listed(*args, problems=problems, **kw)

    be = convert.with_geometry(Counting(), BN, TPS)
    got = engine.seed_points(draws, torch.from_numpy(pts), K, be,
                             "rejection", refresh_block=8)
    assert lists[0] == list(range(B)) and lists[-1] == list(range(B))
    for b in range(B):
        single = _single_refreshes(got.accepts[b].tolist(), K, 8)
        assert sum(b in lst for lst in lists) == single, b


def _single_refreshes(accepts, k, p):
    """Refreshes of one problem's rejection seeding: the schedule's, one
    per exact fallback, and the settle."""
    count, r = p - 1, 0
    for m in range(1, k):
        count += 1
        if count >= p:
            r, count = r + 1, 0
        if not accepts[m]:
            r, count = r + 1, 0
    return r + 1


def test_batched_rejection_needs_rejection_draws():
    pts = _problems()
    eng = ClusterEngine(_port_be(), device="cpu")
    with pytest.raises(ValueError, match="attempts"):
        eng.seed_batched(pts, K, draws=Draws.sample_batched(B, N, K),
                         sampler="rejection")
    with pytest.raises(ValueError, match="weights"):
        engine.seed_points(_draws(), torch.from_numpy(pts), K, _port_be(),
                           "rejection", weights=torch.ones(B, N))
    with pytest.raises(NotImplementedError, match="guard"):
        engine.seed_points(_draws(), torch.from_numpy(pts), K, _port_be(),
                           "tiled", guard=True)
    res = eng.seed_batched(pts, K, generator=torch.Generator().manual_seed(0),
                           sampler="rejection", max_attempts=3)
    assert tuple(res.proposals.shape) == (B, K)
    assert int(res.proposals.max()) <= 3


def test_draws_sample_batched_adds_the_rejection_schedule():
    """Problem b's batched draws are ``Draws.sample(n, k, max_attempts=)``
    taken after b earlier problems'."""
    gen = torch.Generator().manual_seed(4)
    got = Draws.sample_batched(3, 100, 6, generator=gen, max_attempts=5)
    gen = torch.Generator().manual_seed(4)
    for b in range(3):
        one = Draws.sample(100, 6, generator=gen, max_attempts=5)
        for f in ("first", "u", "fallback", "propose_u", "accept_u",
                  "exact_u", "exact_fallback"):
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), f
    assert got.first_u is None and got.max_attempts == 5


# ---------------------------------------------------------------------------
# the batched samplers and the kernels' plain twins, row by row
# ---------------------------------------------------------------------------


def _sampler_inputs(seed=0, n=N, bn=BN, tps=TPS):
    g = torch.Generator().manual_seed(seed)
    w = torch.rand((B, n), generator=g) ** 4
    w[1, : 3 * bn] = 0.0                       # empty tiles in problem 1
    parts = sampling.tile_partials(w, bn)
    tcdf = sampling.prefix_sum(parts)
    cap = torch.rand(parts.shape, generator=g) * 0.02
    tight = torch.rand(parts.shape, generator=g) < 0.5
    ph = torch.where(tight, torch.minimum(parts, cap * bn), parts)
    return w, parts, tcdf, cap, tight, ph


@pytest.mark.parametrize("kind", ["tiled", "hier", "hier tightened"])
def test_many_draws_of_many_problems_are_each_single_draw(kind):
    """(B, A) uniforms against (B, ·) weights: entry (b, a) bitwise the
    single problem's draw with u[b, a]."""
    w, parts, tcdf, cap, tight, ph = _sampler_inputs()
    u = torch.rand((B, A), generator=torch.Generator().manual_seed(1))

    def draw(u_, w_, parts_, cap_, tight_, ph_):
        if kind == "tiled":
            return sampling.tiled_index_from_uniform(u_, w_, parts_,
                                                     block_n=BN)
        tc = sampling.prefix_sum(ph_ if kind == "hier tightened" else parts_)
        extra = (dict(cap=cap_, tight=tight_) if kind == "hier tightened"
                 else {})
        return sampling.hier_index_from_uniform(
            u_, w_, ph_ if extra else parts_, tc, sampling.super_cdf(tc, TPS),
            block_n=BN, tps=TPS, **extra)

    got = draw(u, w, parts, cap, tight, ph)
    assert tuple(got.shape) == (B, A, 1)
    for b in range(B):
        one = draw(u[b], w[b], parts[b], cap[b], tight[b], ph[b])
        assert torch.equal(got[b], one), b


def test_batched_exact_draws_are_each_single_draw():
    """``categorical_hier`` and ``categorical_tiled`` on (B, ·) rows with
    (B,) uniforms: row b bitwise the single draw, the degenerate guard per
    problem."""
    w, parts, *_ = _sampler_inputs()
    w[2] = 0.0
    parts = sampling.tile_partials(w, BN)
    u = torch.rand(B, generator=torch.Generator().manual_seed(2))
    fb = torch.tensor([[5], [6], [7]])
    hier = sampling.categorical_hier(u, fb, w, parts, block_n=BN, tps=TPS)
    tiled = sampling.categorical_tiled(u, fb, w, parts, block_n=BN)
    for b in range(B):
        assert torch.equal(hier[b], sampling.categorical_hier(
            u[b], fb[b], w[b], parts[b], block_n=BN, tps=TPS))
        assert torch.equal(tiled[b], sampling.categorical_tiled(
            u[b], fb[b], w[b], parts[b], block_n=BN))
    assert int(hier[2]) == 7 and int(tiled[2]) == 7


@pytest.mark.parametrize("max_attempts", [1, 4, 8])
def test_batched_rejection_sample_is_each_single_problem(max_attempts):
    """B problems' attempts at once: each problem's index, accept flag and
    attempt count are the single call's."""
    w, parts, *_ = _sampler_inputs()
    g = torch.Generator().manual_seed(3)
    pu = torch.rand((B, max_attempts), generator=g)
    au = torch.rand((B, max_attempts), generator=g)
    shrink = torch.tensor([1.0, 0.2, 1e-6])

    def run(pu_, au_, w_, parts_, s_):
        return sampling.rejection_sample(
            lambda u: sampling.tiled_index_from_uniform(u, w_, parts_,
                                                        block_n=BN),
            lambda i: (sampling.gather(w_, i) * s_, sampling.gather(w_, i)),
            pu_, au_, max_attempts=max_attempts)

    idx, ok, att = run(pu, au, w, parts, shrink[:, None])
    assert tuple(idx.shape) == (B, 1)
    for b in range(B):
        i1, ok1, att1 = run(pu[b], au[b], w[b], parts[b], shrink[b])
        assert torch.equal(idx[b], i1) and ok[b] == ok1 and att[b] == att1


def test_batched_k11_k12_twins_are_each_single_problem():
    """The batched twins of K11 and K12: row b bitwise the single twin on
    problem b, a problem at count 0 priced +inf and given the +inf caps,
    ph = partials and no tight tile (the bits of the shortcut the single
    loop takes there)."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn((B, 300, 3), generator=g)
    idx = torch.randint(-1, 301, (B, A), generator=g)
    pend = torch.randn((B, 8, 3), generator=g)
    cnt = torch.tensor([0, 3, 8], dtype=torch.int32)
    got = kd.row_min_d2(x, idx, pend, cnt)
    for b in range(B):
        assert torch.equal(_bits(got[b]), _bits(kd.row_min_d2(
            x[b], idx[b], pend[b], int(cnt[b]))))
    assert bool(torch.isinf(got[0][(idx[0] >= 0) & (idx[0] < 300)]).all())
    cache = bounds.prologue(x, 64)
    parts = sampling.tile_partials(x.square().sum(-1), 64)
    tile_w = sampling.tile_partials(torch.ones(300), 64)
    env = kd.tile_envelope(cache.centers, cache.radii, pend, cnt, parts,
                           tile_w)
    for b in range(B):
        one = kd.tile_envelope(cache.centers[b], cache.radii[b], pend[b],
                               int(cnt[b]), parts[b], tile_w)
        for u, v in zip(env, one):
            assert torch.equal(u[b], v), b
    assert bool(torch.isinf(env[0][0]).all())
    assert torch.equal(env[1][0], parts[0]) and not bool(env[2][0].any())
    assert int(env[3][0]) == 0


@pytest.mark.parametrize("gated", [True, False])
def test_listed_round_twins_touch_only_the_list(gated):
    """The problem-list forms of K7 and K8 (their CPU twins): the listed
    problems' rows of the carries are the full batched round's, bitwise,
    the others untouched; pruned 0 off the list; an empty list changes
    nothing."""
    g = torch.Generator().manual_seed(7)
    bsz, n, d, bn = 5, 700, 3, 128
    x = torch.randn((bsz, n, d), generator=g)
    cache = bounds.prologue(x, bn)
    cents = x[:, :4].contiguous() + 0.01
    md = kd.distance_min_update_batched_torch(
        x, cache.norms, x[:, 10:12].contiguous(),
        torch.full((bsz, n), torch.inf), block_n=bn)[0]
    parts = sampling.tile_partials(md, bn)
    tmax = bounds.tile_reduce_max(md, bn)
    act, dc, margin = bounds.seed_gate(cents, cache, tmax)
    for lst in ([], [3], [4, 0, 2]):
        problems = torch.tensor(lst, dtype=torch.int32)
        c_md, c_parts, c_tmax = md.clone(), parts.clone(), tmax.clone()
        if gated:
            full = kd.distance_min_update_gated_batched(
                x, cache.norms, cents, md, cache.center_d, dc, margin, parts,
                tmax, act, block_n=bn)
            out = kd.distance_min_update_gated_batched(
                x, cache.norms, cents, c_md, cache.center_d, dc, margin,
                c_parts, c_tmax, act, block_n=bn, problems=problems)
            carries = (c_md, c_parts, c_tmax)
            before = (md, parts, tmax)
            assert not bool(out[3][[b for b in range(bsz)
                                    if b not in lst]].any())
        else:
            full = kd.distance_min_update_batched(x, cache.norms, cents, md,
                                                  block_n=bn)
            out = kd.distance_min_update_batched(
                x, cache.norms, cents, c_md, block_n=bn, problems=problems,
                partials=c_parts)
            carries, before = (c_md, c_parts), (md, parts)
        for got, want, old in zip(carries, full, before):
            for b in range(bsz):
                assert torch.equal(got[b], want[b] if b in lst else old[b])
        assert all(o is c for o, c in zip(out, carries))
        if gated:
            for b in lst:
                assert torch.equal(out[3][b], full[3][b])


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_state(card, bsz, n, d, bn, dtype=torch.float32, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((bsz, n, d), generator=g, device=card)
    cache = bounds.RoundCache(*kd.seed_prologue_batched(x, bn))
    md = kd.distance_min_update_batched(
        x, cache.norms, x[:, 5:7].contiguous(),
        torch.full((bsz, n), torch.inf, device=card), block_n=bn)[0]
    cents = (x[:, 20:28] + 0.01).contiguous()
    return x.to(dtype), cache, md, cents.to(dtype)


LISTS = {"empty": [], "one": [2], "unsorted": [5, 0, 3], "all": None}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2, 5, 16, 40])
@pytest.mark.parametrize("which", list(LISTS))
def test_listed_k7_k8_on_the_card(card, which, d, dtype):
    """K7's and K8's problem-list forms on the card: the listed problems'
    carries bitwise the full-batch launch (and so K2/K5), the others
    untouched, K8's pruned counts 0 off the list; both within tolerance of
    their twins; an empty list launches nothing. d covers the register
    paths (2, 5), the vector rows (16) and the wide path (40); both
    streams."""
    bsz, n, bn = 6, 5000, 1024
    x, cache, md, cents = _card_state(card, bsz, n, d, bn, dtype)
    lst = list(range(bsz)) if LISTS[which] is None else LISTS[which]
    problems = torch.tensor(lst, dtype=torch.int32, device=card)
    parts = sampling.tile_partials(md, bn)
    tmax = bounds.tile_reduce_max(md, bn)
    act, dc, margin = bounds.seed_gate(cents, cache, tmax)
    act[1, 0] = False
    for m in (1, 8):
        c = cents[:, :m].contiguous()
        full7 = kd.distance_min_update_batched(x, cache.norms, c, md,
                                               block_n=bn)
        full8 = kd.distance_min_update_gated_batched(
            x, cache.norms, c, md, cache.center_d, dc, margin, parts, tmax,
            act, block_n=bn)
        ops.reset_launches()
        c7 = (md.clone(), parts.clone())
        kd.distance_min_update_batched(x, cache.norms, c, c7[0], block_n=bn,
                                       problems=problems, partials=c7[1])
        c8 = (md.clone(), parts.clone(), tmax.clone())
        out8 = kd.distance_min_update_gated_batched(
            x, cache.norms, c, c8[0], cache.center_d, dc, margin, c8[1],
            c8[2], act, block_n=bn, problems=problems)
        tag = "_bf16" if dtype == torch.bfloat16 else ""
        want = int(bool(lst))
        assert ops.LAUNCHES[f"distance_min_update_batched{tag}"] == want
        assert ops.LAUNCHES[f"distance_min_update_gated_batched{tag}"] == want
        for got, full, old in ((c7, full7, (md, parts)),
                               (c8, full8, (md, parts, tmax))):
            for g_, f_, o_ in zip(got, full, old):
                for b in range(bsz):
                    assert torch.equal(g_[b], f_[b] if b in lst else o_[b]), \
                        (which, d, m, b)
        for b in range(bsz):
            assert torch.equal(out8[3][b], full8[3][b] if b in lst
                               else torch.zeros_like(out8[3][b]))
        twin = kd.distance_min_update_batched_torch(x, cache.norms, c, md,
                                                    block_n=bn)
        tol = 1e-4 * float(md[torch.isfinite(md)].abs().max() + 1)
        assert float((full7[0] - twin[0]).abs().max()) <= tol


@pytest.mark.cuda
def test_listed_k7_k8_single_problem_batch(card):
    """B = 1: the listed launch over [0] is bitwise K2 / K5."""
    x, cache, md, cents = _card_state(card, 1, 3000, 16, 512)
    parts = sampling.tile_partials(md, 512)
    tmax = bounds.tile_reduce_max(md, 512)
    act, dc, margin = bounds.seed_gate(cents, cache, tmax)
    one = torch.zeros(1, dtype=torch.int32, device=card)
    c7 = (md.clone(), parts.clone())
    kd.distance_min_update_batched(x, cache.norms, cents, c7[0], block_n=512,
                                   problems=one, partials=c7[1])
    k2 = kd.distance_min_update(x[0], cache.norms[0], cents[0], md[0],
                                block_n=512)
    assert torch.equal(c7[0][0], k2[0]) and torch.equal(c7[1][0], k2[1])
    c8 = (md.clone(), parts.clone(), tmax.clone())
    out = kd.distance_min_update_gated_batched(
        x, cache.norms, cents, c8[0], cache.center_d, dc, margin, c8[1],
        c8[2], act, block_n=512, problems=one)
    k5 = kd.distance_min_update_gated(
        x[0], cache.norms[0], cents[0], md[0], cache.center_d[0], dc[0],
        margin[0], parts[0], tmax[0], act[0], block_n=512)
    for g_, w_ in zip((c8[0], c8[1], c8[2], out[3]), k5):
        assert torch.equal(g_[0], w_)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 16, 300])
def test_batched_k11_k12_on_the_card(card, d):
    """The batched K11 and K12: row b bitwise the single launch and the
    twin, counts 0, 3 and P (a problem at count 0: +inf prices, the +inf
    caps, ph = partials, no tight tile); B = 1 bitwise the single launch;
    the arrival counters back at 0."""
    g = torch.Generator(device=card).manual_seed(1)
    bsz, n, bn = 3, 9000, 1024
    x = torch.randn((bsz, n, d), generator=g, device=card)
    idx = torch.randint(-1, n + 1, (bsz, A), generator=g, device=card)
    pend = torch.randn((bsz, 8, d), generator=g, device=card)
    cnt = torch.tensor([0, 3, 8], dtype=torch.int32, device=card)
    got = kd.row_min_d2(x, idx, pend, cnt)
    assert torch.equal(_bits(got), _bits(kd.row_min_d2_torch(x, idx, pend,
                                                             cnt)))
    for b in range(bsz):
        assert torch.equal(_bits(got[b]), _bits(kd.row_min_d2(
            x[b], idx[b], pend[b], int(cnt[b]))))
    _, centers, radii, _ = kd.seed_prologue_batched(x, bn)
    parts = sampling.tile_partials(x.square().sum(-1), bn)
    tile_w = sampling.tile_partials(torch.ones(n, device=card), bn)
    for tw in (tile_w, tile_w.expand(bsz, -1).contiguous()):
        env = kd.tile_envelope(centers, radii, pend, cnt, parts, tw)
        twin = kd.tile_envelope_torch(centers, radii, pend, cnt, parts, tw)
        for u, v in zip(env, twin):
            assert torch.equal(u, v)
        for b in range(bsz):
            one = kd.tile_envelope(centers[b], radii[b], pend[b],
                                   int(cnt[b]), parts[b], tile_w)
            for u, v in zip(env, one):
                assert torch.equal(u[b], v)
    assert torch.equal(env[1][0], parts[0]) and int(env[3][0]) == 0
    one = kd.tile_envelope(centers[1:2], radii[1:2], pend[1:2], cnt[1:2],
                           parts[1:2], tile_w)
    single = kd.tile_envelope(centers[1], radii[1], pend[1], 3, parts[1],
                              tile_w)
    for u, v in zip(one, single):
        assert torch.equal(u[0], v)
    key = ("tile_envelope", torch.cuda.current_device(),
           torch.cuda.current_stream().cuda_stream)
    assert int(ops.arrivals(key, 2 * bsz).abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bounds_on", [True, False])
@pytest.mark.parametrize("proposal", ["hier", "flat"])
def test_batched_rejection_on_the_card(card, proposal, bounds_on):
    """``ClusterEngine(device='cuda').seed_batched(sampler="rejection")``:
    one K11 launch a round, at most one K12 (hier, gated), the refreshes
    through the listed K8 (K7 ungated), nothing else of the rounds; every
    row bitwise the single card seeding with ``draws[b]``; two runs
    bitwise; refresh_block=1 bitwise the batched tiled seeds; gated
    bitwise ungated for flat."""
    bsz, n, k = 5, 20_000, 16
    pts = torch.from_numpy(np.stack([_problems(2, n, seed=s)[0]
                                     for s in range(bsz)])).to(card)
    draws = Draws.sample_batched(bsz, n, k, device=card, max_attempts=A,
                                 generator=torch.Generator().manual_seed(0))
    eng = ClusterEngine(device="cuda", bounds=bounds_on)
    ops.reset_launches()
    res = eng.seed_batched(pts, k, draws=draws, sampler="rejection",
                           proposal=proposal)
    got = dict(ops.LAUNCHES)
    assert got["row_min_d2"] == k - 1
    assert got["tile_cap"] <= (k - 1 if proposal == "hier" and bounds_on
                               else 0)
    listed = ("distance_min_update_gated_batched" if bounds_on
              else "distance_min_update_batched")
    assert 2 <= got[listed] <= 2 * (k - 1) + 1
    for b in range(bsz):
        one = eng.seed(pts[b], k, draws=draws[b], sampler="rejection",
                       proposal=proposal)
        for f in FIELDS:
            if f == "recovered":
                continue
            g_, o_ = getattr(res, f), getattr(one, f)
            assert (g_ is None) == (o_ is None), f
            if o_ is not None:
                assert torch.equal(_bits(g_[b]), _bits(o_)), (b, f)
    again = eng.seed_batched(pts, k, draws=draws, sampler="rejection",
                             proposal=proposal)
    assert torch.equal(res.indices, again.indices)
    assert torch.equal(res.min_d2, again.min_d2)
    tiled = eng.seed_batched(pts, k, draws=draws, sampler="tiled")
    one = eng.seed_batched(pts, k, draws=draws, sampler="rejection",
                           refresh_block=1, proposal=proposal)
    assert torch.equal(one.indices, tiled.indices)
    if proposal == "flat" and bounds_on:
        off = ClusterEngine(device="cuda", bounds=False).seed_batched(
            pts, k, draws=draws, sampler="rejection", proposal="flat")
        assert torch.equal(res.indices, off.indices)
        assert torch.equal(res.min_d2, off.min_d2)
