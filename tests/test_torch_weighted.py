"""Weighted and mini-batch Lloyd in the port against ``repro.core.engine``.

``ClusterEngine.seed/fit/kmeans(weights=)`` weigh every point: seeding
draws ∝ D²·w (the first seed ∝ w), and a weighted fit runs the untiled
assignment round, K4 ``lloyd_assign`` (``repro/kernels/lloyd_assign.py:98``),
whose sums and counts the weights enter. ``fit_minibatch`` streams batches
through the same round. The reference runs on the CPU, its Pallas kernels in
interpret mode, on the reference's draws (``test_torch_jaxref.draws_for``
with ``weighted=True``) and tile geometry (``convert.with_geometry``); the
port's ``cuda`` backend runs the kernels' plain versions, since the tensors
lie on the CPU. Inputs: n = 1500, d = 2 or 5, k = 6, 128-row tiles, weights
integers 1–8, continuous in (0, 1], or with a quarter of them zero.

Held against the reference: the seeds and every per-round counter exactly;
``n_iters`` exactly, labels outside near-ties, centroids and inertia within
the stated tolerances; K4's and K9's (``lloyd_assign.py:184``) plain twins
against the interpreted kernels. Inside the port: weighted gated ==
weighted ``bounds=False`` bitwise, all-ones weights pick the unweighted
seeds, K9's twin row by row K4's, ``segment_update``'s fixed order, the
pipeline's retries and ``PipelineError``, and the weight guard. Tests
marked ``cuda`` hold K4 and K9 to their twins, to K3 and to K4 on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_jaxref import (EPS32, assert_labels_match, d2_tol, draws_for,
                               exact_d2, ref)  # noqa: F401  (ref: fixture)
from repro_torch import convert
from repro_torch.core import (ClusterEngine, Draws, InvalidInputError,
                              PipelineError, bounds, engine, make_backend,
                              sampling)
from repro_torch.core.lloyd import assign, lloyd, update
from repro_torch.data import DataPipeline, blobs
from repro_torch.kernels import lloyd_assign as la
from repro_torch.kernels import ops

N, K, BN, SEED = 1500, 6, 128, 0
PAIRS = [("cuda", "pallas"), ("fused", "fused")]   # (port, reference)
# (d, weight kind) configurations; every kind and both d are covered
CONFIGS = [(2, "int"), (5, "cont"), (2, "zeros")]
SAMPLERS = [("cdf", "hier"), ("tiled", "hier"), ("rejection", "hier"),
            ("rejection", "flat")]


def _weights(kind: str, n: int = N, seed: int = 1) -> np.ndarray:
    """Integer multiplicities 1–8, continuous weights in (0, 1], or
    continuous weights with a quarter of them zero."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(1, 9, n).astype(np.float32)
    w = (1.0 - rng.random(n)).astype(np.float32)
    if kind == "zeros":
        w[rng.random(n) < 0.25] = 0.0
    return w


def _data(d: int, n: int = N, seed: int = 0) -> np.ndarray:
    return blobs(n, d, K, seed=seed)[0]


def _engines(ref, pair):
    """(port engine, reference engine) at the reference's geometry, both
    bound-gated (the default)."""
    port_be, ref_be = pair
    rbe = ref.engine.make_backend(ref_be, block_n=BN)
    tps = rbe.tiles_per_super(-(-N // BN))
    return (ClusterEngine(convert.with_geometry(make_backend(port_be), BN,
                                                tps), device="cpu"),
            ref.engine.ClusterEngine(rbe))


def _assert_weighted_fit(got, want, x, w, prev):
    """``n_iters`` equal; labels equal outside near-ties against ``prev``,
    the centroids the last assignment saw; the counters None; centroids
    within n·eps of the largest coordinate (a weighted mean of n rows,
    summed in two orders, is off by at most n roundings of its largest
    term); inertia within Σw D² errors plus n·eps of itself."""
    n = x.shape[0]
    assert got.n_iters == int(want.n_iters)
    assert got.skipped is None and got.pruned is None
    assert got.recovered is None
    tol = d2_tol(x, prev)
    assert_labels_match(got.assignment.numpy(), np.asarray(want.assignment),
                        exact_d2(x, prev), tol)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=0,
                               atol=n * EPS32 * float(np.abs(x).max()))
    inertia_tol = (float(w.sum()) * tol
                   + n * EPS32 * float(want.inertia))
    assert abs(float(got.inertia) - float(want.inertia)) <= inertia_tol


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,kind", CONFIGS)
@pytest.mark.parametrize("sampler,proposal", SAMPLERS)
@pytest.mark.parametrize("pair", PAIRS)
def test_weighted_seed_matches_reference(ref, pair, sampler, proposal, d,
                                         kind):
    """Weighted seeding, bound-gated: every seed (the first, drawn ∝ w,
    included) and every per-round counter equal the reference's; the
    final D² within the D² tolerance."""
    jax, jnp = ref.jax, ref.jnp
    x, w = _data(d), _weights(kind)
    eng, reng = _engines(ref, pair)
    want = reng.seed(jax.random.PRNGKey(SEED), jnp.asarray(x), K,
                     weights=jnp.asarray(w), sampler=sampler,
                     proposal=proposal)
    got = eng.seed(x, K, weights=w, sampler=sampler, proposal=proposal,
                   draws=draws_for(SEED, N, K, 8, weighted=True))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    fields = ["skipped", "pruned"]
    if sampler == "rejection":
        fields += ["proposals", "accepts", "tightened", "supers"]
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert w[got.indices.numpy()[0]] > 0
    np.testing.assert_allclose(got.min_d2.numpy(), np.asarray(want.min_d2),
                               rtol=0, atol=d2_tol(x, x))


@pytest.mark.parametrize("d,kind", CONFIGS[:2])
@pytest.mark.parametrize("pair", PAIRS)
def test_weighted_fit_matches_reference(ref, pair, d, kind):
    """A weighted fit from the reference's weighted seeds takes the
    reference's steps."""
    jax, jnp = ref.jax, ref.jnp
    x, w = _data(d, seed=2), _weights(kind, seed=3)
    eng, reng = _engines(ref, pair)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    seeds = reng.seed(jax.random.PRNGKey(1), xj, K, weights=wj)
    want = reng.fit(xj, seeds.centroids, weights=wj, max_iters=25)
    assert int(want.n_iters) >= 2
    prev = np.asarray(reng.fit(xj, seeds.centroids, weights=wj,
                               max_iters=int(want.n_iters) - 1).centroids)
    got = eng.fit(x, np.asarray(seeds.centroids), weights=w, max_iters=25)
    _assert_weighted_fit(got, want, x, w, prev)


@pytest.mark.parametrize("sampler,proposal", SAMPLERS[:3])
@pytest.mark.parametrize("pair", PAIRS)
def test_weighted_kmeans_matches_reference(ref, pair, sampler, proposal):
    """End to end, weights with zeros: seeds equal, the fit as above."""
    jax, jnp = ref.jax, ref.jnp
    d, kind = CONFIGS[2]
    x, w = _data(d, seed=4), _weights(kind, seed=5)
    eng, reng = _engines(ref, pair)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    kw = dict(sampler=sampler, proposal=proposal)
    want_seed = reng.seed(jax.random.PRNGKey(SEED), xj, K, weights=wj, **kw)
    want = reng.kmeans(jax.random.PRNGKey(SEED), xj, K, weights=wj,
                       max_iters=25, **kw)
    got = eng.kmeans(x, K, weights=w, max_iters=25,
                     draws=draws_for(SEED, N, K, 8, weighted=True), **kw)
    assert int(want.n_iters) >= 2
    prev = np.asarray(reng.fit(xj, want_seed.centroids, weights=wj,
                               max_iters=int(want.n_iters) - 1).centroids)
    _assert_weighted_fit(got, want, x, w, prev)


def _batches(n_batches=12, b=256, d=2):
    x = _data(d, n=n_batches * b, seed=6)
    return [x[i * b:(i + 1) * b] for i in range(n_batches)]


@pytest.mark.parametrize("source", ["list", "read_fn"])
@pytest.mark.parametrize("pair", PAIRS)
def test_fit_minibatch_matches_reference(ref, pair, source):
    """Mini-batch Lloyd over a list of batches and over a ``read_fn``
    (prefetched by each side's pipeline), with ``tol`` > 0 so the early
    stop fires before the last batch: ``n_iters`` equal, the last batch's
    labels outside near-ties against the centroids it saw, centroids within
    the rows seen times eps of the largest coordinate (each step moves a
    centroid towards a batch mean summed in two orders), the last batch's
    inertia within its D² errors plus b·eps of itself."""
    jnp = ref.jnp
    batches = _batches()
    init = batches[0][:K] + np.float32(0.05)
    eng, reng = _engines(ref, pair)

    def src(n):
        if source == "list":
            return dict(batches=batches[:n], n_batches=None)
        return dict(batches=lambda s: batches[s % len(batches)],
                    n_batches=n)

    kw = dict(tol=0.1, patience=2)
    want = reng.fit_minibatch(jnp.asarray(init), **src(len(batches)), **kw)
    got = eng.fit_minibatch(init, **src(len(batches)), **kw)
    steps = int(want.n_iters)
    assert 2 <= steps < len(batches)          # the early stop fired
    assert got.n_iters == steps
    prev = np.asarray(reng.fit_minibatch(jnp.asarray(init),
                                         **src(steps - 1)).centroids)
    xb = batches[steps - 1]
    tol = d2_tol(xb, prev)
    assert_labels_match(got.assignment.numpy(), np.asarray(want.assignment),
                        exact_d2(xb, prev), tol)
    big = float(np.abs(np.concatenate(batches)).max())
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=0,
                               atol=steps * len(xb) * EPS32 * big)
    assert abs(float(got.inertia) - float(want.inertia)) <= (
        len(xb) * tol + len(xb) * EPS32 * float(want.inertia))


def _k4_against_reference(ref, d, k, weighted):
    """K4's twin against the interpreted ``lloyd_assign_pallas`` on
    ``_data(d)`` (1000 rows: ragged, several tiles) and its first k rows
    moved by 0.01 as centroids."""
    jnp = ref.jnp
    x = _data(d, n=1000, seed=7)
    c = x[:k] + np.float32(0.01)
    w = _weights("cont", n=1000) if weighted else None
    a, md, sums, counts = ref.ops.lloyd_assign(jnp.asarray(x), jnp.asarray(c),
                                               block_n=BN, interpret=True)
    if weighted:
        sums, counts = ref.engine.segment_update(jnp.asarray(x), a, k,
                                                 jnp.asarray(w))
    xt = torch.from_numpy(x)
    got = la.lloyd_assign(xt, bounds.point_norms(xt), torch.from_numpy(c),
                          None if w is None else torch.from_numpy(w),
                          block_n=BN)
    tol = d2_tol(x, c)
    assert_labels_match(got[0].numpy(), np.asarray(a), exact_d2(x, c), tol)
    # no row of this input lies within tol of a tie: the labels, and with
    # them the rows each cluster's sums add, are the reference's
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(a))
    assert got[0].dtype == torch.int32
    np.testing.assert_allclose(got[1].numpy(), np.asarray(md), rtol=0,
                               atol=tol)
    wa = np.ones(1000, np.float32) if w is None else w
    scale = np.zeros((k, d))
    np.add.at(scale, np.asarray(a), np.abs(x * wa[:, None]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(sums), rtol=0,
                               atol=1000 * EPS32 * scale.max() + 1e-6)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(counts),
                               rtol=1000 * EPS32)


@pytest.mark.parametrize("d", [2, 5, 128])
@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_assign_matches_reference(ref, d, weighted):
    """K4's twin against the interpreted ``lloyd_assign_pallas`` (ragged n,
    several tiles; d = 128 is the screened route's widest): labels outside
    near-ties, D² within ``d2_tol``, counts exact and sums within n·eps of
    the rows' absolute sum; weighted, the sums against the reference's
    ``segment_update`` over its own labels, which is what its backend
    computes after K4."""
    _k4_against_reference(ref, d, K, weighted)


@pytest.mark.parametrize("d", [2, 128])
@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_assign_one_centroid_matches_reference(ref, d, weighted):
    """K4's twin at k = 1 (every row labelled 0, the sums over all rows)
    against the interpreted kernel, held as at k = 6."""
    _k4_against_reference(ref, d, 1, weighted)


def _k9_against_reference(ref, d, k):
    """K9's twin against the interpreted ``lloyd_assign_batched_pallas``
    (B = 3 problems of 700 rows, ragged n), held as K4's."""
    jnp = ref.jnp
    xs = np.stack([_data(d, n=700, seed=s) for s in range(3)])
    cs = xs[:, :k] + np.float32(0.02)
    a, md, sums, counts = ref.ops.lloyd_assign_batched(
        jnp.asarray(xs), jnp.asarray(cs), block_n=BN, interpret=True)
    xt = torch.from_numpy(xs)
    got = ops.lloyd_assign(xt, torch.from_numpy(cs))
    for b in range(3):
        tol = d2_tol(xs[b], cs[b])
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(a[b]))
        np.testing.assert_allclose(got[1][b].numpy(), np.asarray(md[b]),
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(
            got[2][b].numpy(), np.asarray(sums[b]), rtol=0,
            atol=700 * EPS32 * float(np.abs(xs[b]).max()))
        np.testing.assert_array_equal(got[3][b].numpy(),
                                      np.asarray(counts[b]))


def test_lloyd_assign_batched_matches_reference(ref):
    """K9's twin against the interpreted ``lloyd_assign_batched_pallas``
    (B = 3 problems, ragged n), held as K4's."""
    _k9_against_reference(ref, 5, K)


@pytest.mark.parametrize("d,k", [(128, K), (5, 1)])
def test_lloyd_assign_batched_matches_reference_at(ref, d, k):
    """K9's twin against the interpreted kernel at d = 128 (the screened
    route's widest) and at k = 1, held as at d = 5."""
    _k9_against_reference(ref, d, k)


@pytest.mark.parametrize("weighted", [False, True])
def test_template_entries_take_the_twins_on_the_cpu(weighted):
    """``lloyd_assign_template`` and ``lloyd_assign_batched_template`` on
    CPU tensors are the plain twins, bitwise, and count no launch."""
    x = torch.from_numpy(_data(5, n=900, seed=3))
    c = x[:K] + 0.01
    norms = bounds.point_norms(x)
    w = torch.from_numpy(_weights("int", n=900)) if weighted else None
    ops.reset_launches()
    got = la.lloyd_assign_template(x, norms, c, w, block_n=BN)
    want = la.lloyd_assign_torch(x, norms, c, w)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    xs = torch.stack([x, x.flip(0), 2 * x])
    cs = xs[:, :K] + 0.01
    ns = bounds.point_norms(xs)
    got = la.lloyd_assign_batched_template(xs, ns, cs, block_n=BN)
    want = la.lloyd_assign_batched_torch(xs, ns, cs)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert sum(ops.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        la.lloyd_assign_batched_template(xs, ns, cs[0], block_n=BN)


def test_segment_update_and_shims_match_reference(ref):
    """``segment_update`` with weights and the ``update``/``lloyd``/
    ``assign`` shims against the reference's."""
    jnp = ref.jnp
    import sys
    rlloyd = sys.modules["repro.core.lloyd"]   # the package's ``lloyd`` is
    #                                            the function of that name
    x = _data(3, n=900, seed=8)
    w = _weights("int", n=900)
    c = x[:K] + np.float32(0.03)
    a = np.asarray(rlloyd.assign(jnp.asarray(x), jnp.asarray(c))[0])
    got = engine.segment_update(torch.from_numpy(x), torch.from_numpy(a), K,
                                torch.from_numpy(w))
    want = ref.engine.segment_update(jnp.asarray(x), jnp.asarray(a), K,
                                     jnp.asarray(w))
    scale = 900 * EPS32 * 8 * float(np.abs(x).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=scale)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(
        update(torch.from_numpy(x), torch.from_numpy(a), K,
               torch.from_numpy(w)).numpy(),
        np.asarray(rlloyd.update(jnp.asarray(x), jnp.asarray(a), K,
                                 jnp.asarray(w))), rtol=0, atol=scale)
    ga, gmd = assign(x, c, device="cpu")
    ra, rmd = rlloyd.assign(jnp.asarray(x), jnp.asarray(c), use_pallas=True)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ra))
    np.testing.assert_allclose(gmd.numpy(), np.asarray(rmd), rtol=0,
                               atol=d2_tol(x, c))
    want = rlloyd.lloyd(jnp.asarray(x), jnp.asarray(c), weights=jnp.asarray(w),
                        max_iters=20)
    got = lloyd(x, c, weights=w, max_iters=20, device="cpu")
    assert got.n_iters == int(want.n_iters)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=0,
                               atol=900 * EPS32 * float(np.abs(x).max()))


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------


def _draws(n, k, seed=0, attempts=8):
    return Draws.sample(n, k, generator=torch.Generator().manual_seed(seed),
                        max_attempts=attempts, weighted=True)


@pytest.mark.parametrize("sampler,proposal", [SAMPLERS[0], SAMPLERS[1],
                                              SAMPLERS[3]])
@pytest.mark.parametrize("backend", ["reference", "fused", "cuda"])
def test_weighted_gated_is_bitwise_ungated(backend, sampler, proposal):
    """On label-sorted blobs (the gate skips), a weighted gated seeding and
    kmeans are bitwise the ``bounds=False`` runs. (Rejection 'hier' only
    tightens its envelope with the tile balls, which ``bounds=False`` does
    not make, so its draws differ by design.)"""
    pts, lab = blobs(4096, 2, K, seed=9, spread=0.03)
    x = pts[np.argsort(lab, kind="stable")]
    w = _weights("zeros", n=4096, seed=10)
    draws = _draws(4096, K, seed=1)
    kw = dict(weights=w, draws=draws, sampler=sampler, proposal=proposal)
    on = ClusterEngine(backend, device="cpu", block_n=512)
    off = ClusterEngine(backend, device="cpu", block_n=512, bounds=False)
    s_on, s_off = on.seed(x, K, **kw), off.seed(x, K, **kw)
    for f in ("indices", "centroids", "min_d2"):
        assert torch.equal(getattr(s_on, f), getattr(s_off, f)), f
    assert s_off.skipped is None
    if backend == "cuda":   # K2 ungated, as the reference's Pallas backend
        assert int(s_on.pruned.sum()) == 0
        if sampler != "rejection":
            assert int(s_on.skipped.sum()) == 0
    elif sampler != "rejection":   # the plain backends' gate model fires
        assert int(s_on.skipped.sum()) + int(s_on.pruned.sum()) > 0
    k_on, k_off = on.kmeans(x, K, **kw), off.kmeans(x, K, **kw)
    for f in ("centroids", "assignment", "inertia"):
        assert torch.equal(getattr(k_on, f), getattr(k_off, f)), f
    assert k_on.n_iters == k_off.n_iters and k_on.skipped is None


@pytest.mark.parametrize("sampler,proposal", SAMPLERS)
@pytest.mark.parametrize("backend", ["reference", "fused", "cuda"])
def test_all_ones_weights_pick_the_unweighted_seeds(backend, sampler,
                                                    proposal):
    """Weights of one: with a first-seed uniform that lands on the
    unweighted first index, every seed, the final D² and every counter are
    bitwise the unweighted run's."""
    x = _data(3, seed=11)
    draws = _draws(N, K, seed=2)
    first = int(draws.first)
    draws = dataclasses.replace(
        draws, first_u=torch.tensor([(first + 0.5) / N]))
    eng = ClusterEngine(backend, device="cpu", block_n=BN)
    kw = dict(draws=draws, sampler=sampler, proposal=proposal)
    plain = eng.seed(x, K, **kw)
    ones = eng.seed(x, K, weights=np.ones(N, np.float32), **kw)
    for f in plain._fields:
        a, b = getattr(plain, f), getattr(ones, f)
        if backend == "cuda" and f in ("skipped", "pruned"):
            continue           # weighted rounds on the card do not gate
        assert (a is None and b is None) or torch.equal(a, b), f


def test_batched_twin_is_k4_twin_row_by_row():
    xs = torch.from_numpy(np.stack([_data(16, n=600, seed=s)
                                    for s in range(4)]))
    cs = xs[:, :9] + 0.01
    got = la.lloyd_assign_batched_torch(xs, bounds.point_norms(xs), cs)
    for b in range(4):
        one = la.lloyd_assign_torch(xs[b], bounds.point_norms(xs[b]), cs[b])
        assert all(torch.equal(g[b], o) for g, o in zip(got, one))


def test_segment_update_is_fixed_order_fixed_sum_per_cluster():
    """Each cluster's sums are its rows' ``fixed_sum`` in row order, bit
    for bit: segments longer than the 128-row blocks go round twice."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(20_000, 3)).astype(np.float32))
    w = torch.from_numpy(rng.random(20_000).astype(np.float32))
    a = torch.from_numpy(rng.choice(5, 20_000, p=[.6, .2, .1, .1, 0.0]))
    sums, counts = engine.segment_update(x, a, 5, w)
    for c in range(4):
        rows = a == c
        assert torch.equal(sums[c],
                           sampling.fixed_sum((x[rows] * w[rows, None]).T))
        assert torch.equal(counts[c], sampling.fixed_sum(w[rows]))
    assert not sums[4].any() and counts[4] == 0     # an empty cluster


def test_fit_minibatch_pipeline_retries_then_raises_with_the_step():
    """A flaky ``read_fn`` is retried inside the pipeline and the run goes
    on; one that keeps failing surfaces as ``PipelineError`` with its
    step. Batches are guarded, and the engine stops the pipeline."""
    batches = _batches(6)
    init = batches[0][:K]
    calls = {}

    def flaky(step):
        calls[step] = calls.get(step, 0) + 1
        if calls[step] < 2:
            raise OSError("transient")
        return batches[step]

    eng = ClusterEngine("cuda", device="cpu")
    res = eng.fit_minibatch(init, flaky, n_batches=6)
    want = eng.fit_minibatch(init, batches)
    assert torch.equal(res.centroids, want.centroids) and res.n_iters == 6

    def broken(step):
        if step == 3:
            raise OSError("gone")
        return batches[step]

    with pytest.raises(PipelineError) as err:
        eng.fit_minibatch(init, broken, n_batches=6)
    assert err.value.step == 3
    pipe = DataPipeline(broken, retries=2, backoff=0.0)
    assert [next(pipe)[0] for _ in range(3)] == [0, 1, 2]
    with pytest.raises(PipelineError):
        next(pipe)
    pipe.stop()
    bad = [b.copy() for b in batches]
    bad[2][5, 1] = np.nan
    with pytest.raises(InvalidInputError, match="batch 2"):
        eng.fit_minibatch(init, bad)
    with pytest.raises(ValueError, match="n_batches"):
        eng.fit_minibatch(init, flaky)


@pytest.mark.parametrize("call", ["seed", "fit", "kmeans"])
def test_weight_guard_rejects_bad_weights(call):
    """NaN, negative and all-zero weights raise under ``validate='raise'``
    at every weighted entry point; a wrong length raises too."""
    x = _data(2, n=200, seed=13)
    eng = ClusterEngine("cuda", device="cpu")
    run = {"seed": lambda w: eng.seed(x, 3, weights=w),
           "fit": lambda w: eng.fit(x, x[:3], weights=w),
           "kmeans": lambda w: eng.kmeans(x, 3, weights=w)}[call]
    for bad in (np.nan, -1.0):
        w = np.ones(200, np.float32)
        w[7] = bad
        with pytest.raises(InvalidInputError):
            run(w)
    for w in (np.zeros(200, np.float32), np.ones(199, np.float32)):
        with pytest.raises(InvalidInputError):
            run(w)
    assert run(np.ones(200, np.float32)) is not None


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_k4(got, want, x, c, w=None):
    """Labels equal outside near-ties, D² within ``d2_tol``; sums within
    n·eps of the rows' absolute (weighted) sum and counts (weighted)
    exact or within n·eps, against a float64 sum over the KERNEL's labels."""
    xn, cn = x.cpu().numpy(), c.cpu().numpy()
    tol = d2_tol(xn, cn)
    a = got[0].cpu().numpy()
    assert_labels_match(a, want[0].cpu().numpy(), exact_d2(xn, cn), tol)
    assert float((got[1] - want[1]).abs().max()) <= tol
    wn = (np.ones(len(xn)) if w is None
          else w.cpu().numpy().astype(np.float64))
    k = cn.shape[0]
    sums = np.zeros((k, xn.shape[1]))
    scale = np.zeros_like(sums)
    counts = np.zeros(k)
    np.add.at(sums, a, xn * wn[:, None])
    np.add.at(scale, a, np.abs(xn * wn[:, None]))
    np.add.at(counts, a, wn)
    n = len(xn)
    assert (np.abs(got[2].cpu().numpy() - sums)
            <= n * EPS32 * scale + 1e-6).all()
    assert (np.abs(got[3].cpu().numpy() - counts)
            <= n * EPS32 * counts).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(10_007, 2, 50), (5003, 16, 9),
                                   (5003, 33, 4)])
@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_assign_kernel_matches_plain_and_k3(card, n, d, k, weighted):
    """K4 against its twin; two launches the same bits, each counted once,
    and bitwise the template entry; labels and D² bitwise K3's on the same
    points and centroids."""
    x = torch.from_numpy(_data(d, n=n, seed=n)).to(card)
    norms = bounds.point_norms(x)
    c = (x[:k] + 0.01).contiguous()
    w = (torch.from_numpy(_weights("int", n=n)).to(card) if weighted
         else None)
    ops.reset_launches()
    got = la.lloyd_assign(x, norms, c, w, block_n=1024)
    again = la.lloyd_assign(x, norms, c, w, block_n=1024)
    assert ops.LAUNCHES["lloyd_assign"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    _same_bits(got, la.lloyd_assign_template(x, norms, c, w, block_n=1024))
    _assert_k4(got, la.lloyd_assign_torch(x, norms, c, w), x, c, w)
    k3 = la.lloyd_assign_tiled(x, norms, c, block_n=1024, tps=2)
    assert torch.equal(got[0], k3[0]) and torch.equal(got[1], k3[1])


@pytest.mark.cuda
def test_lloyd_assign_batched_kernel_is_k4_row_by_row(card):
    """K9 against its twin, rows 0, 1 and B−1 bitwise K4, two launches the
    same bits and bitwise the template entry."""
    g = torch.Generator(device=card).manual_seed(0)
    xs = torch.randn((7, 4100, 16), generator=g, device=card)
    cs = xs[:, :40].contiguous()
    norms = bounds.point_norms(xs)
    ops.reset_launches()
    got = la.lloyd_assign_batched(xs, norms, cs, block_n=1024)
    again = la.lloyd_assign_batched(xs, norms, cs, block_n=1024)
    assert ops.LAUNCHES["lloyd_assign_batched"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    _same_bits(got, la.lloyd_assign_batched_template(xs, norms, cs,
                                                     block_n=1024))
    want = la.lloyd_assign_batched_torch(xs, norms, cs)
    for b in (0, 1, 6):
        _assert_k4([o[b] for o in got], [o[b] for o in want], xs[b], cs[b])
        one = la.lloyd_assign(xs[b], norms[b], cs[b], block_n=1024)
        assert all(torch.equal(o[b], p) for o, p in zip(got, one))


def _same_bits(got, want):
    """Every output bitwise (fp32 compared as int32 patterns, so that NaN
    sums compare too)."""
    assert len(got) == len(want)
    for u, v in zip(got, want):
        assert u.dtype == v.dtype and u.shape == v.shape
        if u.dtype == torch.float32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 5, 8, 16, 33, 128, 160])
@pytest.mark.parametrize("k", [1, 50, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_assign_routes_are_the_template_bitwise(card, d, k, dtype,
                                                      weighted):
    """K4 on its routes (the screened route at d >= 8 within its widths,
    the row pass at d = 2, the template at d = 5 and at fp32 d = 160)
    against the template entry, all four outputs bitwise (int32 views), on
    adversarial rows (duplicated centroids, rows between two centroids and
    on one, a zero row, a NaN row; 5003 rows: a ragged last tile), weighted
    (multiplicities 1-8) or not, on both streams; two launches the same
    bits, each counted once under the stream's name; labels and D² bitwise
    K3's; on the screen, every row screened."""
    from test_torch_screen import adversarial
    x, c = adversarial(5 * d + k, 5003, d, k, 0.0, True)
    x, c = x.to(card), c.to(card)
    norms = bounds.point_norms(x)
    x, c = x.to(dtype), c.to(dtype)
    w = (torch.from_numpy(_weights("int", n=5003)).to(card) if weighted
         else None)
    bn = ops.choose_block_n(5003, d, k)
    ops.reset_launches()
    got = la.lloyd_assign(x, norms, c, w, block_n=bn)
    again = la.lloyd_assign(x, norms, c, w, block_n=bn)
    name = "lloyd_assign" + ("_bf16" if dtype == torch.bfloat16 else "")
    assert ops.LAUNCHES[name] == 2 and sum(ops.LAUNCHES.values()) == 2
    _same_bits(got, again)
    _same_bits(got, la.lloyd_assign_template(x, norms, c, w, block_n=bn))
    assert sum(ops.LAUNCHES.values()) == 2
    k3 = la.lloyd_assign_tiled(x, norms, c, block_n=bn, tps=1)
    _same_bits(got[:2], k3[:2])
    if la.screened(d, dtype == torch.bfloat16):
        assert la.screen_stats("lloyd_assign")["rows"] == 5003


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 8, 13, 16, 128])
@pytest.mark.parametrize("k", [1, 50, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lloyd_assign_batched_routes_are_the_template_bitwise(card, d, k,
                                                              dtype):
    """K9 (the screened route at d >= 8, the template below) on
    ``test_torch_screen``'s adversarial problems (four of 3000 rows, a NaN
    row in each, two shifted by 1e3): all four outputs bitwise the template
    entry, every problem, and each problem bitwise K4 on its slice; two
    launches the same bits, counted once each."""
    from test_torch_screen import adversarial
    xs, cs = zip(*(adversarial(3 * d + k + b, 3000, d, k, 1e3 * (b % 2),
                               True) for b in range(4)))
    x = torch.stack(xs).to(card)
    c = torch.stack(cs).to(card)
    norms = bounds.point_norms(x)
    x, c = x.to(dtype), c.to(dtype)
    bn = ops.choose_block_n(3000, d, k)
    ops.reset_launches()
    got = la.lloyd_assign_batched(x, norms, c, block_n=bn)
    again = la.lloyd_assign_batched(x, norms, c, block_n=bn)
    name = ("lloyd_assign_batched"
            + ("_bf16" if dtype == torch.bfloat16 else ""))
    assert ops.LAUNCHES[name] == 2 and sum(ops.LAUNCHES.values()) == 2
    _same_bits(got, again)
    _same_bits(got, la.lloyd_assign_batched_template(x, norms, c,
                                                     block_n=bn))
    if la.screened(d, dtype == torch.bfloat16):
        assert la.screen_stats("lloyd_assign_batched")["rows"] == 4 * 3000
    for b in range(4):
        _same_bits([o[b] for o in got],
                   la.lloyd_assign(x[b], norms[b], c[b], block_n=bn))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lloyd_assign_row_pass_clamp_is_the_template_bitwise(card, dtype):
    """K4's row pass at d = 2 (fp32 streams clamp D² at 0 after the fold
    and find a clamped row's label again; bf16 streams clamp each value)
    with the norms lowered by up to 1e-3 of themselves, so that many rows'
    values fall at or below 0 against several centroids: all four outputs
    bitwise the template entry, the clamped rows' D² +0."""
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.rand((100_003, 2), generator=g, device=card)
    c = x[torch.randint(100_003, (64,), generator=g, device=card)]
    c = torch.cat([c, c[:8] + 1e-4]).contiguous()   # near-duplicates
    norms = bounds.point_norms(x) * (
        1 - 1e-3 * torch.rand(100_003, generator=g, device=card))
    x, c = x.to(dtype), c.to(dtype)
    bn = ops.choose_block_n(100_003, 2, c.shape[0])
    got = la.lloyd_assign(x, norms, c, block_n=bn)
    _same_bits(got, la.lloyd_assign_template(x, norms, c, block_n=bn))
    zero = got[1] == 0
    assert int(zero.sum()) > 1000
    assert not bool(torch.signbit(got[1][zero]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20_000, 300_001])
@pytest.mark.parametrize("d", [2, 16])
def test_untiled_sums_are_the_tiles_added_in_order(card, n, d):
    """The all-tile reduce's order, held independently of it: K3 with one
    tile a super gives each tile's cluster sums and counts (0 + the tile's
    own), and adding them in ascending tile order on the card, one
    elementwise fp32 add at a time, is bitwise K4's unweighted sums and
    counts and the template entry's (5 tiles: the short chain; 74 tiles:
    the long chain's staged reduce)."""
    g = torch.Generator(device=card).manual_seed(n + d)
    x = torch.rand((n, d), generator=g, device=card)
    c = x[torch.randint(n, (50,), generator=g, device=card)].contiguous()
    norms = bounds.point_norms(x)
    bn = 4096
    k3 = la.lloyd_assign_tiled(x, norms, c, block_n=bn, tps=1)
    sums = torch.zeros_like(k3[4][0])
    counts = torch.zeros_like(k3[5][0])
    for t in range(k3[4].shape[0]):
        sums = sums + k3[4][t]
        counts = counts + k3[5][t]
    got = la.lloyd_assign(x, norms, c, block_n=bn)
    _same_bits(got[2:], (sums, counts))
    _same_bits(la.lloyd_assign_template(x, norms, c, block_n=bn)[2:],
               (sums, counts))
    _same_bits(got[:2], k3[:2])


@pytest.mark.cuda
def test_segment_update_is_deterministic_on_the_card(card):
    """Five runs give one bit pattern, and each cluster's sums are its
    rows' ``fixed_sum`` on the card, bit for bit. (Not the CPU's bits: a
    CPU ``cumsum`` of fp32 accumulates in double.)"""
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((300_000, 3), generator=g, device=card)
    w = torch.rand(300_000, generator=g, device=card)
    a = torch.randint(7, (300_000,), generator=g, device=card)
    first = engine.segment_update(x, a, 7, w)
    for _ in range(4):
        assert all(torch.equal(p, q) for p, q in zip(
            engine.segment_update(x, a, 7, w), first))
    for c in range(7):
        rows = a == c
        assert torch.equal(first[0][c],
                           sampling.fixed_sum((x[rows] * w[rows, None]).T))
        assert torch.equal(first[1][c], sampling.fixed_sum(w[rows]))


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["cdf", "tiled", "rejection"])
def test_weighted_kmeans_on_the_card(card, sampler):
    """A weighted kmeans on the card: bitwise a second run and the
    ``bounds=False`` run, launches K1 1, K2 per round, K4 per iteration
    and no K3/K5/K6, the fit within 1e-4 of the plain twins' from the same
    seeds."""
    x = torch.from_numpy(_data(2, n=200_000, seed=14)).to(card)
    w = torch.from_numpy(_weights("int", n=200_000)).to(card)
    draws = _draws(200_000, 20, seed=3)
    eng = ClusterEngine(device="cuda")
    kw = dict(weights=w, draws=draws, sampler=sampler, max_iters=10)
    ops.reset_launches()
    res = eng.kmeans(x, 20, **kw)
    got = dict(ops.LAUNCHES)
    assert got["seed_prologue"] == 1 and got["lloyd_assign"] == res.n_iters
    assert got["distance_min_update"] >= 1
    assert got["lloyd_assign_tiled"] == got["lloyd_assign_gated"] == 0
    assert got["distance_min_update_gated"] == 0
    if sampler != "rejection":
        assert got["distance_min_update"] == 20
    again = eng.kmeans(x, 20, **kw)
    off = ClusterEngine(device="cuda", bounds=False).kmeans(x, 20, **kw)
    for other in (again, off):
        for f in ("centroids", "assignment", "inertia"):
            assert torch.equal(getattr(res, f), getattr(other, f)), f
    seeds = eng.seed(x, 20, weights=w, draws=draws, sampler=sampler)
    plain = ClusterEngine("fused", device="cuda").fit(
        x, seeds.centroids, weights=w, max_iters=10)
    fit = eng.fit(x, seeds.centroids, weights=w, max_iters=10)
    assert abs(float(plain.inertia) - float(fit.inertia)) <= \
        1e-4 * float(fit.inertia)
