"""``precision="bf16"`` in the port against ``repro.core.engine``'s.

Under ``ClusterEngine(precision="bf16")`` every seeding and assignment
round streams a bf16 copy of the points, made once per call, and the
round's centroids rounded to bf16; the norms (over the fp32 points), D²,
the bound state, the accumulators and the centroid carry stay fp32, seeds
are taken from the fp32 points and the centroids come back fp32. On the
card the rounds are the bf16 instances of K2/K5/K7/K8 and K3/K4/K6/K9/
K10a/K10b (``csrc/kmeans_distance.cu``, ``csrc/lloyd_assign.cu``); here
the ``cuda`` backend runs their plain twins, since the tensors lie on the
CPU. The reference runs ``ClusterEngine(<pallas>, precision="bf16")`` on
the CPU, its Pallas kernels in interpret mode on the bf16 tiles, with the
reference's draws (``test_torch_jaxref.draws_for`` / ``batched_draws_for``)
and tile geometry (``convert.with_geometry``).

Held against the reference, on label-sorted blobs (so the gates skip):
seeds, ``n_iters``, labels and every skip, prune and rejection counter
exactly; D², centroids and inertia within the stated fp32 tolerances
(both sides do fp32 arithmetic on the same bf16-rounded values, in
different orders: ``d2_tol`` per D², n·eps of the largest coordinate per
centroid). Paths: ``seed`` (cdf, tiled, rejection hier and flat),
``fit`` and ``kmeans`` (gated and ungated), weighted ``kmeans``,
``fit_minibatch``, ``seed_batched``/``kmeans_batched`` (gated and
ungated). Gated is NOT held to ungated under bf16: the reference's gate
suppresses bf16-noise updates its bound proves spurious, so the two may
differ (``docs/engine.md``, "Precision & bounds"); each is held to the
reference's run of the same gating.

Inside the port: every twin on a bf16 stream is bitwise the fp32 twin on
the widened copy (what the card's bf16 instances are held to against the
fp32 instances); the bf16 argmin takes the first of tied centroids; row b
of a bf16 batched run is bitwise the single bf16 run; the engine builds
the stream once per call and the rounds receive it with fp32 norms; an
unknown ``precision`` raises ``ValueError``, and so does a wrapper given
points and centroids of two dtypes. Tests marked ``cuda`` hold each bf16
kernel bitwise to its fp32 instance on the widened copy, and to a second
launch, on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_batched import _row, _same, card  # noqa: F401  (fixture)
from test_torch_jaxref import (EPS32, batched_draws_for, d2_tol, draws_for,
                               ref)  # noqa: F401  (ref: fixture)
from repro_torch import convert
from repro_torch.core import ClusterEngine, Draws, bounds, engine, make_backend
from repro_torch.data import blobs
from repro_torch.kernels import kmeans_distance as kd
from repro_torch.kernels import lloyd_assign as la
from repro_torch.kernels import ops

N, D, K, BN, SEED = 1500, 2, 6, 128, 0   # N is no multiple of the tile
B = 3                                     # batched problems
BF = torch.bfloat16
SAMPLERS = [("cdf", "hier"), ("tiled", "hier"), ("rejection", "hier"),
            ("rejection", "flat")]


def _sorted_blobs(n=N, d=D, k=K, seed=0) -> np.ndarray:
    """Blobs with rows sorted by blob: each tile holds few blobs, so the
    seeding and assignment gates have tiles to skip."""
    pts, lab = blobs(n, d, k, seed=seed)
    return pts[np.argsort(lab, kind="stable")]


def _bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16 and widened back: the values both sides'
    rounds see."""
    return torch.from_numpy(x).to(BF).float().numpy()


def _engines(ref, bounds_on=True, n=N, d=D, k=K):
    """(port engine, reference engine), both ``precision='bf16'`` at the
    reference's geometry: tile height ``BN`` for both phases."""
    rbe = ref.engine.make_backend("pallas", block_n=BN)
    assert rbe.seed_tile(n, d, k) == BN
    tps = rbe.tiles_per_super(-(-n // BN))
    be = convert.with_geometry(make_backend("cuda"), BN, tps)
    return (ClusterEngine(be, device="cpu", precision="bf16",
                          bounds=bounds_on),
            ref.engine.ClusterEngine(rbe, precision="bf16",
                                     bounds=bounds_on))


def _assert_counters(got, want, fields=("skipped", "pruned")):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), f)


def _assert_fit(got, want, x, prev):
    """``n_iters`` and labels equal; centroids within n·eps of the largest
    coordinate (means of up to n bf16-rounded rows, summed in two fp32
    orders); inertia within n D² errors (``d2_tol`` on the bf16-rounded
    rows and centroids ``prev`` the last assignment saw) plus n·eps of
    itself."""
    n = x.shape[0]
    assert got.n_iters == int(want.n_iters)
    tol = d2_tol(_bf16(x), _bf16(prev))
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=0,
                               atol=n * EPS32 * float(np.abs(x).max()))
    assert got.centroids.dtype == torch.float32
    w = float(want.inertia)
    assert abs(float(got.inertia) - w) <= n * tol + n * EPS32 * w


def _prev(reng, ref, x, init, n_iters, **kw):
    """The reference's centroids one iteration before its fit stopped: what
    the last assignment saw."""
    return np.asarray(reng.fit(ref.jnp.asarray(x), ref.jnp.asarray(init),
                               max_iters=int(n_iters) - 1, **kw).centroids)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler,proposal", SAMPLERS)
def test_bf16_seed_matches_reference(ref, sampler, proposal):
    """bf16 seeding, bound-gated: every seed and every per-round counter
    equal the reference's; the seeds are the fp32 rows; the final D²
    within ``d2_tol`` of the reference's."""
    x = _sorted_blobs()
    eng, reng = _engines(ref)
    kw = dict(sampler=sampler, proposal=proposal)
    want = reng.seed(ref.jax.random.PRNGKey(SEED), ref.jnp.asarray(x), K,
                     **kw)
    got = eng.seed(x, K, draws=draws_for(SEED, N, K, 8), **kw)
    idx = got.indices.numpy()
    np.testing.assert_array_equal(idx, np.asarray(want.indices))
    np.testing.assert_array_equal(got.centroids.numpy(), x[idx])
    fields = ["skipped", "pruned"]
    if sampler == "rejection":
        fields += ["proposals", "accepts", "tightened", "supers"]
    _assert_counters(got, want, fields)
    assert int(got.skipped.sum()) > 0
    np.testing.assert_allclose(got.min_d2.numpy(), np.asarray(want.min_d2),
                               rtol=0, atol=d2_tol(_bf16(x), _bf16(x)))


@pytest.mark.parametrize("bounds_on", [True, False])
def test_bf16_fit_matches_reference(ref, bounds_on):
    """A bf16 fit from the reference's bf16 seeds takes the reference's
    steps: the fit as ``_assert_fit`` holds it, and (gated) every skip and
    prune counter equal."""
    x = _sorted_blobs(seed=1)
    eng, reng = _engines(ref, bounds_on)
    xj = ref.jnp.asarray(x)
    init = np.asarray(reng.seed(ref.jax.random.PRNGKey(1), xj, K).centroids)
    want = reng.fit(xj, ref.jnp.asarray(init), max_iters=25)
    got = eng.fit(x, init, max_iters=25)
    assert int(want.n_iters) >= 3
    _assert_fit(got, want, x, _prev(reng, ref, x, init, want.n_iters))
    _assert_counters(got, want)
    if bounds_on:
        assert int(got.skipped.sum()) + int(got.pruned.sum()) > 0


@pytest.mark.parametrize("bounds_on", [True, False])
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
def test_bf16_kmeans_matches_reference(ref, sampler, bounds_on):
    """End to end, one shared prologue and one stream: seeds as the
    reference's seeding, the fit and its counters as the reference's."""
    x = _sorted_blobs(seed=2)
    eng, reng = _engines(ref, bounds_on)
    xj = ref.jnp.asarray(x)
    key = ref.jax.random.PRNGKey(SEED)
    want_seed = reng.seed(key, xj, K, sampler=sampler)
    want = reng.kmeans(key, xj, K, sampler=sampler, max_iters=25)
    got = eng.kmeans(x, K, sampler=sampler, max_iters=25,
                     draws=draws_for(SEED, N, K))
    _assert_fit(got, want, x, _prev(reng, ref, x, want_seed.centroids,
                                    want.n_iters))
    _assert_counters(got, want)


@pytest.mark.parametrize("sampler,proposal", [SAMPLERS[0], SAMPLERS[2]])
def test_bf16_weighted_kmeans_matches_reference(ref, sampler, proposal):
    """Weighted bf16 kmeans (integer weights): the seeding's seeds and
    counters, then the weighted fit (K4's round on the stream, its sums the
    weighted bf16-rounded rows) as ``_assert_fit`` holds it, with the
    inertia's D² errors weighted."""
    x = _sorted_blobs(seed=3)
    w = np.random.default_rng(1).integers(1, 9, N).astype(np.float32)
    eng, reng = _engines(ref)
    xj, wj = ref.jnp.asarray(x), ref.jnp.asarray(w)
    key = ref.jax.random.PRNGKey(SEED)
    kw = dict(sampler=sampler, proposal=proposal)
    draws = draws_for(SEED, N, K, 8, weighted=True)
    want_seed = reng.seed(key, xj, K, weights=wj, **kw)
    seeds = eng.seed(x, K, weights=w, draws=draws, **kw)
    np.testing.assert_array_equal(seeds.indices.numpy(),
                                  np.asarray(want_seed.indices))
    _assert_counters(seeds, want_seed)
    want = reng.kmeans(key, xj, K, weights=wj, max_iters=25, **kw)
    got = eng.kmeans(x, K, weights=w, max_iters=25, draws=draws, **kw)
    assert got.skipped is None and got.pruned is None
    prev = _prev(reng, ref, x, want_seed.centroids, want.n_iters,
                 weights=wj)
    _assert_fit(got._replace(inertia=got.inertia / float(w.max())),
                want._replace(inertia=want.inertia / float(w.max())),
                x, prev)


def test_bf16_fit_minibatch_matches_reference(ref):
    """Mini-batch Lloyd, each batch's bf16 copy through the untiled round
    (K4's twin here): ``n_iters``, the last batch's labels, the centroids
    within the rows seen times eps of the largest coordinate."""
    x = blobs(12 * 256, D, K, seed=4)[0]
    batches = [x[i * 256:(i + 1) * 256] for i in range(12)]
    init = batches[0][:K] + np.float32(0.05)
    eng, reng = _engines(ref)
    want = reng.fit_minibatch(ref.jnp.asarray(init), batches, tol=0.1,
                              patience=2)
    got = eng.fit_minibatch(init, batches, tol=0.1, patience=2)
    steps = int(want.n_iters)
    assert 2 <= steps < len(batches) and got.n_iters == steps
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    big = float(np.abs(x).max())
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=0,
                               atol=steps * 256 * EPS32 * big)


@pytest.mark.parametrize("bounds_on", [True, False])
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
def test_bf16_batched_matches_reference(ref, sampler, bounds_on):
    """``seed_batched`` then ``kmeans_batched`` over B label-sorted problems:
    every problem's seeds, ``n_iters``, labels and (B, k) / (B, max_iters)
    counters the reference's, its centroids within tolerance."""
    xs = np.stack([_sorted_blobs(seed=5 + b) for b in range(B)])
    eng, reng = _engines(ref, bounds_on)
    key = ref.jax.random.PRNGKey(SEED)
    draws = batched_draws_for(SEED, B, N, K)
    want_seed = reng.seed_batched(key, ref.jnp.asarray(xs), K,
                                  sampler=sampler)
    seeds = eng.seed_batched(xs, K, draws=draws, sampler=sampler)
    np.testing.assert_array_equal(seeds.indices.numpy(),
                                  np.asarray(want_seed.indices))
    _assert_counters(seeds, want_seed)
    want = reng.kmeans_batched(key, ref.jnp.asarray(xs), K, sampler=sampler,
                               max_iters=25)
    got = eng.kmeans_batched(xs, K, draws=draws, sampler=sampler,
                             max_iters=25)
    _assert_counters(got, want)
    for b in range(B):
        _assert_fit(_row(got, b)._replace(n_iters=int(got.n_iters[b])),
                    convert.lloyd_result(*(np.asarray(f)[b]
                                           for f in want[:4])),
                    xs[b], _prev(reng, ref, xs[b], want_seed.centroids[b],
                                 np.asarray(want.n_iters)[b]))


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------


def _round_inputs(d=5, n=700, k=K, bsz=None, seed=0):
    """Points, their fp32 norms, centroids off the rows, a carried D² and
    a tile height, batched with ``bsz``."""
    g = torch.Generator().manual_seed(seed)
    lead = () if bsz is None else (bsz,)
    x = torch.randn(lead + (n, d), generator=g) * 3.0
    c = x[..., :k, :] + 0.01
    norms = bounds.point_norms(x.to(BF).float())
    md = torch.rand(lead + (n,), generator=g) * 50.0
    return x, norms, c.contiguous(), md, 128


def _twins(bsz=None):
    """(name, twin(points, centroids) -> outputs) of every round twin, on
    one set of carries."""
    x, norms, c, md, bn = _round_inputs(bsz=bsz)
    lead = x.shape[:-2]
    n, d = x.shape[-2:]
    k = c.shape[-2]
    t = -(-n // bn)
    tps = 2
    s = -(-t // tps)
    g = torch.Generator().manual_seed(9)
    act = torch.rand(lead + (t,), generator=g) < 0.7
    cd = torch.rand(lead + (n,), generator=g) * 2.0
    dc = torch.rand(lead + (t,), generator=g) * 4.0
    marg = torch.full(lead + (t,), 1e-3)
    pp = torch.rand(lead + (t,), generator=g)
    ptm = torch.rand(lead + (t,), generator=g) * 60.0
    delta = torch.where(torch.rand(lead + (k,), generator=g) < 0.5, 0.0, 0.1)
    thresh = torch.full(lead + (t,), 0.05)
    absorb = torch.full(lead + (t,), 0.1)
    pa = torch.randint(k, lead + (n,), generator=g, dtype=torch.int32)
    plb = torch.rand(lead + (n,), generator=g) * 20.0
    carries = (torch.rand(lead + (t,), generator=g),
               torch.rand(lead + (t,), generator=g),
               torch.rand(lead + (s, k, d), generator=g),
               torch.rand(lead + (s, k), generator=g))
    if bsz is None:
        return x, c, {
            "K2": lambda p, q: kd.distance_min_update_torch(
                p, norms, q, md, block_n=bn),
            "K5": lambda p, q: kd.distance_min_update_gated_torch(
                p, norms, q, md, cd, dc, marg, pp, ptm, act, block_n=bn),
            "K3": lambda p, q: la.lloyd_assign_tiled_torch(
                p, norms, q, block_n=bn, tps=tps),
            "K6": lambda p, q: la.lloyd_assign_gated_torch(
                p, norms, q, delta, thresh, absorb, pa, md, plb, *carries,
                bounds.align_supers(act, tps), block_n=bn, tps=tps),
            "K4": lambda p, q: la.lloyd_assign_torch(p, norms, q),
            "K4 weighted": lambda p, q: la.lloyd_assign_torch(
                p, norms, q, torch.rand(n, generator=torch.Generator()
                                        .manual_seed(3)))}
    return x, c, {
        "K7": lambda p, q: kd.distance_min_update_batched_torch(
            p, norms, q, md, block_n=bn),
        "K8": lambda p, q: kd.distance_min_update_gated_batched_torch(
            p, norms, q, md, cd, dc, marg, pp, ptm, act, block_n=bn),
        "K10a": lambda p, q: la.lloyd_assign_tiled_batched_torch(
            p, norms, q, block_n=bn, tps=tps),
        "K10b": lambda p, q: la.lloyd_assign_gated_batched_torch(
            p, norms, q, delta, thresh, absorb, pa, md, plb, *carries,
            bounds.align_supers(act, tps), block_n=bn, tps=tps),
        "K9": lambda p, q: la.lloyd_assign_batched_torch(p, norms, q)}


@pytest.mark.parametrize("batched", [False, True])
def test_bf16_twins_are_fp32_twins_on_the_widened_copy(batched):
    """Every round twin on bf16 points and centroids is bitwise the same
    twin on their fp32 widening (a bf16 ``@`` would round the dots, and
    sums over the fp32 points instead of the stream would differ), with
    fp32 outputs; the wrappers on CPU tensors are the twins."""
    x, c, twins = _twins(B if batched else None)
    xb, cb = x.to(BF), c.to(BF)
    for name, twin in twins.items():
        got = twin(xb, cb)
        want = twin(xb.float(), cb.float())
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and a.dtype != BF, (name, i)
            assert torch.equal(a, b), (name, i)
        # and not the fp32 points: the rounding shows
        full = twin(x, c)
        assert not all(torch.equal(a, b) for a, b in zip(got, full)), name


def test_bf16_wrappers_are_the_twins_on_the_cpu():
    """``distance_min_update`` and ``lloyd_assign_tiled`` (and the untiled
    entry ``ops.lloyd_assign``, K4 and K9) take bf16 CPU tensors to the
    twins, bitwise."""
    x, norms, c, md, bn = _round_inputs()
    xb, cb = x.to(BF), c.to(BF)
    for got, want in (
            (kd.distance_min_update(xb, norms, cb, md, block_n=bn),
             kd.distance_min_update_torch(xb, norms, cb, md, block_n=bn)),
            (la.lloyd_assign_tiled(xb, norms, cb, block_n=bn, tps=2),
             la.lloyd_assign_tiled_torch(xb, norms, cb, block_n=bn, tps=2)),
            (ops.lloyd_assign(xb, cb, norms=norms),
             la.lloyd_assign_torch(xb, norms, cb)),
            (ops.lloyd_assign(xb[None].expand(2, -1, -1), cb[None]
                              .expand(2, -1, -1).contiguous(),
                              norms=norms[None].expand(2, -1)),
             la.lloyd_assign_batched_torch(
                 xb[None].expand(2, -1, -1), norms[None].expand(2, -1),
                 cb[None].expand(2, -1, -1)))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bf16_argmin_ties_take_the_first_centroid():
    """Two fp32 centroids that round to one bf16 value tie exactly in every
    row's D²: the label is the lower index (``torch.argmin``'s and the
    kernels' strict <), in K3's and K4's twins."""
    x, norms, c, _, bn = _round_inputs(k=4)
    c = c.clone()
    c[2] = c[1]
    c[2, 0] = torch.nextafter(c[1, 0], torch.tensor(torch.inf))
    cb = c.to(BF)
    assert not torch.equal(c[1], c[2]) and torch.equal(cb[1], cb[2])
    lab = la.lloyd_assign_tiled_torch(x.to(BF), norms, cb, block_n=bn,
                                      tps=2)[0]
    assert bool((lab == 1).any()) and not bool((lab == 2).any())
    assert torch.equal(la.lloyd_assign_torch(x.to(BF), norms, cb)[0], lab)


@pytest.mark.parametrize("bounds_on", [True, False])
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
def test_bf16_batched_rows_are_the_single_runs(sampler, bounds_on):
    """Row b of a bf16 ``seed_batched`` / ``kmeans_batched`` is bitwise the
    single bf16 ``seed`` then ``fit`` of problem b with ``draws[b]``:
    seeds, D², centroids, assignment, inertia, n_iters and counters."""
    xs = np.stack([_sorted_blobs(seed=20 + b) for b in range(B)])
    eng = ClusterEngine("cuda", device="cpu", precision="bf16",
                        bounds=bounds_on, block_n=BN)
    draws = Draws.sample_batched(B, N, K,
                                 generator=torch.Generator().manual_seed(3))
    seeds = eng.seed_batched(xs, K, draws=draws, sampler=sampler)
    got = eng.kmeans_batched(xs, K, draws=draws, sampler=sampler,
                             max_iters=25, tol=1e-4)
    counters = ["skipped", "pruned"] if bounds_on else []
    for b in range(B):
        one = eng.seed(xs[b], K, draws=draws[b], sampler=sampler)
        _same(_row(seeds, b), one, ["indices", "centroids", "min_d2"]
              + counters)
        fit = eng.fit(xs[b], one.centroids, max_iters=25, tol=1e-4)
        _same(_row(got, b), fit, ["centroids", "assignment", "inertia",
                                  "n_iters"] + counters)


def test_bf16_engine_streams_once_with_fp32_norms(monkeypatch):
    """One ``kmeans`` call builds the bf16 stream once (seeding and Lloyd
    share it) and ``fit_minibatch`` once per batch; every round receives
    the bf16 points and bf16 centroids with the norms of the fp32 points;
    the prologue reads the fp32 points; the result is fp32."""
    x = _sorted_blobs(n=900)
    made = []
    real = engine._stream_of

    def counting(pts, precision):
        made.append(precision)
        return real(pts, precision)

    monkeypatch.setattr(engine, "_stream_of", counting)
    seen = []

    @dataclasses.dataclass(frozen=True)
    class Recording(engine.CudaBackend):
        def prologue(self, points, m=1, with_bounds=True):
            seen.append(("prologue", points.dtype, None, None))
            return super().prologue(points, m, with_bounds)

        def seed_round(self, points, c_new, min_d2, **kw):
            seen.append(("seed", points.dtype, c_new.dtype,
                         kw["cache"].norms))
            return super().seed_round(points, c_new, min_d2, **kw)

        def assign_update(self, points, centroids, **kw):
            norms = (kw["cache"].norms if kw.get("cache") is not None
                     else kw.get("norms"))
            seen.append(("assign", points.dtype, centroids.dtype, norms))
            return super().assign_update(points, centroids, **kw)

    eng = ClusterEngine(Recording(block_n=BN), device="cpu",
                        precision="bf16")
    res = eng.kmeans(x, K, generator=torch.Generator().manual_seed(0),
                     max_iters=5)
    assert made == ["bf16"]
    assert res.centroids.dtype == torch.float32
    want_norms = bounds.point_norms(torch.from_numpy(x))
    assert seen[0][:2] == ("prologue", torch.float32)
    rounds = seen[1:]
    assert len(rounds) == K + res.n_iters
    for kind, pdt, cdt, norms in rounds:
        assert pdt == cdt == BF, kind
        assert torch.equal(norms, want_norms), kind
    made.clear()
    eng.fit_minibatch(x[:K], [x[:300], x[300:600], x[600:]])
    assert made == ["bf16"] * 3


def test_unknown_precision_and_mixed_dtypes_raise():
    """``ClusterEngine(precision=)`` takes 'fp32' or 'bf16' only, with the
    reference's message; a round wrapper refuses points and centroids of
    two dtypes on any device, and a gate array must stay fp32 on the card
    (checked where the card is: not here)."""
    for bad in ("fp16", "bfloat16", "float32", None):
        with pytest.raises(ValueError, match="unknown precision"):
            ClusterEngine(device="cpu", precision=bad)
    assert ClusterEngine(device="cpu").precision == "fp32"
    x, norms, c, md, bn = _round_inputs()
    with pytest.raises(ValueError, match="share one dtype"):
        kd.distance_min_update(x, norms, c.to(BF), md, block_n=bn)
    with pytest.raises(ValueError, match="share one dtype"):
        kd.distance_min_update_batched(x[None], norms[None],
                                       c.to(BF)[None], md[None], block_n=bn)
    with pytest.raises(ValueError, match="share one dtype"):
        la.lloyd_assign_tiled(x.to(BF), norms, c, block_n=bn, tps=2)
    with pytest.raises(ValueError, match="share one dtype"):
        ops.lloyd_assign(x.to(BF), c, norms=norms)
    with pytest.raises(ValueError, match="unknown precision"):
        engine._stream_of(x, "fp16")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card_calls(x, c, norms, lead):
    """(kernel name, call(points, centroids)) of every round kernel on one
    card problem: the gated ones from an all-active gate with no carried
    bound, on the seeding gate's scalars."""
    n, d = x.shape[-2:]
    bn, tps = 256, 2
    t = -(-n // bn)
    s = -(-t // tps)
    dev = x.device
    md = torch.full(lead + (n,), torch.inf, device=dev)
    on = torch.ones(lead + (t,), dtype=torch.bool, device=dev)
    zt = torch.zeros(lead + (t,), device=dev)
    cd = torch.zeros(lead + (n,), device=dev)
    gate = (cd, zt, zt, zt, torch.full(lead + (t,), torch.inf, device=dev),
            on)
    assign_gate = (torch.zeros(lead + (K,), device=dev), zt, zt,
                   torch.zeros(lead + (n,), dtype=torch.int32, device=dev),
                   torch.zeros(lead + (n,), device=dev),
                   torch.full(lead + (n,), -torch.inf, device=dev), zt, zt,
                   torch.zeros(lead + (s, K, d), device=dev),
                   torch.zeros(lead + (s, K), device=dev), on)
    if lead:
        return {
            "distance_min_update_batched": lambda p, q: (
                kd.distance_min_update_batched(p, norms, q, md, block_n=bn)),
            "distance_min_update_gated_batched": lambda p, q: (
                kd.distance_min_update_gated_batched(p, norms, q, md, *gate,
                                                     block_n=bn)),
            "lloyd_assign_tiled_batched": lambda p, q: (
                la.lloyd_assign_tiled_batched(p, norms, q, block_n=bn,
                                              tps=tps)),
            "lloyd_assign_gated_batched": lambda p, q: (
                la.lloyd_assign_gated_batched(p, norms, q, *assign_gate,
                                              block_n=bn, tps=tps)),
            "lloyd_assign_batched": lambda p, q: la.lloyd_assign_batched(
                p, norms, q, block_n=bn)}
    return {
        "distance_min_update": lambda p, q: kd.distance_min_update(
            p, norms, q, md, block_n=bn),
        "distance_min_update_gated": lambda p, q: (
            kd.distance_min_update_gated(p, norms, q, md, *gate,
                                         block_n=bn)),
        "lloyd_assign_tiled": lambda p, q: la.lloyd_assign_tiled(
            p, norms, q, block_n=bn, tps=tps),
        "lloyd_assign_gated": lambda p, q: la.lloyd_assign_gated(
            p, norms, q, *assign_gate, block_n=bn, tps=tps),
        "lloyd_assign": lambda p, q: la.lloyd_assign(p, norms, q,
                                                     block_n=bn)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 16, 33])
def test_bf16_kernels_are_fp32_kernels_on_the_widened_copy(card, d):
    """Every bf16 round kernel (K2, K5, K3, K6, K4; K7, K8, K10a, K10b, K9)
    on bf16 points and centroids at the d = 2 and d = 16 register paths
    and the runtime-d path: two launches bitwise, bitwise the fp32 instance
    on the widened copy (the conversion is exact and the arithmetic the
    same), counted under its ``_bf16`` name and not under the fp32 one,
    its D² fp32, finite and non-negative. (``chip_smoke.py`` holds them
    to their twins at the main path's shapes.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=card).manual_seed(d)
    for lead in ((), (B,)):
        x = torch.randn(lead + (2_003, d), generator=g, device=card) * 3.0
        c = (x[..., :K, :] + 0.01).contiguous()
        xb, cb = x.to(BF), c.to(BF)
        norms = bounds.point_norms(x)
        for name, call in _card_calls(x, c, norms, lead).items():
            ops.reset_launches()
            one, two = call(xb, cb), call(xb, cb)
            assert ops.LAUNCHES[f"{name}_bf16"] == 2, name
            full = call(xb.float(), cb.float())
            assert ops.LAUNCHES[name] == 1, name
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(one, two)), name
            assert all(torch.equal(a, b) for a, b in zip(one, full)), name
            md = one[0] if name.startswith("distance") else one[1]
            assert md.dtype == torch.float32, name
            assert bool((torch.isfinite(md) & (md >= 0)).all()), name
