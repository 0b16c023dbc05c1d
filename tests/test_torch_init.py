"""The other training paths in the port against ``repro``'s: the Gumbel
sampler and 'auto', the reference backend's serial and global modes,
``random_init``, k-means|| (``kmeans_parallel_init``), ``kmeans(init=)``
and the quality metrics.

The reference runs on the CPU on its ``fused`` backend (bitwise its
``pallas`` one on these paths), from ``jax.random.PRNGKey(seed)``; the
port gets the same draws through the harness (``gumbel_draws_for``,
``parallel_draws_for``, ``choice_indices``: each round's
``jax.random.gumbel`` noise, k-means||'s key schedule, the rows of
``jax.random.choice``) and the reference's tile geometry. Its ``cuda``
backend runs the kernels' plain versions, since the tensors lie on the
CPU. n = 1500 blobs in d = 2 (k = 6) or d = 5 (k = 4).

Held against the reference: seed and candidate indices exactly; every
skip and prune counter exactly; labels outside near-ties (``d2_tol``),
so the candidates' weights exactly as the counts of those labels; D²
within ``d2_tol``; ``n_iters`` exactly; the quality metrics to 1e-6
relative. Inside the port: Gumbel gated == ungated and batched row b ==
the single run, bitwise; serial == global bitwise; 'auto' == 'tiled';
a checkpointed Gumbel seeding resumed bitwise. ``cuda``-marked tests hold
the card's runs to the plain twins on the card.
"""
from __future__ import annotations

import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

from test_torch_jaxref import (EPS32, assert_labels_match,
                               batched_draws_for, choice_indices,
                               d2_tol, draws_for, exact_d2, gumbel_draws_for,
                               load_reference, parallel_draws_for,
                               ref,  # noqa: F401  (a fixture)
                               ref_geometry)
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (ClusterEngine, Draws, ParallelDraws,
                              ReferenceBackend, kmeans_parallel,
                              kmeans_parallel_init, make_backend,
                              random_init, sampling)
from repro_torch.core import quality
from repro_torch.core.lloyd import kmeans as lloyd_kmeans
from repro_torch.data import blobs
from repro_torch.kernels import ops

N, SEED = 1500, 3
SHAPES = {2: 6, 5: 4}          # d -> k


def _data(d: int, n: int = N, seed: int = 0) -> np.ndarray:
    return blobs(n, d, SHAPES[d], seed=seed)[0]


def _weights(n: int = N) -> np.ndarray:
    return np.random.default_rng(1).integers(1, 9, n).astype(np.float32)


def _seed_backend(port: str, d: int, n: int = N):
    """The port backend at the reference fused backend's seeding tile."""
    rbe = load_reference().engine.make_backend("fused")
    bn = rbe.seed_tile(n, d)
    return convert.with_geometry(make_backend(port), bn,
                                 rbe.tiles_per_super(-(-n // bn)))


@functools.cache
def _ref_seed(d: int, bounds: bool, weighted: bool, sampler: str,
              backend: str = "fused"):
    r = load_reference()
    x = _data(d)
    w = r.jnp.asarray(_weights()) if weighted else None
    res = r.engine.ClusterEngine(backend, bounds=bounds).seed(
        r.jax.random.PRNGKey(SEED), r.jnp.asarray(x), SHAPES[d],
        weights=w, sampler=sampler)
    return {f: None if getattr(res, f) is None else np.asarray(getattr(res, f))
            for f in ("indices", "min_d2", "skipped", "pruned")}


def _assert_seeds(got, want, x):
    np.testing.assert_array_equal(got.indices.numpy(), want["indices"])
    tol = d2_tol(x, x[want["indices"]])
    assert np.abs(got.min_d2.numpy() - want["min_d2"]).max() <= tol
    for f in ("skipped", "pruned"):
        if want[f] is None:
            assert getattr(got, f) is None
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(), want[f])


# ---------------------------------------------------------------------------
# the Gumbel primitives
# ---------------------------------------------------------------------------

TIE_SCORES = {
    "trap": [1.0, -np.inf, 3.0, -np.inf, 3.0, -np.inf],
    "all -inf": [-np.inf] * 7,
    "ties": [0.5, 2.0, 0.5, 2.0, -np.inf, 2.0, 0.5, 1.0],
}


@pytest.mark.parametrize("case", sorted(TIE_SCORES))
def test_gumbel_topk_orders_ties_as_lax_top_k(ref, case):
    """Descending score, ties by the lower index, -inf ties included: the
    order ``jax.lax.top_k`` gives (plain ``torch.topk`` does not)."""
    s = np.asarray(TIE_SCORES[case], np.float32)
    for k in range(1, len(s) + 1):
        want = np.asarray(ref.jax.lax.top_k(ref.jnp.asarray(s), k)[1])
        got = sampling.gumbel_topk(torch.zeros(len(s)), torch.from_numpy(s),
                                   k)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="k <= n"):
        sampling.gumbel_topk(torch.zeros(len(s)), torch.from_numpy(s),
                             len(s) + 1)


@pytest.mark.parametrize("degenerate", [False, True])
def test_gumbel_draw_matches_reference(ref, degenerate):
    """``safe_log`` bitwise the reference's on zeros, and the guarded
    Gumbel draw from the reference's own noise gives its index: the
    argmax for healthy weights, the ``_guarded`` fallback for all-zero
    weights."""
    jax, jnp = ref.jax, ref.jnp
    n = 300
    rng = np.random.default_rng(2)
    w = (np.zeros(n, np.float32) if degenerate
         else rng.exponential(size=n).astype(np.float32))
    w[::7] = 0.0
    lw = sampling.safe_log(torch.from_numpy(w))
    assert torch.equal(torch.isinf(lw), torch.from_numpy(w == 0))
    np.testing.assert_allclose(lw.numpy(),
                               np.asarray(ref.sampling.safe_log(
                                   jnp.asarray(w))), rtol=1e-6)
    key = jax.random.PRNGKey(5)
    for _ in range(10):
        key, ks = jax.random.split(key)
        want = int(ref.sampling.categorical(ks, jnp.asarray(w),
                                            method="gumbel"))
        noise = torch.from_numpy(np.asarray(
            jax.random.gumbel(ks, (n,), jnp.float32)))
        fb = torch.tensor([int(jax.random.randint(
            jax.random.fold_in(ks, 0x0DD), (), 0, n, dtype=jnp.int32))])
        got = sampling.gumbel_categorical(noise, fb, torch.from_numpy(w))
        assert int(got) == want


def test_gumbel_draws_are_sampled_on_the_host():
    """``Draws.sample(gumbel=True)`` adds one host seed a round after every
    other draw; the noise a seed makes is the same bits each time, and
    standard Gumbel (its mean within 4 standard errors of Euler's
    constant)."""
    gen = lambda: torch.Generator().manual_seed(8)  # noqa: E731
    plain = Draws.sample(400, 6, generator=gen(), weighted=True)
    gum = Draws.sample(400, 6, generator=gen(), weighted=True, gumbel=True)
    for f in ("first", "u", "fallback", "first_u", "first_fallback"):
        assert torch.equal(getattr(plain, f), getattr(gum, f))
    assert tuple(gum.gumbel_seed.shape) == (5,)
    assert gum.to("cpu").gumbel_seed.device.type == "cpu"
    a, b = gum.gumbel_round(2, 400, "cpu"), gum.gumbel_round(2, 400, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, gum.gumbel_round(3, 400,
                                                                    "cpu"))
    big = sampling.gumbel_noise(torch.tensor(11), 200_000, "cpu").double()
    assert abs(float(big.mean()) - 0.5772156649) < 4 * 1.2825 / 200_000 ** .5
    with pytest.raises(ValueError, match="Gumbel"):
        ClusterEngine(device="cpu").seed(_data(2)[:400], 6, draws=plain,
                                         sampler="gumbel")


def test_gumbel_noise_is_one_pass_over_the_rows():
    """``gumbel_noise`` over (B,) seeds is one pass whose row b is seed b's
    own noise, bitwise (also for a (2, 3) block of seeds); two seeds give
    different noise; the uniforms it hashes are uniform on [0, 1) (a
    Kolmogorov-Smirnov statistic below its 0.1% critical value, 1.95/√N)
    and hold no lag-1 correlation beyond 4/√N."""
    seeds = torch.randint(2 ** 62, (6,),
                          generator=torch.Generator().manual_seed(3))
    n = 50_000
    noise = sampling.gumbel_noise(seeds, n, "cpu")
    assert tuple(noise.shape) == (6, n) and noise.dtype == torch.float32
    for b in range(6):
        assert torch.equal(noise[b], sampling.gumbel_noise(seeds[b], n,
                                                           "cpu"))
    assert torch.equal(sampling.gumbel_noise(seeds.reshape(2, 3), n, "cpu"),
                       noise.reshape(2, 3, n))
    assert not torch.equal(noise[0], noise[1])
    u = np.sort(np.exp(-np.exp(-noise.double().numpy().reshape(-1))))
    m = u.shape[0]
    ks = np.max(np.maximum(np.arange(1, m + 1) / m - u,
                           u - np.arange(m) / m))
    assert ks < 1.95 / m ** .5
    row = np.exp(-np.exp(-noise[0].double().numpy()))
    lag = np.corrcoef(row[:-1], row[1:])[0, 1]
    assert abs(lag) < 4 / n ** .5


# ---------------------------------------------------------------------------
# Gumbel seeding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bounds", [True, False])
@pytest.mark.parametrize("port", ["cuda", "fused"])
def test_gumbel_seeds_match_reference(port, bounds, weighted):
    """``seed(sampler="gumbel")`` from the reference's noise: its seeds
    and counters exactly, D² within ``d2_tol`` (weighted: the first seed
    by inverse CDF, every round ∝ D²·w). A weighted gated round on the
    ``cuda`` backend is K2, skipping nothing, as the reference's Pallas
    backend's (``test_torch_weighted.py`` holds its counters to it)."""
    x = _data(2)
    eng = ClusterEngine(_seed_backend(port, 2), device="cpu", bounds=bounds)
    got = eng.seed(x, 6, sampler="gumbel",
                   weights=_weights() if weighted else None,
                   draws=gumbel_draws_for(SEED, N, 6, weighted=weighted))
    want = _ref_seed(2, bounds, weighted, "gumbel")
    if port == "cuda" and weighted and bounds:
        want = dict(want, skipped=np.zeros(6, np.int32),
                    pruned=np.zeros(6, np.int32))
    _assert_seeds(got, want, x)


@pytest.mark.parametrize("port", ["cuda", "fused", "reference"])
def test_gumbel_gated_is_ungated_bitwise(port):
    """Gated Gumbel seeding picks the ungated seeds with the same D² bits,
    at d = 2 and 5, from sampled draws (the noise made from host seeds)."""
    for d, k in SHAPES.items():
        x = _data(d)
        draws = Draws.sample(N, k, gumbel=True,
                             generator=torch.Generator().manual_seed(d))
        on = ClusterEngine(port, device="cpu").seed(x, k, draws=draws,
                                                    sampler="gumbel")
        off = ClusterEngine(port, device="cpu", bounds=False).seed(
            x, k, draws=draws, sampler="gumbel")
        assert torch.equal(on.indices, off.indices)
        assert torch.equal(on.min_d2, off.min_d2)
        assert int(on.skipped.sum()) >= 0 and off.skipped is None


@pytest.mark.parametrize("bounds", [True, False])
def test_batched_gumbel_matches_reference_and_single(ref, bounds):
    """``seed_batched(sampler="gumbel")``: the reference's batched seeds
    (its ``vmap`` over ``split(PRNGKey(seed), B)``) and counters exactly,
    and row b bitwise the port's single seeding with ``draws[b]``."""
    bsz, n, d, k = 3, 600, 2, 6
    x = np.stack([_data(d, n=n, seed=s) for s in range(bsz)])
    rbe = ref.engine.make_backend("fused")
    want = ref.engine.ClusterEngine(rbe, bounds=bounds).seed_batched(
        ref.jax.random.PRNGKey(SEED), ref.jnp.asarray(x), k,
        sampler="gumbel")
    eng = ClusterEngine(_seed_backend("cuda", d, n=n), device="cpu",
                        bounds=bounds)
    draws = batched_draws_for(SEED, bsz, n, k, gumbel=True)
    got = eng.seed_batched(x, k, draws=draws, sampler="gumbel")
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    if bounds:
        np.testing.assert_array_equal(got.skipped.numpy(),
                                      np.asarray(want.skipped))
        np.testing.assert_array_equal(got.pruned.numpy(),
                                      np.asarray(want.pruned))
    for b in range(bsz):
        one = eng.seed(x[b], k, draws=draws[b], sampler="gumbel")
        for f in ("indices", "min_d2", "skipped", "pruned"):
            g, o = getattr(got, f), getattr(one, f)
            assert (g is None and o is None) or torch.equal(g[b], o)


@pytest.mark.parametrize("entry", ["seed", "kmeans", "seed_batched",
                                   "checkpointed seed"])
def test_auto_is_tiled(tmp_path, entry):
    """``sampler="auto"`` is the tiled sampler (the reference's pick with
    no tune record), on every entry point, checkpointed too."""
    x = _data(2)
    eng = ClusterEngine("fused", device="cpu")
    draws = Draws.sample(N, 6, generator=torch.Generator().manual_seed(2))
    if entry == "seed_batched":
        bx = np.stack([x[:500], x[500:1000]])
        bd = Draws.sample_batched(2, 500, 6,
                                  generator=torch.Generator().manual_seed(2))
        a = eng.seed_batched(bx, 6, draws=bd, sampler="auto")
        t = eng.seed_batched(bx, 6, draws=bd, sampler="tiled")
    elif entry == "kmeans":
        a = eng.kmeans(x, 6, draws=draws, sampler="auto")
        t = eng.kmeans(x, 6, draws=draws, sampler="tiled")
        assert torch.equal(a.assignment, t.assignment)
        a, t = a.centroids, t.centroids
    elif entry == "seed":
        a = eng.seed(x, 6, draws=draws, sampler="auto")
        t = eng.seed(x, 6, draws=draws, sampler="tiled")
    else:
        a = eng.seed(x, 6, draws=draws, sampler="auto",
                     checkpoint_dir=tmp_path, checkpoint_every=2)
        t = eng.seed(x, 6, draws=draws, sampler="tiled")
        meta = CheckpointManager(tmp_path).read_manifest()["meta"]
        assert meta["sampler"] == "tiled"
    for p, q in zip(*((a, t) if isinstance(a, tuple) else ((a,), (t,)))):
        assert (p is None and q is None) or torch.equal(p, q)
    with pytest.raises(ValueError, match="sampler"):
        eng.seed(x, 6, sampler="gumble")


@pytest.mark.parametrize("injected", [True, False])
def test_checkpointed_gumbel_seed_resumes_bitwise(tmp_path, injected):
    """A Gumbel seeding in chunks of 2 rounds is bitwise the plain one, and
    resumed after the newest two steps are deleted it replays the saved
    noise (injected, or made from the saved host seeds) bitwise."""
    x = _data(2)
    eng = ClusterEngine("fused", device="cpu")
    draws = (gumbel_draws_for(SEED, N, 6) if injected else
             Draws.sample(N, 6, gumbel=True,
                          generator=torch.Generator().manual_seed(6)))
    plain = eng.seed(x, 6, draws=draws, sampler="gumbel")
    ck = eng.seed(x, 6, draws=draws, sampler="gumbel",
                  checkpoint_dir=tmp_path, checkpoint_every=2)
    mgr = CheckpointManager(tmp_path)
    for step in mgr.all_steps()[-2:]:
        shutil.rmtree(tmp_path / f"step_{step:08d}")
    other = (gumbel_draws_for(SEED + 1, N, 6) if injected else
             Draws.sample(N, 6, gumbel=True,
                          generator=torch.Generator().manual_seed(99)))
    resumed = eng.seed(x, 6, draws=other, sampler="gumbel",
                       checkpoint_dir=tmp_path, checkpoint_every=2)
    for f in ("centroids", "indices", "min_d2", "skipped", "pruned",
              "recovered"):
        assert torch.equal(getattr(ck, f), getattr(plain, f)), f
        assert torch.equal(getattr(resumed, f), getattr(plain, f)), f
    if injected:
        _assert_seeds(plain, _ref_seed(2, True, False, "gumbel"), x)


# ---------------------------------------------------------------------------
# the reference backend's modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["cdf", "tiled", "gumbel"])
def test_serial_mode_is_global_and_the_reference_s(sampler):
    """``ClusterEngine("reference", mode="serial")`` picks the reference's
    serial seeds, with its zero counters, and global mode's seeds and D²
    bitwise (every row's D² in the m = 1 diff-square form)."""
    x = _data(5)
    draws = (gumbel_draws_for(SEED, N, 4) if sampler == "gumbel"
             else draws_for(SEED, N, 4))
    be = _seed_backend("reference", 5)
    serial = ClusterEngine(dataclasses.replace(be, mode="serial"),
                           device="cpu").seed(x, 4, draws=draws,
                                              sampler=sampler)
    glob = ClusterEngine(be, device="cpu").seed(x, 4, draws=draws,
                                                sampler=sampler)
    _assert_seeds(serial, _ref_seed(5, True, False, sampler, "serial"), x)
    assert torch.equal(serial.indices, glob.indices)
    assert torch.equal(serial.min_d2, glob.min_d2)


def test_reference_modes_by_name():
    """The registry's 'serial' and 'global' are the reference backend's
    modes, ``ClusterEngine("reference", mode=...)`` takes either, and an
    unknown mode raises. Serial mode folds many centroids at once
    (a refresh) in the diff-square form, within ``d2_tol`` of the matmul
    form's."""
    assert make_backend("serial") == ReferenceBackend(mode="serial")
    assert make_backend("global") == ReferenceBackend()
    eng = ClusterEngine("reference", device="cpu", mode="serial")
    assert eng.backend.mode == "serial"
    with pytest.raises(ValueError, match="mode"):
        ReferenceBackend(mode="parallel")
    x = torch.from_numpy(_data(5))
    c = x[:9] + 0.01
    cache = make_backend("serial").prologue(x)
    md = torch.full((N,), torch.inf)
    s = make_backend("serial").seed_round(x, c, md, cache=cache)
    g = make_backend("global").seed_round(x, c, md, cache=cache)
    assert (s.min_d2 - g.min_d2).abs().max() <= d2_tol(x.numpy(),
                                                       c.numpy())
    want = torch.stack([((x - c[j]) * (x - c[j])).sum(1)
                        for j in range(9)]).amin(0)
    assert torch.equal(s.min_d2, want)
    assert torch.isfinite(s.total) and s.skipped == 0 and s.pruned == 0


# ---------------------------------------------------------------------------
# random init and k-means||
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("port", ["cuda", "fused", "reference"])
def test_random_init_matches_reference(ref, port):
    """``random_init`` on ``jax.random.choice``'s rows: the reference's
    indices, its centroids bitwise, D² within ``d2_tol``."""
    x = _data(5)
    want = ref.kmeanspp.random_init(ref.jax.random.PRNGKey(7),
                                    ref.jnp.asarray(x), 4)
    got = random_init(x, 4, indices=choice_indices(7, N, 4), backend=port,
                      device="cpu")
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.centroids.numpy(),
                                  np.asarray(want.centroids))
    assert (np.abs(got.min_d2.numpy() - np.asarray(want.min_d2)).max()
            <= d2_tol(x, got.centroids.numpy()))
    sampled = random_init(x, 4, generator=torch.Generator().manual_seed(1),
                          device="cpu")
    assert len(set(sampled.indices.tolist())) == 4


def _ref_candidates(ref, seed: int, x: np.ndarray, k: int, rounds: int = 5):
    """The reference's oversampling phase (``kmeans_parallel.py:53-81``)
    step by step on its fused backend: the candidate rows, the argmin
    labels against them and their counts."""
    jax, jnp = ref.jax, ref.jnp
    be = ref.engine.make_backend("fused")
    pts = jnp.asarray(x)
    n, d = x.shape
    l = 2 * k
    cache = be.prologue(pts, m=l)
    tile = be.seed_tile(n, d, l)
    key, k0 = jax.random.split(jax.random.PRNGKey(seed))
    first = jax.random.randint(k0, (), 0, n, dtype=jnp.int32)
    cand = [int(first)]
    min_d2 = ref.engine.point_d2(pts, pts[first])
    state = ref.bounds.BoundState(ref.sampling.tile_partials(min_d2, tile),
                                  ref.bounds.tile_reduce_max(min_d2, tile))
    for _ in range(rounds):
        key, ks = jax.random.split(key)
        idx = ref.sampling.gumbel_topk(ks, ref.sampling.safe_log(min_d2), l)
        rnd = be.seed_round(pts, pts[idx], min_d2, None, cache=cache,
                            state=state)
        state = ref.bounds.BoundState(rnd.partials, rnd.tile_max)
        min_d2 = rnd.min_d2
        cand += np.asarray(idx).tolist()
    labels = jnp.argmin(ref.engine.pairwise_d2(pts, pts[jnp.asarray(cand)]),
                        axis=1)
    return np.asarray(cand), np.asarray(labels)


def _assert_candidates(got, cand, labels, x, port):
    """Candidate rows exactly; the port's labels (its backend's untiled
    round) the reference's outside near-ties, and the weights their
    counts; an exact duplicate of an earlier candidate weighs 0."""
    np.testing.assert_array_equal(got.indices.numpy(), cand)
    cands = x[cand]
    mine = make_backend(port).assign_update(
        torch.from_numpy(x), torch.from_numpy(cands)).assignment.numpy()
    assert_labels_match(mine, labels, exact_d2(x, cands),
                        d2_tol(x, cands))
    np.testing.assert_array_equal(
        got.weights.numpy(), np.bincount(mine, minlength=len(cand)))
    for j in range(1, len(cand)):
        if (cands[:j] == cands[j]).all(1).any():
            assert got.weights[j] == 0


@pytest.mark.parametrize("port", ["cuda", "fused", "reference", "serial"])
def test_kmeans_parallel_matches_reference(ref, port):
    """``kmeans_parallel_init`` (5 rounds of l = 2k) from the reference's
    key schedule: its candidates and their weights (above), its seeds and
    centroids exactly, the final D² within ``d2_tol``; the first
    candidate's D² is the diff-square form."""
    x = _data(2)
    want = ref.kmeans_parallel.kmeans_parallel_init(
        ref.jax.random.PRNGKey(5), ref.jnp.asarray(x), 6, backend="fused")
    draws = parallel_draws_for(5, N, 6)
    got = kmeans_parallel_init(x, 6, backend=port, draws=draws, device="cpu")
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.centroids.numpy(),
                                  np.asarray(want.centroids))
    assert (np.abs(got.min_d2.numpy() - np.asarray(want.min_d2)).max()
            <= d2_tol(x, got.centroids.numpy()))
    cands = kmeans_parallel.oversample_candidates(
        x, 6, backend=port, draws=draws, device="cpu")
    _assert_candidates(cands, *_ref_candidates(ref, 5, x, 6), x, port)


@pytest.mark.parametrize("port", ["cuda", "fused"])
def test_kmeans_parallel_duplicate_heavy(ref, port):
    """Four distinct rows, 75 copies each: after the first rounds fewer
    than l rows have positive D², so -inf scores fill the top-l and their
    ties decide the candidates (lowest index first, as ``lax.top_k``);
    the duplicate candidates weigh 0 and the reference's seeds come
    out."""
    base = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [3.0, 3.0]],
                      np.float32)
    x = base[np.random.default_rng(4).integers(0, 4, 300)]
    want = ref.kmeans_parallel.kmeans_parallel_init(
        ref.jax.random.PRNGKey(9), ref.jnp.asarray(x), 3, backend="fused")
    draws = parallel_draws_for(9, 300, 3)
    got = kmeans_parallel_init(x, 3, backend=port, draws=draws, device="cpu")
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.min_d2.numpy(),
                                  np.asarray(want.min_d2))
    cands = kmeans_parallel.oversample_candidates(
        x, 3, backend=port, draws=draws, device="cpu")
    cand, labels = _ref_candidates(ref, 9, x, 3)
    assert int((cands.min_d2 > 0).sum()) < 6
    _assert_candidates(cands, cand, labels, x, port)
    assert int((cands.weights == 0).sum()) > 0


def test_kmeans_parallel_draws_and_limits(monkeypatch):
    """Sampled draws replay bitwise, and the two phases run apart
    (``oversample_candidates`` then ``reduce_candidates``) are the whole;
    l > n and n past the exact-count limit raise; the reduce's draws cover
    rounds·l + 1 candidates."""
    x = _data(2)[:400]
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    draws = ParallelDraws.sample(400, 6, rounds=3, generator=gen())
    assert tuple(draws.noise.shape) == (3, 400)
    assert tuple(draws.reduce.u.shape) == (5,)
    assert draws.reduce.first_u is not None
    a = kmeans_parallel_init(x, 6, rounds=3, generator=gen(), device="cpu")
    b = kmeans_parallel_init(x, 6, rounds=3, draws=draws, device="cpu")
    c = kmeans_parallel.reduce_candidates(
        x, kmeans_parallel.oversample_candidates(x, 6, rounds=3, draws=draws,
                                                 device="cpu"),
        6, draws=draws, device="cpu")
    for r in (b, c):
        assert torch.equal(a.indices, r.indices)
        assert torch.equal(a.min_d2, r.min_d2)
    with pytest.raises(ValueError, match="k <= n"):
        kmeans_parallel_init(x[:10], 6, device="cpu")
    monkeypatch.setattr(kmeans_parallel, "MAX_ROWS", 399)
    with pytest.raises(ValueError, match="exact"):
        kmeans_parallel_init(x, 6, device="cpu")


# ---------------------------------------------------------------------------
# kmeans(init=) and the quality metrics
# ---------------------------------------------------------------------------


@functools.cache
def _ref_kmeans(init: str):
    r = load_reference()
    res = r.engine.ClusterEngine("fused").kmeans(
        r.jax.random.PRNGKey(SEED), r.jnp.asarray(_data(2)), 6, init=init)
    return tuple(np.asarray(f) for f in res[:4])


def _init_draws(init: str):
    return {"kmeans++": lambda: draws_for(SEED, N, 6),
            "kmeans||": lambda: parallel_draws_for(SEED, N, 6),
            "random": lambda: choice_indices(SEED, N, 6)}[init]()


@pytest.mark.parametrize("init", ["kmeans++", "kmeans||", "random"])
def test_kmeans_inits_match_reference(ref, init):
    """``ClusterEngine.kmeans(init=)`` (and ``core.lloyd.kmeans``) from the
    reference's draws at its fit geometry: ``n_iters`` exactly, labels
    outside near-ties, centroids and inertia within 1e-5 relative."""
    x = _data(2)
    bn, tps = ref_geometry(ref, N, 2, 6, backend="fused")
    be = convert.with_geometry(make_backend("cuda"), bn, tps)
    got = ClusterEngine(be, device="cpu").kmeans(x, 6, init=init,
                                                 draws=_init_draws(init))
    cents, labels, inertia, n_iters = _ref_kmeans(init)
    assert got.n_iters == int(n_iters)
    np.testing.assert_allclose(got.centroids.numpy(), cents, rtol=1e-5,
                               atol=1e-6)
    assert abs(float(got.inertia) - float(inertia)) <= 1e-5 * float(inertia)
    c = got.centroids.numpy()
    assert_labels_match(got.assignment.numpy(), labels, exact_d2(x, c),
                        d2_tol(x, c))
    again = lloyd_kmeans(x, 6, init=init, draws=_init_draws(init),
                              variant=be, device="cpu")
    assert torch.equal(again.assignment, got.assignment)


def test_unknown_init_raises():
    x = _data(2)
    with pytest.raises(ValueError, match="init"):
        ClusterEngine(device="cpu").kmeans(x, 6, init="kmeans+")


def test_kmeans_init_order_and_weights():
    """k-means|| and random seeding with ``order=`` and ``weights=``: the
    seeds come from the reordered rows, unweighted, and the fit is the
    weighted fit from them, its labels back in the caller's order."""
    x = _data(2)
    w = _weights()
    eng = ClusterEngine("fused", device="cpu")
    for init, draws in (("kmeans||", parallel_draws_for(1, N, 6)),
                        ("random", choice_indices(1, N, 6))):
        res = eng.kmeans(x, 6, init=init, draws=draws, weights=w,
                         order="morton")
        perm = res.reorder.long().numpy()
        seeds = (kmeans_parallel_init(x[perm], 6, backend="fused",
                                      draws=draws, device="cpu")
                 if init == "kmeans||" else
                 random_init(x[perm], 6, indices=draws, device="cpu"))
        fit = eng.fit(x[perm], seeds.centroids, weights=w[perm])
        assert torch.equal(res.centroids, fit.centroids)
        assert torch.equal(res.assignment[torch.from_numpy(perm)],
                           fit.assignment)


@pytest.mark.parametrize("d", [2, 5])
def test_quality_metrics_match_reference(ref, d):
    """``quantization_error`` against the reference's within n·eps
    relative (one fp32 sum of n non-negative terms against another), and
    ``balance`` to 1e-6 relative (a ratio of exact counts)."""
    x = _data(d)
    k = SHAPES[d]
    c = x[:k] + 0.05
    a = exact_d2(x, c).argmin(1).astype(np.int32)
    want_q = float(ref.quality.quantization_error(ref.jnp.asarray(x),
                                                  ref.jnp.asarray(c)))
    got_q = float(quality.quantization_error(torch.from_numpy(x),
                                             torch.from_numpy(c)))
    assert abs(got_q - want_q) <= N * EPS32 * want_q
    want_b = float(ref.quality.balance(ref.jnp.asarray(a), k))
    got_b = float(quality.balance(torch.from_numpy(a), k))
    assert abs(got_b - want_b) <= 1e-6 * want_b
    assert float(quality.balance(torch.arange(12) % 4, 4)) == 1.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 5])
def test_gumbel_seeding_on_the_card(card, d):
    """The card's Gumbel seeding: gated bitwise ungated, the fused twin's
    seeds on the card from the same draws (D² within the twin's
    tolerance), batched row b bitwise the single run; K1 once, K5 a round
    (K8 batched)."""
    k = SHAPES[d]
    x = torch.from_numpy(_data(d, n=20_011)).to(card)
    draws = Draws.sample(x.shape[0], k, gumbel=True,
                         generator=torch.Generator().manual_seed(0))
    ops.reset_launches()
    on = ClusterEngine(device=card).seed(x, k, draws=draws, sampler="gumbel")
    assert ops.LAUNCHES["seed_prologue"] == 1
    assert ops.LAUNCHES["distance_min_update_gated"] == k
    off = ClusterEngine(device=card, bounds=False).seed(
        x, k, draws=draws, sampler="gumbel")
    assert torch.equal(on.indices, off.indices)
    assert torch.equal(on.min_d2, off.min_d2)
    twin = ClusterEngine("fused", device=card).seed(x, k, draws=draws,
                                                    sampler="gumbel")
    assert torch.equal(on.indices, twin.indices)
    xs = x.cpu().numpy()
    assert (float((on.min_d2 - twin.min_d2).abs().max())
            <= d2_tol(xs, on.centroids.cpu().numpy()))
    bx = torch.stack([x[:5003], x[5003:10006], x[10006:15009]])
    bd = Draws.sample_batched(3, 5003, k, gumbel=True,
                              generator=torch.Generator().manual_seed(1))
    batched = ClusterEngine(device=card).seed_batched(bx, k, draws=bd,
                                                      sampler="gumbel")
    for b in range(3):
        one = ClusterEngine(device=card).seed(bx[b], k, draws=bd[b],
                                              sampler="gumbel")
        assert torch.equal(batched.indices[b], one.indices)
        assert torch.equal(batched.min_d2[b], one.min_d2)


@pytest.mark.cuda
def test_gumbel_noise_on_the_card(card):
    """The card's noise: the CPU's uniforms (the same hash), so the noise
    within a few ulps of the CPU's (the two logs' roundings), and row b of
    the one-pass (B, n) noise bitwise seed b's own on the card."""
    seeds = torch.randint(2 ** 62, (5,),
                          generator=torch.Generator().manual_seed(4))
    n = 100_003
    on = sampling.gumbel_noise(seeds, n, card)
    off = sampling.gumbel_noise(seeds, n, "cpu")
    assert on.device.type == "cuda"
    torch.testing.assert_close(on.cpu(), off, rtol=8 * EPS32, atol=8 * EPS32)
    for b in range(5):
        assert torch.equal(on[b], sampling.gumbel_noise(seeds[b], n, card))


@pytest.mark.cuda
def test_kmeans_parallel_on_the_card(card):
    """k-means|| on the card against the fused twin on the card, from the
    same draws: the candidates exactly, their weights the counts of labels
    that agree with the twin's outside near-ties; the twin's reduce on the
    card's candidates and weights picks the card's seeds, the final D²
    within the twin's tolerance; K1 on the rows and on the candidates, K5
    once a round at m = l, K4 against the candidates and the seeds, K2 a
    round of the reduce."""
    x = torch.from_numpy(_data(2, n=50_000)).to(card)
    draws = ParallelDraws.sample(x.shape[0], 6,
                                 generator=torch.Generator().manual_seed(0))
    ops.reset_launches()
    got = kmeans_parallel_init(x, 6, draws=draws, device=card)
    assert ops.LAUNCHES["seed_prologue"] == 2
    assert ops.LAUNCHES["distance_min_update_gated"] == 5
    assert ops.LAUNCHES["lloyd_assign"] == 2
    assert ops.LAUNCHES["distance_min_update"] == 6
    mine = kmeans_parallel.oversample_candidates(x, 6, draws=draws,
                                                 device=card)
    twin = kmeans_parallel.reduce_candidates(x, mine, 6, draws=draws,
                                             backend="fused", device=card)
    assert torch.equal(got.indices, twin.indices)
    xs = x.cpu().numpy()
    assert (float((got.min_d2 - twin.min_d2).abs().max())
            <= d2_tol(xs, got.centroids.cpu().numpy()))
    plain = kmeans_parallel.oversample_candidates(
        x, 6, draws=draws, backend="fused", device=card)
    assert torch.equal(mine.indices, plain.indices)
    cands = xs[mine.indices.cpu().numpy()]
    lab = make_backend("cuda").assign_update(
        x, x[mine.indices]).assignment.cpu().numpy()
    lab_twin = make_backend("fused").assign_update(
        x, x[mine.indices]).assignment.cpu().numpy()
    assert_labels_match(lab, lab_twin, exact_d2(xs, cands),
                        d2_tol(xs, cands))
    np.testing.assert_array_equal(mine.weights.cpu().numpy(),
                                  np.bincount(lab, minlength=len(cands)))


@pytest.mark.cuda
def test_random_init_and_serial_mode_on_the_card(card):
    """``random_init`` on the card: D² within the twin's tolerance of the
    CPU's; the reference backend's serial mode bitwise its global mode on
    the card."""
    x = torch.from_numpy(_data(2, n=20_011)).to(card)
    idx = torch.randperm(x.shape[0], generator=torch.Generator()
                         .manual_seed(0))[:6]
    got = random_init(x, 6, indices=idx, device=card)
    cpu = random_init(x.cpu(), 6, indices=idx, device="cpu")
    assert torch.equal(got.indices.cpu(), cpu.indices)
    assert (float((got.min_d2.cpu() - cpu.min_d2).abs().max())
            <= d2_tol(x.cpu().numpy(), cpu.centroids.numpy()))
    draws = Draws.sample(x.shape[0], 6,
                         generator=torch.Generator().manual_seed(1))
    s = ClusterEngine("serial", device=card).seed(x, 6, draws=draws)
    g = ClusterEngine("global", device=card).seed(x, 6, draws=draws)
    assert torch.equal(s.indices, g.indices)
    assert torch.equal(s.min_d2, g.min_d2)
