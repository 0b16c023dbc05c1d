"""Row orderings and ``order=`` in the port against ``repro.data.ordering``
and ``repro.core.engine``.

``data.ordering`` makes the permutations (Morton/Z-order over quantized
coordinates, a stable sort by label with the inverted-list offsets); the
engine's ``order=`` on ``fit``, ``kmeans``, ``fit_batched``,
``kmeans_batched`` and ``fit_minibatch`` applies one on the way in and
inverts it on the way out, recording it in ``LloydResult.reorder``.

Held against the reference: codes, perms, inverses and offsets exactly for
d in {1, 2, 5, 16, 20}; ``kmeans(order="morton")`` on the reference's draws
and tile geometry (its Pallas backend interpreted, and its fused one): the
permutation exactly, the seeds of the reordered rows exactly, ``n_iters``
and the skip counters as the engine tests hold them, the assignment in the
caller's order outside near-ties; the same for ``fit``, ``fit_batched`` and
``kmeans_batched`` (B problems, each its own permutation) and
``fit_minibatch``. Inside the port: 'auto' is the natural order, batched
orderings are the single ones row by row, and a precomputed permutation
is taken as given.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_batched import _assert_rows_fit, _prev_centroids
from test_torch_batched_gated import (_assert_counters, _engines,
                                      _problems)
from test_torch_jaxref import (EPS32, assert_labels_match, batched_draws_for,
                               d2_tol, draws_for, exact_d2,
                               ref)  # noqa: F401  (ref: fixture)
from repro_torch import convert
from repro_torch.core import ClusterEngine, Draws, make_backend
from repro_torch.data import blobs, ordering

N, K, BN, SEED = 1500, 6, 128, 3
PAIRS = [("cuda", "pallas"), ("fused", "fused")]   # (port, reference)
DIMS = [1, 2, 5, 16, 20]


def _points(d, n=N, seed=0):
    """Blobs off the origin at an awkward scale, one column constant when
    d > 3 (its span is the 1e-30 floor)."""
    rng = np.random.default_rng(seed)
    x, _ = blobs(n, d, K, seed=seed)
    x = (x * rng.uniform(0.3, 30.0) + rng.normal(size=d) * 40).astype(
        np.float32)
    if d > 3:
        x[:, 3] = np.float32(7.5)
    return x


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the permutations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", DIMS)
def test_morton_matches_reference(ref, d):
    """Z-order codes, perms and inverses equal the reference's exactly (the
    fp32 quantization in its operation order, the uint32 bit layout in
    int64), at the default bits and at 3 bits."""
    from repro.data import ordering as rord
    x = _points(d, seed=d)
    jx = ref.jnp.asarray(x)
    for bits in (None, 3):
        _eq(ordering.morton_code(torch.from_numpy(x), bits=bits),
            np.asarray(rord.morton_code(jx, bits=bits)).astype(np.int64))
        perm, inv = ordering.morton_order(torch.from_numpy(x), bits=bits)
        wperm, winv = rord.morton_order(jx, bits=bits)
        assert perm.dtype == inv.dtype == torch.int32
        _eq(perm, wperm)
        _eq(inv, winv)


@pytest.mark.parametrize("nlist", [5, 32])
def test_label_sort_order_matches_reference(ref, nlist):
    """Stable label sort: perm, inv, starts and counts exactly, with a label
    value that never occurs (an empty list)."""
    from repro.data import ordering as rord
    lab = np.random.default_rng(nlist).integers(0, nlist - 1, 700).astype(
        np.int32)
    got = ordering.label_sort_order(torch.from_numpy(lab), nlist=nlist,
                                    return_offsets=True)
    want = rord.label_sort_order(ref.jnp.asarray(lab), nlist=nlist,
                                 return_offsets=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)
    assert int(got[3][-1]) == 0
    two = ordering.label_sort_order(torch.from_numpy(lab))
    _eq(two[0], got[0])
    with pytest.raises(ValueError, match="nlist"):
        ordering.label_sort_order(torch.from_numpy(lab), return_offsets=True)


def test_spatial_order_and_batched_rows():
    """'label' needs labels; unknown names raise; a (B, n, d) ordering is
    each problem's own, and inverse_permutation undoes it."""
    x = torch.from_numpy(_points(5))
    lab = torch.from_numpy(np.arange(N, dtype=np.int32) % 7)
    with pytest.raises(ValueError, match="labels"):
        ordering.spatial_order(x, method="label")
    with pytest.raises(ValueError, match="unknown ordering"):
        ordering.spatial_order(x, method="hilbert")
    perm, inv = ordering.spatial_order(x, method="label", labels=lab)
    assert torch.equal(x[perm.long()][inv.long()], x)
    xs = torch.stack([x, x * 2 - 1, x.flip(0)])
    bperm, binv = ordering.spatial_order(xs)
    for b in range(3):
        one = ordering.morton_order(xs[b])
        assert torch.equal(bperm[b], one[0]) and torch.equal(binv[b], one[1])


# ---------------------------------------------------------------------------
# order= on the engine, against the reference
# ---------------------------------------------------------------------------


def _single(ref, pair):
    port_be, ref_be = pair
    rbe = ref.engine.make_backend(ref_be, block_n=BN)
    tps = rbe.tiles_per_super(-(-N // BN))
    return (ClusterEngine(convert.with_geometry(make_backend(port_be), BN,
                                                tps), device="cpu"),
            ref.engine.ClusterEngine(rbe))


def _assert_fit(got, want, x, prev):
    """n_iters equal, the assignment (caller's order) outside near-ties
    against ``prev``, centroids within n·eps of the largest coordinate,
    the skip counters within ±1 tile and the prune counts equal where the
    skips agree."""
    n = x.shape[0]
    assert got.n_iters == int(want.n_iters)
    assert_labels_match(got.assignment.numpy(), np.asarray(want.assignment),
                        exact_d2(x, prev), d2_tol(x, prev))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=0,
                               atol=n * EPS32 * float(np.abs(x).max()))
    gs, ws = got.skipped.numpy(), np.asarray(want.skipped)
    assert (np.abs(gs - ws) <= 1).all(), (gs, ws)
    _eq(got.pruned.numpy()[gs == ws], np.asarray(want.pruned)[gs == ws])


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("pair", PAIRS)
def test_kmeans_morton_matches_reference(ref, pair, sampler):
    """``kmeans(order="morton")``: ``reorder`` the reference's permutation,
    the seeds of the reordered rows the reference's, the fit as
    ``_assert_fit`` holds it; the seeding's tile gate skips on the
    coherent rows."""
    jax, jnp = ref.jax, ref.jnp
    x = _points(2, seed=11)
    eng, reng = _single(ref, pair)
    key = jax.random.PRNGKey(SEED)
    want = reng.kmeans(key, jnp.asarray(x), K, sampler=sampler,
                       max_iters=25, order="morton")
    draws = draws_for(SEED, N, K)
    got = eng.kmeans(x, K, draws=draws, sampler=sampler, max_iters=25,
                     order="morton")
    _eq(got.reorder, want.reorder)
    xs = x[np.asarray(want.reorder)]
    want_seed = reng.seed(key, jnp.asarray(xs), K, sampler=sampler)
    seeds = eng.seed(xs, K, draws=draws, sampler=sampler)
    _eq(seeds.indices, want_seed.indices)
    prev = np.asarray(reng.fit(jnp.asarray(xs), want_seed.centroids,
                               max_iters=int(want.n_iters) - 1).centroids)
    _assert_fit(got, want, x, prev)
    assert int(seeds.skipped.sum()) > 0


@pytest.mark.parametrize("pair", PAIRS)
def test_fit_with_order_matches_reference(ref, pair):
    """``fit`` with 'morton' and with a precomputed (label-sort)
    permutation, from fixed centroids, with ``tol`` 1e-4 as the batched
    fit tests take it: at 1e-6 this data's relative improvement at the stop
    lies within the fp32 rounding of the two sides' inertia sums (the port
    stops at 9 iterations, the reference at 10; ROADMAP.md queue 3). The
    reference's ``fit`` cannot take an array ``order`` (it compares it with
    'auto'), so the permutation case is held against its fit of the
    permuted rows, the assignment mapped back."""
    jnp = ref.jnp
    x = _points(5, seed=12)
    eng, reng = _single(ref, pair)
    init = jnp.asarray(x[:K] + np.float32(0.5))
    kw = dict(max_iters=25, tol=1e-4)
    lab = np.arange(N, dtype=np.int32) % 5
    given = np.argsort(lab, kind="stable").astype(np.int32)
    for order in ("morton", given):
        got = eng.fit(x, np.asarray(init), order=order, **kw)
        if isinstance(order, str):
            want = reng.fit(jnp.asarray(x), init, order=order, **kw)
        else:
            sorted_fit = reng.fit(jnp.asarray(x[given]), init, **kw)
            inv = np.argsort(given)
            want = sorted_fit._replace(
                assignment=np.asarray(sorted_fit.assignment)[inv],
                reorder=given)
        _eq(got.reorder, want.reorder)
        xs = x[np.asarray(want.reorder)]
        prev = np.asarray(reng.fit(jnp.asarray(xs), init,
                                   max_iters=int(want.n_iters) - 1,
                                   tol=1e-4).centroids)
        _assert_fit(got, want, x, prev)


@pytest.mark.parametrize("batched", ["fit_batched", "kmeans_batched"])
@pytest.mark.parametrize("pair", PAIRS)
def test_batched_morton_matches_reference(ref, pair, batched):
    """``fit_batched`` / ``kmeans_batched(order="morton")``: every problem's
    permutation exactly, its seeds (kmeans) exactly, the fit and its
    counters as the gated batched tests hold them."""
    jax, jnp = ref.jax, ref.jnp
    pts = _problems(2, "shuffled", seed=5)
    reng, eng = _engines(ref, pair[0], pair[1], N, 2, BN)
    key = jax.random.PRNGKey(SEED)
    draws = batched_draws_for(SEED, 3, N, K)
    if batched == "fit_batched":
        init = np.asarray(reng.seed_batched(key, jnp.asarray(pts),
                                            K).centroids)
        want = reng.fit_batched(jnp.asarray(pts), jnp.asarray(init),
                                max_iters=25, order="morton")
        got = eng.fit_batched(pts, init, max_iters=25, order="morton")
    else:
        want = reng.kmeans_batched(key, jnp.asarray(pts), K, max_iters=25,
                                   order="morton")
        got = eng.kmeans_batched(pts, K, draws=draws, max_iters=25,
                                 order="morton")
    _eq(got.reorder, want.reorder)
    perm = np.asarray(want.reorder)
    xs = np.take_along_axis(pts, perm[..., None], axis=1)
    if batched == "kmeans_batched":
        want_seed = reng.seed_batched(key, jnp.asarray(xs), K)
        seeds = eng.seed_batched(xs, K, draws=draws)
        _eq(seeds.indices, want_seed.indices)
        init = np.asarray(want_seed.centroids)
    prev = _prev_centroids(reng, ref, xs, init, want.n_iters)
    _assert_rows_fit(got, convert.lloyd_result(*want[:4]), pts, prev)
    _assert_counters(got, want, want.n_iters)


def test_fit_minibatch_order_matches_reference(ref):
    """``fit_minibatch(order="morton")``: each batch reordered before its
    step, the last batch's assignment in its own row order."""
    jnp = ref.jnp
    x = _points(2, n=12 * 256, seed=13)
    batches = [x[i * 256:(i + 1) * 256] for i in range(12)]
    init = batches[0][:K] + np.float32(0.05)
    eng, reng = _single(ref, PAIRS[0])
    want = reng.fit_minibatch(jnp.asarray(init), batches, order="morton")
    got = eng.fit_minibatch(init, batches, order="morton")
    assert got.n_iters == int(want.n_iters) == 12
    prev = np.asarray(reng.fit_minibatch(jnp.asarray(init), batches[:11])
                      .centroids)
    xb = batches[-1]
    assert_labels_match(got.assignment.numpy(), np.asarray(want.assignment),
                        exact_d2(xb, prev), d2_tol(xb, prev))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=0,
                               atol=12 * 256 * EPS32 * float(np.abs(x).max()))
    plain = eng.fit_minibatch(init, batches)
    assert torch.equal(plain.assignment, got.assignment)


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------


def test_order_auto_and_given_permutations():
    """'auto' is the natural order (the port has no tuner): bitwise
    ``order=None`` with ``reorder`` None. A given permutation is taken as
    is: the result is the plain fit of the permuted rows, its assignment
    mapped back. A wrong-shaped permutation raises."""
    x = _points(2, seed=14)
    eng = ClusterEngine(device="cpu")
    gen = torch.Generator().manual_seed(0)
    none = eng.kmeans(x, K, generator=gen)
    auto = eng.kmeans(x, K, generator=torch.Generator().manual_seed(0),
                      order="auto")
    assert auto.reorder is None and none.reorder is None
    assert torch.equal(auto.assignment, none.assignment)
    assert torch.equal(auto.centroids, none.centroids)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(N)
                            .astype(np.int32))
    init = torch.from_numpy(x[:K] + np.float32(0.5))
    got = eng.fit(x, init, order=perm)
    direct = eng.fit(x[perm.numpy()], init)
    assert torch.equal(got.reorder, perm)
    assert torch.equal(got.centroids, direct.centroids)
    inv = ordering.inverse_permutation(perm).long()
    assert torch.equal(got.assignment, direct.assignment[inv])
    with pytest.raises(ValueError, match="permutation shape"):
        eng.fit(x, init, order=perm[:-1])


@pytest.mark.cuda
def test_kmeans_morton_on_the_card():
    """On the card: ``kmeans(order="morton")`` returns the caller's order
    (the labels of the plain fit of the reordered rows, mapped back),
    ``reorder`` the Morton permutation, bitwise a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    x = torch.from_numpy(_points(2, n=200_000, seed=15)).cuda()
    eng = ClusterEngine(device="cuda")
    draws = Draws.sample(200_000, 20, generator=torch.Generator()
                         .manual_seed(0), device="cuda")
    kw = dict(draws=draws, max_iters=10)
    one = eng.kmeans(x, 20, order="morton", **kw)
    two = eng.kmeans(x, 20, order="morton", **kw)
    perm = ordering.morton_order(x)[0]
    assert torch.equal(one.reorder, perm)
    for f in ("centroids", "assignment", "inertia", "reorder"):
        assert torch.equal(getattr(one, f), getattr(two, f)), f
    direct = eng.kmeans(x[perm.long()], 20, **kw)
    inv = ordering.inverse_permutation(perm).long()
    assert torch.equal(one.assignment, direct.assignment[inv])
