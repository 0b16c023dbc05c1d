"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold it
against ``repro.kernels.ops`` run in interpret mode, on the same inputs
made from a seed with numpy (carried bound state handed to both sides
through ``convert``):

* K1 ``seed_prologue`` (``repro/kernels/kmeans_distance.py:405``): norms,
  tile centers and radii, each row's distance to its tile's center;
* K2 ``distance_min_update`` (``repro/kernels/kmeans_distance.py:99``):
  the seeding round's D² min-update and per-tile partials;
* K3 ``lloyd_assign_tiled`` (``repro/kernels/lloyd_assign.py:324``): the
  tiled assignment round's labels, D², per-tile partials and gaps, and
  per-super-tile cluster sums and counts;
* K5 ``distance_min_update_gated`` (``kmeans_distance.py:192``): K2 on the
  active tiles with the per-point prune, tile maxima and pruned counts;
* K6 ``lloyd_assign_gated`` (``lloyd_assign.py:416``): K3 on super-aligned
  active tiles with the per-point Hamerly prune, lower bounds and pruned
  counts.

K11 ``row_min_d2`` and K12 ``tile_cap`` are held against the reference in
``test_torch_rejection``.

Tests marked ``cuda`` hold the CUDA kernels against the plain versions on
the card (and the all-active gated kernels bitwise against K2/K3) and skip
without one.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_jaxref import (EPS32, assert_labels_match, d2_tol, exact_d2,
                               np32, ref)  # noqa: F401  (ref is a fixture)
from repro_torch import convert
from repro_torch.core import bounds
from repro_torch.core.sampling import tile_partials
from repro_torch.data import blobs
from repro_torch.kernels import flash_attention, ivf_scan
from repro_torch.kernels import kmeans_distance as kd
from repro_torch.kernels import lloyd_assign as la
from repro_torch.kernels import ops
from repro_torch.kernels import pq_decode


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def _md_in(x, first_round, seed):
    """The carried D²: +inf before the first round, else the D² to a few
    earlier centroids."""
    n = x.shape[0]
    if first_round:
        return np.full(n, np.inf, np.float32)
    prev = x[np.random.default_rng(seed).choice(n, 3, replace=False)]
    return exact_d2(x, prev).min(1).astype(np.float32)


def _partial_tol(tol, block_n, partials):
    """A tile partial sums block_n D² values, each within ``tol``, in two
    orders: block_n roundings of at most eps·partial each, per side."""
    return block_n * tol + 2 * block_n * EPS32 * np.abs(partials)


# ---------------------------------------------------------------------------
# K2: the seeding round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,block_n", [(1000, 3, 128), (777, 16, 256),
                                         (300, 2, 512)])
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("first_round", [True, False])
def test_distance_min_update_matches_reference(ref, n, d, block_n, m,
                                               resident, first_round):
    """Ragged n (tail rows enter no partial), m centroids per round, both
    centroid placements, the +inf carry of the first round. D² within
    ``d2_tol``; partials within block_n D² errors plus two summation
    orders."""
    x = _data(n, d, seed=n + d)
    c = x[np.random.default_rng(m).choice(n, m, replace=False)]
    md = _md_in(x, first_round, seed=d)
    norms = (x.astype(np.float32) ** 2).sum(1, dtype=np.float32)
    jnp = ref.jnp
    want_md, want_p = ref.ops.distance_min_update(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(md),
        norms=jnp.asarray(norms), resident_centroids=resident,
        block_n=block_n, interpret=True)
    got_md, got_p = kd.distance_min_update(
        torch.from_numpy(x), bounds.point_norms(torch.from_numpy(x)),
        torch.from_numpy(c), torch.from_numpy(md), block_n=block_n,
        resident=resident)
    tol = d2_tol(x, c)
    np.testing.assert_allclose(got_md.numpy(), np32(want_md), rtol=0,
                               atol=tol)
    assert got_p.shape == (-(-n // block_n),)
    want_p = np32(want_p)
    assert (np.abs(got_p.numpy() - want_p)
            <= _partial_tol(tol, block_n, want_p)).all()


def test_distance_min_update_partials_are_the_tiles_sums():
    """The partials cut min_d2 at the same tile boundaries as
    ``sampling.tile_partials``, the window the tiled sampler reads."""
    from repro_torch.core.sampling import tile_partials
    x = torch.from_numpy(_data(1001, 4, seed=5))
    md, parts = kd.distance_min_update(
        x, bounds.point_norms(x), x[:2].contiguous(),
        torch.full((1001,), torch.inf), block_n=128)
    assert torch.equal(parts, tile_partials(md, 128))


# ---------------------------------------------------------------------------
# K3: the tiled assignment round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,block_n,tps", [(1000, 2, 128, 4),
                                             (1300, 5, 128, 2),
                                             (640, 16, 256, 1)])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_lloyd_assign_tiled_matches_reference(ref, n, d, block_n, tps, k):
    """Labels equal outside near-ties (first index on ties, as argmin);
    D², partials and gaps within tolerance; gaps +inf at k = 1; counts
    exact; sums within 1e-5 of the rows' absolute sum (fp32 adds of at
    most tps·block_n rows, in two orders)."""
    x = _data(n, d, seed=k + d)
    c = x[np.random.default_rng(k).choice(n, k, replace=False)] + 0.01
    norms = (x ** 2).sum(1, dtype=np.float32)
    jnp = ref.jnp
    want = ref.ops.lloyd_assign_tiled(jnp.asarray(x), jnp.asarray(c),
                                      norms=jnp.asarray(norms),
                                      block_n=block_n, tps=tps,
                                      interpret=True)
    a, md, part, gap, ssums, scounts = la.lloyd_assign_tiled(
        torch.from_numpy(x), bounds.point_norms(torch.from_numpy(x)),
        torch.from_numpy(c), block_n=block_n, tps=tps)
    wa, wmd, wpart, wgap, wsums, wcounts = (np.asarray(v) for v in want)
    tol = d2_tol(x, c)
    assert a.dtype == torch.int32
    assert_labels_match(a.numpy(), wa, exact_d2(x, c), tol)
    np.testing.assert_allclose(md.numpy(), wmd, rtol=0, atol=tol)
    assert (np.abs(part.numpy() - wpart)
            <= _partial_tol(tol, block_n, wpart)).all()
    if k == 1:
        assert np.isinf(gap.numpy()).all() and np.isinf(wgap).all()
    else:
        # a gap is √second − √best: a D² error δ moves each root by ≤ √δ
        np.testing.assert_allclose(gap.numpy(), wgap, rtol=0,
                                   atol=2 * np.sqrt(tol))
    n_super = -(-(-(-n // block_n)) // tps)
    assert ssums.shape == (n_super, k, d) and scounts.shape == (n_super, k)
    if (a.numpy() == wa).all():
        np.testing.assert_array_equal(scounts.numpy(), wcounts)
        rows = tps * block_n
        s_of = np.arange(n) // rows
        abs_sum = np.zeros((n_super, k, d))
        np.add.at(abs_sum, (s_of, wa), np.abs(x))
        assert (np.abs(ssums.numpy() - wsums) <= 1e-5 * abs_sum + 1e-6).all()


@pytest.mark.parametrize("n,d,k,block_n,tps", [(300, 128, 512, 128, 2),
                                               (260, 2, 6000, 128, 1)])
def test_lloyd_assign_tiled_past_the_old_cap_matches_reference(
        ref, n, d, k, block_n, tps):
    """K3's twin against the reference's interpreted kernel at k past the
    template's staging at this height (``ops.template_max_k``: 419 at
    d = 128, 5,224 at d = 2), the k the card's chunked routes now take:
    labels outside near-ties, D² and partials within tolerance, gaps
    within 2·√tol, counts exact where the labels agree."""
    assert k > ops.template_max_k(d, block_n)
    rng = np.random.default_rng(k)
    x = _data(n, d, seed=d)
    c = rng.normal(size=(k, d)).astype(np.float32)
    norms = (x ** 2).sum(1, dtype=np.float32)
    jnp = ref.jnp
    want = ref.ops.lloyd_assign_tiled(jnp.asarray(x), jnp.asarray(c),
                                      norms=jnp.asarray(norms),
                                      block_n=block_n, tps=tps,
                                      interpret=True)
    a, md, part, gap, ssums, scounts = la.lloyd_assign_tiled(
        torch.from_numpy(x), bounds.point_norms(torch.from_numpy(x)),
        torch.from_numpy(c), block_n=block_n, tps=tps)
    wa, wmd, wpart, wgap, _, wcounts = (np.asarray(v) for v in want)
    tol = d2_tol(x, c)
    assert_labels_match(a.numpy(), wa, exact_d2(x, c), tol)
    np.testing.assert_allclose(md.numpy(), wmd, rtol=0, atol=tol)
    assert (np.abs(part.numpy() - wpart)
            <= _partial_tol(tol, block_n, wpart)).all()
    np.testing.assert_allclose(gap.numpy(), wgap, rtol=0,
                               atol=2 * np.sqrt(tol))
    if (a.numpy() == wa).all():
        np.testing.assert_array_equal(scounts.numpy(), wcounts)


def test_lloyd_assign_tiled_template_entry_takes_the_twin_on_cpu():
    """On CPU tensors the template entry is the plain twin, as K3 is."""
    x = torch.from_numpy(_data(700, 5, seed=3))
    c = x[:9].contiguous() + 0.01
    nr = bounds.point_norms(x)
    got = la.lloyd_assign_tiled_template(x, nr, c, block_n=128, tps=2)
    for u, v in zip(got, la.lloyd_assign_tiled(x, nr, c, block_n=128,
                                               tps=2)):
        assert torch.equal(u, v)


def test_lloyd_assign_tiled_first_index_wins_ties():
    """Two identical centroids: every row takes the first, and the gap is
    zero."""
    x = torch.from_numpy(_data(300, 3, seed=1))
    c = torch.stack([x[0], x[0], x[5]])
    a, _, _, gap, _, counts = la.lloyd_assign_tiled(
        x, bounds.point_norms(x), c, block_n=128, tps=1)
    assert not (a == 1).any()
    assert counts[:, 1].sum() == 0
    assert (gap == 0).all()


# ---------------------------------------------------------------------------
# K1: the prologue
# ---------------------------------------------------------------------------


def test_seed_prologue_template_entry_takes_the_twin_on_cpu():
    """On the CPU the template entries take the plain twin, single and
    batched, and count no launch."""
    x = torch.from_numpy(_data(700, 3, seed=7))
    ops.reset_launches()
    for pts in (x, torch.stack([x, x.flip(0)])):
        got = kd.seed_prologue_template(pts, 128)
        want = kd.seed_prologue_torch(pts, 128)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got = (kd.seed_prologue(pts, 128) if pts.dim() == 2
               else kd.seed_prologue_batched(pts, 128))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("n,d,block_n", [(1000, 2, 128), (777, 9, 256)])
def test_seed_prologue_matches_reference(ref, n, d, block_n):
    """Norms within d roundings (the interpreted kernel may fuse a product
    into the add); centers within block_n·eps of the largest coordinate (a
    mean in two orders); radii and center_d within 1e-5 of it."""
    x = _data(n, d, seed=n)
    want = ref.ops.seed_prologue(ref.jnp.asarray(x), block_n=block_n,
                                 interpret=True)
    got = kd.seed_prologue(torch.from_numpy(x), block_n)
    assert got[0].shape == (n,) and got[1].shape == (-(-n // block_n), d)
    np.testing.assert_allclose(got[0].numpy(), np32(want[0]), rtol=d * EPS32)
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(got[1].numpy(), np32(want[1]), rtol=0,
                               atol=block_n * EPS32 * scale)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np32(w), rtol=0,
                                   atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# K5: the gated seeding round
# ---------------------------------------------------------------------------


def _sorted_blobs(n, d, k, seed, spread=0.03):
    pts, lab = blobs(n, d, k, seed=seed, spread=spread)
    return pts[np.argsort(lab, kind="stable")]


def _k5_inputs(ref, m, mask, block_n=128):
    """A mid-seeding state on label-sorted blobs: the reference's prologue,
    the D² to three earlier seeds, its tile partials and maxima as the
    carries, the gate of the reference for m new centroids, and the active
    mask: the gate's, all tiles, or every other tile."""
    x = _sorted_blobs(2000, 2, 5, seed=m)
    jnp = ref.jnp
    cache = ref.bounds.prologue(jnp.asarray(x), block_n)
    prev = x[[10, 900, 1700]]
    md = exact_d2(x, prev).min(1).astype(np.float32)
    parts = np32(ref.sampling.tile_partials(jnp.asarray(md), block_n))
    tmax = np32(ref.bounds.tile_reduce_max(jnp.asarray(md), block_n))
    c = x[[400, 1300, 1600, 50, 1999, 700, 1100, 300][:m]]
    act, dc, margin = (np.asarray(v) for v in ref.bounds.seed_gate(
        jnp.asarray(c), cache, jnp.asarray(tmax)))
    if mask == "all":
        act = np.ones_like(act)
    elif mask == "half":
        act = np.arange(act.shape[0]) % 2 == 0
    return x, cache, c, md, parts, tmax, act, dc, margin


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("mask", ["gate", "all", "half"])
@pytest.mark.parametrize("resident", [True, False])
def test_distance_min_update_gated_matches_reference(ref, m, mask, resident):
    """Fed the same carries and gate, the plain K5 and the reference's
    interpreted kernel: D² within ``d2_tol``; per-tile pruned counts equal;
    partials and maxima of active tiles within tolerance; every output of a
    skipped tile bitwise its carry (and pruned 0)."""
    x, cache, c, md, parts, tmax, act, dc, margin = _k5_inputs(ref, m, mask)
    jnp = ref.jnp
    want = ref.ops.distance_min_update_gated(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(md), cache.norms,
        cache.center_d, jnp.asarray(dc), jnp.asarray(margin),
        jnp.asarray(parts), jnp.asarray(tmax), jnp.asarray(act), block_n=128,
        resident_centroids=resident, interpret=True)
    pc = convert.round_cache(cache)

    def t(v):
        return torch.from_numpy(np.array(v))

    got = kd.distance_min_update_gated(
        t(x), pc.norms, t(c), t(md), pc.center_d, t(dc), t(margin), t(parts),
        t(tmax), t(act), block_n=128, resident=resident)
    tol = d2_tol(x, c)
    np.testing.assert_allclose(got[0].numpy(), np32(want[0]), rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(got[3].numpy(),
                                  np32(want[3]).astype(np.int32))
    if mask != "all":
        assert (~act).any()
    skip = ~act
    rows = bounds.expand_mask(t(skip), 128, x.shape[0]).numpy()
    np.testing.assert_array_equal(got[0].numpy()[rows], md[rows])
    np.testing.assert_array_equal(got[1].numpy()[skip], parts[skip])
    np.testing.assert_array_equal(got[2].numpy()[skip], tmax[skip])
    assert (got[3].numpy()[skip] == 0).all()
    wp = np32(want[1])
    assert (np.abs(got[1].numpy() - wp) <= _partial_tol(tol, 128, wp)).all()
    np.testing.assert_allclose(got[2].numpy(), np32(want[2]), rtol=0,
                               atol=tol)
    if mask == "gate":
        assert int(got[3].sum()) > 0           # the per-point prune fired


def test_distance_min_update_gated_all_active_is_k2():
    """With every tile active the gated round is the ungated one: pruned
    rows keep exactly the value the min-update gives them."""
    x = torch.from_numpy(_sorted_blobs(3000, 2, 6, seed=2))
    cache = bounds.prologue(x, 256)
    md = torch.from_numpy(exact_d2(x.numpy(), x[[0, 2999]].numpy())
                          .min(1).astype(np.float32))
    c = x[1500:1501].contiguous()
    tmax = bounds.tile_reduce_max(md, 256)
    _, dc, margin = bounds.seed_gate(c, cache, tmax)
    t = tmax.shape[0]
    got = kd.distance_min_update_gated(
        x, cache.norms, c, md, cache.center_d, dc, margin, torch.zeros(t),
        tmax, torch.ones(t, dtype=torch.bool), block_n=256)
    want = kd.distance_min_update(x, cache.norms, c, md, block_n=256)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[3].sum()) > 0


# ---------------------------------------------------------------------------
# K6: the gated assignment round
# ---------------------------------------------------------------------------


def _k6_inputs(ref, k, mask, n=2400, block_n=128, tps=4, d=2):
    """A carried state from one round of the reference's tiled kernel on
    label-sorted blobs of width ``d``, its centroids moved slightly for two
    clusters (or none at k = 1), the per-point lower bound sqrt(second
    best) − 1e-3 of the previous round, and the mask: the reference's gate,
    all tiles, or half the supers."""
    jnp = ref.jnp
    x = _sorted_blobs(n, d, max(k, 2), seed=k)
    cache = ref.bounds.prologue(jnp.asarray(x), block_n)
    rng = np.random.default_rng(k)
    c0 = (x[rng.choice(n, k, replace=False)] + 0.01).astype(np.float32)
    a, md, part, gap, ssums, scounts = (np.asarray(v) for v in
                                        ref.ops.lloyd_assign_tiled(
        jnp.asarray(x), jnp.asarray(c0), norms=cache.norms, block_n=block_n,
        tps=tps, interpret=True))
    d2 = exact_d2(x, c0)
    d2[np.arange(n), a] = np.inf
    lb = (np.sqrt(d2.min(1)) - 1e-3).astype(np.float32) if k > 1 else         np.full(n, np.inf, np.float32)
    c1 = c0.copy()
    if k > 1:
        c1[[0, k - 1]] += 0.002
    t = part.shape[0]
    st = ref.bounds.BoundState(
        jnp.asarray(part), tile_gap=jnp.asarray(gap),
        tile_sums=jnp.asarray(ssums), tile_counts=jnp.asarray(scounts),
        assignment=jnp.asarray(a), min_d2=jnp.asarray(md),
        point_lb=jnp.asarray(lb), lb_debt=jnp.zeros(t, jnp.float32))
    delta = ref.bounds.centroid_movement(jnp.asarray(c1), jnp.asarray(c0))
    thresh, absorb = ref.bounds.assign_point_scalars(delta, jnp.asarray(c1),
                                                     st, cache)
    act = np.asarray(ref.bounds.assign_active_tiles(
        delta, jnp.asarray(c1), st, cache, tps=tps))
    if mask == "all":
        act = np.ones_like(act)
    elif mask == "half":
        act = (np.arange(t) // tps) % 2 == 0
    act = np.asarray(ref.bounds.expand_active_supers(jnp.asarray(act), tps))
    return x, cache, c1, st, np32(delta), np32(thresh), np32(absorb), act


@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("mask", ["gate", "all", "half"])
def test_lloyd_assign_gated_matches_reference(ref, k, mask):
    """Fed the same carries, movement and mask, the plain K6 and the
    reference's interpreted kernel: labels equal outside near-ties; D² and
    lower bounds within tolerance; pruned counts equal; every output of a
    skipped tile and super bitwise its carry; counts exact and sums within
    1e-5 of the rows' absolute sum where the labels agree."""
    _check_k6_against_reference(ref, k, mask)


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("mask", ["gate", "all", "half"])
def test_lloyd_assign_gated_matches_reference_wide(ref, d, k, mask):
    """The plain K6 against the reference's interpreted kernel at the widths
    of the card's screened route, d = 16 (the PQ sweep's) and d = 128 (the
    IVF build's), as at d = 2: labels outside near-ties, D² and lower
    bounds within tolerance, pruned counts equal, skipped tiles and supers
    bitwise their carries."""
    _check_k6_against_reference(ref, k, mask, n=1200, d=d)


def _check_k6_against_reference(ref, k, mask, n=2400, d=2):
    bn, tps = 128, 4
    x, cache, c1, st, delta, thresh, absorb, act = _k6_inputs(ref, k, mask,
                                                              n=n, d=d)
    jnp = ref.jnp
    want = [np.asarray(v) for v in ref.ops.lloyd_assign_gated(
        jnp.asarray(x), jnp.asarray(c1), cache.norms, jnp.asarray(delta),
        jnp.asarray(thresh), jnp.asarray(absorb), st.assignment, st.min_d2,
        st.point_lb, st.partials, st.tile_gap, st.tile_sums, st.tile_counts,
        jnp.asarray(act), block_n=bn, tps=tps, interpret=True)]
    pst, pc = convert.bound_state(st), convert.round_cache(cache)

    def t(v):
        return torch.from_numpy(np.array(v))

    got = la.lloyd_assign_gated(
        t(x), pc.norms, t(c1), t(delta), t(thresh), t(absorb),
        pst.assignment, pst.min_d2, pst.point_lb, pst.partials,
        pst.tile_gap, pst.tile_sums, pst.tile_counts, t(act), block_n=bn,
        tps=tps)
    a, md, lb, part, gap, ssums, scounts, pruned = (v.numpy() for v in got)
    tol = d2_tol(x, c1)
    assert_labels_match(a, want[0], exact_d2(x, c1), tol)
    np.testing.assert_allclose(md, want[1], rtol=0, atol=tol)
    fin = np.isfinite(want[2])
    assert (np.isfinite(lb) == fin).all()
    np.testing.assert_allclose(lb[fin], want[2][fin], rtol=0,
                               atol=2 * np.sqrt(tol))
    np.testing.assert_array_equal(pruned, want[7].astype(np.int32))
    if mask == "gate":
        assert pruned.sum() > 0                 # the Hamerly prune fired
    skip = ~act
    rows = bounds.expand_mask(t(skip), bn, x.shape[0]).numpy()
    sup_skip = ~np.asarray(bounds.super_any(t(act), tps))
    carries = ((a, pst.assignment, rows), (md, pst.min_d2, rows),
               (lb, pst.point_lb, rows), (part, pst.partials, skip),
               (gap, pst.tile_gap, skip), (ssums, pst.tile_sums, sup_skip),
               (scounts, pst.tile_counts, sup_skip))
    for out, carry, sel in carries:
        np.testing.assert_array_equal(out[sel], carry.numpy()[sel])
    assert (pruned[skip] == 0).all()
    assert (np.abs(part - want[3]) <= _partial_tol(tol, bn, want[3])).all()
    if (a == want[0]).all():
        np.testing.assert_array_equal(scounts, want[6])
        s_of = np.arange(x.shape[0]) // (bn * tps)
        abs_sum = np.zeros(ssums.shape)
        np.add.at(abs_sum, (s_of, a), np.abs(x))
        assert (np.abs(ssums - want[5]) <= 1e-5 * abs_sum + 1e-6).all()


def test_lloyd_assign_gated_all_active_without_prune_is_k3():
    """All tiles active and no carried bound (point_lb = -inf): the gated
    round is the ungated one, bit for bit, and lb is sqrt(second best)."""
    x = torch.from_numpy(_sorted_blobs(3000, 2, 5, seed=4))
    norms = bounds.point_norms(x)
    c = x[[0, 700, 1400, 2100, 2999]].contiguous()
    n, k, bn, tps = 3000, 5, 256, 4
    t = -(-n // bn)
    s = -(-t // tps)
    got = la.lloyd_assign_gated(
        x, norms, c, torch.zeros(k), torch.zeros(t), torch.zeros(t),
        torch.zeros(n, dtype=torch.int32), torch.zeros(n),
        torch.full((n,), -torch.inf), torch.zeros(t), torch.zeros(t),
        torch.zeros(s, k, 2), torch.zeros(s, k),
        torch.ones(t, dtype=torch.bool), block_n=bn, tps=tps)
    want = la.lloyd_assign_tiled(x, norms, c, block_n=bn, tps=tps)
    for g, w in zip((got[0], got[1], got[3], got[4], got[5], got[6]), want):
        assert torch.equal(g, w)
    assert int(got[7].sum()) == 0


# ---------------------------------------------------------------------------
# wrapper contract and tile geometry (no card needed)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask", ["gate", "half"])
def test_k5_template_entry_and_inplace_take_the_twin_on_cpu(mask):
    """On the CPU, K5's template entry and its in-place call take the plain
    twin: the same outputs as ``distance_min_update_gated_torch``, the
    carry left as it was (in place is the card's), and no launch
    counted; K8's in-place call likewise row by row."""
    x = torch.from_numpy(_sorted_blobs(3000, 2, 5, seed=4))
    bn = 256
    cache = bounds.prologue(x, bn)
    md = torch.from_numpy(exact_d2(x.numpy(), x[[3, 1500]].numpy())
                          .min(1).astype(np.float32))
    tmax = bounds.tile_reduce_max(md, bn)
    c = x[[2000]].contiguous()
    act, dc, margin = bounds.seed_gate(c, cache, tmax)
    if mask == "half":
        act = torch.arange(act.shape[0]) % 2 == 0
    args = (x, cache.norms, c, md, cache.center_d, dc, margin,
            tile_partials(md, bn), tmax, act)
    want = kd.distance_min_update_gated_torch(*args, block_n=bn)
    before = md.clone()
    ops.reset_launches()
    for got in (kd.distance_min_update_gated_template(*args, block_n=bn),
                kd.distance_min_update_gated(*args, block_n=bn,
                                             inplace=True)):
        assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert torch.equal(md, before)
    two = tuple(torch.stack([a, a]) for a in args)
    got = kd.distance_min_update_gated_batched(*two, block_n=bn, inplace=True)
    assert all(torch.equal(u[1], v) for u, v in zip(got, want))
    assert sum(ops.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="center_d"):
        kd.distance_min_update_gated(*args[:4], args[4][1:], *args[5:],
                                     block_n=bn)


def test_k2_k7_template_entry_takes_the_twin_on_cpu():
    """On the CPU, K2/K7's template entry takes the plain twins, the same
    outputs as ``distance_min_update(_batched)_torch``, and counts no
    launch."""
    x = torch.from_numpy(_data(700, 16, seed=5))
    md = torch.full((700,), torch.inf)
    c = x[[3, 300]].contiguous()
    norms = bounds.point_norms(x)
    ops.reset_launches()
    got = kd.distance_min_update_template(x, norms, c, md, block_n=256)
    want = kd.distance_min_update_torch(x, norms, c, md, block_n=256)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    xb, nb, cb, mb = (torch.stack([v, v.flip(0)]) for v in (x, norms, c, md))
    got = kd.distance_min_update_template(xb, nb, cb, mb, block_n=256)
    want = kd.distance_min_update_batched_torch(xb, nb, cb, mb, block_n=256)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert sum(ops.LAUNCHES.values()) == 0


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    x = torch.from_numpy(_data(500, 2, seed=3))
    ops.reset_launches()
    kd.distance_min_update(x, bounds.point_norms(x), x[:1].contiguous(),
                           torch.full((500,), torch.inf), block_n=128)
    la.lloyd_assign_tiled(x, bounds.point_norms(x), x[:3].contiguous(),
                          block_n=128, tps=1)
    norms, centers, radii, cd = kd.seed_prologue(x, 128)
    t = torch.ones(4, dtype=torch.bool)
    kd.distance_min_update_gated(
        x, norms, x[:1].contiguous(), torch.full((500,), torch.inf), cd,
        torch.zeros(4), torch.zeros(4), torch.zeros(4),
        torch.full((4,), torch.inf), t, block_n=128)
    la.lloyd_assign_gated(
        x, norms, x[:3].contiguous(), torch.zeros(3), torch.zeros(4),
        torch.zeros(4), torch.zeros(500, dtype=torch.int32), torch.zeros(500),
        torch.full((500,), -torch.inf), torch.zeros(4), torch.zeros(4),
        torch.zeros(4, 3, 2), torch.zeros(4, 3), t, block_n=128, tps=1)
    kd.row_min_d2(x, torch.tensor(7), x[:8].contiguous(), 3)
    kd.tile_cap(centers, radii, x[:8].contiguous(), torch.tensor(3))
    xb = torch.stack([x, x.flip(0)])
    nb = bounds.point_norms(xb)
    kd.distance_min_update_batched(xb, nb, xb[:, :1].contiguous(),
                                   torch.full((2, 500), torch.inf),
                                   block_n=128)
    la.lloyd_assign_tiled_batched(xb, nb, xb[:, :3].contiguous(),
                                  block_n=128, tps=1)
    nb, _, _, cdb = kd.seed_prologue_batched(xb, 128)
    tb = torch.ones((2, 4), dtype=torch.bool)
    zb = torch.zeros((2, 4))
    kd.distance_min_update_gated_batched(
        xb, nb, xb[:, :1].contiguous(), torch.full((2, 500), torch.inf), cdb,
        zb, zb, zb, torch.full((2, 4), torch.inf), tb, block_n=128)
    la.lloyd_assign_gated_batched(
        xb, nb, xb[:, :3].contiguous(), torch.zeros(2, 3), zb, zb,
        torch.zeros((2, 500), dtype=torch.int32), torch.zeros(2, 500),
        torch.full((2, 500), -torch.inf), zb, zb, torch.zeros(2, 4, 3, 2),
        torch.zeros(2, 4, 3), tb, block_n=128, tps=1)
    la.lloyd_assign(x, bounds.point_norms(x), x[:3].contiguous(),
                    torch.ones(500), block_n=128)
    la.lloyd_assign_batched(xb, bounds.point_norms(xb),
                            xb[:, :3].contiguous(), block_n=128)
    ids, nact = bounds.compact_ids(torch.ones((3, 4), dtype=torch.bool))
    q = x[:3].contiguous()
    ivf_scan.ivf_scan(q, x, norms, centers, radii, ids, nact, k=5,
                      block_n=128)
    ivf_scan.ivf_adc_scan(q, torch.zeros(3, 2, 256), torch.zeros(3, 4),
                          torch.zeros((500, 2), dtype=torch.uint8),
                          torch.zeros(500, dtype=torch.int32), norms,
                          centers, radii, ids, nact, k=5, block_n=128)
    qa = torch.zeros(1, 4, 2, 8)
    flash_attention.flash_attention(qa, qa[:, :, :1].contiguous(),
                                    qa[:, :, :1].contiguous())
    codes = torch.zeros((1, 16, 1, 2), dtype=torch.uint8)
    cb = torch.zeros(1, 2, 256, 4)
    pq_decode.pq_decode_attention(qa[:, :1].contiguous(), codes, codes, cb,
                                  cb, 16)
    # the rounds' bf16 stream takes the twins on the CPU too
    x16 = x.bfloat16()
    kd.distance_min_update(x16, bounds.point_norms(x), x16[:1].contiguous(),
                           torch.full((500,), torch.inf), block_n=128)
    la.lloyd_assign_tiled(x16, bounds.point_norms(x), x16[:3].contiguous(),
                          block_n=128, tps=1)
    rounds = {"distance_min_update", "lloyd_assign_tiled",
              "distance_min_update_gated", "lloyd_assign_gated",
              "distance_min_update_batched", "lloyd_assign_tiled_batched",
              "distance_min_update_gated_batched",
              "lloyd_assign_gated_batched", "lloyd_assign",
              "lloyd_assign_batched"}
    assert set(ops.LAUNCHES) == rounds | {f"{r}_bf16" for r in rounds} | {
        "seed_prologue", "row_min_d2", "tile_cap", "seed_prologue_batched",
        "ivf_scan", "ivf_adc_scan", "pq_decode_attention", "flash_attention",
        "flash_attention_bf16"}
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("bad", ["norms", "centroids", "min_d2", "block_n"])
def test_wrappers_reject_bad_shapes(bad):
    x = torch.zeros(100, 3)
    args = dict(norms=torch.zeros(100), centroids=torch.zeros(2, 3),
                min_d2=torch.zeros(100), block_n=128)
    args[bad] = {"norms": torch.zeros(99), "centroids": torch.zeros(2, 4),
                 "min_d2": torch.zeros(101), "block_n": 0}[bad]
    with pytest.raises(ValueError):
        kd.distance_min_update(x, args["norms"], args["centroids"],
                               args["min_d2"], block_n=args["block_n"])
    if bad != "min_d2":
        with pytest.raises(ValueError):
            la.lloyd_assign_tiled(x, args["norms"], args["centroids"],
                                  block_n=args["block_n"], tps=1)


@pytest.mark.parametrize("n,d,k,block_n,cols", [
    (4_000_000, 2, 50, 4096, 3),      # the paper's FULL configuration
    (100_003, 128, 64, 4096, 88),     # wide: two passes over the columns
    (16_384, 16, 256, 4096, 17),      # kvquant-gemma2-2b: K3's and K10a's
    (3000, 8, 5, 2048, 9),            # clamped to the largest 2^j <= n
    (50, 2, 4, 128, 3),               # floored at 128 rows
    (10_000, 512, 128, 128, 0),       # nothing fits: the wrapper raises
])
def test_tile_geometry_fits_shared_memory(n, d, k, block_n, cols):
    assert ops.choose_block_n(n, d, k) == block_n
    assert ops.assign_cols(d, k, block_n) == cols
    if cols:
        assert ops.assign_smem_bytes(d, k, block_n, cols) <= ops.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,m", [(10_007, 2, 1), (5003, 33, 4)])
@pytest.mark.parametrize("resident", [True, False])
def test_distance_min_update_kernel_matches_plain(card, n, d, m, resident):
    """D² within ``d2_tol``, partials within tolerance, two launches give
    the same bits, and each launch counts once."""
    x = torch.from_numpy(_data(n, d, seed=n)).to(card)
    norms = bounds.point_norms(x)
    md = torch.from_numpy(_md_in(x.cpu().numpy(), False, seed=1)).to(card)
    c = x[:m].contiguous()
    ops.reset_launches()
    got = kd.distance_min_update(x, norms, c, md, block_n=1024,
                                 resident=resident)
    again = kd.distance_min_update(x, norms, c, md, block_n=1024,
                                   resident=resident)
    assert ops.LAUNCHES["distance_min_update"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    want = kd.distance_min_update_torch(x, norms, c, md, block_n=1024)
    tol = d2_tol(x.cpu().numpy(), c.cpu().numpy())
    assert float((got[0] - want[0]).abs().max()) <= tol
    wp = want[1].cpu().numpy()
    assert (np.abs(got[1].cpu().numpy() - wp)
            <= _partial_tol(tol, 1024, wp)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,tps", [(10_007, 2, 50, 4), (5003, 33, 1, 2),
                                       (5003, 33, 9, 1)])
def test_lloyd_assign_tiled_kernel_matches_plain(card, n, d, k, tps):
    """Labels equal outside near-ties, D²/partials/gaps within tolerance,
    counts exact, sums within 1e-5 of the rows' absolute sum, and two
    launches give the same bits."""
    x = torch.from_numpy(_data(n, d, seed=n)).to(card)
    norms = bounds.point_norms(x)
    c = (x[:k] + 0.01).contiguous()
    ops.reset_launches()
    got = la.lloyd_assign_tiled(x, norms, c, block_n=1024, tps=tps)
    again = la.lloyd_assign_tiled(x, norms, c, block_n=1024, tps=tps)
    assert ops.LAUNCHES["lloyd_assign_tiled"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    want = la.lloyd_assign_tiled_torch(x, norms, c, block_n=1024, tps=tps)
    xn, cn = x.cpu().numpy(), c.cpu().numpy()
    tol = d2_tol(xn, cn)
    a = got[0].cpu().numpy()
    assert_labels_match(a, want[0].cpu().numpy(), exact_d2(xn, cn), tol)
    assert float((got[1] - want[1]).abs().max()) <= tol
    wp = want[2].cpu().numpy()
    assert (np.abs(got[2].cpu().numpy() - wp)
            <= _partial_tol(tol, 1024, wp)).all()
    fin = torch.isfinite(want[3])
    assert torch.equal(torch.isfinite(got[3]), fin)
    if fin.any():
        assert float((got[3] - want[3])[fin].abs().max()) <= 2 * np.sqrt(tol)
    _assert_super_sums(xn, a, got[4], got[5], 1024 * tps)


def _assert_super_sums(xn, a, ssums, scounts, rows_per_super, supers=None):
    """Super-tile counts exact and sums within 1e-5 of the rows' absolute
    sum, against a float64 segment sum over the kernel's labels ``a``;
    ``supers`` (n_super,) bool restricts the check to those supers."""
    n_super, k = scounts.shape
    s_of = np.arange(xn.shape[0]) // rows_per_super
    counts = np.zeros((n_super, k))
    np.add.at(counts, (s_of, a), 1)
    sums = np.zeros((n_super, k, xn.shape[1]))
    abs_sum = np.zeros_like(sums)
    np.add.at(sums, (s_of, a), xn.astype(np.float64))
    np.add.at(abs_sum, (s_of, a), np.abs(xn))
    sel = slice(None) if supers is None else supers.cpu().numpy()
    np.testing.assert_array_equal(scounts.cpu().numpy()[sel], counts[sel])
    assert (np.abs(ssums.cpu().numpy() - sums)
            <= 1e-5 * abs_sum + 1e-6)[sel].all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [977, 4096, 4_000_000])
def test_prefix_sum_is_deterministic_on_the_card(card, n):
    """``sampling.prefix_sum`` rests on how ``torch.cumsum`` dispatches on
    the card: a scan along dim 1 of a tensor with two or more rows walks
    each row in one fixed order, while a 1-D (or single-row) scan goes to
    the single-pass scan, whose order may change from run to run. Twenty
    runs on one tensor must give one bit pattern, within ``cdf_tol`` of the
    float64 scan; a PyTorch that dispatches otherwise fails here. The sizes
    are the tiled sampler's two scans and the cdf sampler's at the paper's
    shape."""
    from repro_torch.core import sampling
    from test_torch_jaxref import cdf_tol
    w = torch.rand(n, generator=torch.Generator(device=card).manual_seed(n),
                   device=card)
    first = sampling.prefix_sum(w)
    for _ in range(19):
        assert torch.equal(sampling.prefix_sum(w), first)
    wn = w.cpu().numpy()
    exact = np.cumsum(wn.astype(np.float64))
    assert np.abs(first.cpu().numpy() - exact).max() <= cdf_tol(wn)


@pytest.mark.cuda
def test_card_wrappers_reject_non_fp32(card):
    x = torch.zeros(256, 2, device=card, dtype=torch.float64)
    with pytest.raises(ValueError):
        kd.distance_min_update(x, torch.zeros(256, device=card),
                               torch.zeros(1, 2, device=card),
                               torch.zeros(256, device=card), block_n=128)
    with pytest.raises(ValueError):
        la.lloyd_assign_tiled(x, torch.zeros(256, device=card),
                              torch.zeros(1, 2, device=card), block_n=128,
                              tps=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(10_007, 2), (5003, 33)])
def test_seed_prologue_kernel_matches_plain(card, n, d):
    """K1's norms bitwise ``bounds.point_norms``; centers, radii and
    center_d within 1e-5 of the largest coordinate (sums in two orders);
    two launches give the same bits; each launch counts once."""
    x = torch.from_numpy(_data(n, d, seed=n)).to(card)
    ops.reset_launches()
    got = kd.seed_prologue(x, 1024)
    again = kd.seed_prologue(x, 1024)
    assert ops.LAUNCHES["seed_prologue"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    assert torch.equal(got[0], bounds.point_norms(x))
    want = kd.seed_prologue_torch(x, 1024)
    scale = float(x.abs().max())
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= 1e-5 * scale


def _card_seed_state(card, m, block_n=1024):
    x = torch.from_numpy(_sorted_blobs(20_011, 2, 8, seed=m)).to(card)
    cache = bounds.prologue(x, block_n)
    md = torch.from_numpy(exact_d2(x.cpu().numpy(), x[[5, 9000]].cpu()
                                   .numpy()).min(1).astype(np.float32))
    md = md.to(card)
    c = x[[3000, 12_000, 17_000, 100, 19_000, 7000, 15_000, 1][:m]] \
        .contiguous()
    return x, cache, md, c


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("mask", ["gate", "all", "half", "none"])
def test_distance_min_update_gated_kernel_matches_plain(card, m, resident,
                                                        mask):
    """K5 against its plain twin: D² within ``d2_tol``, partials and maxima
    within tolerance, skipped tiles' outputs bitwise their carries; two
    launches the same bits; all tiles active, bitwise K2."""
    bn = 1024
    x, cache, md, c = _card_seed_state(card, m)
    tmax = bounds.tile_reduce_max(md, bn)
    parts = kd.distance_min_update_torch(x, cache.norms, c[:1], md,
                                         block_n=bn)[1]
    act, dc, margin = bounds.seed_gate(c, cache, tmax)
    t = act.shape[0]
    act = {"gate": act, "all": torch.ones_like(act),
           "half": torch.arange(t, device=card) % 2 == 0,
           "none": torch.zeros_like(act)}[mask]
    args = (x, cache.norms, c, md, cache.center_d, dc, margin, parts, tmax,
            act)
    ops.reset_launches()
    got = kd.distance_min_update_gated(*args, block_n=bn, resident=resident)
    again = kd.distance_min_update_gated(*args, block_n=bn,
                                         resident=resident)
    assert ops.LAUNCHES["distance_min_update_gated"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    want = kd.distance_min_update_gated_torch(*args, block_n=bn)
    tol = d2_tol(x.cpu().numpy(), c.cpu().numpy())
    assert float((got[0] - want[0]).abs().max()) <= tol
    wp = want[1].cpu().numpy()
    assert (np.abs(got[1].cpu().numpy() - wp)
            <= _partial_tol(tol, bn, wp)).all()
    assert float((got[2] - want[2]).abs().max()) <= tol
    skip = ~act
    rows = bounds.expand_mask(skip, bn, x.shape[0])
    assert torch.equal(got[0][rows], md[rows])
    assert torch.equal(got[1][skip], parts[skip])
    assert torch.equal(got[2][skip], tmax[skip])
    assert not got[3][skip].any()
    if mask == "all":
        k2 = kd.distance_min_update(x, cache.norms, c, md, block_n=bn,
                                    resident=resident)
        assert torch.equal(got[0], k2[0]) and torch.equal(got[1], k2[1])


def _bits(got, want):
    """Every output bitwise (fp32 compared as int32 bit patterns, so that
    NaN equals NaN)."""
    for u, v in zip(got, want):
        assert u.dtype == v.dtype and u.shape == v.shape
        if u.dtype == torch.float32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        assert torch.equal(u, v)


def _k5_args(card, n, d, m, mask, dtype, seed, bn):
    """K5's arguments on adversarial rows: label-sorted blobs (the gate
    skips tiles and the bound prunes rows), a carried D² with +inf rows and
    a NaN, rows on a centroid and duplicated centroids (ties), a NaN row;
    the fp32 points' prologue and norms, the stream in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_sorted_blobs(n, d, 8, seed)).to(card)
    rows = torch.from_numpy(rng.choice(n, m + 3, replace=False)).to(card)
    c = x[rows[:m]].clone()
    if m >= 2:
        c[1] = c[0]
    md = torch.from_numpy(exact_d2(x.cpu().numpy(), x[rows[m:]].cpu()
                                   .numpy()).min(1).astype(np.float32))
    md = md.to(card)
    md[5::997] = torch.inf
    md[7] = torch.nan
    x[11] = torch.nan
    cache = bounds.prologue(x, bn)
    tmax = bounds.tile_reduce_max(md, bn)
    parts = tile_partials(md, bn)
    act, dc, margin = bounds.seed_gate(c, cache, tmax)
    t = act.shape[0]
    act = {"gate": act, "all": torch.ones_like(act),
           "half": torch.arange(t, device=card) % 2 == 0,
           "none": torch.zeros_like(act)}[mask]
    return (x.to(dtype), cache.norms, c.to(dtype), md, cache.center_d, dc,
            margin, parts, tmax, act)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 16, 128, 129])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("mask", ["gate", "all", "half", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_is_the_template_bitwise(card, d, m, mask, dtype):
    """K5 (``distance_min_update_gated``) against its template entry
    (``distance_min_update_gated_template``, K5's kernel before) on
    adversarial rows, 20,011 rows in tiles of 1,000 or 4,096 (ragged): all
    four outputs bitwise, resident and not (the same bits), in place too;
    one counted launch each; skipped tiles' outputs bitwise their carries;
    all active on fp32, bitwise K2."""
    _k5_held_to_the_template(card, 20_011, d, m, mask, dtype,
                             4096 if (d + m) % 2 else 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(600, torch.float32),
                                     (1024, torch.float32),
                                     (2048, torch.bfloat16),
                                     (16_384, torch.float32)])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("mask", ["gate", "all", "half"])
def test_k5_wide_rows_are_the_template_bitwise(card, d, m, mask, dtype):
    """Rows too wide for 32 staged rows a block (fp32 d above about 590,
    bf16 about 1,180): the wide path's threads read their listed rows from
    device memory; every output bitwise the template entry as above, on
    3,001 rows in tiles of 1,000."""
    _k5_held_to_the_template(card, 3_001, d, m, mask, dtype, 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["gate", "all"])
def test_k5_takes_any_width(card, mask):
    """d = 60,000: not one centroid stages beside the wide path's rows, so
    K5 reads its centroids from device memory whether asked to stage them
    or not; every output bitwise the template entry reading them from
    device memory, and all active, K2 (its ungated row loop) bitwise
    too."""
    n, d, m, bn = 600, 60_000, 2, 128
    args = _k5_args(card, n, d, m, mask, torch.float32, 7, bn)
    want = kd.distance_min_update_gated_template(*args, block_n=bn,
                                                 resident=False)
    for resident in (True, False):
        got = kd.distance_min_update_gated(*args, block_n=bn,
                                           resident=resident)
        _bits(got, want)
    if mask == "all":
        for resident in (True, False):
            _bits(got[:2], kd.distance_min_update(*args[:4], block_n=bn,
                                                  resident=resident))


@pytest.mark.cuda
def test_row_passes_take_any_width(card):
    """d = 60,000: not one centroid row stages in a block, so the row pass
    (K3, K4) and the split row pass (K6) read the centroids from device
    memory and stage only their norms; labels and counts equal to the
    plain twins', D² within tolerance, two launches the same bits."""
    n, d, k, bn, tps = 600, 60_000, 4, 128, 2
    rng = np.random.default_rng(60)
    cents = rng.normal(size=(k, d)).astype(np.float32) * 3
    lab = rng.integers(0, k, n)
    x = torch.from_numpy(cents[lab] + rng.normal(size=(n, d))
                         .astype(np.float32)).to(card)
    c = torch.from_numpy(cents).to(card)
    nr = bounds.point_norms(x)
    t = -(-n // bn)
    s = -(-t // tps)
    zt = torch.zeros(t, device=card)
    gargs = (x, nr, c, torch.zeros(k, device=card), zt, zt,
             torch.zeros(n, dtype=torch.int32, device=card),
             torch.zeros(n, device=card),
             torch.full((n,), -torch.inf, device=card), zt, zt,
             torch.zeros(s, k, d, device=card), torch.zeros(s, k, device=card),
             torch.ones(t, dtype=torch.bool, device=card))
    tol = d2_tol(x.cpu().numpy(), cents)
    for got, again, want in (
            (la.lloyd_assign_gated(*gargs, block_n=bn, tps=tps),
             la.lloyd_assign_gated(*gargs, block_n=bn, tps=tps),
             la.lloyd_assign_gated_torch(*gargs, block_n=bn, tps=tps)),
            (la.lloyd_assign_tiled(x, nr, c, block_n=bn, tps=tps),
             la.lloyd_assign_tiled(x, nr, c, block_n=bn, tps=tps),
             la.lloyd_assign_tiled_torch(x, nr, c, block_n=bn, tps=tps)),
            (la.lloyd_assign(x, nr, c, None, block_n=bn),
             la.lloyd_assign(x, nr, c, None, block_n=bn),
             la.lloyd_assign_torch(x, nr, c, None))):
        assert all(_same_bits(p, q) for p, q in zip(got, again))
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[0].cpu(), torch.from_numpy(lab).int())
        assert float((got[1] - want[1]).abs().max()) <= tol


def _k5_held_to_the_template(card, n, d, m, mask, dtype, bn):
    """The checks of ``test_k5_is_the_template_bitwise`` at one shape."""
    args = _k5_args(card, n, d, m, mask, dtype, 10 * d + m, bn)
    md, parts, tmax, act = args[3], args[7], args[8], args[9]
    want = kd.distance_min_update_gated_template(*args, block_n=bn)
    for resident in (True, False):
        ops.reset_launches()
        got = kd.distance_min_update_gated(*args, block_n=bn,
                                           resident=resident)
        counted = "distance_min_update_gated" + (
            "_bf16" if dtype == torch.bfloat16 else "")
        assert ops.LAUNCHES[counted] == 1 and sum(ops.LAUNCHES.values()) == 1
        _bits(got, want)
        _bits(kd.distance_min_update_gated_template(
            *args, block_n=bn, resident=resident), want)
        carry = md.clone()
        inplace = kd.distance_min_update_gated(
            *args[:3], carry, *args[4:], block_n=bn, resident=resident,
            inplace=True)
        assert inplace[0].data_ptr() == carry.data_ptr()
        _bits(inplace, want)
    skip = ~act
    rows = bounds.expand_mask(skip, bn, n)
    _bits((got[0][rows], got[1][skip], got[2][skip]),
          (md[rows], parts[skip], tmax[skip]))
    assert not got[3][skip].any()
    if mask == "all" and dtype == torch.float32:
        k2 = kd.distance_min_update(*args[:4], block_n=bn)
        _bits(got[:2], k2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 7, 8, 13, 16, 64, 128, 129, 1024])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k7_are_the_template_bitwise(card, d, m, dtype):
    """K2 (K5's row loop ungated at d >= 8, the template body below) against
    its template entry (``distance_min_update_template``) on adversarial
    rows (+inf and NaN carries, a NaN row, duplicated centroids), 9,001
    rows in tiles of 1,024: both outputs bitwise, resident and not; K7
    over three problems bitwise its template entry and row b bitwise K2;
    one counted launch each."""
    n, bn = 9_001, 1024
    x, nr, c, md = _k5_args(card, n, d, m, "all", dtype, 3 * d + m, bn)[:4]
    want = kd.distance_min_update_template(x, nr, c, md, block_n=bn)
    counted = "distance_min_update" + (
        "_bf16" if dtype == torch.bfloat16 else "")
    for resident in (True, False):
        ops.reset_launches()
        got = kd.distance_min_update(x, nr, c, md, block_n=bn,
                                     resident=resident)
        assert ops.LAUNCHES[counted] == 1 and sum(ops.LAUNCHES.values()) == 1
        _bits(got, want)
    xb, nb, cb, mb = (torch.stack([v, v.flip(0), v]) for v in (x, nr, c, md))
    ops.reset_launches()
    k7 = kd.distance_min_update_batched(xb, nb, cb, mb, block_n=bn)
    assert sum(ops.LAUNCHES.values()) == 1
    _bits(k7, kd.distance_min_update_template(xb, nb, cb, mb, block_n=bn))
    for b in range(3):
        _bits((k7[0][b], k7[1][b]), kd.distance_min_update(
            xb[b], nb[b], cb[b], mb[b], block_n=bn))


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["gate", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_and_k2_take_a_block_past_shared_memory(card, mask, dtype):
    """m = 1,024 centroids at d = 64 (the guard heal's fold of all k), whose
    resident block the old staging refused: K5 bitwise its template entry,
    resident and not; K2 and K7 (two problems) resident bitwise
    non-resident, K7's rows bitwise K2."""
    n, d, m, bn = 9_001, 64, 1024, 1024
    args = _k5_args(card, n, d, m, mask, dtype, 64, bn)
    want = kd.distance_min_update_gated_template(*args, block_n=bn,
                                                 resident=False)
    for resident in (True, False):
        _bits(kd.distance_min_update_gated(*args, block_n=bn,
                                           resident=resident), want)
        _bits(kd.distance_min_update_gated_template(
            *args, block_n=bn, resident=resident), want)
    x, nr, c, md = args[:4]
    k2 = kd.distance_min_update(x, nr, c, md, block_n=bn)
    _bits(k2, kd.distance_min_update(x, nr, c, md, block_n=bn,
                                     resident=False))
    _bits(k2, kd.distance_min_update_template(x, nr, c, md, block_n=bn))
    xb, nb, cb, mb = (torch.stack([v, v.flip(0)]) for v in (x, nr, c, md))
    k7 = kd.distance_min_update_batched(xb, nb, cb, mb, block_n=bn)
    _bits(k7, kd.distance_min_update_batched(xb, nb, cb, mb, block_n=bn,
                                             resident=False))
    _bits((k7[0][0], k7[1][0]), k2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 5, 16, 128, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_rows_are_k5(card, d, dtype):
    """K8 over three problems, each with its own state and mask (the
    gate's, all, half): row b bitwise K5 on problem b, in place too, and
    one counted launch."""
    n, m, bn = 9_001, 8, 1024
    probs = [_k5_args(card, n, d, m, mask, dtype, 7 * d + i, bn)
             for i, mask in enumerate(("gate", "all", "half"))]
    args = tuple(torch.stack(v) for v in zip(*probs))
    ops.reset_launches()
    got = kd.distance_min_update_gated_batched(*args, block_n=bn)
    counted = "distance_min_update_gated_batched" + (
        "_bf16" if dtype == torch.bfloat16 else "")
    assert ops.LAUNCHES[counted] == 1 and sum(ops.LAUNCHES.values()) == 1
    for b, one in enumerate(probs):
        _bits(tuple(o[b] for o in got),
              kd.distance_min_update_gated(*one, block_n=bn))
    carry = args[3].clone()
    inplace = kd.distance_min_update_gated_batched(
        *args[:3], carry, *args[4:], block_n=bn, inplace=True)
    assert inplace[0].data_ptr() == carry.data_ptr()
    _bits(inplace, got)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 50])
@pytest.mark.parametrize("mask", ["all", "half"])
def test_lloyd_assign_gated_kernel_matches_plain(card, k, mask):
    """K6 against its plain twin, from a carried state whose point_lb makes
    the prune fire: pruned rows' label, D² and lb (one fp32 subtraction)
    bitwise the plain version's; other labels equal outside near-ties, D²
    and fresh lb within tolerance; active tiles' partials and gaps as K3's
    test holds them; active supers' counts exact and sums within 1e-5 over
    the kernel's labels, pruned rows included; skipped tiles and supers
    bitwise their carries; two launches the same bits; with no carried bound
    and every tile active, bitwise K3."""
    bn, tps = 1024, 4
    x = torch.from_numpy(_sorted_blobs(40_009, 2, max(k, 2), seed=k)) \
        .to(card)
    n = x.shape[0]
    cache = bounds.prologue(x, bn)
    c0 = (x[torch.randperm(n, generator=torch.Generator().manual_seed(k))
            [:k].to(card)] + 0.01).contiguous()
    t = -(-n // bn)
    s = -(-t // tps)
    zeros_lb = torch.full((n,), -torch.inf, device=card)
    base = (torch.zeros(k, device=card), torch.zeros(t, device=card),
            torch.zeros(t, device=card))
    carry0 = (torch.zeros(n, dtype=torch.int32, device=card),
              torch.zeros(n, device=card), zeros_lb,
              torch.zeros(t, device=card), torch.zeros(t, device=card),
              torch.zeros(s, k, 2, device=card),
              torch.zeros(s, k, device=card))
    all_on = torch.ones(t, dtype=torch.bool, device=card)
    first = la.lloyd_assign_gated(x, cache.norms, c0, *base, *carry0, all_on,
                                  block_n=bn, tps=tps)
    k3 = la.lloyd_assign_tiled(x, cache.norms, c0, block_n=bn, tps=tps)
    for g, w in zip((first[0], first[1], first[3], first[4], first[5],
                     first[6]), k3):
        assert torch.equal(g, w)
    c1 = c0.clone()
    if k > 1:
        c1[[0, k - 1]] += 0.002
    st = bounds.BoundState(first[3], tile_gap=first[4], tile_sums=first[5],
                           tile_counts=first[6], assignment=first[0],
                           min_d2=first[1], point_lb=first[2],
                           lb_debt=torch.zeros(t, device=card))
    delta = bounds.centroid_movement(c1, c0)
    thresh, absorb = bounds.assign_point_scalars(delta, c1, st, cache)
    act = all_on if mask == "all" else (
        torch.arange(t, device=card) // tps) % 2 == 0
    args = (x, cache.norms, c1, delta, thresh, absorb, st.assignment,
            st.min_d2, st.point_lb, st.partials, st.tile_gap, st.tile_sums,
            st.tile_counts, act)
    ops.reset_launches()
    got = la.lloyd_assign_gated(*args, block_n=bn, tps=tps)
    again = la.lloyd_assign_gated(*args, block_n=bn, tps=tps)
    assert ops.LAUNCHES["lloyd_assign_gated"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    want = la.lloyd_assign_gated_torch(*args, block_n=bn, tps=tps)
    assert torch.equal(got[7], want[7]) and int(got[7].sum()) > 0
    act_pt = bounds.expand_mask(act, bn, n)
    prune = bounds.assign_point_prune(st.assignment, st.min_d2, st.point_lb,
                                      delta, bounds.expand_mask(thresh, bn, n),
                                      act_pt)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[prune], w[prune])
    xn, cn = x.cpu().numpy(), c1.cpu().numpy()
    tol = d2_tol(xn, cn)
    a = got[0].cpu().numpy()
    assert_labels_match(a, want[0].cpu().numpy(), exact_d2(xn, cn), tol)
    assert float((got[1] - want[1]).abs().max()) <= tol
    fin = torch.isfinite(want[2])          # all +inf at k = 1
    assert torch.equal(torch.isfinite(got[2]), fin)
    fresh = act_pt & ~prune & fin
    if fresh.any():
        assert float((got[2] - want[2])[fresh].abs().max()) \
            <= 2 * np.sqrt(tol)
    on = act.cpu().numpy()
    wp = want[3].cpu().numpy()
    assert (np.abs(got[3].cpu().numpy() - wp)
            <= _partial_tol(tol, bn, wp))[on].all()
    gfin = torch.isfinite(want[4])
    assert torch.equal(torch.isfinite(got[4]), gfin)
    if (gfin & act).any():
        assert float((got[4] - want[4])[gfin & act].abs().max()) \
            <= 2 * np.sqrt(tol)
    _assert_super_sums(xn, a, got[5], got[6], bn * tps,
                       bounds.super_any(act, tps))
    skip = ~act
    rows = bounds.expand_mask(skip, bn, n)
    sup_skip = ~bounds.super_any(act, tps)
    for out, carry, sel in ((got[0], st.assignment, rows),
                            (got[1], st.min_d2, rows),
                            (got[2], st.point_lb, rows),
                            (got[3], st.partials, skip),
                            (got[4], st.tile_gap, skip),
                            (got[5], st.tile_sums, sup_skip),
                            (got[6], st.tile_counts, sup_skip)):
        assert torch.equal(out[sel], carry[sel])
    assert not got[7][skip].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(10_007, 2), (5003, 33), (3001, 40)])
@pytest.mark.parametrize("count", [0, 1, 8])
def test_row_min_d2_kernel_matches_plain(card, n, d, count):
    """K11 bitwise its plain version (the same roundings in the same
    order) for several rows, +inf at count 0; two launches give the same
    bits and each counts once. d = 40 spans more than one lane per
    column pass when staging the row."""
    x = torch.from_numpy(_data(n, d, seed=n)).to(card)
    pend = (x[[7, 100, 2000, 3, 55, 900, 1500, 2500]] + 0.01).contiguous()
    for i in (0, 1234, n - 1):
        idx = torch.tensor(i, device=card)
        ops.reset_launches()
        got = kd.row_min_d2(x, idx, pend, count)
        again = kd.row_min_d2(x, idx, pend, count)
        assert ops.LAUNCHES["row_min_d2"] == 2
        assert torch.equal(got, again)
        want = kd.row_min_d2_torch(x, idx, pend, count)
        assert torch.equal(got, want), (float(got), float(want))
        if count == 0:
            assert float(got) == float("inf")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1_000_003, 2), (100_003, 33)])
@pytest.mark.parametrize("count", [0, 1, 8])
def test_tile_cap_kernel_matches_plain(card, n, d, count):
    """K12 bitwise its plain version on the prologue's tile balls (more
    tiles than one block holds), +inf everywhere at count 0; two launches
    give the same bits and each counts once."""
    x = torch.from_numpy(_data(n, d, seed=d)).to(card)
    cache = bounds.prologue(x, 1024)
    pend = (x[[7, 100, 2000, 3, 55, 900, 1500, 2500]] + 0.01).contiguous()
    cnt = torch.tensor(count, dtype=torch.int32, device=card)
    ops.reset_launches()
    got = kd.tile_cap(cache.centers, cache.radii, pend, cnt)
    again = kd.tile_cap(cache.centers, cache.radii, pend, cnt)
    assert ops.LAUNCHES["tile_cap"] == 2
    assert torch.equal(got, again)
    assert torch.equal(got, kd.tile_cap_torch(cache.centers, cache.radii,
                                              pend, cnt))
    if count == 0:
        assert bool(torch.isinf(got).all())
    else:
        assert bool(torch.isfinite(got).all())


def _same_bits(a, b) -> bool:
    """Bitwise equality, fp32 compared as int32 patterns (NaN equals NaN)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d,a", [(2, 1), (2, 8), (33, 8), (60_000, 1),
                                 (60_000, 8)])
@pytest.mark.parametrize("count", [0, 1, 8])
def test_row_min_d2_prices_many_rows_in_one_launch(card, d, a, count):
    """K11's (A,) form: one launch for A drawn rows (an index outside
    [0, n) among them when A = 8), bitwise the plain version and, entry by
    entry, the 0-d launch; NaN at the bad indices; two launches the same
    bits; the row read from device memory, so d = 60,000 too."""
    n = 5003 if d < 1000 else 40
    x = torch.from_numpy(_data(n, d, seed=d)).to(card)
    pend = (x[[7, 1, 20, 3, 5, 9, 15, 25]] + 0.01).contiguous()
    idx = torch.tensor([0, n - 1, 7, -1, n, 13, 5, 7][:a], device=card)
    ops.reset_launches()
    got = kd.row_min_d2(x, idx, pend, count)
    again = kd.row_min_d2(x, idx, pend, count)
    assert ops.LAUNCHES["row_min_d2"] == 2
    assert got.shape == (a,)
    assert _same_bits(got, again)
    assert _same_bits(got, kd.row_min_d2_torch(x, idx, pend, count))
    for j in range(a):
        assert _same_bits(got[j], kd.row_min_d2(x, idx[j], pend, count))
        bad = not 0 <= int(idx[j]) < n
        assert bool(torch.isnan(got[j])) == bad
        if count == 0 and not bad:
            assert float(got[j]) == float("inf")


@pytest.mark.cuda
@pytest.mark.parametrize("p,d", [(8, 8000), (64, 1000), (8, 20_000),
                                 (3, 2)])
@pytest.mark.parametrize("count", [0, 1, "P"])
def test_tile_cap_takes_any_pending_block(card, p, d, count):
    """K12 past the old shared-memory cap (a (P, d) block of more than
    58,112 floats): whole slots a stage, or one slot in column chunks past
    12,288 columns; bitwise the plain version, two launches the same
    bits."""
    count = p if count == "P" else count
    gen = torch.Generator(device=card).manual_seed(d)
    t = 300
    centers = torch.randn((t, d), generator=gen, device=card)
    radii = torch.rand(t, generator=gen, device=card)
    pend = torch.randn((p, d), generator=gen, device=card)
    cnt = torch.tensor(count, dtype=torch.int32, device=card)
    ops.reset_launches()
    got = kd.tile_cap(centers, radii, pend, cnt)
    again = kd.tile_cap(centers, radii, pend, cnt)
    assert ops.LAUNCHES["tile_cap"] == 2
    assert _same_bits(got, again)
    assert _same_bits(got, kd.tile_cap_torch(centers, radii, pend, cnt))
    assert bool(torch.isinf(got).all()) == (count == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["FULL", "(8, 8000)"])
@pytest.mark.parametrize("tile_w_kind", ["counts", "weighted", "special"])
def test_tile_envelope_is_its_twin_on_the_card(card, shape, tile_w_kind):
    """The hier round's tile envelope in one launch, counted as K12: its
    four outputs (caps, capped masses, tight tiles, their count) bitwise
    the twin's on the card at count 0, 1 and P, at the paper's 977 tiles
    (4M rows, d = 2) and at a (8, 8,000) pending block; tile masses of
    rows, weighted with a zero tile, or with NaN, +inf and 0 (and a NaN and
    +inf partial); two launches the same bits; its counters back at 0."""
    gen = torch.Generator(device=card).manual_seed(7)
    if shape == "FULL":
        x = torch.from_numpy(_data(4_000_000, 2, seed=2)).to(card)
        cache = bounds.prologue(x, 4096)
        centers, radii = cache.centers, cache.radii
        pend = (x[[7, 100, 2000, 3, 55, 900, 1500, 2500]] + 0.01).contiguous()
        md = kd.row_min_d2_torch(x, torch.arange(x.shape[0], device=card),
                                 pend[:1], 1)
        partials = tile_partials(md, 4096)
        rows = tile_partials(torch.ones(x.shape[0], device=card), 4096)
    else:
        t, d = 157, 8000
        centers = torch.randn((t, d), generator=gen, device=card)
        radii = torch.rand(t, generator=gen, device=card)
        pend = torch.randn((8, d), generator=gen, device=card)
        partials = 128 * (2 * d + 40) * torch.rand(t, generator=gen,
                                                   device=card)
        rows = torch.full((t,), 128.0, device=card)
    t = partials.shape[0]
    if tile_w_kind == "counts":
        tile_w = rows
    elif tile_w_kind == "weighted":
        tile_w = rows * torch.rand(t, generator=gen, device=card)
        tile_w[0] = 0.0
    else:
        tile_w = torch.linspace(0.5, 40.0, t, device=card)
        tile_w[[1, 4, 9]] = torch.tensor([torch.nan, torch.inf, 0.0],
                                         device=card)
        partials = partials.clone()
        partials[[2, 9]] = torch.tensor([torch.nan, torch.inf], device=card)
    for count in (0, 1, 8):
        cnt = torch.tensor(count, dtype=torch.int32, device=card)
        ops.reset_launches()
        got = kd.tile_envelope(centers, radii, pend, cnt, partials, tile_w)
        again = kd.tile_envelope(centers, radii, pend, cnt, partials, tile_w)
        assert ops.LAUNCHES["tile_cap"] == 2
        assert sum(ops.LAUNCHES.values()) == 2
        want = kd.tile_envelope_torch(centers, radii, pend, cnt, partials,
                                      tile_w)
        for g, a, w in zip(got, again, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert _same_bits(g, a) and _same_bits(g, w)
        torch.cuda.synchronize()
        assert all(not c.any() for key, c in ops._ARRIVALS.items()
                   if key[0] == "tile_envelope")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 5, 16, 17, 128, 257, 300, 9588,
                               9589, 20_000])
@pytest.mark.parametrize("block_n", [128, 1024, 4096])
def test_k1_is_the_template_bitwise(card, d, block_n):
    """K1 bitwise the template entry in all four outputs, on ragged n (the
    last tile short; the lone route staging all of a tile or its first
    rows, the rest from device memory), on the route the width picks: the
    lone route up to d = 9,588, the wide route past it; two launches the
    same bits, each counted once. d = 3, 5, 17, 300: lane counts that are
    no power of two."""
    n = 2 * block_n + 77
    x = torch.from_numpy(_data(n, d, seed=d + block_n)).to(card)
    want = kd.seed_prologue_template(x, block_n)
    assert kd.prologue_route(d, block_n) == (1 if d <= 9588 else 0)
    ops.reset_launches()
    got = kd.seed_prologue(x, block_n)
    again = kd.seed_prologue(x, block_n)
    assert ops.LAUNCHES["seed_prologue"] == 2
    for g, a, w in zip(got, again, want):
        assert _same_bits(g, w), (g, w)
        assert _same_bits(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 16, 17])
def test_k1_batched_rows_are_k1(card, d):
    """The batched K1 bitwise the batched template entry, and row b
    bitwise the single K1 on problem b."""
    bsz, n, bn = 5, 3001, 1024
    xb = torch.from_numpy(_data(bsz * n, d, seed=d)).reshape(bsz, n, d) \
        .to(card)
    want = kd.seed_prologue_template(xb, bn)
    ops.reset_launches()
    got = kd.seed_prologue_batched(xb, bn)
    assert ops.LAUNCHES["seed_prologue_batched"] == 1
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    for b in range(bsz):
        single = kd.seed_prologue(xb[b], bn)
        assert all(_same_bits(g[b], s) for g, s in zip(got, single))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 6, 16, 32])
def test_k1_reads_unaligned_points(card, d):
    """Points one float past a 16-byte boundary (a contiguous view at
    storage offset 1): the bulk copies' unaligned ends are copied by the
    threads, rows read by float; bitwise the template entry."""
    n, bn = 5000, 1024
    flat = torch.from_numpy(_data(1, n * d + 1, seed=d)).reshape(-1).to(card)
    x = flat[1:].view(n, d)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    want = kd.seed_prologue_template(x, bn)
    got = kd.seed_prologue(x, bn)
    assert all(_same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_k1_takes_any_width(card):
    """d = 60,000: the template entry refuses (its center does not fit
    beside 256 floats of shared memory) and K1 takes the wide route, held
    to the plain twin: norms bitwise ``bounds.point_norms``, centers within
    block_n roundings of the largest coordinate, radii and center_d within
    d roundings (sums of d squares in two orders); two launches the same
    bits."""
    from repro_torch.core.guards import KernelFailureError
    n, d, bn = 300, 60_000, 128
    x = torch.from_numpy(_data(n, d, seed=1)).to(card)
    with pytest.raises(KernelFailureError):
        kd.seed_prologue_template(x, bn)
    assert kd.prologue_route(d, bn) == 0
    got = kd.seed_prologue(x, bn)
    again = kd.seed_prologue(x, bn)
    assert all(_same_bits(g, a) for g, a in zip(got, again))
    assert torch.equal(got[0], bounds.point_norms(x))
    want = kd.seed_prologue_torch(x, bn)
    scale = float(x.abs().max())
    assert float((got[1] - want[1]).abs().max()) <= bn * EPS32 * scale
    for g, w in zip(got[2:], want[2:]):
        assert bool(((g - w).abs() <= d * EPS32 * w.abs() + 1e-6).all())
