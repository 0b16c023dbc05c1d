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
from repro_torch.data import blobs
from repro_torch.kernels import kmeans_distance as kd
from repro_torch.kernels import lloyd_assign as la
from repro_torch.kernels import ops


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


def _k6_inputs(ref, k, mask, n=2400, block_n=128, tps=4):
    """A carried state from one round of the reference's tiled kernel on
    label-sorted blobs, its centroids moved slightly for two clusters (or
    none at k = 1), the per-point lower bound sqrt(second best) − 1e-3 of
    the previous round, and the mask: the reference's gate, all tiles, or
    half the supers."""
    jnp = ref.jnp
    x = _sorted_blobs(n, 2, max(k, 2), seed=k)
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
    bn, tps = 128, 4
    x, cache, c1, st, delta, thresh, absorb, act = _k6_inputs(ref, k, mask)
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
    assert set(ops.LAUNCHES) == {
        "seed_prologue", "distance_min_update", "lloyd_assign_tiled",
        "distance_min_update_gated", "lloyd_assign_gated", "row_min_d2",
        "tile_cap", "distance_min_update_batched",
        "lloyd_assign_tiled_batched"}
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
