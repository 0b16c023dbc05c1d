"""The port's bound machinery (``repro_torch.core.bounds``) against
``repro.core.bounds``.

Both sides get the same inputs, made from a seed with numpy; where a
function reads a prologue cache or a carried state, the reference's is
carried over through ``convert`` so both evaluate the same bound. Masks are
held equal. Floats are held to the tolerance each test states: the two sides
round the same formulas in different summation orders.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_jaxref import EPS32, np32, ref  # noqa: F401  (ref is a fixture)
from repro_torch import convert
from repro_torch.core import bounds


def _t(x):
    return torch.from_numpy(np.array(x))


def _cache_pair(ref, x, block_n):
    """The reference's prologue and the same arrays as the port's."""
    rc = ref.bounds.prologue(ref.jnp.asarray(x), block_n)
    return rc, convert.round_cache(rc)


@pytest.mark.parametrize("n,d,block_n", [(1000, 2, 128), (777, 5, 256),
                                         (300, 16, 512)])
@pytest.mark.parametrize("with_bounds", [True, False])
def test_prologue_matches_reference(ref, n, d, block_n, with_bounds):
    """Norms within d roundings of ‖x‖² (bitwise at d = 2, where both add
    two products); centers within n·eps of the largest coordinate (a mean
    of up to block_n rows, in two orders); radii and center_d within
    1e-5 of the tile's scale (square roots of sums of d squares)."""
    x = np.random.default_rng(n + d).normal(size=(n, d)).astype(np.float32)
    want = ref.bounds.prologue(ref.jnp.asarray(x), block_n,
                               with_bounds=with_bounds)
    got = bounds.prologue(_t(x), block_n, with_bounds=with_bounds)
    wn = np32(want.norms)
    if d == 2:
        np.testing.assert_array_equal(got.norms.numpy(), wn)
    np.testing.assert_allclose(got.norms.numpy(), wn, rtol=d * EPS32)
    if not with_bounds:
        assert got.centers is None and want.centers is None
        return
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(got.centers.numpy(), np32(want.centers),
                               rtol=0, atol=block_n * EPS32 * scale)
    np.testing.assert_allclose(got.radii.numpy(), np32(want.radii), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got.center_d.numpy(), np32(want.center_d),
                               rtol=0, atol=1e-5 * scale)


def test_point_norms_add_columns_in_order():
    """The norms the kernels stream: ascending columns, one rounded product
    and one rounded add each (what K1 reproduces bitwise)."""
    x = np.random.default_rng(0).normal(size=(200, 7)).astype(np.float32)
    want = x[:, 0] * x[:, 0]
    for j in range(1, 7):
        want = (want + x[:, j] * x[:, j]).astype(np.float32)
    np.testing.assert_array_equal(bounds.point_norms(_t(x)).numpy(), want)


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("offset", [0.0, 100.0])
def test_seed_gate_matches_reference(ref, m, offset):
    """Both levels of the seeding gate on the same cache and carried
    tile_max: the active mask and the per-point prune mask equal; dc and
    margin within 1e-5 relative (a matmul and a square root apart)."""
    rng = np.random.default_rng(m)
    x = (np.sort(rng.normal(size=(2000, 2)), axis=0) + offset) \
        .astype(np.float32)
    rc, pc = _cache_pair(ref, x, 128)
    c = x[rng.choice(2000, m, replace=False)] + 0.3
    prev = x[rng.choice(2000, 4, replace=False)]
    md = ((x[:, None, :] - prev[None]) ** 2).sum(-1).min(1).astype(np.float32)
    tmax = np.asarray(ref.bounds.tile_reduce_max(ref.jnp.asarray(md), 128))
    wa, wdc, wmg = ref.bounds.seed_gate(ref.jnp.asarray(c), rc,
                                        ref.jnp.asarray(tmax))
    ga, gdc, gmg = bounds.seed_gate(_t(c), pc, _t(tmax))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    if offset == 0.0:        # far from the origin the margin keeps all
        assert 0 < int(ga.sum()) < ga.shape[0]
    np.testing.assert_allclose(gdc.numpy(), np32(wdc), rtol=1e-5)
    np.testing.assert_allclose(gmg.numpy(), np32(wmg), rtol=1e-5)
    # the fine level on the reference's dc/margin, expanded per point
    n = x.shape[0]
    wdc_pt = ref.bounds.expand_mask(wdc, 128, n)
    wmg_pt = ref.bounds.expand_mask(wmg, 128, n)
    want = ref.bounds.seed_point_prune(ref.jnp.asarray(md), rc.center_d,
                                       wdc_pt, wmg_pt)
    got = bounds.seed_point_prune(_t(md), pc.center_d, _t(wdc_pt),
                                  _t(wmg_pt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < n


@pytest.mark.parametrize("n,block_n", [(1000, 128), (256, 64), (5, 8)])
def test_tile_helpers_match_reference(ref, n, block_n):
    """expand_mask and tile_reduce_max equal; n_active is the count the
    reference's compact_ids floors at one tile."""
    rng = np.random.default_rng(n)
    t = -(-n // block_n)
    act = rng.random(t) < 0.5
    np.testing.assert_array_equal(
        bounds.expand_mask(_t(act), block_n, n).numpy(),
        np.asarray(ref.bounds.expand_mask(ref.jnp.asarray(act), block_n, n)))
    x = rng.exponential(size=n).astype(np.float32)
    np.testing.assert_array_equal(
        bounds.tile_reduce_max(_t(x), block_n).numpy(),
        np.asarray(ref.bounds.tile_reduce_max(ref.jnp.asarray(x), block_n)))
    for mask in (act, np.zeros(t, bool), np.ones(t, bool)):
        _, wna = ref.bounds.compact_ids(ref.jnp.asarray(mask))
        assert int(bounds.n_active(_t(mask))) == int(wna) \
            == max(int(mask.sum()), 1)


@pytest.mark.parametrize("n_tiles,tps", [(9, 4), (16, 4), (7, 1), (5, 8)])
def test_super_masks_match_reference(ref, n_tiles, tps):
    """expand_active_supers (floored at one super) and super_any: equal,
    for a random mask and for the all-skipped one."""
    rng = np.random.default_rng(n_tiles * tps)
    for act in (rng.random(n_tiles) < 0.3, np.zeros(n_tiles, bool)):
        ja = ref.jnp.asarray(act)
        np.testing.assert_array_equal(
            bounds.expand_active_supers(_t(act), tps).numpy(),
            np.asarray(ref.bounds.expand_active_supers(ja, tps)))
        np.testing.assert_array_equal(
            bounds.super_any(_t(act), tps).numpy(),
            np.asarray(ref.bounds.super_any(ja, tps)))


def _assign_state(rng, n, d, k, block_n, tps):
    """A carried assignment state in the reference's layout: labels, D²,
    lower bounds, per-tile gaps/debt and per-super counts with some clusters
    empty per super."""
    t = -(-n // block_n)
    s = -(-t // tps)
    counts = rng.integers(0, 3, size=(s, k)).astype(np.float32)
    a = rng.integers(0, k, size=n).astype(np.int32)
    md = rng.exponential(size=n).astype(np.float32) * 0.1
    lb = (np.sqrt(md) + rng.exponential(size=n) * 0.5).astype(np.float32)
    return SimpleNamespace(
        partials=rng.random(t).astype(np.float32),
        tile_gap=(rng.random(t) * 0.2).astype(np.float32),
        tile_sums=rng.normal(size=(s, k, d)).astype(np.float32),
        tile_counts=counts, assignment=a, min_d2=md, point_lb=lb,
        lb_debt=(rng.random(t) * 0.05).astype(np.float32))


@pytest.mark.parametrize("moved", ["none", "some"])
def test_assign_gate_matches_reference(ref, moved):
    """The assignment gate on the same cache, state and movement: the tile
    mask and the per-point prune mask equal, thresh/absorb and the decayed
    gap within 1e-6 relative, centroid_movement within 2 eps relative."""
    rng = np.random.default_rng(len(moved))
    n, d, k, bn, tps = 1500, 3, 6, 128, 4
    x = np.sort(rng.normal(size=(n, d)), axis=0).astype(np.float32)
    rc, pc = _cache_pair(ref, x, bn)
    c_old = rng.normal(size=(k, d)).astype(np.float32)
    c_new = c_old.copy()
    if moved == "some":
        c_new[[1, 4]] += 0.01
    st = _assign_state(rng, n, d, k, bn, tps)
    rst = ref.bounds.BoundState(**{f: ref.jnp.asarray(v)
                                   for f, v in vars(st).items()})
    pst = convert.bound_state(st)
    jd = ref.bounds.centroid_movement(ref.jnp.asarray(c_new),
                                      ref.jnp.asarray(c_old))
    gd = bounds.centroid_movement(_t(c_new), _t(c_old))
    np.testing.assert_allclose(gd.numpy(), np32(jd), rtol=2 * EPS32)
    assert (gd.numpy() == 0).sum() == (np32(jd) == 0).sum()
    delta = np32(jd)
    want = ref.bounds.assign_active_tiles(ref.jnp.asarray(delta),
                                          ref.jnp.asarray(c_new), rst, rc,
                                          tps=tps)
    got = bounds.assign_active_tiles(_t(delta), _t(c_new), pst, pc, tps=tps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if moved == "none":
        assert 0 < int(got.sum()) < got.shape[0]
    wth, wab = ref.bounds.assign_point_scalars(
        ref.jnp.asarray(delta), ref.jnp.asarray(c_new), rst, rc)
    gth, gab = bounds.assign_point_scalars(_t(delta), _t(c_new), pst, pc)
    np.testing.assert_allclose(gth.numpy(), np32(wth), rtol=1e-6)
    np.testing.assert_allclose(gab.numpy(), np32(wab), rtol=1e-6)
    th_pt = np32(ref.bounds.expand_mask(wth, bn, n))
    valid = rng.random(n) < 0.9
    wp = ref.bounds.assign_point_prune(
        ref.jnp.asarray(st.assignment), ref.jnp.asarray(st.min_d2),
        ref.jnp.asarray(st.point_lb), ref.jnp.asarray(delta),
        ref.jnp.asarray(th_pt), ref.jnp.asarray(valid))
    gp = bounds.assign_point_prune(_t(st.assignment), _t(st.min_d2),
                                   _t(st.point_lb), _t(delta), _t(th_pt),
                                   _t(valid))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert 0 < int(gp.sum()) < n
    fresh = rng.random(got.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(
        bounds.decay_gap(pst.tile_gap, got, _t(fresh), gd.max()).numpy(),
        np.asarray(ref.bounds.decay_gap(rst.tile_gap, want,
                                        ref.jnp.asarray(fresh),
                                        ref.jnp.max(jd))))


def test_convert_carries_reference_state(ref):
    """convert.round_cache / bound_state keep every field's values, with the
    port's dtypes, and leave unset fields None."""
    x = np.random.default_rng(3).normal(size=(300, 2)).astype(np.float32)
    rc, pc = _cache_pair(ref, x, 128)
    for f in ("norms", "centers", "radii", "center_d"):
        np.testing.assert_array_equal(getattr(pc, f).numpy(),
                                      np.asarray(getattr(rc, f)))
    seed_state = ref.bounds.BoundState(ref.jnp.zeros(3),
                                       ref.jnp.full((3,), np.inf))
    ps = convert.bound_state(seed_state)
    assert ps.tile_gap is None and torch.isinf(ps.tile_max).all()
    st = convert.bound_state(_assign_state(np.random.default_rng(0), 300, 2,
                                           4, 128, 2))
    assert st.assignment.dtype == torch.int32
    assert st.tile_sums.dtype == torch.float32
