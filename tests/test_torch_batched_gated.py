"""Gated batched clustering in the port against ``repro.core.engine``.

``ClusterEngine.seed_batched``, ``fit_batched`` and ``kmeans_batched`` with
``bounds=True`` (the default) cluster B independent problems in one loop,
each gated by its own bound state: one batched prologue (K1's batched form
on the card) per phase, one gated seeding round (K8
``distance_min_update_gated_batched``) per round and one gated assignment
round (K10b ``lloyd_assign_gated_batched``) per Lloyd iteration for all B.
The reference vmaps its gated single-problem loops, and its Pallas
backend's ``custom_vmap`` rules send the rounds to its gated batch-grid
kernels (``repro/kernels/kmeans_distance.py:540``, ``lloyd_assign.py:609``),
run here in interpret mode, on the reference's draws
(``test_torch_jaxref.batched_draws_for``) and tile geometry
(``convert.with_geometry``). Seeds, ``n_iters`` and the skip and prune
counters of every problem are held to the reference's.

Inside the port, row b of every gated batched result is held bitwise to
the single gated ``seed`` and ``fit`` with ``draws[b]``, counters included,
on all three backends; the gated batched results bitwise to the ungated
ones; the plain twins of the batched K1, K8 and K10b row by row to those of
K1, K5 and K6; and the batched gate arithmetic row by row to the single.
Tests marked ``cuda`` hold the three kernels against their twins and row b
bitwise against K1/K5/K6 on the card, and the gated batched engine against
the ungated and the single one.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_batched import (_assert_rows_fit, _card_tol,
                                _prev_centroids, _row, _same,
                                card)  # noqa: F401  (card is a fixture)
from test_torch_jaxref import (EPS32, batched_draws_for, d2_tol,
                               ref)  # noqa: F401  (ref is a fixture)
from repro_torch import convert
from repro_torch.configs import KVQUANT_SMOKE
from repro_torch.core import ClusterEngine, Draws, bounds, make_backend
from repro_torch.data import blobs, blobs_batched
from repro_torch.kernels import kmeans_distance as kd
from repro_torch.kernels import lloyd_assign as la
from repro_torch.kernels import ops

B, N, K, SEED = 3, 1500, 6, 3     # N is not a multiple of any tile height
PAIRS = [("cuda", "pallas"), ("fused", "fused")]   # (port, reference)
LAYOUTS = ["shuffled", "sorted"]


def _problems(d, layout, n=N, k=K, seed=0):
    """B blob problems; 'sorted' orders each problem's rows by blob, so the
    tile gate has tiles to skip."""
    out = []
    for b in range(B):
        pts, lab = blobs(n, d, k, seed=seed + 7 * b)
        out.append(pts[np.argsort(lab, kind="stable")]
                   if layout == "sorted" else pts)
    return np.stack(out)


def _engines(ref, port_be, ref_be, n, d, block_n, k=K):
    """The reference's gated engine at tile height ``block_n`` and a port
    engine at its geometry (``block_n`` is below both phases' picks)."""
    rbe = ref.engine.make_backend(ref_be, block_n=block_n)
    assert rbe.seed_tile(n, d) == rbe.seed_tile(n, d, k) == block_n
    tps = rbe.tiles_per_super(-(-n // block_n))
    be = convert.with_geometry(make_backend(port_be), block_n, tps)
    return ref.engine.ClusterEngine(rbe), ClusterEngine(be, device="cpu")


def _assert_counters(got, want, n_rounds=None):
    """Per problem and round: skipped tiles within ±1 of the reference's
    (the two prologues agree to ulps only), pruned rows equal where the
    skips agree; with ``n_rounds`` (B,), both sides zero from each
    problem's own stop on."""
    gs, gp = got.skipped.numpy(), got.pruned.numpy()
    ws, wp = np.asarray(want.skipped), np.asarray(want.pruned)
    assert gs.shape == ws.shape and gp.shape == wp.shape
    assert got.skipped.dtype == got.pruned.dtype == torch.int32
    assert (np.abs(gs - ws) <= 1).all(), (gs, ws)
    eq = gs == ws
    np.testing.assert_array_equal(gp[eq], wp[eq])
    if n_rounds is not None:
        for b, it in enumerate(np.asarray(n_rounds)):
            for arr in (gs, gp, ws, wp):
                assert not arr[b, it:].any(), (b, it, arr[b])


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("d", [2, 5])
@pytest.mark.parametrize("port_be,ref_be", PAIRS)
def test_gated_seed_batched_matches_reference(ref, layout, sampler, d,
                                              port_be, ref_be):
    """Every problem's seeds are the reference's, exactly; the centroids are
    those rows bitwise, the final D² within the D² tolerance; the (B, k)
    skip and prune counters as ``_assert_counters`` holds them."""
    pts = _problems(d, layout)
    reng, eng = _engines(ref, port_be, ref_be, N, d, 128)
    want = reng.seed_batched(ref.jax.random.PRNGKey(SEED),
                             ref.jnp.asarray(pts), K, sampler=sampler)
    got = eng.seed_batched(pts, K, draws=batched_draws_for(SEED, B, N, K),
                           sampler=sampler)
    idx = got.indices.numpy()
    np.testing.assert_array_equal(idx, np.asarray(want.indices))
    for b in range(B):
        np.testing.assert_array_equal(got.centroids[b].numpy(),
                                      pts[b][idx[b]])
        np.testing.assert_allclose(got.min_d2[b].numpy(),
                                   np.asarray(want.min_d2)[b], rtol=0,
                                   atol=d2_tol(pts[b], pts[b][idx[b]]))
    assert got.skipped.shape == (B, K)
    _assert_counters(got, want)
    assert int(got.pruned.sum()) > 0
    if layout == "sorted":
        assert int(got.skipped.sum()) > 0


@pytest.mark.parametrize("empty", ["keep", "reseed"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("port_be,ref_be", PAIRS)
def test_gated_fit_batched_matches_reference(ref, empty, layout, port_be,
                                             ref_be):
    """From the reference's seeds (under 'reseed' one problem's last
    centroid far outside its data), ``tol`` > 0, more than one super-tile
    per problem: each problem's ``n_iters`` is the reference's, the fit as
    ``test_torch_batched._assert_rows_fit`` holds it, and the (B,
    max_iters) counters as ``_assert_counters`` does, zero from each
    problem's stop on."""
    d, tol = 5, 1e-4
    pts = _problems(d, layout, seed=1)
    reng, eng = _engines(ref, port_be, ref_be, N, d, 128)
    assert eng.backend.tiles_per_super(-(-N // 128)) > 1
    init = np.asarray(reng.seed_batched(ref.jax.random.PRNGKey(SEED),
                                        ref.jnp.asarray(pts), K).centroids)
    init = init.copy()
    if empty == "reseed":
        init[1, -1] = pts[1].max(0) + 50.0
    kw = dict(max_iters=25, tol=tol, empty=empty)
    want = reng.fit_batched(ref.jnp.asarray(pts), ref.jnp.asarray(init),
                            **kw)
    got = eng.fit_batched(pts, init, **kw)
    its = np.asarray(want.n_iters)
    if empty == "keep":
        assert len(set(its.tolist())) > 1
    prev = _prev_centroids(reng, ref, pts, init, its, tol=tol, empty=empty)
    _assert_rows_fit(got, convert.lloyd_result(*want[:4]), pts, prev)
    assert got.skipped.shape == (B, 25)
    _assert_counters(got, want, its)
    assert int(got.pruned.sum()) > 0


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("port_be,ref_be", PAIRS)
def test_gated_kmeans_batched_matches_reference(ref, sampler, port_be,
                                                ref_be):
    """``kmeans_batched`` end to end on label-sorted problems: the seeds
    exactly, then the fit and its counters as
    ``test_gated_fit_batched_matches_reference`` holds them."""
    d = 5
    pts = _problems(d, "sorted", seed=2)
    reng, eng = _engines(ref, port_be, ref_be, N, d, 128)
    key = ref.jax.random.PRNGKey(SEED)
    want_seed = reng.seed_batched(key, ref.jnp.asarray(pts), K,
                                  sampler=sampler)
    want = reng.kmeans_batched(key, ref.jnp.asarray(pts), K, sampler=sampler,
                               max_iters=25)
    draws = batched_draws_for(SEED, B, N, K)
    seeds = eng.seed_batched(pts, K, draws=draws, sampler=sampler)
    np.testing.assert_array_equal(seeds.indices.numpy(),
                                  np.asarray(want_seed.indices))
    _assert_counters(seeds, want_seed)
    got = eng.kmeans_batched(pts, K, draws=draws, sampler=sampler,
                             max_iters=25)
    prev = _prev_centroids(reng, ref, pts, np.asarray(want_seed.centroids),
                           want.n_iters)
    _assert_rows_fit(got, convert.lloyd_result(*want[:4]), pts, prev)
    _assert_counters(got, want, want.n_iters)


def test_gated_kvquant_smoke_matches_reference(ref):
    """The CPU-sized codebook sweep (``KVQUANT_SMOKE``: d = 16, the d = 16
    register path's width on the card), gated, against the reference's
    interpreted gated batch-grid kernels: seeds exact, the fit and every
    counter as above."""
    cfg = KVQUANT_SMOKE
    pts = blobs_batched(cfg.batch, cfg.n_points, cfg.dim, cfg.k,
                        generator=torch.Generator().manual_seed(0),
                        sort=True).numpy()
    reng, eng = _engines(ref, "cuda", "pallas", cfg.n_points, cfg.dim, 256,
                         cfg.k)
    key = ref.jax.random.PRNGKey(SEED)
    want_seed = reng.seed_batched(key, ref.jnp.asarray(pts), cfg.k)
    want = reng.fit_batched(ref.jnp.asarray(pts), want_seed.centroids,
                            max_iters=cfg.max_iters)
    draws = batched_draws_for(SEED, cfg.batch, cfg.n_points, cfg.k)
    seeds = eng.seed_batched(pts, cfg.k, draws=draws)
    np.testing.assert_array_equal(seeds.indices.numpy(),
                                  np.asarray(want_seed.indices))
    _assert_counters(seeds, want_seed)
    got = eng.kmeans_batched(pts, cfg.k, draws=draws,
                             max_iters=cfg.max_iters)
    prev = _prev_centroids(reng, ref, pts, np.asarray(want_seed.centroids),
                           want.n_iters)
    _assert_rows_fit(got, convert.lloyd_result(*want[:4]), pts, prev)
    _assert_counters(got, want, want.n_iters)
    assert int(seeds.pruned.sum()) > 0 and int(got.pruned.sum()) > 0


# ---------------------------------------------------------------------------
# inside the port: row b is the single gated problem, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("backend", ["reference", "fused", "cuda"])
def test_gated_batched_rows_are_the_single_gated_runs(backend, sampler,
                                                      layout):
    """Row b of gated seed_batched / fit_batched / kmeans_batched is bitwise
    the single gated ``seed`` then ``fit`` of problem b with ``draws[b]``,
    counters included, the problems stopping at different iterations; and
    every gated batched result is bitwise the ungated batched one."""
    d, tol = 5, 1e-4
    pts = _problems(d, layout, seed=3)
    eng = ClusterEngine(backend, device="cpu", block_n=128)
    off = ClusterEngine(backend, device="cpu", block_n=128, bounds=False)
    draws = Draws.sample_batched(B, N, K,
                                 generator=torch.Generator().manual_seed(5))
    seeds = eng.seed_batched(pts, K, draws=draws, sampler=sampler)
    kw = dict(max_iters=25, tol=tol)
    fit = eng.fit_batched(pts, seeds.centroids, **kw)
    km = eng.kmeans_batched(pts, K, draws=draws, sampler=sampler, **kw)
    assert len(set(fit.n_iters.tolist())) > 1
    fields = ("centroids", "assignment", "inertia", "n_iters")
    _same(off.seed_batched(pts, K, draws=draws, sampler=sampler), seeds,
          ("indices", "centroids", "min_d2"))
    _same(off.fit_batched(pts, seeds.centroids, **kw), fit, fields)
    _same(fit, km, fields + ("skipped", "pruned"))
    for b in range(B):
        one = eng.seed(pts[b], K, draws=draws[b], sampler=sampler)
        _same(one, _row(seeds, b),
              ("indices", "centroids", "min_d2", "skipped", "pruned"))
        single = eng.fit(pts[b], one.centroids, **kw)
        _same(single, _row(fit, b), fields + ("skipped", "pruned"))
    assert int(seeds.pruned.sum()) > 0 and int(fit.pruned.sum()) > 0
    if layout == "sorted":
        assert int(seeds.skipped.sum()) > 0 and int(fit.skipped.sum()) > 0


def test_gated_batched_reseed_rows_are_the_single_runs():
    """Under empty='reseed', with one problem's centroid far outside its
    data (a cluster empties and jumps), row b of the gated fit_batched is
    the single gated fit bitwise, counters included."""
    pts = _problems(2, "sorted", seed=4)
    eng = ClusterEngine(device="cpu", block_n=128)
    init = torch.from_numpy(np.stack([p[[0, 300, 600, 900, 1200, 1499]]
                                      for p in pts]))
    init[2, 0] = torch.from_numpy(pts[2].max(0) + 50.0)
    kw = dict(max_iters=15, tol=1e-4, empty="reseed")
    fit = eng.fit_batched(pts, init, **kw)
    for b in range(B):
        _same(eng.fit(pts[b], init[b], **kw), _row(fit, b),
              ("centroids", "assignment", "inertia", "n_iters", "skipped",
               "pruned"))


def _seed_state(dev, bsz, n, d, m, bn, gen_seed=0):
    """A mid-seeding gated state of ``bsz`` label-sorted problems on
    ``dev``: the batched prologue, the D² to two earlier seeds, its tile
    partials and maxima as the carries, m new centroids per problem and
    their gate."""
    g = torch.Generator(device=dev).manual_seed(gen_seed)
    x = blobs_batched(bsz, n, d, 4, generator=g, spread=0.03, sort=True)
    cache = bounds.RoundCache(*kd.seed_prologue_torch(x, bn))
    idx = torch.randint(n, (bsz, m + 2, 1), generator=g, device=dev)
    pick = torch.take_along_dim(x, idx, dim=1)
    md = kd.distance_min_update_batched_torch(
        x, cache.norms, pick[:, m:].contiguous(),
        torch.full((bsz, n), torch.inf, device=dev), block_n=bn)[0]
    c = pick[:, :m].contiguous()
    tmax = bounds.tile_reduce_max(md, bn)
    parts = kd.distance_min_update_batched_torch(
        x, cache.norms, c[:, :1].contiguous(), md, block_n=bn)[1]
    act, dc, margin = bounds.seed_gate(c, cache, tmax)
    return x, cache, md, c, tmax, parts, act, dc, margin


def _assign_state(dev, bsz, n, d, k, bn, tps, gen_seed=0):
    """A carried gated assignment state of ``bsz`` label-sorted problems:
    one all-active round from centroids c0 with no carried bound, then c1,
    two centroids of each problem moved a little. Returns (x, cache, c1,
    delta, thresh, absorb, state)."""
    g = torch.Generator(device=dev).manual_seed(gen_seed)
    x = blobs_batched(bsz, n, d, max(k // 2, 2), generator=g, spread=0.03,
                      sort=True)
    cache = bounds.RoundCache(*kd.seed_prologue_torch(x, bn))
    idx = torch.randint(n, (bsz, k, 1), generator=g, device=dev)
    c0 = (torch.take_along_dim(x, idx, dim=1) + 0.01).contiguous()
    t = -(-n // bn)
    s = -(-t // tps)
    zt = torch.zeros((bsz, t), device=dev)
    first = la.lloyd_assign_gated_batched_torch(
        x, cache.norms, c0, torch.zeros((bsz, k), device=dev), zt, zt,
        torch.zeros((bsz, n), dtype=torch.int32, device=dev),
        torch.zeros((bsz, n), device=dev),
        torch.full((bsz, n), -torch.inf, device=dev), zt, zt,
        torch.zeros((bsz, s, k, d), device=dev),
        torch.zeros((bsz, s, k), device=dev),
        torch.ones((bsz, t), dtype=torch.bool, device=dev), block_n=bn,
        tps=tps)
    c1 = c0.clone()
    if k > 1:
        c1[:, [0, k - 1]] += 0.002
    st = bounds.BoundState(first[3], tile_gap=first[4], tile_sums=first[5],
                           tile_counts=first[6], assignment=first[0],
                           min_d2=first[1], point_lb=first[2], lb_debt=zt)
    delta = bounds.centroid_movement(c1, c0)
    thresh, absorb = bounds.assign_point_scalars(delta, c1, st, cache)
    return x, cache, c1, delta, thresh, absorb, st


def _masks(t, bsz, tps, dev):
    """Per-problem active masks: problem 0 every other tile, problem 1
    none, the rest every other super-tile."""
    ar = torch.arange(t, device=dev)
    act = ((ar // tps) % 2 == 0).expand(bsz, t).clone()
    act[0] = ar % 2 == 0
    act[1] = False
    return act


@pytest.mark.parametrize("d", [2, 16])
def test_gated_batched_twins_are_the_single_twins_row_by_row(d):
    """The batched K1's, K8's and K10b's plain twins are K1's, K5's and
    K6's on each problem, bitwise, under per-problem masks (one problem
    with nothing active), and the CPU wrappers run them, counting no
    launch."""
    n, bn, tps, m, k = 1100, 128, 2, 1, 5
    x, cache, md, c, tmax, parts, _, dc, margin = _seed_state(
        torch.device("cpu"), B, n, d, m, bn)
    for b in range(B):
        one = kd.seed_prologue_torch(x[b], bn)
        assert all(torch.equal(u[b], v) for u, v in zip(cache, one))
    act = _masks(-(-n // bn), B, 1, x.device)
    seed_args = (x, cache.norms, c, md, cache.center_d, dc, margin, parts,
                 tmax, act)
    seeded = kd.distance_min_update_gated_batched_torch(*seed_args,
                                                        block_n=bn)
    x2, cache2, c1, delta, thresh, absorb, st = _assign_state(
        torch.device("cpu"), B, n, d, k, bn, tps)
    act2 = bounds.expand_active_supers(_masks(-(-n // bn), B, tps,
                                              x.device), tps)
    asg_args = (x2, cache2.norms, c1, delta, thresh, absorb, st.assignment,
                st.min_d2, st.point_lb, st.partials, st.tile_gap,
                st.tile_sums, st.tile_counts, act2)
    assigned = la.lloyd_assign_gated_batched_torch(*asg_args, block_n=bn,
                                                   tps=tps)
    assert int(assigned[7].sum()) > 0 and int(seeded[3].sum()) > 0
    for b in range(B):
        one = kd.distance_min_update_gated_torch(
            *(a[b] for a in seed_args), block_n=bn)
        assert all(torch.equal(u[b], v) for u, v in zip(seeded, one))
        one = la.lloyd_assign_gated_torch(*(a[b] for a in asg_args),
                                          block_n=bn, tps=tps)
        assert all(torch.equal(u[b], v) for u, v in zip(assigned, one))
    ops.reset_launches()
    wrapped = kd.seed_prologue_batched(x, bn)
    assert all(torch.equal(u, v) for u, v in zip(wrapped, cache))
    wrapped = kd.distance_min_update_gated_batched(*seed_args, block_n=bn)
    assert all(torch.equal(u, v) for u, v in zip(wrapped, seeded))
    wrapped = la.lloyd_assign_gated_batched(*asg_args, block_n=bn, tps=tps)
    assert all(torch.equal(u, v) for u, v in zip(wrapped, assigned))
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("bad", ["center_d", "dc", "active", "problems",
                                 "delta", "prev_super_sums", "prev_lb"])
def test_gated_batched_wrappers_reject_bad_shapes(bad):
    """K8's and K10b's wrappers raise ValueError on an argument of the wrong
    shape (one per case; 'problems' gives one carry another problem
    count), and the batched K1's on points that are not (B, n, d)."""
    n, bn, tps, k, cpu = 300, 128, 2, 4, torch.device("cpu")
    x, cache, md, c, tmax, parts, act, dc, margin = _seed_state(
        cpu, B, n, 2, 1, bn)
    seed = dict(center_d=cache.center_d, dc=dc, active=act,
                problems=parts)
    if bad in seed:
        seed[bad] = {"center_d": cache.center_d[:, 1:], "dc": dc[:, 1:],
                     "active": act[:, :1], "problems": parts[1:]}[bad]
        with pytest.raises(ValueError):
            kd.distance_min_update_gated_batched(
                x, cache.norms, c, md, seed["center_d"], seed["dc"], margin,
                seed["problems"], tmax, seed["active"], block_n=bn)
        return
    x2, cache2, c1, delta, thresh, absorb, st = _assign_state(
        cpu, B, n, 2, k, bn, tps)
    asg = dict(delta=delta, prev_super_sums=st.tile_sums,
               prev_lb=st.point_lb)
    asg[bad] = {"delta": delta[:, 1:],
                "prev_super_sums": st.tile_sums[:, :, :, :1],
                "prev_lb": st.point_lb[:2]}[bad]
    with pytest.raises(ValueError):
        la.lloyd_assign_gated_batched(
            x2, cache2.norms, c1, asg["delta"], thresh, absorb,
            st.assignment, st.min_d2, asg["prev_lb"], st.partials,
            st.tile_gap, asg["prev_super_sums"], st.tile_counts,
            torch.ones_like(st.partials, dtype=torch.bool), block_n=bn,
            tps=tps)
    with pytest.raises(ValueError):
        kd.seed_prologue_batched(x2[0], bn)


@pytest.mark.parametrize("d,m", [(2, 1), (5, 3), (16, 1)])
def test_batched_gate_arithmetic_is_the_single_row_by_row(d, m):
    """Every bound function on (B, ...) arrays is the single call on each
    problem, bitwise: the seeding gate's mask, dc and margin, the point
    prune, the tile maxima and masks, the super masks and the floors (one
    problem with nothing active), the assignment gate's mask, thresh,
    absorb, point prune and gap decay, and the centroid movement."""
    n, bn, tps, k = 1100, 128, 2, 5
    cpu = torch.device("cpu")
    x, cache, md, c, tmax, parts, act, dc, margin = _seed_state(
        cpu, B, n, d, m, bn, gen_seed=d)
    prune = bounds.seed_point_prune(md, cache.center_d,
                                    bounds.expand_mask(dc, bn, n),
                                    bounds.expand_mask(margin, bn, n))
    masks = _masks(-(-n // bn), B, tps, cpu)
    x2, cache2, c1, delta, thresh, absorb, st = _assign_state(
        cpu, B, n, d, k, bn, tps, gen_seed=d)
    cand = bounds.assign_active_tiles(delta, c1, st, cache2, tps=tps)
    aprune = bounds.assign_point_prune(
        st.assignment, st.min_d2, st.point_lb, delta,
        bounds.expand_mask(thresh, bn, n), bounds.expand_mask(cand, bn, n))
    dmax = delta.amax(-1, keepdim=True)
    gap = bounds.decay_gap(st.tile_gap, cand, st.partials, dmax)
    c0 = c1 + torch.linspace(0, 1e-3, k)[:, None]
    move = bounds.centroid_movement(c1, c0)
    assert 0 < int(prune.sum()) < prune.numel()
    assert int(aprune.sum()) > 0
    for b in range(B):
        one_cache = bounds.prologue(x[b], bn)
        assert all(torch.equal(u[b], v) for u, v in zip(cache, one_cache))
        a1, dc1, mg1 = bounds.seed_gate(c[b], one_cache, tmax[b])
        assert torch.equal(act[b], a1) and torch.equal(dc[b], dc1) \
            and torch.equal(margin[b], mg1)
        assert torch.equal(prune[b], bounds.seed_point_prune(
            md[b], one_cache.center_d, bounds.expand_mask(dc1, bn, n),
            bounds.expand_mask(mg1, bn, n)))
        assert torch.equal(tmax[b], bounds.tile_reduce_max(md[b], bn))
        for mk in (masks, act):
            assert torch.equal(bounds.expand_active_supers(mk, tps)[b],
                               bounds.expand_active_supers(mk[b], tps))
            assert torch.equal(bounds.super_any(mk, tps)[b],
                               bounds.super_any(mk[b], tps))
            assert torch.equal(bounds.n_active(mk)[b],
                               bounds.n_active(mk[b]))
        one_st, one_c2 = _row(st, b), _row(cache2, b)
        c1b = bounds.assign_active_tiles(delta[b], c1[b], one_st, one_c2,
                                         tps=tps)
        assert torch.equal(cand[b], c1b)
        th1, ab1 = bounds.assign_point_scalars(delta[b], c1[b], one_st,
                                               one_c2)
        assert torch.equal(thresh[b], th1) and torch.equal(absorb[b], ab1)
        assert torch.equal(aprune[b], bounds.assign_point_prune(
            one_st.assignment, one_st.min_d2, one_st.point_lb, delta[b],
            bounds.expand_mask(th1, bn, n), bounds.expand_mask(c1b, bn, n)))
        assert torch.equal(gap[b], bounds.decay_gap(
            one_st.tile_gap, c1b, one_st.partials, delta[b].max()))
        assert torch.equal(move[b], bounds.centroid_movement(c1[b], c0[b]))
    # the floors are per problem: problem 1 has nothing active
    assert not masks[1].any()
    assert int(bounds.n_active(masks)[1]) == 1
    assert bool(bounds.expand_active_supers(masks, tps)[1, :tps].all())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(10_007, 2), (16_384, 16), (5003, 33)])
def test_batched_k1_matches_plain_and_is_k1_row_by_row_on_the_card(card, n,
                                                                    d):
    """The batched K1: norms bitwise ``bounds.point_norms``; centers, radii
    and center_d within 1e-5 of the largest coordinate of the plain twin's;
    two launches the same bits, each counted once; rows 0, 1 and B−1
    bitwise K1 on their problem."""
    bsz, bn = 5, 1024
    x = torch.rand((bsz, n, d), generator=torch.Generator(
        device=card).manual_seed(n), device=card)
    ops.reset_launches()
    got = kd.seed_prologue_batched(x, bn)
    again = kd.seed_prologue_batched(x, bn)
    assert ops.LAUNCHES["seed_prologue_batched"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    assert torch.equal(got[0], bounds.point_norms(x))
    want = kd.seed_prologue_torch(x, bn)
    scale = float(x.abs().max())
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= 1e-5 * scale
    for b in (0, 1, bsz - 1):
        one = kd.seed_prologue(x[b], bn)
        assert all(torch.equal(u[b], v) for u, v in zip(got, one))


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(2, 1), (16, 1), (16, 8)])
@pytest.mark.parametrize("mask", ["gate", "mixed"])
@pytest.mark.parametrize("resident", [True, False])
def test_k8_matches_plain_keeps_carries_and_is_k5_row_by_row_on_the_card(
        card, d, m, mask, resident):
    """K8 against its plain twin: D² within tolerance, partials and maxima
    within tolerance, pruned counts equal; skipped tiles' outputs bitwise
    their carries; two launches the same bits; rows 0, 1 and B−1 bitwise
    K5 on their problem. Masks: each problem's gate, or mixed (every other
    tile in problem 0, none in problem 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bsz, n, bn = 5, 10_007, 1024
    x, cache, md, c, tmax, parts, act, dc, margin = _seed_state(
        card, bsz, n, d, m, bn, gen_seed=d + m)
    if mask == "mixed":
        act = _masks(act.shape[-1], bsz, 1, card)
    args = (x, cache.norms, c, md, cache.center_d, dc, margin, parts, tmax,
            act)
    ops.reset_launches()
    got = kd.distance_min_update_gated_batched(*args, block_n=bn,
                                               resident=resident)
    again = kd.distance_min_update_gated_batched(*args, block_n=bn,
                                                 resident=resident)
    assert ops.LAUNCHES["distance_min_update_gated_batched"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    want = kd.distance_min_update_gated_batched_torch(*args, block_n=bn)
    tol = _card_tol(cache.norms, c)
    assert float((got[0] - want[0]).abs().max()) <= tol
    assert bool(((got[1] - want[1]).abs()
                 <= bn * tol + 2 * bn * EPS32 * want[1].abs()).all())
    assert float((got[2] - want[2]).abs().max()) <= tol
    assert torch.equal(got[3], want[3])
    skip = ~act
    rows = bounds.expand_mask(skip, bn, n)
    assert torch.equal(got[0][rows], md[rows])
    assert torch.equal(got[1][skip], parts[skip])
    assert torch.equal(got[2][skip], tmax[skip])
    assert not got[3][skip].any()
    for b in (0, 1, bsz - 1):
        k5 = kd.distance_min_update_gated(*(a[b] for a in args), block_n=bn,
                                          resident=resident)
        assert all(torch.equal(u[b], v) for u, v in zip(got, k5))


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(2, 6), (16, 256), (33, 7)])
def test_k10b_matches_plain_keeps_carries_and_is_k6_row_by_row_on_the_card(
        card, d, k):
    """K10b from a carried state whose lower bounds make the prune fire,
    with per-problem masks (every other tile, none, every other super):
    pruned counts equal the plain twin's and some rows prune; pruned rows'
    label, D² and lb bitwise the twin's; D² within tolerance; skipped
    tiles and supers bitwise their carries; two launches the same bits;
    rows 0, 1 and B−1 bitwise the template's K6 on their problem
    (``lloyd_assign_gated_template``; d = 2 takes K10b's template path,
    d = 16 and 33 its screened route)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bsz, n = 4, 20_011
    bn = ops.choose_block_n(n, d, k)
    tps = 2
    x, cache, c1, delta, thresh, absorb, st = _assign_state(
        card, bsz, n, d, k, bn, tps, gen_seed=d + k)
    t = -(-n // bn)
    act = bounds.expand_active_supers(_masks(t, bsz, tps, card), tps)
    args = (x, cache.norms, c1, delta, thresh, absorb, st.assignment,
            st.min_d2, st.point_lb, st.partials, st.tile_gap, st.tile_sums,
            st.tile_counts, act)
    ops.reset_launches()
    got = la.lloyd_assign_gated_batched(*args, block_n=bn, tps=tps)
    again = la.lloyd_assign_gated_batched(*args, block_n=bn, tps=tps)
    assert ops.LAUNCHES["lloyd_assign_gated_batched"] == 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    want = la.lloyd_assign_gated_batched_torch(*args, block_n=bn, tps=tps)
    assert torch.equal(got[7], want[7]) and int(got[7].sum()) > 0
    prune = bounds.assign_point_prune(
        st.assignment, st.min_d2, st.point_lb, delta,
        bounds.expand_mask(thresh, bn, n), bounds.expand_mask(act, bn, n))
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[prune], w[prune])
    assert float((got[1] - want[1]).abs().max()) <= _card_tol(cache.norms,
                                                              c1)
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
    for b in (0, 1, bsz - 1):
        k6 = la.lloyd_assign_gated_template(*(a[b] for a in args),
                                            block_n=bn, tps=tps)
        assert all(torch.equal(u[b], v) for u, v in zip(got, k6))


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
def test_gated_batched_engine_is_ungated_and_single_on_the_card(card,
                                                               sampler,
                                                               sort):
    """On the card the gated kmeans_batched launches the batched K1 once
    per phase, K8 once per round and K10b once per iteration of the slowest
    problem, nothing else; it is bitwise the ungated kmeans_batched, and
    row b bitwise the single gated seed then fit, counters included."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bsz, n, d, k = 4, 5000, 16, 16
    pts = blobs_batched(bsz, n, d, 4 if sort else k, sort=sort,
                        generator=torch.Generator(device=card).manual_seed(0))
    eng = ClusterEngine(device=card)
    draws = Draws.sample_batched(bsz, n, k,
                                 generator=torch.Generator().manual_seed(1))
    kw = dict(draws=draws, sampler=sampler, max_iters=8, tol=1e-4)
    ops.reset_launches()
    got = eng.kmeans_batched(pts, k, **kw)
    counts = dict(ops.LAUNCHES)
    assert counts.pop("seed_prologue_batched") == 2
    assert counts.pop("distance_min_update_gated_batched") == k
    assert counts.pop("lloyd_assign_gated_batched") == int(got.n_iters.max())
    assert not any(counts.values()), counts
    off = ClusterEngine(device=card, bounds=False).kmeans_batched(pts, k,
                                                                  **kw)
    fields = ("centroids", "assignment", "inertia", "n_iters")
    _same(got, off, fields)
    seeds = eng.seed_batched(pts, k, draws=draws, sampler=sampler)
    for b in (0, 1, bsz - 1):
        one = eng.seed(pts[b], k, draws=draws[b], sampler=sampler)
        _same(one, _row(seeds, b), ("indices", "min_d2", "skipped",
                                    "pruned"))
        fit = eng.fit(pts[b], one.centroids, max_iters=8, tol=1e-4)
        _same(fit, _row(got, b), fields + ("skipped", "pruned"))
    if sort:
        assert int(seeds.skipped.sum()) > 0
