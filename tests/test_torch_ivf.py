"""IVF serving in the port against ``repro.serve.ivf``.

``IvfIndex.build/search/exhaustive`` over a trained k-means model, with the
gated scan kernels K13 ``ivf_scan`` (``repro/kernels/ivf_scan.py:122``)
and K14 ``ivf_adc_scan`` (``:249``). On the CPU the port's ``cuda``
backend runs the kernels' plain twins, since the tensors lie on the CPU.

One reference index at ``IVF_SMOKE`` (the JAX suite's fixture: blobs(4000,
16, 32), 128-row tiles, PQ with 4 sub-spaces) is carried across with
``convert.ivf_index``, so both sides search the same index. Held against
the reference: ``search`` ids and its three counters (``probed_lists``,
``probed_tiles``, ``gate_skipped``) exactly at nprobe 4, 8 and 32, exact
and ADC, dists within a stated tolerance; the twins against the
interpreted Pallas kernels on the fixture's probe maps and on random ones
(rows and ``gate_skipped`` exactly); ``build`` from the reference's key
schedule (perm, offsets and list coverage exactly); the gate, the probe
maps' floor and the top-k merge. Inside the port: ``nprobe == nlist`` is
``exhaustive`` bitwise, the gate is a value-noop, the offset faults raise
``CorruptedStateError``. Tests marked ``cuda`` hold K13 and K14 to their
twins on the card.

Tolerance on dists: the two sides round the same D² differently (the
reference's CPU dot and reductions add in other orders than the port's
fixed ascending chains), each within ``d2_tol``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_jaxref import (EPS32, d2_tol, draws_for, ref_geometry,
                               ref)  # noqa: F401  (ref: fixture)
from repro_torch import convert
from repro_torch.configs import IVF_SMOKE
from repro_torch.core import ClusterEngine, bounds, make_backend, telemetry
from repro_torch.core.guards import CorruptedStateError, InvalidInputError
from repro_torch.core.topk import (IDX_SENTINEL, init_topk, lex_topk,
                                   merge_topk)
from repro_torch.data import blobs
from repro_torch.kernels import ivf_scan as ks
from repro_torch.kernels import ops
from repro_torch.serve import IvfIndex, default_nprobe
from repro_torch.serve import ivf as ivf_mod
from repro_torch.testing import IVF_OFFSET_FAULTS, corrupt_list_offsets

CFG = IVF_SMOKE


def _data():
    pts, _ = blobs(CFG.n_points, CFG.dim, CFG.nlist, seed=0)
    qs, _ = blobs(CFG.n_queries, CFG.dim, CFG.nlist, seed=1)
    return pts, qs


@pytest.fixture(scope="module")
def pair(ref):
    """(reference index, the same index in the port, queries)."""
    from repro.serve import IvfIndex as RefIndex
    pts, qs = _data()
    ridx = RefIndex.build(ref.jnp.asarray(pts), CFG.nlist,
                          block_n=CFG.block_n, pq_nsub=CFG.pq_nsub,
                          engine=ref.engine.ClusterEngine("fused"))
    return ridx, convert.ivf_index(ridx), qs


def _dist_tol(index, qs) -> float:
    return d2_tol(index.points.numpy(), qs)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nprobe", [4, 8, 32])
@pytest.mark.parametrize("mode", ["exact", "adc"])
def test_search_matches_reference(ref, pair, mode, nprobe):
    """ids and every counter equal the reference's interpreted Pallas
    search; dists within the D² tolerance."""
    ridx, pidx, qs = pair
    want = ridx.search(ref.jnp.asarray(qs), CFG.k, nprobe=nprobe, mode=mode,
                       backend="pallas")
    got = pidx.search(qs, CFG.k, nprobe=nprobe, mode=mode)
    for f in ("indices", "probed_lists", "probed_tiles", "gate_skipped"):
        assert getattr(got, f).dtype == torch.int32, f
        _eq(getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=0, atol=_dist_tol(pidx, qs))
    if nprobe > 4:
        assert int(got.gate_skipped.sum()) > 0
    telemetry.check_ivf_counters(got.probed_lists, got.probed_tiles,
                                 got.gate_skipped, n_queries=len(qs),
                                 nlist=pidx.nlist, n_tiles=pidx.n_tiles)


def _probe_maps(ref, ridx, qs, nprobe):
    """The reference search's own (ids, n_active, qdots) for these
    queries."""
    from repro.serve import ivf as rivf
    jnp = ref.jnp
    q = jnp.asarray(qs)
    probed, qdots = rivf._route(q, ridx.centroids, ridx.centroid_norms,
                                ridx.super_centers, ridx.super_radii,
                                ridx.super_sizes, nprobe=nprobe)
    tiles = (probed.astype(jnp.float32)
             @ ridx.list_tiles.astype(jnp.float32)) > 0.0
    ids, nact = ref.jax.vmap(ref.bounds.compact_ids)(tiles)
    return np.array(ids), np.array(nact), np.array(qdots)


def _random_maps(rng, nq, n_tiles):
    """Random probe maps, one query with nothing active (the floor)."""
    active = rng.random((nq, n_tiles)) < 0.4
    active[0] = False
    return bounds.compact_ids(torch.from_numpy(active))


def _assert_scan(got, want, tol):
    _eq(got[1], want[1])
    _eq(got[2], want[2])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("maps", ["fixture", "random"])
def test_k13_twin_matches_interpreted_kernel(ref, pair, maps, gate):
    """K13's twin against ``ivf_scan_pallas`` in interpret mode, on the
    fixture's probe maps (nprobe 8) and random ones: rows and gate_skipped
    exactly, dists within the D² tolerance."""
    ridx, pidx, qs = pair
    if maps == "fixture":
        ids, nact, _ = _probe_maps(ref, ridx, qs, 8)
        ids, nact = torch.from_numpy(ids), torch.from_numpy(nact)
    else:
        ids, nact = _random_maps(np.random.default_rng(3), len(qs),
                                 pidx.n_tiles)
    args = (pidx.points, pidx.norms, pidx.centers, pidx.radii)
    kw = dict(k=CFG.k, block_n=CFG.block_n, gate=gate)
    got = ks.ivf_scan(torch.from_numpy(qs), *args, ids, nact, **kw)
    jnp = ref.jnp
    want = ref.ops.ivf_scan(jnp.asarray(qs), *(jnp.asarray(a.numpy())
                                               for a in args),
                            jnp.asarray(ids.numpy()),
                            jnp.asarray(nact.numpy()), interpret=True, **kw)
    _assert_scan(got, want, _dist_tol(pidx, qs))
    if gate:
        assert int(got[2].sum()) > 0


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("maps", ["fixture", "random"])
def test_k14_twin_matches_interpreted_kernel(ref, pair, maps, gate):
    """K14's twin against ``ivf_adc_scan_pallas`` in interpret mode, the
    LUT and routing dots from the reference: rows and gate_skipped
    exactly, dists within the D² tolerance of the reconstruction."""
    from repro.serve import ivf as rivf
    ridx, pidx, qs = pair
    ids, nact, qdots = _probe_maps(ref, ridx, qs, 8)
    ids, nact = torch.from_numpy(ids), torch.from_numpy(nact)
    if maps == "random":
        ids, nact = _random_maps(np.random.default_rng(4), len(qs),
                                 pidx.n_tiles)
    jnp = ref.jnp
    lut = np.array(rivf._adc_lut(jnp.asarray(qs), ridx.pq.codebook))
    pq = pidx.pq
    args = (torch.from_numpy(lut), torch.from_numpy(qdots), pq.codes,
            pidx.labels, pq.u, pq.centers, pq.radii)
    kw = dict(k=CFG.k, block_n=CFG.block_n, gate=gate)
    got = ks.ivf_adc_scan(torch.from_numpy(qs), *args, ids, nact, **kw)
    want = ref.ops.ivf_adc_scan(
        jnp.asarray(qs), *(jnp.asarray(a.numpy()) for a in args),
        jnp.asarray(ids.numpy()), jnp.asarray(nact.numpy()), interpret=True,
        **kw)
    _assert_scan(got, want, d2_tol(_xhat(pidx).numpy(), qs))
    if gate:
        assert int(got[2].sum()) > 0


def _xhat(index):
    """The PQ reconstruction of every sorted row."""
    from repro_torch.serve import kvquant
    return (kvquant.decode(index.pq.codes, index.pq.codebook)
            + index.centroids[index.labels.long()])


def test_build_matches_reference_from_its_key_schedule(ref):
    """``IvfIndex.build`` on the reference's draws and tile geometry: perm,
    list offsets, labels, list coverage and super sizes exactly; centroids,
    norms and tile balls within n·eps of the data's scale."""
    from repro.serve import IvfIndex as RefIndex
    pts, _ = _data()
    n, d, nlist = CFG.n_points, CFG.dim, CFG.nlist
    want = RefIndex.build(ref.jnp.asarray(pts), nlist, block_n=CFG.block_n,
                          engine=ref.engine.ClusterEngine("fused"))
    bn, tps = ref_geometry(ref, n, d, nlist, backend="fused")
    eng = ClusterEngine(convert.with_geometry(make_backend("cuda"), bn, tps),
                        device="cpu")
    got = IvfIndex.build(pts, nlist, engine=eng, block_n=CFG.block_n,
                         draws=draws_for(0, n, nlist))
    for f in ("perm", "starts", "counts", "labels", "list_tiles",
              "super_sizes"):
        _eq(getattr(got, f), getattr(want, f))
    assert got.block_n == want.block_n and got.backend == "cuda"
    scale = float(np.abs(pts).max())
    for f in ("centroids", "points", "centers", "super_centers"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=n * EPS32 * scale, err_msg=f)
    for f in ("norms", "radii", "centroid_norms", "super_radii"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=n * EPS32 * scale, err_msg=f)


def test_gate_and_compact_ids_match_reference(ref):
    """The gate's rounded operations give the reference's booleans (values
    drawn around the boundary), and the probe maps equal
    ``compact_ids``' under ``vmap``, an all-off row visiting tile 0."""
    rng = np.random.default_rng(5)
    m = 4000
    dc = rng.uniform(0, 10, m).astype(np.float32)
    r = rng.uniform(0, 3, m).astype(np.float32)
    cn = rng.uniform(0, 20, m).astype(np.float32)
    qn = rng.uniform(0, 400, m).astype(np.float32)
    lo = np.maximum(dc - r, 0)
    tau = (lo * lo * rng.uniform(0.98, 1.02, m)).astype(np.float32)
    tau[:10] = np.inf
    jnp = ref.jnp
    want = ref.bounds.ivf_gate_skip(*(jnp.asarray(v)
                                      for v in (dc, r, cn, qn, tau)))
    got = bounds.ivf_gate_skip(*(torch.from_numpy(v)
                                 for v in (dc, r, cn, qn, tau)))
    _eq(got, want)
    assert 0 < int(got.sum()) < m and not got[:10].any()
    active = rng.random((7, 13)) < 0.3
    active[2] = False
    active[4] = True
    ids, nact = bounds.compact_ids(torch.from_numpy(active))
    wids, wnact = ref.jax.vmap(ref.bounds.compact_ids)(jnp.asarray(active))
    _eq(ids, wids)
    _eq(nact, wnact)
    assert ids.dtype == nact.dtype == torch.int32
    assert int(nact[2]) == 1 and int(ids[2, 0]) == 0


def test_topk_matches_reference_sort(ref):
    """``lex_topk`` is ``jax.lax.sort(num_keys=2)``'s first k, ties on the
    value (many) broken by the index, sentinels last; a batch of rows is
    each row's own."""
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 5, (4, 300)).astype(np.float32)
    vals[:, :20] = np.inf
    idxs = np.stack([rng.permutation(300) for _ in range(4)]).astype(
        np.int32)
    idxs[:, :10] = IDX_SENTINEL
    gv, gi = lex_topk(torch.from_numpy(vals), torch.from_numpy(idxs), 290)
    for b in range(4):
        sv, si = ref.jax.lax.sort((ref.jnp.asarray(vals[b]),
                                   ref.jnp.asarray(idxs[b])), num_keys=2)
        _eq(gv[b], np.asarray(sv)[:290])
        _eq(gi[b], np.asarray(si)[:290])


def test_topk_matches_reference_sort_on_signed_values(ref):
    """``lex_topk`` orders negative values, -0 and +0 (as equal, so ties by
    index), ±inf and ±NaN as ``jax.lax.sort(num_keys=2)`` does, and
    returns the values' own bits."""
    rng = np.random.default_rng(7)
    vals = rng.integers(-3, 4, (3, 200)).astype(np.float32) \
        * np.float32(0.25)
    vals[:, :12] = np.float32(-0.0)
    vals[:, 12:24] = np.float32(0.0)
    vals[:, 24:28] = np.inf
    vals[:, 28:32] = -np.inf
    vals[:, 32:34] = np.nan
    vals[:, 34:36] = -np.nan
    for b in range(3):
        rng.shuffle(vals[b])
    idxs = np.stack([rng.permutation(200) for _ in range(3)]).astype(
        np.int32)
    gv, gi = lex_topk(torch.from_numpy(vals), torch.from_numpy(idxs), 200)
    for b in range(3):
        sv, si = ref.jax.lax.sort((ref.jnp.asarray(vals[b]),
                                   ref.jnp.asarray(idxs[b])), num_keys=2)
        _eq(gi[b], np.asarray(si))
        assert np.array_equal(gv[b].numpy().view(np.int32),
                              np.asarray(sv).view(np.int32))


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------


def test_merge_topk_is_blocking_invariant():
    """Any blocking of the candidates merges to the global lex top-k,
    bitwise, ties included."""
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.integers(0, 20, 500).astype(np.float32))
    idxs = torch.from_numpy(rng.permutation(500).astype(np.int32))
    want = lex_topk(vals, idxs, 17)
    for block in (1, 7, 64, 500):
        tv, ti = init_topk(17)
        for s in range(0, 500, block):
            tv, ti = merge_topk(tv, ti, vals[s:s + block],
                                idxs[s:s + block], 17)
        assert torch.equal(tv, want[0]) and torch.equal(ti, want[1])


def test_exact_scores_are_the_dots_chain():
    """The twins' column-major dot chain is ``bounds._dots`` bitwise."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(300, 24)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(7, 24)).astype(np.float32))
    xn = bounds.point_norms(x)
    want = torch.clamp_min(xn[None, :] - 2.0 * bounds._dots(q, x)
                           + bounds.point_norms(q)[:, None], 0.0)
    assert torch.equal(ks.exact_scores(q, x, xn), want)


def _port_maps(index, q, nprobe):
    """The port's own probe maps (``search``'s routing) at ``nprobe``."""
    probed, _ = ivf_mod._route(
        q, index.centroids, index.centroid_norms, index.super_centers,
        index.super_radii, index.super_sizes, nprobe=nprobe)
    tiles = (probed.float() @ index.list_tiles.float()) > 0.0
    return bounds.compact_ids(tiles)


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("maps", [4, 8, 32, "random"])
def test_two_part_k13_is_the_walk_bitwise(pair, maps, gate):
    """K13's two parts in plain torch, every (query, step) pair's top-k of
    its tile (:func:`tile_topk_torch`) and then each query's walk over
    them (:func:`replay_torch`), are the one-pass walk ``ivf_scan_torch``
    bitwise: dists, rows and gate_skipped, at nprobe 4, 8 and 32 (= nlist,
    full probe) on the fixture and on random maps, gate on and off."""
    _, pidx, qs = pair
    q = torch.from_numpy(qs)
    if maps == "random":
        ids, nact = _random_maps(np.random.default_rng(8), len(qs),
                                 pidx.n_tiles)
    else:
        ids, nact = _port_maps(pidx, q, maps)
    kw = dict(k=CFG.k, block_n=CFG.block_n)
    want = ks.ivf_scan_torch(q, pidx.points, pidx.norms, pidx.centers,
                             pidx.radii, ids, nact, gate=gate, **kw)
    cd, cr = ks.tile_topk_torch(q, pidx.points, pidx.norms, ids, nact, **kw)
    assert cd.shape == cr.shape == (int(nact.sum()), CFG.k)
    assert cr.dtype == torch.int32
    got = ks.replay_torch(cd, cr, q, pidx.centers, pidx.radii, ids, nact,
                          k=CFG.k, gate=gate)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if not gate:
        assert int(got[2].sum()) == 0
    elif maps != 4:
        assert int(got[2].sum()) > 0


def _adc_args(index, q, nprobe):
    """K14's inputs from the port's routing at ``nprobe``: (lut, qdots,
    codes, labels, u, pq centers, pq radii), ids, n_active."""
    probed, qdots = ivf_mod._route(
        q, index.centroids, index.centroid_norms, index.super_centers,
        index.super_radii, index.super_sizes, nprobe=nprobe)
    tiles = (probed.float() @ index.list_tiles.float()) > 0.0
    ids, nact = bounds.compact_ids(tiles)
    pq = index.pq
    return ((ivf_mod._adc_lut(q, pq.codebook), qdots, pq.codes,
             index.labels, pq.u, pq.centers, pq.radii), ids, nact)


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("maps", [4, 8, 32, "random"])
def test_two_part_k14_is_the_walk_bitwise(pair, maps, gate):
    """K14's two parts in plain torch, every (query, step) pair's ADC top-k
    of its tile (:func:`adc_tile_topk_torch`) and then each query's walk
    over them (:func:`replay_torch`, the gate over the reconstruction's
    balls), are the one-pass walk ``ivf_adc_scan_torch`` bitwise: dists,
    rows and gate_skipped, at nprobe 4, 8 and 32 (= nlist, full probe) and
    on random maps, gate on and off."""
    _, pidx, qs = pair
    q = torch.from_numpy(qs)
    args, ids, nact = _adc_args(pidx, q, 8 if maps == "random" else maps)
    if maps == "random":
        ids, nact = _random_maps(np.random.default_rng(9), len(qs),
                                 pidx.n_tiles)
    kw = dict(k=CFG.k, block_n=CFG.block_n)
    want = ks.ivf_adc_scan_torch(q, *args, ids, nact, gate=gate, **kw)
    cd, cr = ks.adc_tile_topk_torch(q, *args[:5], ids, nact, **kw)
    assert cd.shape == cr.shape == (int(nact.sum()), CFG.k)
    assert cr.dtype == torch.int32
    got = ks.replay_torch(cd, cr, q, args[5], args[6], ids, nact, k=CFG.k,
                          gate=gate)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if not gate:
        assert int(got[2].sum()) == 0
    elif maps != 4:
        assert int(got[2].sum()) > 0


def test_two_part_k13_pads_past_a_tile(pair):
    """At k past a tile's rows the tile top-k is every row then (+inf,
    INT32_MAX) pads, and the two parts are still the walk bitwise."""
    _, pidx, qs = pair
    q = torch.from_numpy(qs[:9])
    ids, nact = _port_maps(pidx, q, 4)
    k = CFG.block_n + 72
    cd, cr = ks.tile_topk_torch(q, pidx.points, pidx.norms, ids, nact,
                                k=k, block_n=CFG.block_n)
    assert torch.isinf(cd[:, CFG.block_n:]).all()
    assert (cr[:, CFG.block_n:] == IDX_SENTINEL).all()
    assert torch.isfinite(cd[:, :CFG.block_n - 1]).all()
    got = ks.replay_torch(cd, cr, q, pidx.centers, pidx.radii, ids, nact,
                          k=k)
    want = ks.ivf_scan_torch(q, pidx.points, pidx.norms, pidx.centers,
                             pidx.radii, ids, nact, k=k,
                             block_n=CFG.block_n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_query_groups_cut_the_pairs_to_the_budget():
    """K13's query groups: consecutive, covering every query once, each at
    most the budget's pairs and as long as it can be; one group when all
    fit, [(0, 0)] for no queries; a query alone past the budget raises."""
    act = torch.tensor([3, 0, 5, 2, 2, 7, 1, 0], dtype=torch.int32)
    assert ks.query_groups(act, 20) == [(0, 8)]
    assert ks.query_groups(act, 8) == [(0, 3), (3, 5), (5, 8)]
    assert ks.query_groups(act, 7) == [(0, 2), (2, 4), (4, 5), (5, 6),
                                       (6, 8)]
    groups = ks.query_groups(act, 9)
    assert groups[0][0] == 0 and groups[-1][1] == len(act)
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(groups, groups[1:]))
    sums = [int(act[a:b].sum()) for a, b in groups]
    assert max(sums) <= 9 and all(
        s + int(act[b]) > 9 for s, (_, b) in zip(sums, groups[:-1]))
    assert ks.query_groups(act[:0], 5) == [(0, 0)]
    with pytest.raises(InvalidInputError, match="query 5"):
        ks.query_groups(act, 6)


def test_lex_topk_breaks_ties_by_index():
    v = torch.tensor([1.0, 0.5, 1.0, 0.5, torch.inf])
    i = torch.tensor([9, 4, 2, 3, 0], dtype=torch.int32)
    sv, si = lex_topk(v, i, 5)
    assert si.tolist() == [3, 4, 2, 9, 0]
    assert sv.tolist()[:4] == [0.5, 0.5, 1.0, 1.0]


@pytest.mark.parametrize("backend", ["cuda", "fused"])
@pytest.mark.parametrize("mode", ["exact", "adc"])
def test_full_probe_and_gate(pair, backend, mode):
    """exact at ``nprobe == nlist`` is ``exhaustive`` bitwise; for both
    modes the gate is a value-noop (gate off: bitwise the same, nothing
    skipped) and it skips on clustered data."""
    _, pidx, qs = pair
    full = pidx.search(qs, CFG.k, nprobe=pidx.nlist, mode=mode,
                       backend=backend)
    off = pidx.search(qs, CFG.k, nprobe=pidx.nlist, mode=mode,
                      backend=backend, gate=False)
    assert torch.equal(full.indices, off.indices)
    assert torch.equal(full.dists, off.dists)
    assert int(off.gate_skipped.sum()) == 0 < int(full.gate_skipped.sum())
    if mode == "exact":
        ei, ev = pidx.exhaustive(qs, CFG.k)
        assert torch.equal(full.indices, ei) and torch.equal(full.dists, ev)


def test_adc_equals_decode_then_exact(pair):
    """ADC at full probe: the exact top-k over the reconstructed rows, ids
    equal where the k-th/(k+1)-th gap exceeds the D² tolerance."""
    _, pidx, qs = pair
    r = pidx.search(qs, CFG.k, nprobe=pidx.nlist, mode="adc")
    xhat = _xhat(pidx)
    d2 = ks.exact_scores(torch.from_numpy(qs), xhat,
                         bounds.point_norms(xhat)).double()
    tol = d2_tol(xhat.numpy(), qs)
    ev, ei = torch.sort(d2, dim=1, stable=True)
    np.testing.assert_allclose(r.dists.numpy(), ev[:, :CFG.k].numpy(),
                               rtol=0, atol=tol)
    clear = (ev[:, 1:CFG.k + 1] - ev[:, :CFG.k] > 2 * tol).all(dim=1)
    want = pidx.perm[ei[:, :CFG.k]]
    assert torch.equal(r.indices[clear], want[clear])
    assert int(clear.sum()) > len(qs) // 2


@pytest.mark.parametrize("kind", IVF_OFFSET_FAULTS)
def test_offset_faults_raise(pair, kind):
    _, pidx, qs = pair
    bad = corrupt_list_offsets(pidx, kind=kind)
    with pytest.raises(CorruptedStateError):
        bad.search(qs, 5, nprobe=4)
    assert pidx.search(qs, 5, nprobe=4).indices.shape == (len(qs), 5)
    with pytest.raises(ValueError, match="unknown offset fault"):
        corrupt_list_offsets(pidx, kind="flipped")


def test_build_layouts_and_sentinels():
    """layout='none' keeps the caller's order (perm the identity) and is
    exact at full probe; k > n pads with (+inf, INT32_MAX) as exhaustive
    does; nprobe=None is nlist // 8; the default tile height is about four
    tiles per list, at least 128."""
    pts, _ = blobs(300, 4, 4, seed=5)
    qs, _ = blobs(3, 4, 4, seed=6)
    eng = ClusterEngine(device="cpu")
    gen = torch.Generator().manual_seed(0)
    for layout in ("label", "none"):
        idx = IvfIndex.build(pts, 4, engine=eng, generator=gen,
                             layout=layout)
        assert idx.block_n == 128
        if layout == "none":
            assert torch.equal(idx.perm, torch.arange(300, dtype=torch.int32))
        r = idx.search(qs, 310, nprobe=4)
        ei, ev = idx.exhaustive(qs, 310)
        assert torch.equal(r.indices, ei) and torch.equal(r.dists, ev)
        assert (r.indices[:, 300:] == IDX_SENTINEL).all()
        assert torch.isinf(r.dists[:, 300:]).all()
    assert default_nprobe(10**6, 256, 128) == 32
    assert default_nprobe(100, 4, 2) == 1
    big = IvfIndex.build(np.tile(pts, (20, 1)), 4, engine=eng,
                         generator=gen)
    assert big.block_n == 256          # 6000 rows / (4 · 4 lists) -> 256


@pytest.mark.parametrize("nlist", [5, 20])
def test_routing_is_exact_for_non_pow2_nlist(nlist):
    """Routing probes exactly the true top-nprobe centroids (by D², then
    list id) at every nprobe, where the pow2 super groups are ragged."""
    from repro_torch.serve import ivf as pivf
    pts, _ = blobs(3000, 12, nlist, seed=12)
    qs, _ = blobs(24, 12, nlist, seed=13)
    idx = IvfIndex.build(pts, nlist, engine=ClusterEngine(device="cpu"),
                         generator=torch.Generator().manual_seed(1),
                         block_n=128)
    q = torch.from_numpy(qs)
    cd2 = torch.clamp_min(bounds.point_norms(q)[:, None]
                          - 2.0 * bounds._dots(q, idx.centroids)
                          + idx.centroid_norms[None, :], 0.0)
    lid = torch.arange(nlist, dtype=torch.int32).expand(cd2.shape)
    for nprobe in (1, 2, nlist // 2, nlist):
        probed, _ = pivf._route(q, idx.centroids, idx.centroid_norms,
                                idx.super_centers, idx.super_radii,
                                idx.super_sizes, nprobe=nprobe)
        assert (probed.sum(1) == nprobe).all()
        true = lex_topk(cd2, lid, nprobe)[1].long()
        assert probed.gather(1, true).all()


def test_guards_and_k_limit(pair):
    """Typed raises: a bad mode, ADC without PQ, a bad query width, k < 1,
    non-finite queries, a bad layout or nlist; a k past one block's shared
    memory raises naming the limit on either device, never falling back."""
    _, pidx, qs = pair
    with pytest.raises(InvalidInputError, match="mode"):
        pidx.search(qs, 5, mode="fast")
    with pytest.raises(InvalidInputError, match="pq_nsub"):
        pidx._replace(pq=None).search(qs, 5, mode="adc")
    with pytest.raises(InvalidInputError, match="dimension"):
        pidx.search(qs[:, :3], 5)
    with pytest.raises(InvalidInputError, match="k >= 1"):
        pidx.search(qs, 0)
    bad = qs.copy()
    bad[1, 2] = np.nan
    with pytest.raises(InvalidInputError, match="non-finite"):
        pidx.search(bad, 5)
    assert pidx.search(bad, 5, validate="sanitize").indices.shape == (48, 5)
    pts, _ = blobs(200, 4, 4, seed=1)
    eng = ClusterEngine(device="cpu")
    with pytest.raises(InvalidInputError, match="layout"):
        IvfIndex.build(pts, 4, engine=eng, layout="random")
    with pytest.raises(InvalidInputError, match="nlist"):
        IvfIndex.build(pts, 201, engine=eng)
    # the scans' limit: their part-(b) block (the carried and merged lists)
    # fits and one more k does not; it is no lower than the
    # one-block-per-query kernels', whose block (16 bytes of static shared
    # memory beside it) also held the query and the tile's candidates, and
    # for K14 the LUT and the routing dots
    limit = ks.max_k(CFG.dim, CFG.block_n)
    assert ks.replay_smem_bytes(limit) <= ops.SMEM_LIMIT \
        < ks.replay_smem_bytes(limit + 1)
    assert limit >= (ops.SMEM_LIMIT - 16
                     - 4 * (CFG.dim + 2 * CFG.block_n)) // 16
    n_sub, n_codes = pidx.pq.codebook.centroids.shape[:2]
    assert ks.max_k(CFG.dim, CFG.block_n, n_sub, n_codes, CFG.nlist) \
        == limit >= (ops.SMEM_LIMIT - 16 - 4 * (
            CFG.dim + 2 * CFG.block_n + n_sub * n_codes + CFG.nlist)) // 16
    ids, nact = bounds.compact_ids(torch.ones((2, pidx.n_tiles),
                                              dtype=torch.bool))
    with pytest.raises(InvalidInputError, match=str(limit)):
        ks.ivf_scan(torch.from_numpy(qs[:2]), pidx.points, pidx.norms,
                    pidx.centers, pidx.radii, ids, nact, k=limit + 1,
                    block_n=CFG.block_n)


def test_build_with_pq_in_the_port():
    """A port build with PQ (the codebook sweep through the same engine):
    codes of the right shape, ``u`` the reconstruction's norms, ADC recall
    against the exact search at full probe."""
    from repro_torch.serve import kvquant
    pts, qs = _data()
    eng = ClusterEngine(device="cpu")
    idx = IvfIndex.build(pts, CFG.nlist, engine=eng, block_n=CFG.block_n,
                         pq_nsub=CFG.pq_nsub,
                         generator=torch.Generator().manual_seed(2))
    pq = idx.pq
    assert pq.codes.dtype == torch.uint8
    assert pq.codes.shape == (CFG.n_points, CFG.pq_nsub)
    assert pq.codebook.centroids.shape == (CFG.pq_nsub, 256,
                                           CFG.dim // CFG.pq_nsub)
    assert torch.equal(pq.u, bounds.point_norms(_xhat(idx)))
    resid = idx.points - idx.centroids[idx.labels.long()]
    assert torch.equal(pq.codes, kvquant.encode(resid, pq.codebook))
    a = idx.search(qs, 10, nprobe=idx.nlist, mode="adc")
    e = idx.search(qs, 10, nprobe=idx.nlist)
    hits = [len(set(a.indices[i].tolist()) & set(e.indices[i].tolist()))
            for i in range(len(qs))]
    assert np.mean(hits) / 10 >= 0.5


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_index(card):
    """20,000 rows of d = 32 in 40 lists, PQ with 8 sub-spaces; 64
    queries."""
    pts, _ = blobs(20_000, 32, 40, seed=3)
    qs, _ = blobs(64, 32, 40, seed=4)
    idx = IvfIndex.build(pts, 40, engine=ClusterEngine(device=card),
                         generator=torch.Generator().manual_seed(0),
                         pq_nsub=8, block_n=256)
    return idx, torch.from_numpy(qs).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "adc"])
def test_scan_kernels_match_twins_on_the_card(card, mode):
    """K13/K14 against their twins at nprobe 8 and nlist, gated and not:
    rows equal where the k-th/(k+1)-th gap clears the D² tolerance, dists
    within it, gate_skipped equal; gate on == off bitwise; two launches
    the same bits, each counted once."""
    idx, q = _card_index(card)
    name = "ivf_scan" if mode == "exact" else "ivf_adc_scan"
    rows = idx.points if mode == "exact" else _xhat(idx)
    tol = d2_tol(rows.cpu().numpy(), q.cpu().numpy())
    for nprobe in (8, idx.nlist):
        runs = {}
        for gate in (True, False):
            ops.reset_launches()
            one = idx.search(q, 10, nprobe=nprobe, mode=mode, gate=gate)
            two = idx.search(q, 10, nprobe=nprobe, mode=mode, gate=gate)
            assert ops.LAUNCHES[name] == 2
            assert all(torch.equal(a, b) for a, b in zip(one, two))
            plain = idx.search(q, 10, nprobe=nprobe, mode=mode, gate=gate,
                               backend="fused")
            wide = idx.search(q, 11, nprobe=nprobe, mode=mode, gate=gate,
                              backend="fused")
            assert ops.LAUNCHES[name] == 2
            assert float((one.dists - plain.dists).abs().max()) <= tol
            assert torch.equal(one.gate_skipped, plain.gate_skipped)
            clear = (wide.dists.diff(dim=1) > 2 * tol).all(dim=1)
            same = (one.indices == plain.indices).all(dim=1)
            assert bool((same | ~clear).all()) and int(clear.sum()) > 0
            runs[gate] = one
        assert torch.equal(runs[True].indices, runs[False].indices)
        assert torch.equal(runs[True].dists, runs[False].dists)
        assert int(runs[True].gate_skipped.sum()) > 0


@pytest.mark.cuda
def test_full_probe_is_exhaustive_on_the_card(card):
    """On the card K13 at ``nprobe == nlist`` is the oracle bitwise (its
    x·q chain of ``fmaf`` is the twin's ``addcmul`` chain)."""
    idx, q = _card_index(card)
    r = idx.search(q, 10, nprobe=idx.nlist)
    ei, ev = idx.exhaustive(q, 10)
    assert torch.equal(r.indices, ei) and torch.equal(r.dists, ev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "adc"])
def test_scan_kernels_take_max_k_on_the_card(card, mode):
    """At ``k == max_k`` the block, static shared memory included, fits:
    the kernel launches and equals its twin; ``max_k + 1`` raises the typed
    error that names the limit."""
    idx, q = _card_index(card)
    q = q[:2]
    probed, qdots = ivf_mod._route(
        q, idx.centroids, idx.centroid_norms, idx.super_centers,
        idx.super_radii, idx.super_sizes, nprobe=4)
    tiles = (probed.float() @ idx.list_tiles.float()) > 0.0
    ids, nact = bounds.compact_ids(tiles)
    if mode == "exact":
        fn, twin = ks.ivf_scan, ks.ivf_scan_torch
        args = (q, idx.points, idx.norms, idx.centers, idx.radii, ids, nact)
        limit = ks.max_k(q.shape[1], idx.block_n)
    else:
        pq = idx.pq
        fn, twin = ks.ivf_adc_scan, ks.ivf_adc_scan_torch
        lut = ivf_mod._adc_lut(q, pq.codebook)
        args = (q, lut, qdots, pq.codes, idx.labels, pq.u, pq.centers,
                pq.radii, ids, nact)
        limit = ks.max_k(q.shape[1], idx.block_n, lut.shape[1],
                         lut.shape[2], qdots.shape[1])
    got = fn(*args, k=limit, block_n=idx.block_n)
    torch.cuda.synchronize()
    want = twin(*args, k=limit, block_n=idx.block_n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(InvalidInputError, match=str(limit)):
        fn(*args, k=limit + 1, block_n=idx.block_n)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 33, 100, 200])
def test_k13_tile_topk_matches_plain_on_the_card(card, k):
    """K13's part (a) against its plain version on the same card inputs,
    bitwise, at k in each of its register-list widths (k <= 32, 64, 128)
    and past them (the rank path), at nprobe 8 and full probe; no launch
    counted (a part is no whole K13)."""
    idx, q = _card_index(card)
    for nprobe in (8, idx.nlist):
        ids, nact = _port_maps(idx, q, nprobe)
        ops.reset_launches()
        got = ks._launch_topk(q, idx.points, idx.norms, idx.centers,
                              idx.radii, ks._pair_maps(ids, nact), k,
                              idx.block_n, False)[:2]
        assert not any(ops.LAUNCHES.values())
        want = ks.tile_topk_torch(q, idx.points, idx.norms, ids, nact, k=k,
                                  block_n=idx.block_n)
        assert got[0].shape == (int(nact.sum()), k)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("nprobe", [4, 40])
def test_k13_is_its_twin_bitwise_on_the_card(card, nprobe):
    """The whole K13 (glue, part (a), part (b)) bitwise ``ivf_scan_torch``
    with 150 queries (a tile's pairs in chunks of 64, 64 and 22 at full
    probe; at nprobe 4 some tile no query probes), gate on and off, and on
    random maps; two launches the same bits."""
    idx, q = _card_index(card)
    q = torch.cat([q, q, q[:22]]).contiguous()
    for maps in ("route", "random"):
        if maps == "route":
            ids, nact = _port_maps(idx, q, nprobe)
        else:
            ids, nact = (t.to(card) for t in _random_maps(
                np.random.default_rng(nprobe), len(q), idx.n_tiles))
        used = torch.arange(idx.n_tiles, device=card)[None, :] \
            < nact[:, None].long()
        probes = torch.bincount(ids.long()[used], minlength=idx.n_tiles)
        if maps == "route" and nprobe == 4:
            assert int((probes == 0).sum()) > 0
        if maps == "route" and nprobe == idx.nlist:
            assert int(probes.max()) == len(q) and len(q) % ks.CHUNK
        args = (q, idx.points, idx.norms, idx.centers, idx.radii, ids, nact)
        for gate in (True, False):
            got = ks.ivf_scan(*args, k=10, block_n=idx.block_n, gate=gate)
            again = ks.ivf_scan(*args, k=10, block_n=idx.block_n, gate=gate)
            want = ks.ivf_scan_torch(*args, k=10, block_n=idx.block_n,
                                     gate=gate)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_k13_runs_in_query_groups_on_the_card(card, monkeypatch):
    """With the card's memory for only some queries' scratch, K13 runs in
    query groups, one counted launch each, and gives the one-group bits."""
    idx, q = _card_index(card)
    ids, nact = _port_maps(idx, q, 8)
    args = (q, idx.points, idx.norms, idx.centers, idx.radii, ids, nact)
    want = ks.ivf_scan(*args, k=10, block_n=idx.block_n)
    budget = 3 * int(nact.max())
    groups = ks.query_groups(nact, budget)
    assert len(groups) > 2
    monkeypatch.setattr(ks, "_free_bytes",
                        lambda device: budget * (80 + ks.PAIR_BYTES))
    ops.reset_launches()
    got = ks.ivf_scan(*args, k=10, block_n=idx.block_n)
    assert ops.LAUNCHES["ivf_scan"] == len(groups)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(
        got, ks.ivf_scan_torch(*args, k=10, block_n=idx.block_n)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 33, 100, 200, "max_k"])
def test_k14_is_its_twin_bitwise_on_the_card(card, k):
    """K14 on the card (part (a), a block per query, then K13's replay)
    bitwise ``ivf_adc_scan_torch`` at k in each of part (a)'s register-list
    widths and past them (the rank path), with 150 queries, and at
    ``max_k`` with 4 queries, at nprobe 8 and full probe and on random
    maps, gate on and off; part (a) bitwise its plain version; two launches
    the same bits, each counted once."""
    idx, q = _card_index(card)
    if k == "max_k":
        n_sub, n_codes = idx.pq.codebook.centroids.shape[:2]
        q = q[:4].contiguous()
        k = ks.max_k(q.shape[1], idx.block_n, n_sub, n_codes, idx.nlist)
    else:
        q = torch.cat([q, q, q[:22]]).contiguous()
    for maps in (8, idx.nlist, "random"):
        args, ids, nact = _adc_args(idx, q, 8 if maps == "random" else maps)
        if maps == "random":
            ids, nact = (t.to(card) for t in _random_maps(
                np.random.default_rng(k), len(q), idx.n_tiles))
        want_a = ks.adc_tile_topk_torch(q, *args[:5], ids, nact, k=k,
                                        block_n=idx.block_n)
        got_a = ks._launch_adc_topk(q, *args, ids, nact,
                                    ks._pair_start(nact), k, idx.block_n,
                                    True)
        assert all(torch.equal(a, b) for a, b in zip(got_a, want_a))
        for gate in (True, False):
            ops.reset_launches()
            got = ks.ivf_adc_scan(q, *args, ids, nact, k=k,
                                  block_n=idx.block_n, gate=gate)
            again = ks.ivf_adc_scan(q, *args, ids, nact, k=k,
                                    block_n=idx.block_n, gate=gate)
            assert ops.LAUNCHES["ivf_adc_scan"] == 2
            want = ks.ivf_adc_scan_torch(q, *args, ids, nact, k=k,
                                         block_n=idx.block_n, gate=gate)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert all(torch.equal(a, b) for a, b in zip(got, again))
