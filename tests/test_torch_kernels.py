"""The port's two kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold it
against ``repro.kernels.ops`` run in interpret mode, on the same inputs
made from a seed with numpy:

* K2 ``distance_min_update`` (``repro/kernels/kmeans_distance.py:99``):
  the seeding round's D² min-update and per-tile partials;
* K3 ``lloyd_assign_tiled`` (``repro/kernels/lloyd_assign.py:324``): the
  tiled assignment round's labels, D², per-tile partials and gaps, and
  per-super-tile cluster sums and counts.

Tests marked ``cuda`` hold the CUDA kernels against the plain versions on
the card and skip without one.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_jaxref import (EPS32, assert_labels_match, d2_tol, exact_d2,
                               np32, ref)  # noqa: F401  (ref is a fixture)
from repro_torch.core import bounds
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
# wrapper contract and tile geometry (no card needed)
# ---------------------------------------------------------------------------


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    x = torch.from_numpy(_data(500, 2, seed=3))
    ops.reset_launches()
    kd.distance_min_update(x, bounds.point_norms(x), x[:1].contiguous(),
                           torch.full((500,), torch.inf), block_n=128)
    la.lloyd_assign_tiled(x, bounds.point_norms(x), x[:3].contiguous(),
                          block_n=128, tps=1)
    assert ops.LAUNCHES == {"distance_min_update": 0,
                            "lloyd_assign_tiled": 0}


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
    s_of = np.arange(n) // (1024 * tps)
    n_super = got[4].shape[0]
    counts = np.zeros((n_super, k))
    np.add.at(counts, (s_of, a), 1)
    np.testing.assert_array_equal(got[5].cpu().numpy(), counts)
    sums = np.zeros((n_super, k, d))
    abs_sum = np.zeros((n_super, k, d))
    np.add.at(sums, (s_of, a), xn.astype(np.float64))
    np.add.at(abs_sum, (s_of, a), np.abs(xn))
    assert (np.abs(got[4].cpu().numpy() - sums) <= 1e-5 * abs_sum + 1e-6).all()


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
