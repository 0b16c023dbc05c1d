"""The screened route of the batched assignment rounds (K10a, K10b at d >= 8).

On the card, ``csrc/lloyd_assign.cu`` screens every (row, centroid) pair on
the tensor cores (TF32 for fp32 streams, bf16 for bf16 streams), keeps the
centroids whose screened value A' = cn - 2 x.c is at most T' = max(a2,
-xn) + 2 eps, a2 the second smallest of the row's group minima seen so far
(never below the second smallest A'), and rechecks only those with the
round's exact arithmetic; a row with a non-finite value or more than 16
candidates takes the full scan. This file holds a plain PyTorch copy of
that candidate rule, used only here, with the margin ``screen_eps`` copied
from the source's header (its constants: 2^-9 + 2^-20 for TF32 operands,
(d + 1) 2^-20 (1 + 2^-8) for the accumulation, gamma_d = d 2^-24 /
(1 - d 2^-24) for the exact chain, 4 2^-24 for the two combinations, d
2^-124 (1 + sqrt(xx) + sqrt(cnmax)) for underflow, 1 + 2^-9 on P and
1 + 2^-7 on the whole), and checks on adversarial data that:

- the candidates always hold the exact best and second of ``tile_d2`` (the
  twins' D²), with TF32 emulated by clearing the low 13 mantissa bits
  (truncation, the hardware's worst case), bf16 products exact, and every
  screened dot product moved by the whole accumulation term in the
  direction that hurts: up for the true best and second, down for the
  rest;
- the merge over the candidates on (value, index) gives labels, D² and
  second bitwise equal to ``argmin``, ``amin`` and the second of
  ``tile_d2`` over all k;
- a row with a non-finite value is sent to the full scan.

Tests marked ``cuda`` hold the kernels themselves bitwise to K3/K6 row by
row on such data, on the card.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.core import bounds
from repro_torch.kernels import lloyd_assign as la
from repro_torch.kernels import ops
from repro_torch.kernels.kmeans_distance import tile_d2

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "lloyd_assign.cu")
MAX_CAND = 16
F32_MAX = float(np.finfo(np.float32).max)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values as the TF32 tensor cores read them: the low 13 mantissa
    bits cleared (truncation toward zero)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def screen_eps(xx, xn, cnmax, d: int, bf16: bool) -> torch.Tensor:
    """The screen's margin per row, fp32 in the source's order (its header
    derives it); -1 where S + 2 eps is not below 1e37 (the row takes the
    full scan; false for inf and NaN)."""
    f = torch.float32
    xx, xn = xx.to(f), xn.to(f)
    cnmax = torch.as_tensor(cnmax, dtype=f)
    du = torch.tensor(d, dtype=f) * 2.0 ** -24
    rel = (2.0 * ((0.0 if bf16 else 2.0 ** -9 + 2.0 ** -20)
                  + torch.tensor(d + 1, dtype=f) * 2.0 ** -20
                  * (1.0 + 2.0 ** -8))
           + 2.0 * (du / (1.0 - du)))
    sx, sc = xx.sqrt(), cnmax.sqrt()
    P = sx * sc * (1.0 + 2.0 ** -9)
    S = xn.abs() + cnmax + 3.0 * P
    eps = (1.0 + 2.0 ** -7) * (rel * P + 4.0 * 2.0 ** -24 * S
                               + torch.tensor(d, dtype=f) * 2.0 ** -124
                               * (1.0 + sx + sc))
    return torch.where(S + 2.0 * eps < 1e37, eps, torch.full_like(eps, -1.0))


def exact_parts(x, c, xn):
    """tile_d2's D² (n, k) and per row its argmin, amin and second (the
    smallest over the other centroids: the multiset second)."""
    e = tile_d2(x, c, xn)
    lab = e.argmin(dim=1)
    won = lab[:, None] == torch.arange(c.shape[0])
    return e, lab, e.amin(dim=1), torch.where(won, torch.inf, e).amin(dim=1)


def group_of(k: int) -> torch.Tensor:
    """The kernel's groups of a row's centroids (k,): centroid c lies in
    wgmma w = c // 128 (128 centroids each, in order), in quad lane
    q = (c % 8) // 2 of it and in group G = (c % 128) // 32 of that lane
    (the lane's 8 values of the row with 8 g4 + 2 q + p, g4 // 4 = G)."""
    c = torch.arange(k)
    w, col = c // 128, c % 128
    return (w * 4 + (col % 8) // 2) * 4 + col // 32


def screen(x, c, xn, *, bf16: bool, adverse=None):
    """The candidate rule on fp32 rows ``x`` (n, d) and centroids ``c``
    (k, d) (a bf16 stream's values widened): (candidates (n, k) bool, eps
    (n,)). ``adverse`` (n, k) bool marks the pairs whose screened value is
    pushed up by the whole accumulation term; the rest are pushed down.
    As the kernel: one pass over the wgmmas of 128 centroids; after each,
    the row's two smallest group minima so far (a2 the second), the
    threshold T' = min(max(a2, -xn) + 2 eps, FLT_MAX), and that wgmma's
    candidates A' <= T'."""
    n, d = x.shape
    k = c.shape[0]
    xo, co = (x, c) if bf16 else (tf32(x), tf32(c))
    dots = xo.double() @ co.double().T              # exact products, fp64
    absdots = xo.double().abs() @ co.double().abs().T
    err = (d + 1) * 2.0 ** -20 * absdots
    if adverse is not None:
        dots = dots + torch.where(adverse, -err, err)
    acc = dots.float()
    cn = (c * c).sum(dim=1)                          # tile_d2's cn
    a = (cn.double()[None, :] - 2.0 * acc.double()).float()   # one rounding
    cnmax = cn.max() if bool(torch.isfinite(cn).all()) \
        else torch.tensor(float("nan"))
    eps = screen_eps((x * x).sum(dim=1), xn, cnmax, d, bf16)
    grp = group_of(k)
    n_groups = 16 * -(-k // 128)            # 4 lanes x 4 groups a wgmma
    gmin = torch.full((n, n_groups), torch.inf)
    gmin = gmin.scatter_reduce(1, grp.expand(n, k),
                               torch.where(torch.isnan(a), torch.inf, a),
                               "amin")
    cand = torch.zeros((n, k), dtype=torch.bool)
    for w in range(-(-k // 128)):
        seen = gmin[:, :4 * 4 * (w + 1)]
        two = seen.topk(2, dim=1, largest=False).values
        thr = torch.clamp(torch.maximum(two[:, 1], -xn) + 2.0 * eps,
                          max=F32_MAX)
        cols = slice(128 * w, min(k, 128 * (w + 1)))
        cand[:, cols] = a[:, cols] <= thr[:, None]
    return cand & (eps[:, None] >= 0), eps


def merged(e, cand):
    """The recheck's merge on (value, index) over the candidates: label,
    D² and second per row."""
    m = torch.where(cand, e, torch.inf)
    lab = m.argmin(dim=1)
    won = lab[:, None] == torch.arange(e.shape[1])
    return lab, m.amin(dim=1), torch.where(won, torch.inf, m).amin(dim=1)


def adversarial(seed: int, n: int, d: int, k: int, shift: float,
                nan_row: bool):
    """Rows and centroids with duplicated centroids, rows exactly between
    two centroids and on one, a zero row, optionally a NaN row, everything
    shifted by ``shift`` (norms far above the distances)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d)).astype(np.float32)
    if k >= 4:
        c[1] = c[0]
        c[k - 1] = c[2]
    lab = rng.integers(0, k, size=n)
    x = (c[lab] + 0.05 * rng.normal(size=(n, d))).astype(np.float32)
    if k >= 2:
        x[2] = 0.5 * (c[0] + c[k - 1])
        x[3] = 0.5 * (c[2] + c[k // 2])
    x[4] = c[k - 1]
    x += np.float32(shift)
    c += np.float32(shift)
    x[0] = 0.0
    if nan_row:
        x[1] = np.nan
    return torch.from_numpy(x), torch.from_numpy(c)


def _stream(x, c, bf16):
    """The round's inputs: the stream (rounded to bf16 and widened, or
    fp32) and the fp32 points' norms, as the engine passes them."""
    xn = bounds.point_norms(x)
    if bf16:
        x, c = x.bfloat16().float(), c.bfloat16().float()
    return x, c, xn


CASES = st.tuples(st.sampled_from([8, 13, 16, 128]),
                  st.sampled_from([1, 8, 250, 256]),
                  st.integers(0, 2 ** 31 - 1))


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("shift", [0.0, 1e3], ids=["centred", "shifted"])
@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(case=CASES)
def test_candidates_hold_the_exact_best_and_second(bf16, shift, case):
    """Every screened row's candidates hold tile_d2's best (the first index
    of the minimum) and a centroid other than it at the second's value,
    under the adversarial push of every screened dot product."""
    d, k, seed = case
    x, c, xn = _stream(*adversarial(seed, 96, d, k, shift, nan_row=False),
                       bf16)
    e, lab, best, second = exact_parts(x, c, xn)
    want = torch.zeros_like(e, dtype=torch.bool)
    want[torch.arange(e.shape[0]), lab] = True
    want |= (e == second[:, None]) & torch.isfinite(second)[:, None]
    cand, eps = screen(x, c, xn, bf16=bf16, adverse=want)
    rows = eps >= 0
    assert bool(rows.any())
    assert bool(cand[rows, lab[rows]].all())
    has2 = torch.isfinite(second) & rows
    other = cand & (e == second[:, None])
    other[torch.arange(e.shape[0]), lab] = False
    assert bool(other[has2].any(dim=1).all())


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("shift", [0.0, 1e3], ids=["centred", "shifted"])
@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(case=CASES)
def test_merge_over_candidates_is_the_full_argmin(bf16, shift, case):
    """On every row the recheck screens (at most 16 candidates), the merge
    over the candidates gives labels, D² and second bitwise equal to the
    argmin, amin and second of tile_d2 over all k; the other rows take the
    full scan, which is the same merge over every centroid."""
    d, k, seed = case
    x, c, xn = _stream(*adversarial(seed, 96, d, k, shift, nan_row=True),
                       bf16)
    e, lab, best, second = exact_parts(x, c, xn)
    want = torch.zeros_like(e, dtype=torch.bool)
    want[torch.arange(e.shape[0]), lab] = True
    want |= e == second[:, None]
    cand, eps = screen(x, c, xn, bf16=bf16, adverse=want)
    full = (eps < 0) | (cand.sum(dim=1) > MAX_CAND)
    assert bool(full[1])                       # the NaN row
    got = merged(e, cand | full[:, None])
    ref = merged(e, torch.ones_like(cand))
    keep = ~full
    assert torch.equal(got[0][keep], lab[keep])
    for g_, w_ in ((got[1], best), (got[2], second)):
        assert torch.equal(g_[keep].view(torch.int32),
                           w_[keep].view(torch.int32))
    for g_, r_ in zip(got, ref):
        assert torch.equal(g_.view(torch.int32) if g_.is_floating_point()
                           else g_, r_.view(torch.int32)
                           if r_.is_floating_point() else r_)


@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
def test_nonfinite_rows_and_centroids_take_the_full_scan(bf16):
    """eps < 0 (no screen, the full scan) for a NaN or inf row, for a row
    whose values overflow, and for every row when a centroid is not
    finite; a zero row is screened, with a positive margin."""
    x, c = adversarial(5, 16, 16, 8, 0.0, nan_row=True)
    x[2, 3] = torch.inf
    x[3] = 3e19                                   # x² overflows
    x_, c_, xn = _stream(x, c, bf16)
    _, eps = screen(x_, c_, xn, bf16=bf16)
    assert bool((eps[1:4] < 0).all())
    assert float(eps[0]) > 0 and bool((eps[4:] > 0).all())
    c[5, 0] = torch.nan
    x_, c_, xn = _stream(x, c, bf16)
    _, eps = screen(x_, c_, xn, bf16=bf16)
    assert bool((eps < 0).all())


def test_tf32_truncation_bound():
    """The TF32 emulation truncates: each value moves toward zero by less
    than 2^-10 of itself, the operand term the margin assumes."""
    v = torch.randn(10_000) * 10.0 ** torch.randint(-30, 30, (10_000,))
    t = tf32(v)
    assert bool((t.abs() <= v.abs()).all())
    assert bool(((v - t).abs() <= v.abs() * 2.0 ** -10).all())
    assert torch.equal(tf32(t), t)


def test_eps_copy_names_the_source_constants():
    """The Python copy of the margin and the CUDA source's ``screen_eps``
    and per-problem ``rel`` use the same constants."""
    src = CSRC.read_text()
    body = src[src.index("float screen_eps("):]
    body = body[:body.index("\n}\n")]
    for const in ("0x1p-9f", "0x1p-7f", "0x1p-24f", "0x1p-124f", "3.f * P",
                  "1e37f"):
        assert const in body, const
    rel = re.search(r"const float rel =(.*?);", src, re.S).group(1)
    for const in ("0x1p-9f + 0x1p-20f", "0x1p-20f * (1.f + 0x1p-8f)",
                  "du / (1.f - du)"):
        assert const in rel, const


def screened_gated(x, xn, c, delta, thresh, absorb, prev_a, prev_md,
                   prev_lb, active, *, block_n: int, bf16: bool):
    """A plain copy of K6's screened route (d >= 8), its labels, D² and lb:
    the twin's prune (``bounds.assign_point_prune``), then on the rows it
    keeps the candidate rule (every screened dot product pushed
    adversarially) and the recheck's merge over the candidates, or over
    every centroid for a row on the full scan; a pruned row keeps its
    carried label and D² and takes lb = prev_lb - absorb; a skipped tile
    keeps its carries. ``x`` and ``c`` are the stream's values widened."""
    n = x.shape[0]
    act_pt = bounds.expand_mask(active, block_n, n)
    prune = bounds.assign_point_prune(
        prev_a, prev_md, prev_lb, delta,
        bounds.expand_mask(thresh, block_n, n), act_pt)
    e, lab, _, second = exact_parts(x, c, xn)
    want = torch.zeros_like(e, dtype=torch.bool)
    want[torch.arange(n), lab] = True
    want |= e == second[:, None]
    cand, eps = screen(x, c, xn, bf16=bf16, adverse=want)
    full = (eps < 0) | (cand.sum(dim=1) > MAX_CAND)
    a, md, sec = merged(e, cand | full[:, None])
    a = torch.where(prune, prev_a.long(), a)
    md = torch.where(prune, prev_md, md)
    lb = torch.where(prune,
                     prev_lb - bounds.expand_mask(absorb, block_n, n),
                     sec.sqrt())
    return (torch.where(act_pt, a.int(), prev_a),
            torch.where(act_pt, md, prev_md),
            torch.where(act_pt, lb, prev_lb))


@pytest.mark.parametrize("d", [8, 16, 128])
@pytest.mark.parametrize("k", [1, 64, 256, 300])
@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
@pytest.mark.parametrize("shift", [0.0, 1e3], ids=["centred", "shifted"])
def test_k6_screened_route_is_the_twin(d, k, bf16, shift):
    """K6's screened route in plain torch (:func:`screened_gated`) from a
    carried state (one all-active round without a bound, then two
    centroids moved), bitwise ``lloyd_assign_gated_torch`` in labels, D²
    and lb for the masks all, half the supers and the movement gate's,
    both streams, on adversarial rows (k = 300 takes three wgmma groups)."""
    bn, tps = 128, 2
    x, c = adversarial(3 * d + k, 600, d, k, shift, nan_row=False)
    n = x.shape[0]
    cache = bounds.prologue(x, bn)
    xs, cs, xn = _stream(x, c, bf16)   # the stream widened, fp32 norms
    xk = x.bfloat16() if bf16 else x   # the stream as the round reads it
    t = -(-n // bn)
    s_ = -(-t // tps)
    zt = torch.zeros(t)
    first = la.lloyd_assign_gated_torch(
        xk, xn, cs.to(xk.dtype), torch.zeros(k), zt, zt,
        torch.zeros(n, dtype=torch.int32), torch.zeros(n),
        torch.full((n,), -torch.inf), zt, zt, torch.zeros((s_, k, d)),
        torch.zeros((s_, k)), torch.ones(t, dtype=torch.bool), block_n=bn,
        tps=tps)
    st = bounds.BoundState(first[3], tile_gap=first[4], tile_sums=first[5],
                           tile_counts=first[6], assignment=first[0],
                           min_d2=first[1], point_lb=first[2], lb_debt=zt)
    c0 = cs
    c1 = c0.clone()
    if k > 1:
        c1[[0, k - 1]] += 0.002
    delta = bounds.centroid_movement(c1, c0)
    c1 = _stream(x, c1, bf16)[1]
    thresh, absorb = bounds.assign_point_scalars(delta, c1, st, cache)
    masks = {"all": torch.ones(t, dtype=torch.bool),
             "half": (torch.arange(t) // tps) % 2 == 0,
             "gate": bounds.expand_active_supers(bounds.assign_active_tiles(
                 delta, c1, st, cache, tps=tps), tps)}
    pruned = 0
    for name, act in masks.items():
        carry = (st.assignment, st.min_d2, st.point_lb)
        want = la.lloyd_assign_gated_torch(
            xk, xn, c1.to(xk.dtype), delta, thresh, absorb, *carry,
            st.partials, st.tile_gap, st.tile_sums, st.tile_counts, act,
            block_n=bn, tps=tps)
        got = screened_gated(xs, xn, c1, delta, thresh, absorb, *carry, act,
                             block_n=bn, bf16=bf16)
        assert torch.equal(got[0], want[0]), name
        for g_, w_ in zip(got[1:], want[1:3]):
            assert torch.equal(g_.view(torch.int32), w_.view(torch.int32)), \
                name
        pruned += int(want[7].sum())
    assert pruned > 0 or k == 1 or shift > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


WIDTHS = [(2, False, False), (7, True, False), (8, False, True),
          (13, True, True), (16, False, True), (128, False, True),
          (129, False, False), (256, True, True), (257, True, False)]


@pytest.mark.cuda
def test_screened_widths_on_card(card):
    """The route's widths as the CUDA source decides them: d >= 8 and the
    row padded to 8 fp32 or 16 bf16 values at most 512 bytes."""
    for d, bf16, want in WIDTHS:
        assert la.screened(d, bf16) == want, (d, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(8, 256), (13, 250), (16, 256), (16, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_screened_rounds_are_k3_and_k6_row_by_row(card, d, k, dtype):
    """K10a and K10b on the screened route, on adversarial rows (duplicated
    centroids, rows between two centroids, a zero row, a NaN row, half the
    problems shifted by 1e3; k = 300 takes two centroid chunks): every
    problem bitwise the templates' K3 and K6
    (``lloyd_assign_tiled_template``, K10a;
    ``lloyd_assign_gated_template``, K10b) on its slice, an all-active
    K10b with no
    carried bound bitwise K10a, and the route taken."""
    assert la.screened(d, dtype == torch.bfloat16)
    xs, cs = zip(*(adversarial(7 + b, 3_000, d, k, 1e3 * (b % 2), True)
                   for b in range(4)))
    x = torch.stack(xs).to(card)
    c = torch.stack(cs).to(card)
    norms = bounds.point_norms(x)
    x, c = x.to(dtype), c.to(dtype)
    bn = ops.choose_block_n(x.shape[1], d, k)
    t = -(-x.shape[1] // bn)
    tps = bounds.tiles_per_super(t)
    s = -(-t // tps)
    out = la.lloyd_assign_tiled_batched(x, norms, c, block_n=bn, tps=tps)
    assert la.screen_stats("lloyd_assign_tiled_batched")["rows"] \
        == x.shape[0] * x.shape[1]
    for b in range(x.shape[0]):
        one = la.lloyd_assign_tiled_template(x[b], norms[b], c[b],
                                             block_n=bn, tps=tps)
        for u, v in zip(out, one):
            assert torch.equal(u[b].view(torch.int32), v.view(torch.int32))
    bsz, n = x.shape[:2]
    zt = torch.zeros((bsz, t), device=card)
    gated = la.lloyd_assign_gated_batched(
        x, norms, c, torch.zeros((bsz, k), device=card), zt, zt,
        torch.zeros((bsz, n), dtype=torch.int32, device=card),
        torch.zeros((bsz, n), device=card),
        torch.full((bsz, n), -torch.inf, device=card), zt, zt,
        torch.zeros((bsz, s, k, d), device=card),
        torch.zeros((bsz, s, k), device=card),
        torch.ones((bsz, t), dtype=torch.bool, device=card), block_n=bn,
        tps=tps)
    for u, v in zip((gated[0], gated[1], gated[3], gated[4], gated[5],
                     gated[6]), out):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
    args = (x, norms, c, torch.zeros((bsz, k), device=card),
            torch.full((bsz, t), -1.0, device=card), zt, gated[0], gated[1],
            gated[2], gated[3], gated[4], gated[5], gated[6],
            torch.ones((bsz, t), dtype=torch.bool, device=card))
    again = la.lloyd_assign_gated_batched(*args, block_n=bn, tps=tps)
    assert int(again[7].sum()) > 0
    for b in range(bsz):
        one = la.lloyd_assign_gated_template(*(a[b] for a in args),
                                             block_n=bn, tps=tps)
        for u, v in zip(again, one):
            assert torch.equal(u[b].view(torch.int32), v.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 8, 13, 16, 128])
@pytest.mark.parametrize("k", [1, 64, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_routes_are_the_template_bitwise(card, d, k, dtype):
    """K6 on its routes (the screened route at d >= 8, the split row pass
    below) against the template kernel's entry on the same inputs, all eight
    outputs bitwise (int32 views), for the masks all, half the supers and
    the movement gate's, from a carried state on adversarial rows; with no
    carried bound and every tile active bitwise K3; two launches the same
    bits."""
    x, c = adversarial(11 + d + k, 20_000, d, k, 0.0, False)
    x, c = x.to(card), c.to(card)
    n = x.shape[0]
    bn = ops.choose_block_n(n, d, k)
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    cache = bounds.prologue(x, bn)   # the fp32 points' norms and balls
    norms = cache.norms
    x = x.to(dtype)
    c0 = c.float().contiguous()
    zt = torch.zeros(t, device=card)
    s = -(-t // tps)
    args0 = (x, norms, c0.to(dtype), torch.zeros(k, device=card), zt, zt,
             torch.zeros(n, dtype=torch.int32, device=card),
             torch.zeros(n, device=card),
             torch.full((n,), -torch.inf, device=card), zt, zt,
             torch.zeros((s, k, d), device=card),
             torch.zeros((s, k), device=card),
             torch.ones(t, dtype=torch.bool, device=card))
    first = la.lloyd_assign_gated(*args0, block_n=bn, tps=tps)
    tmpl = la.lloyd_assign_gated_template(*args0, block_n=bn, tps=tps)
    k3 = la.lloyd_assign_tiled(x, norms, c0.to(dtype), block_n=bn, tps=tps)
    _bitwise(first, tmpl)
    _bitwise((first[0], first[1], first[3], first[4], first[5], first[6]),
             k3)
    assert int(first[7].sum()) == 0
    c1 = c0.clone()
    if k > 1:
        c1[[0, k - 1]] += 0.002
    st = bounds.BoundState(first[3], tile_gap=first[4], tile_sums=first[5],
                           tile_counts=first[6], assignment=first[0],
                           min_d2=first[1], point_lb=first[2], lb_debt=zt)
    delta = bounds.centroid_movement(c1, c0)
    thresh, absorb = bounds.assign_point_scalars(delta, c1, st, cache)
    masks = {"all": torch.ones(t, dtype=torch.bool, device=card),
             "half": (torch.arange(t, device=card) // tps) % 2 == 0,
             "gate": bounds.expand_active_supers(bounds.assign_active_tiles(
                 delta, c1, st, cache, tps=tps), tps)}
    for name, act in masks.items():
        args = (x, norms, c1.to(dtype), delta, thresh, absorb,
                st.assignment, st.min_d2, st.point_lb, st.partials,
                st.tile_gap, st.tile_sums, st.tile_counts, act)
        ops.reset_launches()
        got = la.lloyd_assign_gated(*args, block_n=bn, tps=tps)
        again = la.lloyd_assign_gated(*args, block_n=bn, tps=tps)
        want = la.lloyd_assign_gated_template(*args, block_n=bn, tps=tps)
        counted = "lloyd_assign_gated" + ("_bf16" if dtype == torch.bfloat16
                                          else "")
        assert ops.LAUNCHES[counted] == 2, name
        assert sum(ops.LAUNCHES.values()) == 2, name
        _bitwise(got, again)
        _bitwise(got, want)
        if la.screened(d, dtype == torch.bfloat16):
            st_ = la.screen_stats("lloyd_assign_gated")
            pruned = int(got[7].sum())
            active_rows = int(bounds.expand_mask(act, bn, n).sum())
            assert st_["rows"] == active_rows - pruned, name


def _bitwise(got, want):
    for u, v in zip(got, want):
        assert u.dtype == v.dtype
        if u.dtype == torch.float32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 16, 128])
@pytest.mark.parametrize("k", [1, 50, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0.0, 1e3], ids=["centred", "shifted"])
def test_k3_routes_are_the_template_bitwise(card, d, k, dtype, shift):
    """K3 on its routes (the screened route at d >= 8, the row pass below)
    against the template entry (``lloyd_assign_tiled_template``) on
    adversarial rows (duplicated centroids, rows between two centroids and
    on one, a zero row, a NaN row; shifted, most values of the fp32 row
    pass fall to 0 or below before the clamp), 20,011 rows in tiles of
    1,024 and ragged supers: all six outputs bitwise (int32 views), two
    launches the same bits, one counted launch, and the screen's counters
    on the screened route."""
    x, c = adversarial(5 + d + k, 20_011, d, k, shift, True)
    x, c = x.to(card), c.to(card)
    norms = bounds.point_norms(x)
    x, c = x.to(dtype), c.to(dtype)
    bn = 1024
    tps = bounds.tiles_per_super(-(-x.shape[0] // bn))
    ops.reset_launches()
    got = la.lloyd_assign_tiled(x, norms, c, block_n=bn, tps=tps)
    again = la.lloyd_assign_tiled(x, norms, c, block_n=bn, tps=tps)
    want = la.lloyd_assign_tiled_template(x, norms, c, block_n=bn, tps=tps)
    counted = "lloyd_assign_tiled" + ("_bf16" if dtype == torch.bfloat16
                                      else "")
    assert ops.LAUNCHES[counted] == 2 and sum(ops.LAUNCHES.values()) == 2
    _bitwise(got, again)
    _bitwise(got, want)
    if la.screened(d, dtype == torch.bfloat16):
        assert la.screen_stats("lloyd_assign_tiled")["rows"] == x.shape[0]


def _blobs(seed: int, n: int, d: int, k: int, dev):
    """Rows 0.01 from one of k well-separated centroids (no near-ties), on
    the card: the twins' matmul-form labels are the kernels' labels."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d)).astype(np.float32)
    lab = rng.integers(0, k, size=n)
    x = (c[lab] + 0.01 * rng.normal(size=(n, d))).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev)


def _near(got, want, tol, rel=0.0):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    err = (got - want)[fin].abs()
    assert bool((err <= tol + rel * want[fin].abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_k6_k4_past_the_old_cap(card, dtype):
    """d = 128, k = 1,024: past the template's staging (k <= 419 at 128-row
    tiles) and pass A's old all-chunk norm staging, the screened K3, K6
    (all active, no carried bound) and K4 run, labels and counts bitwise
    their plain twins', D², partials, gaps and sums within tolerance; K3
    bitwise K10a on one problem, K6's outputs bitwise K3's, and two
    launches the same bits."""
    n, d, k = 30_001, 128, 1024
    x, c = _blobs(3, n, d, k, card)
    norms = bounds.point_norms(x)
    x, c = x.to(dtype), c.to(dtype)
    bn = ops.choose_block_n(n, d, k)
    assert bn == 4096 and ops.template_max_k(d, 128) < k
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    got = la.lloyd_assign_tiled(x, norms, c, block_n=bn, tps=tps)
    _bitwise(got, la.lloyd_assign_tiled(x, norms, c, block_n=bn, tps=tps))
    twin = la.lloyd_assign_tiled_torch(x, norms, c, block_n=bn, tps=tps)
    assert torch.equal(got[0], twin[0])
    assert torch.equal(got[5], twin[5])
    cf = c.float()
    tol = 2 * (d + 4) * 2.0 ** -23 * (float(norms.max())
                                      + float((cf * cf).sum(1).max()))
    _near(got[1], twin[1], tol)
    _near(got[2], twin[2], tol * bn, rel=1e-5)
    _near(got[3], twin[3], 2 * tol ** 0.5)
    # the sums within 1e-4 of the rows' absolute sums under the labels
    slot = (torch.arange(n, device=card) // (bn * tps)) * k + got[0].long()
    absum = torch.zeros((got[4].shape[0] * k, d), device=card).index_add_(
        0, slot, x.float().abs()).view(got[4].shape)
    assert bool(((got[4] - twin[4]).abs() <= 1e-4 * absum + 1e-6).all())
    one = la.lloyd_assign_tiled_batched(x[None], norms[None], c[None],
                                        block_n=bn, tps=tps)
    _bitwise((o[0] for o in one), got)
    zt = torch.zeros(t, device=card)
    s = -(-t // tps)
    gated = la.lloyd_assign_gated(
        x, norms, c, torch.zeros(k, device=card), zt, zt,
        torch.zeros(n, dtype=torch.int32, device=card),
        torch.zeros(n, device=card),
        torch.full((n,), -torch.inf, device=card), zt, zt,
        torch.zeros((s, k, d), device=card), torch.zeros((s, k), device=card),
        torch.ones(t, dtype=torch.bool, device=card), block_n=bn, tps=tps)
    _bitwise((gated[0], gated[1], gated[3], gated[4], gated[5], gated[6]),
             got)
    lab, md, sums, counts = la.lloyd_assign(x, norms, c, block_n=bn)
    k4 = la.lloyd_assign_torch(x, norms, c)
    assert torch.equal(lab, k4[0]) and torch.equal(counts, k4[3])
    assert torch.equal(lab, got[0]) and torch.equal(md, got[1])
    _near(sums, k4[2], 1e-4 * float(x.float().abs().sum(0).max()) + 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 5, 16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pass_b_k_chunks_are_one_block_bitwise(card, d, dtype):
    """Pass B with a forced small k-chunk (16 and 100 centroids a block,
    k = 300) bitwise the one-block pass B in every output of K3, K6 (a
    gated round from a carried state), K4 (weighted) and K10a (two
    problems, screened widths)."""
    n, k = 9_000, 300
    x, c = adversarial(d, n, d, k, 0.0, False)
    x, c = x.to(card), c.to(card)
    norms = bounds.point_norms(x)
    x, c = x.to(dtype), c.to(dtype)
    bn = 1024
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    w = torch.rand(n, device=card)
    zt = torch.zeros(t, device=card)
    s_ = -(-t // tps)
    first = la.lloyd_assign_gated(
        x, norms, c, torch.zeros(k, device=card), zt, zt,
        torch.zeros(n, dtype=torch.int32, device=card),
        torch.zeros(n, device=card),
        torch.full((n,), -torch.inf, device=card), zt, zt,
        torch.zeros((s_, k, d), device=card),
        torch.zeros((s_, k), device=card),
        torch.ones(t, dtype=torch.bool, device=card), block_n=bn, tps=tps)
    st = bounds.BoundState(first[3], tile_gap=first[4], tile_sums=first[5],
                           tile_counts=first[6], assignment=first[0],
                           min_d2=first[1], point_lb=first[2], lb_debt=zt)
    c1 = c.float().clone()
    c1[[0, k - 1]] += 0.002
    delta = bounds.centroid_movement(c1, c.float())
    cache = bounds.prologue(x.float(), bn)
    thresh, absorb = bounds.assign_point_scalars(delta, c1, st, cache)
    gargs = (x, norms, c1.to(dtype), delta, thresh, absorb, st.assignment,
             st.min_d2, st.point_lb, st.partials, st.tile_gap, st.tile_sums,
             st.tile_counts, torch.ones(t, dtype=torch.bool, device=card))
    calls = {
        "K3": lambda kc: la.lloyd_assign_tiled(x, norms, c, block_n=bn,
                                               tps=tps, k_chunk=kc),
        "K6": lambda kc: la.lloyd_assign_gated(*gargs, block_n=bn, tps=tps,
                                               k_chunk=kc),
        "K4": lambda kc: la.lloyd_assign(x, norms, c, w, block_n=bn,
                                         k_chunk=kc)}
    if la.screened(d, dtype == torch.bfloat16):
        xb, nb, cb = (torch.stack([v, v.flip(0)]) for v in (x, norms, c))
        calls["K10a"] = lambda kc: la.lloyd_assign_tiled_batched(
            xb, nb, cb, block_n=bn, tps=tps, k_chunk=kc)
    for name, call in calls.items():
        whole = call(0)
        for kc in (16, 100):
            _bitwise(call(kc), whole)


def _lattice(seed: int, n: int, d: int, k: int, dev):
    """k distinct centroids on the integer lattice (at least 1 apart) and
    rows 0.01 from one of them, on the card: well separated at any k."""
    rng = np.random.default_rng(seed)
    side = max(2, int(np.ceil((4 * k) ** (1.0 / d))))
    picked: set = set()
    c = np.empty((k, d), np.float32)
    while len(picked) < k:
        v = tuple(rng.integers(0, side, size=d).tolist())
        if v not in picked:
            c[len(picked)] = v
            picked.add(v)
    c -= np.float32(side / 2)
    lab = rng.integers(0, k, size=n)
    x = (c[lab] + 0.01 * rng.normal(size=(n, d))).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev)


def _near_twin(x, norms, c, lab, md, counts, lb=None):
    """Labels, D² and counts against the plain twins past the old cap, to
    the screen tests' D² tolerance: D² within it, a label that differs only
    between two centroids whose twin D² lie within it (narrow rows with
    thousands of centroids: 1-D lattices), counts off by no more than the
    rows whose labels differ, and lb = sqrt(second) within the tolerance's
    root."""
    d2 = tile_d2(x, c, norms)
    want = d2.argmin(dim=1)
    cf = c.float()
    tol = 2 * (x.shape[1] + 4) * 2.0 ** -23 * (
        float(norms.max()) + float((cf * cf).sum(1).max()))
    _near(md, d2.amin(dim=1), tol)
    diff = lab.long() != want
    gap = (d2.gather(1, lab.long()[:, None])
           - d2.gather(1, want[:, None]))[:, 0].abs()
    assert not bool((diff & (gap > tol)).any())
    wc = torch.bincount(want, minlength=c.shape[0]).float()
    assert float((counts - wc).abs().sum()) <= 2 * int(diff.sum())
    if lb is not None:
        won = lab.long()[:, None] == torch.arange(c.shape[0], device=x.device)
        second = torch.where(won, torch.inf, d2).amin(dim=1)
        _near(lb, second.sqrt(), 2 * tol ** 0.5)


# the (round, width) pairs the template served and refused past its staging,
# with the stream and tile height: K4 at d = 1 and 3..7, K9, K10a and K10b
# below d = 8, and the rounds past the screened widths
REFUSED = [("K4", 1, torch.float32, 1024), ("K4", 5, torch.float32, 1024),
           ("K4", 200, torch.float32, 128), ("K4", 300, torch.bfloat16, 128),
           ("K9", 3, torch.float32, 1024), ("K9", 200, torch.float32, 128),
           ("K10a", 4, torch.float32, 1024),
           ("K10a", 7, torch.bfloat16, 1024),
           ("K10a", 200, torch.float32, 128),
           ("K10b", 4, torch.float32, 1024),
           ("K10b", 200, torch.float32, 128),
           ("K3", 200, torch.float32, 128), ("K3", 300, torch.bfloat16, 128)]


def _gated_first(x, norms, c, bn, tps, batch: bool):
    """K6 (K10b with ``batch``) on a first round's carries (no bound, half
    the supers active): every row of an active super recomputed."""
    lead = x.shape[:-2]
    n, d = x.shape[-2:]
    k = c.shape[-2]
    t = -(-n // bn)
    s_ = -(-t // tps)
    dev = x.device
    zt = torch.zeros(lead + (t,), device=dev)
    act = (torch.arange(t, device=dev) // tps % 2 == 0).expand(lead + (t,))
    args = (x, norms, c, torch.zeros(lead + (k,), device=dev), zt, zt,
            torch.zeros(lead + (n,), dtype=torch.int32, device=dev),
            torch.zeros(lead + (n,), device=dev),
            torch.full(lead + (n,), -torch.inf, device=dev), zt, zt,
            torch.zeros(lead + (s_, k, d), device=dev),
            torch.zeros(lead + (s_, k), device=dev), act.contiguous())
    fn = la.lloyd_assign_gated_batched if batch else la.lloyd_assign_gated
    return fn(*args, block_n=bn, tps=tps), args


@pytest.mark.cuda
@pytest.mark.parametrize("rnd,d,dtype,bn", REFUSED)
def test_formerly_refused_routes_match_twins(card, rnd, d, dtype, bn):
    """The rounds the template served past the screened widths and below
    d = 8 take chunked routes now: one centroid past the old limit
    (``ops.template_max_k``) the round runs and its labels, D² and counts
    match the plain twin; the template entries still raise there, naming
    their limit; at the limit every output is bitwise the template entry
    (K10a and K10b problem by problem bitwise K3 and K6, which are)."""
    gated = rnd == "K10b"
    most = ops.template_max_k(d, bn, gated)
    n = 2 * bn + 17
    x, c = _lattice(d, n, d, most + 1, card)
    norms = bounds.point_norms(x)
    x, c = x.to(dtype), c.to(dtype)
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    w = torch.rand(n, device=card)
    two = lambda v: torch.stack([v, v.flip(0)])   # noqa: E731
    for k in (most + 1, most):
        ck = c[:k].contiguous()
        if rnd == "K4":
            got = la.lloyd_assign(x, norms, ck, w, block_n=bn)
            plain = la.lloyd_assign(x, norms, ck, block_n=bn)
            tmpl = (lambda: la.lloyd_assign_template(x, norms, ck, w,
                                                     block_n=bn))
            check = (plain[0], plain[1], plain[3], None)
        elif rnd == "K9":
            got = la.lloyd_assign_batched(two(x), two(norms), two(ck),
                                          block_n=bn)
            tmpl = (lambda: la.lloyd_assign_batched_template(
                two(x), two(norms), two(ck), block_n=bn))
            check = (got[0][0], got[1][0], got[3][0], None)
        elif rnd == "K3":
            got = la.lloyd_assign_tiled(x, norms, ck, block_n=bn, tps=tps)
            tmpl = (lambda: la.lloyd_assign_tiled_template(
                x, norms, ck, block_n=bn, tps=tps))
            check = (got[0], got[1], got[5].sum(0), None)
        elif rnd == "K10a":
            got = la.lloyd_assign_tiled_batched(two(x), two(norms), two(ck),
                                                block_n=bn, tps=tps)
            tmpl = (lambda: la.lloyd_assign_tiled_template(
                x, norms, ck, block_n=bn, tps=tps))
            check = (got[0][0], got[1][0], got[5][0].sum(0), None)
        else:
            got, gargs = _gated_first(two(x), two(norms), two(ck), bn, tps,
                                      True)
            tmpl = (lambda: la.lloyd_assign_gated_template(
                *(a[0] for a in gargs), block_n=bn, tps=tps))
            act = bounds.expand_mask(gargs[-1][0], bn, n)
            check = (got[0][0][act], got[1][0][act], None, got[2][0][act])
        if k > most:
            lab, md, counts, lb = check
            rows = slice(None) if rnd != "K10b" else act
            _near_twin(x[rows], norms[rows], ck, lab, md,
                       counts if counts is not None
                       else torch.bincount(lab.long(), minlength=k).float(),
                       lb)
            with pytest.raises(ValueError,
                               match=f"template route.*k <= {most}"):
                tmpl()
            continue
        want = tmpl()
        if rnd in ("K4", "K3"):
            _bitwise(got, want)
        elif rnd == "K9":
            _bitwise(got, want)
            _bitwise((o[0] for o in got),
                     la.lloyd_assign(x, norms, ck, block_n=bn))
        elif rnd == "K10a":
            _bitwise((o[0] for o in got), want)
            _bitwise((o[1] for o in got), la.lloyd_assign_tiled(
                x.flip(0), norms.flip(0), ck.flip(0), block_n=bn, tps=tps))
        else:
            _bitwise((o[0] for o in got), want)
            one, _ = _gated_first(x, norms, ck, bn, tps, False)
            _bitwise((o[0] for o in got), one)
