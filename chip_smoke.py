#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH] [--profile]

Phases, each of which exits non-zero on failure:

0. The samplers' prefix sums: ``torch.cumsum`` and ``sampling.prefix_sum``
   (the fixed-order scan the samplers use), each run repeatedly on one
   tensor of the cdf sampler's length (n) and of the tiled sampler's two
   (n_tiles and block_n at the paper's shape); ``prefix_sum`` must give one
   bit pattern at each. The host time of one call of each is printed. For
   batched problems, one row scanned by the samplers' row scan must keep
   its bits whatever the number of rows beside it (``torch.cumsum`` along
   dim 1 is shown beside it, which does not), and rows 0, 1 and B−1 of a
   (B, n) ``prefix_sum`` at the codebook sweep's shape must be the 1-D
   calls.
1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all at once) and print the build time and ptxas report.
2. Hold every kernel against its plain PyTorch twin on the card, at the
   paper's shape (n = 4,000,000, d = 2; label-sorted for the gated seeding
   round, so its gate skips) and a ragged wide one (n = 100,003, d = 128):
   K1 (prologue), K2 (seeding round) with resident centroids on and off at
   m = 1 and m = 8, K3 (tiled assignment) at k = 50 or 64 (tps > 1) and at
   k = 1, K5 (gated seeding round) at m = 1 and 8, resident on and off, with
   the gate's mask, all tiles, half and none active, and K6 (gated
   assignment) at k = 50 or 64 and k = 1 from a carried state whose lower
   bounds make the prune fire, with every tile, half the supers and the
   gate's mask active, K11 (the rejection sampler's drawn-row D²) and K12
   (its per-tile envelope caps, over K1's tile balls) against a pending
   block of 8 centroids with count 0, 1 and 8. Two launches must give
   identical bits, skipped tiles must keep their carried values, all-active
   K5 and K6 (the latter with no carried bound) must be bitwise K2 and K3,
   and K11/K12 must be bitwise their plain twins (+inf everywhere at count
   0). Each kernel's median time (CUDA events) is printed beside its plain
   twin's and its bound (for the gated kernels, from the bytes of the
   active tiles).
3. Drive the main path, ``ClusterEngine(device="cuda").kmeans`` (bound-gated)
   at the paper's size, k = 50, 25 iterations, for sampler cdf and tiled, on
   the shuffled blobs and on a label-sorted copy, with the launch counters
   zeroed just before each run and read just after (K1 once, K5 k times,
   K6 n_iters times, K2/K3 never); each run is held bitwise to
   ``bounds=False`` (seeds, centroids, assignment, inertia, n_iters), and a
   second run to the first. The ungated path is driven the same way
   (K2 k times, K3 n_iters times) and compared with the plain
   ``FusedBackend`` on the card from the same draws.
4. Rejection seeding at the paper's size, ``ClusterEngine(device="cuda")
   .seed/kmeans(sampler="rejection", refresh_block=8)`` for proposal hier
   and flat on both layouts, counted like phase 3: K1 once, K5 once per
   refresh (the schedule's, the exact fallbacks' and the settling one),
   K11 once per proposal, K12 once per round under hier and never under
   flat; ungated, K2 in K5's place and no K12. Held: two runs bitwise
   equal; flat gated bitwise ungated (seeds, D², the kmeans fit); at
   ``refresh_block=1`` hier, flat and the tiled sampler pick the same
   seeds; the returned D² bitwise one K2 fold of all k seeds from +inf;
   the counters under ``core.telemetry``'s contract; the kmeans fit
   bitwise a fit from the seeding's seeds. Seeding ms of rejection beside
   tiled, gated and ungated (median of 3 host-clock runs).
5. Batched problems at ``kvquant-gemma2-2b`` (``configs/kvquant.py``: the
   PQ codebook sweep of one gemma2-2b K tensor, B = 1664 problems of
   n = 16384 rows, d = 16, k = 256, 6 Lloyd iterations; blobs made on the
   card from a seed), bounds off: K7 (batched seeding round, m = 1 and 8)
   and K10a (batched assignment round) against their plain twins, two
   launches bitwise, rows 0, 1 and B−1 bitwise K2/K3 on that problem's
   slice; then ``ClusterEngine(device="cuda", bounds=False)
   .kmeans_batched`` for sampler cdf and tiled, counted (K7 k times, K10a
   once per iteration of the slowest problem, nothing else), a second run
   bitwise, rows 0, 1 and B−1 bitwise the single ``seed`` then ``fit``
   from the same draws, every problem's inertia within 1e-4 of the plain
   fit's from the same seeds. Printed: seeding ms, Lloyd ms per iteration,
   kmeans_batched s and ms per problem beside a loop of single seed + fit
   over 16 problems.
6. With ``--profile`` only: trace one seeding run per sampler (rejection
   hier and flat included) and one Lloyd fit at the paper's shape,
   ungated and gated (shuffled and sorted), and the batched seeding (cdf,
   tiled) and fit at the codebook sweep's, with torch.profiler, and print
   the device time by kernel and the device's idle share.

The last three lines of stdout are the card's name and power limit, the
kernels' JSON record, and ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 rate outside the tensor cores
EPS32 = 2.0 ** -23


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def gpu_ms(torch, fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of ``fn`` from CUDA events. The launches are queued
    behind a device-side sleep, so each event pair brackets device work only,
    not the host's time to issue it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def d2_tol(torch, norms, cents) -> float:
    """Largest |kernel − plain| allowed on a matmul-form D². Each side's
    error is at most (d + 4)·eps·(‖x‖² + ‖c‖²): d roundings in the dot
    product plus the two add/subtracts; the two sides can err in opposite
    directions."""
    d = cents.shape[1]
    cmax = float((cents * cents).sum(dim=1).max())
    return 2 * (d + 4) * EPS32 * (float(norms.max()) + cmax)


def partial_tol(d2tol: float, block_n: int, partials) -> "object":
    """Per-tile partial tolerance: block_n rows of D² error, plus the two
    reduction orders, each within block_n·eps of the tile's sum."""
    return block_n * d2tol + 2 * block_n * EPS32 * partials.abs()


def k2_case(torch, kd, ops, pts, norms, m, resident, gen):
    n, d = pts.shape
    bn = ops.choose_block_n(n, d, 50)
    rows = torch.randint(n, (2 * m,), generator=gen, device=pts.device)
    cents = pts[rows[:m]].contiguous()
    md_in, _ = kd.distance_min_update_torch(
        pts, norms, pts[rows[m:]].contiguous(),
        torch.full((n,), torch.inf, device=pts.device), block_n=bn)
    out1 = kd.distance_min_update(pts, norms, cents, md_in, block_n=bn,
                                  resident=resident)
    out2 = kd.distance_min_update(pts, norms, cents, md_in, block_n=bn,
                                  resident=resident)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K2 m={m} resident={resident}: two launches differ")
    ref = kd.distance_min_update_torch(pts, norms, cents, md_in, block_n=bn)
    tol = d2_tol(torch, norms, cents)
    err_md = float((out1[0] - ref[0]).abs().max())
    check(err_md <= tol, f"K2 min_d2 err {err_md} > {tol}")
    ptol = partial_tol(tol, bn, ref[1])
    check(bool(((out1[1] - ref[1]).abs() <= ptol).all()),
          f"K2 partials outside tolerance (max err "
          f"{float((out1[1] - ref[1]).abs().max())})")
    ms = gpu_ms(torch, lambda: kd.distance_min_update(
        pts, norms, cents, md_in, block_n=bn, resident=resident))
    plain = gpu_ms(torch, lambda: kd.distance_min_update_torch(
        pts, norms, cents, md_in, block_n=bn))
    t = -(-n // bn)
    bms, by = bound_ms(4 * (n * d + 3 * n + m * d + t), n * m * (2 * d + 3))
    return dict(n=n, d=d, m=m, resident=resident, block_n=bn,
                max_abs_err=err_md, tol=tol, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by)


def super_sums_ok(torch, pts, lab, ssums, scounts, rows_per_super,
                  supers=None, s_of=None) -> bool:
    """Super-tile sums and counts against a float64 segment sum over the
    KERNEL's labels ``lab``: counts exact, sums within 1e-4 of the rows'
    absolute sum (the sequential fp32 adds of up to ``rows_per_super``
    rows). ``supers`` (n_super,) bool restricts the check to those supers;
    ``s_of`` (n,) gives each row's super when it is not row //
    rows_per_super (batched problems flattened into one)."""
    n, d = pts.shape
    n_super, k = scounts.shape
    if s_of is None:
        s_of = torch.arange(n, device=pts.device) // rows_per_super
    slot = s_of * k + lab.long()
    want_c = torch.bincount(slot, minlength=n_super * k).view(n_super, k)
    x64 = pts.double()
    want_s = torch.zeros(n_super * k, d, dtype=torch.float64,
                         device=pts.device).index_add_(0, slot, x64)
    abs_s = torch.zeros_like(want_s).index_add_(0, slot, x64.abs())
    ok_s = ((ssums.double().view(-1, d) - want_s).abs()
            <= 1e-4 * abs_s + 1e-6).view(n_super, k, d).all(dim=2)
    ok = ok_s & (scounts == want_c.float())
    if supers is not None:
        ok = ok[supers]
    return bool(ok.all())


def k3_case(torch, la, ops, bounds, pts, norms, k, gen):
    n, d = pts.shape
    bn = ops.choose_block_n(n, d, k)
    tps = bounds.tiles_per_super(-(-n // bn))
    cents = pts[torch.randint(n, (k,), generator=gen,
                              device=pts.device)].contiguous()
    out1 = la.lloyd_assign_tiled(pts, norms, cents, block_n=bn, tps=tps)
    out2 = la.lloyd_assign_tiled(pts, norms, cents, block_n=bn, tps=tps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K3 k={k}: two launches differ")
    lab, md, part, gap, ssums, scounts = out1
    ref = la.lloyd_assign_tiled_torch(pts, norms, cents, block_n=bn, tps=tps)
    tol = d2_tol(torch, norms, cents)
    # labels: equal, except rows whose best and runner-up D² lie within the
    # D² tolerance (then either is a correct argmin)
    d2 = la.tile_d2(pts, cents, norms)
    diff = lab.long() != ref[0].long()
    tie_gap = (d2.gather(1, lab.long()[:, None])
               - d2.gather(1, ref[0].long()[:, None])).abs()[:, 0]
    n_diff = int(diff.sum())
    check(bool((tie_gap[diff] <= tol).all()),
          f"K3 k={k}: {n_diff} labels differ beyond near-ties")
    err_md = float((md - ref[1]).abs().max())
    check(err_md <= tol, f"K3 min_d2 err {err_md} > {tol}")
    check(bool(((part - ref[2]).abs() <= partial_tol(tol, bn, ref[2])).all()),
          "K3 partials outside tolerance")
    # gaps are distance units: sqrt turns a D² error δ into at most √δ
    gfin = torch.isfinite(ref[3])
    check(torch.equal(torch.isfinite(gap), gfin)
          and bool(((gap - ref[3])[gfin].abs() <= 2 * math.sqrt(tol)).all()),
          "K3 gaps outside tolerance")
    check(super_sums_ok(torch, pts, lab, ssums, scounts, bn * tps),
          f"K3 k={k}: super sums or counts outside tolerance")
    n_super = ssums.shape[0]
    ms = gpu_ms(torch, lambda: la.lloyd_assign_tiled(
        pts, norms, cents, block_n=bn, tps=tps))
    plain = gpu_ms(torch, lambda: la.lloyd_assign_tiled_torch(
        pts, norms, cents, block_n=bn, tps=tps))
    t = -(-n // bn)
    bms, by = bound_ms(4 * (n * d + 3 * n + k * d + 2 * t
                            + n_super * k * (d + 1)),
                       n * k * (2 * d + 3) + n * d)
    return dict(n=n, d=d, k=k, block_n=bn, tps=tps, label_diffs=n_diff,
                max_abs_err=err_md, tol=tol, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by)


def timed(torch, fn, plain):
    return gpu_ms(torch, fn), gpu_ms(torch, plain)


def bitwise_err(torch, a, b) -> float:
    """Largest |a − b|, with equal entries (+inf included) counting 0."""
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def rejection_kernel_cases(torch, kd, pts, centers, radii, gen, p=8):
    """K11 and K12 on one shape against a (p, d) pending block, count 0, 1
    and p: each launch bitwise its plain twin and a second launch, +inf
    everywhere at count 0; K11 at four drawn rows. Timed at count p."""
    n, d = pts.shape
    dev = pts.device
    pend = pts[torch.randint(n, (p,), generator=gen, device=dev)].contiguous()
    rows = torch.randint(n, (4,), generator=gen, device=dev)
    err11 = err12 = 0.0
    for count in (0, 1, p):
        cnt = torch.tensor(count, dtype=torch.int32, device=dev)
        what = f"n={n} d={d} count={count}"
        for i in rows.unbind():
            a = kd.row_min_d2(pts, i, pend, cnt)
            b = kd.row_min_d2(pts, i, pend, cnt)
            plain = kd.row_min_d2_torch(pts, i, pend, cnt)
            check(torch.equal(a, b), f"K11 {what}: two launches differ")
            check(torch.equal(a, plain),
                  f"K11 {what}: {float(a)} is not the plain {float(plain)}")
            err11 = max(err11, bitwise_err(torch, a, plain))
            check(count > 0 or bool(torch.isinf(a)), f"K11 {what}: not +inf")
        c1 = kd.tile_cap(centers, radii, pend, cnt)
        c2 = kd.tile_cap(centers, radii, pend, cnt)
        plain = kd.tile_cap_torch(centers, radii, pend, cnt)
        check(torch.equal(c1, c2), f"K12 {what}: two launches differ")
        check(torch.equal(c1, plain), f"K12 {what}: not bitwise the plain "
              f"version (max err {bitwise_err(torch, c1, plain)})")
        err12 = max(err12, bitwise_err(torch, c1, plain))
        check(bool(torch.isinf(c1).all()) if count == 0
              else bool(torch.isfinite(c1).all()),
              f"K12 {what}: +inf where it should not be, or missing")
    i = rows[0]
    cnt = torch.tensor(p, dtype=torch.int32, device=dev)
    t = centers.shape[0]
    ms11, plain11 = timed(torch, lambda: kd.row_min_d2(pts, i, pend, cnt),
                          lambda: kd.row_min_d2_torch(pts, i, pend, cnt))
    ms12, plain12 = timed(
        torch, lambda: kd.tile_cap(centers, radii, pend, cnt),
        lambda: kd.tile_cap_torch(centers, radii, pend, cnt))
    # K11 reads the row, the block, idx and count and writes one float;
    # K12 reads the balls, the block and count and writes T caps
    b11, by11 = bound_ms(4 * (d + p * d + 1) + 8 + 4, p * 3 * d)
    b12, by12 = bound_ms(4 * (t * (d + 1) + p * d + t) + 4,
                         t * (p * 3 * d + 3))
    return (dict(n=n, d=d, p=p, max_abs_err=err11, ms=ms11, plain_ms=plain11,
                 bound_ms=b11, bound_by=by11),
            dict(n=n, d=d, p=p, tiles=t, max_abs_err=err12, ms=ms12,
                 plain_ms=plain12, bound_ms=b12, bound_by=by12))


def k1_case(torch, kd, bounds, pts):
    n, d = pts.shape
    bn = 4096 if n >= 4096 else 128
    out1 = kd.seed_prologue(pts, bn)
    out2 = kd.seed_prologue(pts, bn)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K1 d={d}: two launches differ")
    check(torch.equal(out1[0], bounds.point_norms(pts)),
          f"K1 d={d}: norms are not bitwise bounds.point_norms")
    ref = kd.seed_prologue_torch(pts, bn)
    # centers are means and radii/center_d square roots of sums of d
    # squares, each summed in another order than the plain version's
    tol = 1e-5 * float(pts.abs().max())
    err = max(float((a - b).abs().max()) for a, b in zip(out1[1:], ref[1:]))
    check(err <= tol, f"K1 d={d}: centers/radii/center_d err {err} > {tol}")
    ms, plain = timed(torch, lambda: kd.seed_prologue(pts, bn),
                      lambda: kd.seed_prologue_torch(pts, bn))
    t = -(-n // bn)
    bms, by = bound_ms(4 * (n * d + 2 * n + t * (d + 1)),
                       n * (3 * d + 1) + t * d)
    return dict(n=n, d=d, block_n=bn, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by)


def k5_case(torch, kd, bounds, ops, pts, cache, md_in, cents, mask, resident):
    """K5 on one carried state: ``mask`` is 'gate' (the seeding gate's own
    mask for these centroids), 'all', 'half' or 'none'."""
    n, d = pts.shape
    m = cents.shape[0]
    bn = ops.choose_block_n(n, d, 50)
    parts = kd.distance_min_update_torch(pts, cache.norms, cents[:1],
                                         md_in, block_n=bn)[1]
    tmax = bounds.tile_reduce_max(md_in, bn)
    act, dc, margin = bounds.seed_gate(cents, cache, tmax)
    t = act.shape[0]
    act = {"gate": act, "all": torch.ones_like(act),
           "half": torch.arange(t, device=pts.device) % 2 == 0,
           "none": torch.zeros_like(act)}[mask]
    args = (pts, cache.norms, cents, md_in, cache.center_d, dc, margin,
            parts, tmax, act)
    out1 = kd.distance_min_update_gated(*args, block_n=bn, resident=resident)
    out2 = kd.distance_min_update_gated(*args, block_n=bn, resident=resident)
    torch.cuda.synchronize()
    what = f"K5 d={d} m={m} resident={resident} mask={mask}"
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"{what}: two launches differ")
    ref = kd.distance_min_update_gated_torch(*args, block_n=bn)
    tol = d2_tol(torch, cache.norms, cents)
    err = float((out1[0] - ref[0]).abs().max())
    check(err <= tol, f"{what}: min_d2 err {err} > {tol}")
    check(bool(((out1[1] - ref[1]).abs()
                <= partial_tol(tol, bn, ref[1])).all()),
          f"{what}: partials outside tolerance")
    check(float((out1[2] - ref[2]).abs().max()) <= tol,
          f"{what}: tile maxima outside tolerance")
    # the prune test is the same four roundings on the same inputs
    check(torch.equal(out1[3], ref[3]), f"{what}: pruned counts differ")
    skip = ~act
    rows = bounds.expand_mask(skip, bn, n)
    check(torch.equal(out1[0][rows], md_in[rows])
          and torch.equal(out1[1][skip], parts[skip])
          and torch.equal(out1[2][skip], tmax[skip])
          and not bool(out1[3][skip].any()),
          f"{what}: a skipped tile's outputs moved")
    if mask == "all":
        k2 = kd.distance_min_update(pts, cache.norms, cents, md_in,
                                    block_n=bn, resident=resident)
        check(torch.equal(out1[0], k2[0]) and torch.equal(out1[1], k2[1]),
              f"{what}: all-active K5 is not bitwise K2")
    ms, plain = timed(
        torch, lambda: kd.distance_min_update_gated(*args, block_n=bn,
                                                    resident=resident),
        lambda: kd.distance_min_update_gated_torch(*args, block_n=bn))
    rows_act = int(bounds.expand_mask(act, bn, n).sum())
    n_pruned = int(out1[3].sum())
    fresh = rows_act - n_pruned
    bms, by = bound_ms(4 * (3 * rows_act + fresh * (d + 1) + m * d + 7 * t),
                       fresh * m * (2 * d + 3) + rows_act * 6)
    return dict(n=n, d=d, m=m, resident=resident, mask=mask, block_n=bn,
                active_tiles=int(act.sum()), tiles=t, pruned=n_pruned,
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by)


def k6_case(torch, la, bounds, ops, pts, cache, k, gen):
    """K6 from a carried state: one all-active launch with no carried bound
    (held bitwise to K3) gives the state; two centroids then move a little
    (none at k = 1), so the rows of unmoved clusters prune. Masks: every
    tile, half the supers, the movement gate's."""
    n, d = pts.shape
    bn = ops.choose_block_n(n, d, k)
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    s = -(-t // tps)
    dev = pts.device
    c0 = (pts[torch.randint(n, (k,), generator=gen, device=dev)]
          + 0.01).contiguous()
    all_on = torch.ones(t, dtype=torch.bool, device=dev)
    zero_t = torch.zeros(t, device=dev)
    first = la.lloyd_assign_gated(
        pts, cache.norms, c0, torch.zeros(k, device=dev), zero_t, zero_t,
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.zeros(n, device=dev), torch.full((n,), -torch.inf, device=dev),
        zero_t, zero_t, torch.zeros((s, k, d), device=dev),
        torch.zeros((s, k), device=dev), all_on, block_n=bn, tps=tps)
    k3 = la.lloyd_assign_tiled(pts, cache.norms, c0, block_n=bn, tps=tps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(
        (first[0], first[1], first[3], first[4], first[5], first[6]), k3))
        and not bool(first[7].any()),
        f"K6 d={d} k={k}: all-active K6 without a bound is not bitwise K3")
    c1 = c0.clone()
    if k > 1:
        c1[[0, k - 1]] += 0.002
    st = bounds.BoundState(first[3], tile_gap=first[4], tile_sums=first[5],
                           tile_counts=first[6], assignment=first[0],
                           min_d2=first[1], point_lb=first[2],
                           lb_debt=zero_t)
    delta = bounds.centroid_movement(c1, c0)
    thresh, absorb = bounds.assign_point_scalars(delta, c1, st, cache)
    masks = {"all": all_on,
             "half": (torch.arange(t, device=dev) // tps) % 2 == 0,
             "gate": bounds.expand_active_supers(bounds.assign_active_tiles(
                 delta, c1, st, cache, tps=tps), tps)}
    tol = d2_tol(torch, cache.norms, c1)
    d2 = la.tile_d2(pts, c1, cache.norms)
    res = []
    for name, act in masks.items():
        what = f"K6 d={d} k={k} mask={name}"
        args = (pts, cache.norms, c1, delta, thresh, absorb, st.assignment,
                st.min_d2, st.point_lb, st.partials, st.tile_gap,
                st.tile_sums, st.tile_counts, act)
        out1 = la.lloyd_assign_gated(*args, block_n=bn, tps=tps)
        out2 = la.lloyd_assign_gated(*args, block_n=bn, tps=tps)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
              f"{what}: two launches differ")
        ref = la.lloyd_assign_gated_torch(*args, block_n=bn, tps=tps)
        act_pt = bounds.expand_mask(act, bn, n)
        prune = bounds.assign_point_prune(
            st.assignment, st.min_d2, st.point_lb, delta,
            bounds.expand_mask(thresh, bn, n), act_pt)
        check(torch.equal(out1[7], ref[7]), f"{what}: pruned counts differ")
        if name != "half":
            check(int(out1[7].sum()) > 0, f"{what}: the prune never fired")
        # a pruned row takes its carried label and D² and lb = prev_lb −
        # absorb, one fp32 subtraction on the same inputs: bitwise
        check(all(torch.equal(o[prune], r[prune])
                  for o, r in zip(out1[:3], ref[:3])),
              f"{what}: pruned rows' label, D² or lb differ")
        lab = out1[0].long()
        diff = lab != ref[0].long()
        tie_gap = (d2.gather(1, lab[:, None])
                   - d2.gather(1, ref[0].long()[:, None])).abs()[:, 0]
        check(bool((tie_gap[diff] <= tol).all()),
              f"{what}: labels differ beyond near-ties")
        err = float((out1[1] - ref[1]).abs().max())
        check(err <= tol, f"{what}: min_d2 err {err} > {tol}")
        # fresh rows' lb = √second: sqrt turns a D² error δ into at most √δ
        fin = torch.isfinite(ref[2])
        fresh_pt = act_pt & ~prune & fin
        check(torch.equal(torch.isfinite(out1[2]), fin)
              and bool(((out1[2] - ref[2])[fresh_pt].abs()
                        <= 2 * math.sqrt(tol)).all()),
              f"{what}: lower bounds outside tolerance")
        # active tiles' partials and gaps as K3's; active supers' sums and
        # counts over the kernel's labels, pruned rows under their carried
        # label included
        check(bool(((out1[3] - ref[3])[act].abs()
                    <= partial_tol(tol, bn, ref[3])[act]).all()),
              f"{what}: partials outside tolerance")
        gfin = torch.isfinite(ref[4])
        check(torch.equal(torch.isfinite(out1[4]), gfin)
              and bool(((out1[4] - ref[4])[gfin & act].abs()
                        <= 2 * math.sqrt(tol)).all()),
              f"{what}: gaps outside tolerance")
        sup_act = bounds.super_any(act, tps)
        check(super_sums_ok(torch, pts, lab, out1[5], out1[6], bn * tps,
                            sup_act),
              f"{what}: super sums or counts outside tolerance")
        skip = ~act
        rows = bounds.expand_mask(skip, bn, n)
        sup_skip = ~sup_act
        kept = all(torch.equal(o[sel], c[sel]) for o, c, sel in (
            (out1[0], st.assignment, rows), (out1[1], st.min_d2, rows),
            (out1[2], st.point_lb, rows), (out1[3], st.partials, skip),
            (out1[4], st.tile_gap, skip), (out1[5], st.tile_sums, sup_skip),
            (out1[6], st.tile_counts, sup_skip)))
        check(kept and not bool(out1[7][skip].any()),
              f"{what}: a skipped tile's or super's outputs moved")
        ms, plain = timed(
            torch, lambda: la.lloyd_assign_gated(*args, block_n=bn, tps=tps),
            lambda: la.lloyd_assign_gated_torch(*args, block_n=bn, tps=tps))
        rows_act = int(act_pt.sum())
        n_pruned = int(out1[7].sum())
        fresh = rows_act - n_pruned
        s_act = int(sup_act.sum())
        # an active row reads x and its three carries and writes label, D²
        # and lb; only a fresh row also reads its norm
        bms, by = bound_ms(4 * (rows_act * (d + 6) + fresh + k * (d + 1)
                                + 6 * t + s_act * k * (d + 1)),
                           fresh * k * (2 * d + 3) + rows_act * (d + 4))
        res.append(dict(n=n, d=d, k=k, mask=name, block_n=bn, tps=tps,
                        active_tiles=int(act.sum()), tiles=t,
                        pruned=n_pruned, label_diffs=int(diff.sum()),
                        max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                        bound_ms=bms, bound_by=by))
    return res


def scan_determinism(torch, sampling, w, reps: int) -> dict:
    """How many distinct bit patterns ``reps`` runs of torch.cumsum and of
    the samplers' fixed-order prefix_sum give on one tensor, and the host
    time of one synchronised call of each (median of ``reps``, in µs)."""
    out = {}
    for name, fn in (("torch.cumsum", lambda: torch.cumsum(w, 0)),
                     ("prefix_sum", lambda: sampling.prefix_sum(w))):
        runs, times = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(fn())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e6)
        distinct = []
        for r in runs:
            if not any(torch.equal(r, q) for q in distinct):
                distinct.append(r)
        out[name] = len(distinct)
        out[f"{name} us"] = statistics.median(times)
    return out


def profile_call(torch, fn) -> dict:
    """Device time by kernel over one call of ``fn`` and the device's idle
    share of the call's wall time, from torch.profiler (whose own host-side
    cost lengthens the wall time, so the idle share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
                kernels={name: {"ms": ms, "count": c}
                         for name, (ms, c) in top})


def kmeans_run(torch, ops, eng, pts, k, sampler, draws, max_iters=25,
               **kw):
    """One counted kmeans: counters zeroed just before, read just after."""
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.kmeans(pts, k, draws=draws, sampler=sampler,
                     max_iters=max_iters, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(ops.LAUNCHES)


def seed_run(torch, ops, eng, pts, k, draws, **kw):
    """One counted seeding: counters zeroed just before, read just after."""
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.seed(pts, k, draws=draws, **kw)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3, dict(ops.LAUNCHES)


def median_seed_ms(torch, eng, pts, k, draws, reps=3, **kw) -> float:
    """Median host-clock ms of ``reps`` synchronised seedings."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.seed(pts, k, draws=draws, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def refreshes(accepts, k: int, p: int) -> int:
    """Round-kernel launches a rejection seeding makes: the schedule's
    (every p appended centroids, the first at round 1), one per round
    whose attempts all rejected (the count restarts), and the settle."""
    count, r = p - 1, 0
    for m in range(1, k):
        count += 1
        if count >= p:
            r, count = r + 1, 0
        if not accepts[m]:
            r, count = r + 1, 0
    return r + 1


def same_seeds(torch, a, b) -> bool:
    return (torch.equal(a.indices, b.indices)
            and torch.equal(a.centroids, b.centroids)
            and torch.equal(a.min_d2, b.min_d2))


def phase_ms(torch, eng, pts, k, sampler, draws, max_iters=25):
    """Seeding ms and Lloyd ms per iteration, the two phases apart."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seeds = eng.seed(pts, k, draws=draws, sampler=sampler)
    torch.cuda.synchronize()
    seed_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fit = eng.fit(pts, seeds.centroids, max_iters=max_iters)
    torch.cuda.synchronize()
    lloyd_ms = (time.perf_counter() - t0) * 1e3 / max(fit.n_iters, 1)
    return seeds, fit, seed_ms, lloyd_ms


def same_fit(torch, a, b) -> bool:
    """Bitwise equal fits; n_iters an int, or a tensor when batched."""
    return (torch.equal(a.centroids, b.centroids)
            and torch.equal(a.assignment, b.assignment)
            and torch.equal(a.inertia, b.inertia)
            and torch.equal(torch.as_tensor(a.n_iters).long().cpu(),
                            torch.as_tensor(b.n_iters).long().cpu()))


def rejection_phase(torch, ops, kd, bounds, telemetry, Draws, eng, ungated,
                    layouts, k, dev, launches, max_iters=25):
    """Phase 4: rejection seeding (hier, flat) and its kmeans on each
    ``(name, points)`` of ``layouts``, gated (``eng``) and ungated, counted
    and held to its pins; every counted run's launches are added to
    ``launches``. Returns one record per layout and proposal."""
    P, A = 8, 8
    n, dim = layouts[0][1].shape
    n_tiles = -(-n // ops.choose_block_n(n, dim, 1))
    block_n = ops.choose_block_n(n, dim, k)
    rej_runs = []
    for layout, pts in layouts:
        draws = Draws.sample(pts.shape[0], k,
                             generator=torch.Generator().manual_seed(0),
                             device=dev, max_attempts=A)
        norms = bounds.point_norms(pts)
        tiled_ms = median_seed_ms(torch, eng, pts, k, draws, sampler="tiled")
        tiled_off_ms = median_seed_ms(torch, ungated, pts, k, draws,
                                      sampler="tiled")
        tiled = eng.seed(pts, k, draws=draws, sampler="tiled")
        for prop in ("hier", "flat"):
            hier = prop == "hier"
            what = f"rejection[{prop}, {layout}]"
            kw = dict(sampler="rejection", proposal=prop, refresh_block=P)
            outs = {}
            for tag, e in (("gated", eng), ("ungated", ungated)):
                res, ms, got = seed_run(torch, ops, e, pts, k, draws, **kw)
                for name in launches:
                    launches[name] += got[name]
                r = refreshes(res.accepts.tolist(), k, P)
                want = {name: 0 for name in got}
                want["row_min_d2"] = int(res.proposals.sum())
                if tag == "gated":
                    want.update(seed_prologue=1,
                                distance_min_update_gated=r,
                                tile_cap=k - 1 if hier else 0)
                else:
                    want["distance_min_update"] = r
                check(got == want, f"{what} {tag}: launches {got}, want "
                      f"{want}")
                check(tuple(res.centroids.shape) == (k, dim)
                      and bool(torch.isfinite(res.min_d2).all())
                      and len(set(res.indices.tolist())) == k,
                      f"{what} {tag}: output malformed")
                telemetry.check_rejection_counters(
                    res.proposals, res.accepts, k, A, res.recovered)
                telemetry.check_hier_counters(
                    res.tightened, res.supers, res.proposals, k,
                    n_tiles=n_tiles, hier=hier)
                check(int(res.recovered.sum()) == 0,
                      f"{what} {tag}: a guard healed a round")
                again = e.seed(pts, k, draws=draws, **kw)
                check(same_seeds(torch, res, again)
                      and all(torch.equal(getattr(res, f), getattr(again, f))
                              for f in ("proposals", "accepts", "tightened",
                                        "supers")),
                      f"{what} {tag}: two runs differ")
                # the settled D² is one fold of all k seeds from +inf
                fold, _ = kd.distance_min_update(
                    pts, norms, res.centroids.contiguous(),
                    torch.full_like(norms, torch.inf), block_n=block_n)
                check(torch.equal(fold, res.min_d2),
                      f"{what} {tag}: min_d2 is not one fold of the seeds "
                      f"(max err {bitwise_err(torch, fold, res.min_d2)})")
                outs[tag] = dict(res=res, ms=ms, launches=got, refreshes=r)
            on, off = outs["gated"]["res"], outs["ungated"]["res"]
            if not hier:
                check(same_seeds(torch, on, off)
                      and torch.equal(on.proposals, off.proposals)
                      and torch.equal(on.accepts, off.accepts),
                      f"{what}: gated is not bitwise ungated")
            # refresh_block=1: hier, flat and the tiled sampler agree
            one = eng.seed(pts, k, draws=draws, sampler="rejection",
                           proposal=prop, refresh_block=1)
            check(torch.equal(one.indices, tiled.indices),
                  f"{what}: refresh_block=1 is not the tiled seeds")
            # the kmeans entry point: the seeding's seeds, then Lloyd
            fit, fit_s, fgot = kmeans_run(torch, ops, eng, pts, k,
                                          "rejection", draws, max_iters,
                                          proposal=prop)
            for name in launches:
                launches[name] += fgot[name]
            check(fgot["lloyd_assign_gated"] == fit.n_iters
                  and fgot["seed_prologue"] == 1
                  and fgot["row_min_d2"] == int(on.proposals.sum())
                  and fgot["tile_cap"] == (k - 1 if hier else 0),
                  f"{what}: kmeans launches {fgot}")
            check(same_fit(torch, fit, eng.fit(pts, on.centroids,
                                               max_iters=max_iters)),
                  f"{what}: kmeans is not a fit from the seeding's seeds")
            if not hier:
                ofit, _, _ = kmeans_run(torch, ops, ungated, pts, k,
                                        "rejection", draws, max_iters,
                                        proposal=prop)
                check(same_fit(torch, fit, ofit),
                      f"{what}: kmeans gated is not bitwise ungated")
            rej_ms = median_seed_ms(torch, eng, pts, k, draws, **kw)
            rej_off_ms = median_seed_ms(torch, ungated, pts, k, draws, **kw)
            run = dict(layout=layout, proposal=prop,
                       proposals=int(on.proposals.sum()),
                       accepts=int(on.accepts.sum()),
                       fallbacks=int((on.accepts[1:] == 0).sum()),
                       tightened=int(on.tightened.sum()),
                       refreshes=outs["gated"]["refreshes"],
                       ungated_refreshes=outs["ungated"]["refreshes"],
                       seed_skipped=int(on.skipped.sum()),
                       seed_pruned=int(on.pruned.sum()),
                       seed_ms=rej_ms, ungated_seed_ms=rej_off_ms,
                       tiled_seed_ms=tiled_ms,
                       tiled_ungated_seed_ms=tiled_off_ms,
                       kmeans_s=fit_s, n_iters=fit.n_iters,
                       inertia=float(fit.inertia),
                       launches=outs["gated"]["launches"],
                       ungated_launches=outs["ungated"]["launches"])
            rej_runs.append(run)
            print(f"{what}: seeding {rej_ms:.2f} ms gated / {rej_off_ms:.2f} "
                  f"ms ungated (tiled {tiled_ms:.2f} / {tiled_off_ms:.2f}); "
                  f"proposals {run['proposals']}, accepts {run['accepts']}, "
                  f"fallbacks {run['fallbacks']}, tightened "
                  f"{run['tightened']}, refreshes {run['refreshes']} gated / "
                  f"{run['ungated_refreshes']} ungated; skipped "
                  f"{run['seed_skipped']} tiles, pruned {run['seed_pruned']} "
                  f"rows; kmeans {fit_s:.3f} s, n_iters {fit.n_iters}, "
                  f"inertia {run['inertia']:.6g}; launches "
                  f"{outs['gated']['launches']}")
    return rej_runs


def scan_row_census(torch, sampling, dev, n_problems, n) -> dict:
    """What batched sampling rests on: how many bit patterns one row's scan
    takes over tensors of 1, 8, 64 and 6656 rows, for ``torch.cumsum``
    along dim 1 (rows of 4096 floats, the samplers' rows before batching)
    and for the samplers' row scan (``sampling._row_scan``, rows of
    ``SCAN_BLOCK``); and whether rows 0, 1 and B−1 of a (B, n)
    ``prefix_sum`` are the 1-D calls."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name, width, scan in (
            ("torch.cumsum dim 1", 4096, lambda x: torch.cumsum(
                torch.cat([x, torch.zeros_like(x)]) if x.shape[0] == 1
                else x, 1)),
            ("sampling row scan", sampling.SCAN_BLOCK, sampling._row_scan)):
        base = torch.rand((6656, width), generator=gen, device=dev)
        rows = []
        for count in (1, 8, 64, 6656):
            row = scan(base[:count])[0]
            if not any(torch.equal(row, r) for r in rows):
                rows.append(row)
        out[name] = len(rows)
    w = torch.rand((n_problems, n), generator=gen, device=dev)
    got = sampling.prefix_sum(w)
    out["prefix_sum rows bitwise"] = all(
        torch.equal(got[b], sampling.prefix_sum(w[b]))
        for b in (0, 1, n_problems - 1))
    return out


def k7_case(torch, kd, ops, pts, norms, m, gen):
    """K7 at the batched shape: two launches bitwise, against its plain
    twin, rows 0, 1 and B−1 bitwise K2 on their problem; times and bound."""
    bsz, n, d = pts.shape
    bn = ops.choose_block_n(n, d, 1)        # the seeding rounds' tiles
    rows = torch.randint(n, (2 * m,), generator=gen, device=pts.device)
    cents = pts[:, rows[:m]].contiguous()
    md_in = kd.distance_min_update_batched_torch(
        pts, norms, pts[:, rows[m:]].contiguous(),
        torch.full((bsz, n), torch.inf, device=pts.device), block_n=bn)[0]
    out1 = kd.distance_min_update_batched(pts, norms, cents, md_in,
                                          block_n=bn)
    out2 = kd.distance_min_update_batched(pts, norms, cents, md_in,
                                          block_n=bn)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K7 m={m}: two launches differ")
    ref = kd.distance_min_update_batched_torch(pts, norms, cents, md_in,
                                               block_n=bn)
    tol = d2_tol(torch, norms, cents.reshape(-1, d))
    err_md = float((out1[0] - ref[0]).abs().max())
    check(err_md <= tol, f"K7 min_d2 err {err_md} > {tol}")
    check(bool(((out1[1] - ref[1]).abs()
                <= partial_tol(tol, bn, ref[1])).all()),
          f"K7 partials outside tolerance (max err "
          f"{float((out1[1] - ref[1]).abs().max())})")
    for b in (0, 1, bsz - 1):
        single = kd.distance_min_update(pts[b], norms[b], cents[b], md_in[b],
                                        block_n=bn)
        check(all(torch.equal(u[b], v) for u, v in zip(out1, single)),
              f"K7 m={m}: problem {b} is not bitwise K2 on its slice")
    ms = gpu_ms(torch, lambda: kd.distance_min_update_batched(
        pts, norms, cents, md_in, block_n=bn))
    plain = gpu_ms(torch, lambda: kd.distance_min_update_batched_torch(
        pts, norms, cents, md_in, block_n=bn), reps=3, warmup=1)
    t = -(-n // bn)
    bms, by = bound_ms(4 * bsz * (n * d + 3 * n + m * d + t),
                       bsz * n * m * (2 * d + 3))
    return dict(batch=bsz, n=n, d=d, m=m, block_n=bn, max_abs_err=err_md,
                tol=tol, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)


def k10a_case(torch, la, kd, ops, bounds, pts, norms, k, gen):
    """K10a at the batched shape: two launches bitwise, against its plain
    twin (labels outside near-ties, D², partials and gaps within tolerance,
    super counts exact and sums within tolerance over its own labels), rows
    0, 1 and B−1 bitwise K3 on their problem; times and bound."""
    bsz, n, d = pts.shape
    bn = ops.choose_block_n(n, d, k)
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    idx = torch.randint(n, (bsz, k, 1), generator=gen, device=pts.device)
    cents = torch.take_along_dim(pts, idx, dim=1).contiguous()
    out1 = la.lloyd_assign_tiled_batched(pts, norms, cents, block_n=bn,
                                         tps=tps)
    out2 = la.lloyd_assign_tiled_batched(pts, norms, cents, block_n=bn,
                                         tps=tps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K10a k={k}: two launches differ")
    lab, md, part, gap, ssums, scounts = out1
    ref = la.lloyd_assign_tiled_batched_torch(pts, norms, cents, block_n=bn,
                                              tps=tps)
    tol = d2_tol(torch, norms, cents.reshape(-1, d))
    bad = torch.zeros((), dtype=torch.int64, device=pts.device)
    n_diff = torch.zeros((), dtype=torch.int64, device=pts.device)
    for b in range(bsz):
        d2 = kd.tile_d2(pts[b], cents[b], norms[b])
        diff = lab[b] != ref[0][b]
        tie_gap = (d2.gather(1, lab[b].long()[:, None])
                   - d2.gather(1, ref[0][b].long()[:, None])).abs()[:, 0]
        bad += (diff & (tie_gap > tol)).sum()
        n_diff += diff.sum()
    check(int(bad) == 0, f"K10a k={k}: {int(bad)} labels differ beyond "
          "near-ties")
    err_md = float((md - ref[1]).abs().max())
    check(err_md <= tol, f"K10a min_d2 err {err_md} > {tol}")
    check(bool(((part - ref[2]).abs() <= partial_tol(tol, bn, ref[2])).all()),
          "K10a partials outside tolerance")
    gfin = torch.isfinite(ref[3])
    check(torch.equal(torch.isfinite(gap), gfin)
          and bool(((gap - ref[3])[gfin].abs() <= 2 * math.sqrt(tol)).all()),
          "K10a gaps outside tolerance")
    n_super = ssums.shape[1]
    s_of = (torch.arange(bsz, device=pts.device)[:, None] * n_super
            + torch.arange(n, device=pts.device)[None, :] // (bn * tps))
    check(super_sums_ok(torch, pts.reshape(-1, d), lab.reshape(-1),
                        ssums.reshape(-1, k, d), scounts.reshape(-1, k),
                        bn * tps, s_of=s_of.reshape(-1)),
          f"K10a k={k}: super sums or counts outside tolerance")
    for b in (0, 1, bsz - 1):
        single = la.lloyd_assign_tiled(pts[b], norms[b], cents[b],
                                       block_n=bn, tps=tps)
        check(all(torch.equal(u[b], v) for u, v in zip(out1, single)),
              f"K10a k={k}: problem {b} is not bitwise K3 on its slice")
    ms = gpu_ms(torch, lambda: la.lloyd_assign_tiled_batched(
        pts, norms, cents, block_n=bn, tps=tps), reps=5)
    plain = gpu_ms(torch, lambda: la.lloyd_assign_tiled_batched_torch(
        pts, norms, cents, block_n=bn, tps=tps), reps=3, warmup=1)
    bms, by = bound_ms(4 * bsz * (n * d + 3 * n + k * d + 2 * t
                                  + n_super * k * (d + 1)),
                       bsz * (n * k * (2 * d + 3) + n * d))
    return dict(batch=bsz, n=n, d=d, k=k, block_n=bn, tps=tps,
                label_diffs=int(n_diff), max_abs_err=err_md, tol=tol, ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by)


def row(res, b):
    """Problem b of a batched result, as the single result type."""
    return type(res)(*(f if f is None else f[b] for f in res))


def batched_phase(torch, ops, kd, la, bounds, ClusterEngine, Draws, pts,
                  cfg, dev, launches, gen, n_single=16):
    """Phase 5: K7 and K10a at ``cfg``, then ``kmeans_batched`` with bounds
    off for both samplers, counted (K7 once per round, K10a once per
    iteration of the slowest problem, nothing else), repeated bitwise,
    rows 0, 1 and B−1 bitwise the single ``seed`` then ``fit`` from the same
    draws, and every problem's inertia within 1e-4 of the plain fit's from
    the same seeds. Times: seeding, Lloyd per iteration, kmeans_batched,
    and a loop of single seed + fit over ``n_single`` problems."""
    bsz, n, d, k = cfg.batch, cfg.n_points, cfg.dim, cfg.k
    norms = bounds.point_norms(pts)
    cases = {"K7": [k7_case(torch, kd, ops, pts, norms, m, gen)
                    for m in (1, 8)],
             "K10a": [k10a_case(torch, la, kd, ops, bounds, pts, norms, k,
                                gen)]}
    del norms
    for name, cs in cases.items():
        for c in cs:
            print(f"{name} B={c['batch']} n={c['n']} d={c['d']} "
                  + (f"m={c['m']}" if name == "K7" else
                     f"k={c['k']} tps={c['tps']} label diffs "
                     f"{c['label_diffs']}")
                  + f": err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}), "
                  f"rows 0, 1, B-1 bitwise the single kernel; "
                  f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, bound "
                  f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
    eng = ClusterEngine(device="cuda", bounds=False)
    fused = ClusterEngine("fused", device="cuda", bounds=False)
    runs = []
    for sampler in ("cdf", "tiled"):
        what = f"kmeans_batched[{sampler}]"
        draws = Draws.sample_batched(
            bsz, n, k, generator=torch.Generator().manual_seed(0), device=dev)
        kw = dict(draws=draws, sampler=sampler, max_iters=cfg.max_iters)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.kmeans_batched(pts, k, **kw)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        got = dict(ops.LAUNCHES)
        for name in launches:
            launches[name] += got[name]
        iters = int(res.n_iters.max())
        want = {name: 0 for name in got}
        want.update(distance_min_update_batched=k,
                    lloyd_assign_tiled_batched=iters)
        check(got == want, f"{what}: launches {got}, want {want}")
        check(tuple(res.centroids.shape) == (bsz, k, d)
              and tuple(res.assignment.shape) == (bsz, n)
              and bool(torch.isfinite(res.centroids).all())
              and bool(torch.isfinite(res.inertia).all())
              and int(res.assignment.min()) >= 0
              and int(res.assignment.max()) < k
              and int(res.n_iters.min()) >= 1 and iters <= cfg.max_iters,
              f"{what}: output malformed")
        again = eng.kmeans_batched(pts, k, **kw)
        check(same_fit(torch, again, res), f"{what}: two runs differ")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seeds = eng.seed_batched(pts, k, draws=draws, sampler=sampler)
        torch.cuda.synchronize()
        seed_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        fit = eng.fit_batched(pts, seeds.centroids, max_iters=cfg.max_iters)
        torch.cuda.synchronize()
        lloyd_ms = (time.perf_counter() - t0) * 1e3 / iters
        check(same_fit(torch, fit, res),
              f"{what}: not seed_batched then fit_batched")
        for b in (0, 1, bsz - 1):
            one = eng.seed(pts[b], k, draws=draws[b], sampler=sampler)
            check(same_seeds(torch, one, row(seeds, b)),
                  f"{what}: problem {b}'s seeds are not the single seeding's")
            check(same_fit(torch, eng.fit(pts[b], one.centroids,
                                          max_iters=cfg.max_iters),
                           row(res, b)),
                  f"{what}: problem {b} is not the single seed + fit")
        # the plain twins on the card from the same seeds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = fused.fit_batched(pts, seeds.centroids,
                                  max_iters=cfg.max_iters)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        rel = float(((plain.inertia - res.inertia).abs()
                     / res.inertia).max())
        # 1e-4: both fits take the same Lloyd steps; they differ only in
        # the fp32 summation order of partials and sums
        check(rel <= 1e-4, f"{what}: plain fit inertia differs by {rel:.3g}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(n_single):
            one = eng.seed(pts[b], k, draws=draws[b], sampler=sampler)
            eng.fit(pts[b], one.centroids, max_iters=cfg.max_iters)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3 / n_single
        run = dict(sampler=sampler, kmeans_batched_s=total_s,
                   seed_ms=seed_ms, lloyd_ms_per_iter=lloyd_ms,
                   n_iters_max=iters, n_iters_min=int(res.n_iters.min()),
                   inertia_mean=float(res.inertia.mean()),
                   plain_fit_s=plain_s, inertia_rel_diff_max=rel,
                   ms_per_problem=total_s * 1e3 / bsz,
                   single_ms_per_problem=single_ms, launches=got,
                   repeat_bitwise=True, rows_bitwise_single=True)
        runs.append(run)
        print(f"{what} at {cfg.name} (B={bsz}, n={n}, d={d}, k={k}): "
              f"{total_s:.3f} s end to end, seeding {seed_ms:.1f} ms, Lloyd "
              f"{lloyd_ms:.2f} ms/iter ({iters} iterations, min "
              f"{run['n_iters_min']}); {run['ms_per_problem']:.4f} ms per "
              f"problem against {single_ms:.2f} ms for a single seed + fit "
              f"({n_single} problems); plain fit {plain_s:.2f} s, inertia "
              f"rel diff max {rel:.3g}; launches "
              f"{ {n: c for n, c in got.items() if c} }")
    return cases, runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace seeding and Lloyd at the paper's shape "
                         "with torch.profiler: device time by kernel and "
                         "the device's idle share")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.core import (ClusterEngine, Draws, bounds, sampling,
                                  telemetry)
    from repro_torch.configs import FULL, KVQUANT_GEMMA2_2B as KVQ
    from repro_torch.data import blobs, blobs_batched
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import kmeans_distance as kd
    from repro_torch.kernels import lloyd_assign as la

    torch.backends.cuda.matmul.allow_tf32 = False   # plain twins in fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    report = {"card": card}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    paper_np, labels = blobs(FULL.n_points, FULL.dim, FULL.k, seed=0)
    paper = torch.from_numpy(paper_np).to(dev)
    paper_sorted = torch.from_numpy(
        paper_np[np.argsort(labels, kind="stable")]).to(dev)
    k = FULL.k

    # 0. the samplers' prefix sums, run to run: the cdf sampler's over n,
    #    and the tiled sampler's over the n_tiles partials and one window
    bn_full = ops.choose_block_n(FULL.n_points, FULL.dim, FULL.k)
    report["scan_determinism"] = {}
    for size, reps in ((FULL.n_points, 10), (-(-FULL.n_points // bn_full), 50),
                       (bn_full, 50)):
        w = torch.rand(size, generator=gen, device=dev)
        det = scan_determinism(torch, sampling, w, reps)
        report["scan_determinism"][size] = det
        print(f"prefix sums over {size} floats, {reps} runs each: "
              f"torch.cumsum gave {det['torch.cumsum']} distinct results "
              f"({det['torch.cumsum us']:.1f} us per synchronised call), "
              f"sampling.prefix_sum {det['prefix_sum']} "
              f"({det['prefix_sum us']:.1f} us)")
        check(det["prefix_sum"] == 1,
              f"prefix_sum over {size} floats is not deterministic")
    del w
    # ... and batched: row b of a (B, n) scan must be the 1-D scan's bits
    census = scan_row_census(torch, sampling, dev, KVQ.batch, KVQ.n_points)
    report["scan_row_census"] = census
    print(f"one row scanned among 1, 8, 64 and 6656 rows: "
          f"{census['torch.cumsum dim 1']} bit pattern(s) from torch.cumsum "
          f"along dim 1 (width 4096), {census['sampling row scan']} from "
          f"the samplers' row scan (width {sampling.SCAN_BLOCK}); "
          f"prefix_sum rows 0, 1, B-1 of ({KVQ.batch}, {KVQ.n_points}) "
          f"bitwise the 1-D calls: {census['prefix_sum rows bitwise']}")
    check(census["sampling row scan"] == 1
          and census["prefix_sum rows bitwise"],
          "batched prefix sums are not the single ones row by row")

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print(f"  {name}: {line.strip()}")

    # 2. kernels against their plain twins
    wide = torch.rand((100_003, 128), generator=gen, device=dev)
    cases = {"K1": [], "K2": [], "K3": [], "K5": [], "K6": [], "K11": [],
             "K12": []}
    for pts, k_wide in ((paper, FULL.k), (wide, 64)):
        n, d = pts.shape
        norms = bounds.point_norms(pts)
        c = k1_case(torch, kd, bounds, pts)
        cases["K1"].append(c)
        print(f"K1 n={n} d={d}: err {c['max_abs_err']:.3g} "
              f"(tol {c['tol']:.3g}) {c['ms']:.4f} ms, plain "
              f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']})")
        for m in (1, 8):
            for resident in (True, False):
                c = k2_case(torch, kd, ops, pts, norms, m, resident, gen)
                cases["K2"].append(c)
                print(f"K2 n={c['n']} d={c['d']} m={m} resident={resident}: "
                      f"err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}) "
                      f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
                      f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
        for kk in (k_wide, 1):
            c = k3_case(torch, la, ops, bounds, pts, norms, kk, gen)
            cases["K3"].append(c)
            print(f"K3 n={c['n']} d={c['d']} k={kk} tps={c['tps']}: "
                  f"err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}) "
                  f"label diffs {c['label_diffs']} {c['ms']:.4f} ms, "
                  f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} "
                  f"ms ({c['bound_by']})")
        # the gated seeding round on a mid-seeding state: D² to 8 earlier
        # seeds; at the paper's shape on the label-sorted copy
        gpts = paper_sorted if pts is paper else pts
        bn = ops.choose_block_n(n, d, 50)
        cache = bounds.prologue(gpts, bn)
        rows = torch.randint(n, (16,), generator=gen, device=dev)
        md_in, _ = kd.distance_min_update_torch(
            gpts, cache.norms, gpts[rows[8:]].contiguous(),
            torch.full((n,), torch.inf, device=dev), block_n=bn)
        for m in (1, 8):
            cents = gpts[rows[:m]].contiguous()
            for resident in (True, False):
                for mask in ("gate", "all", "half", "none"):
                    c = k5_case(torch, kd, bounds, ops, gpts, cache, md_in,
                                cents, mask, resident)
                    cases["K5"].append(c)
                    print(f"K5 n={n} d={d} m={m} resident={resident} "
                          f"mask={mask}: {c['active_tiles']}/{c['tiles']} "
                          f"tiles active, {c['pruned']} rows pruned, err "
                          f"{c['max_abs_err']:.3g} (tol {c['tol']:.3g}) "
                          f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
                          f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
        del md_in
        for kk in (k_wide, 1):
            cache = bounds.prologue(pts, ops.choose_block_n(n, d, kk))
            for c in k6_case(torch, la, bounds, ops, pts, cache, kk, gen):
                cases["K6"].append(c)
                print(f"K6 n={n} d={d} k={kk} mask={c['mask']}: "
                      f"{c['active_tiles']}/{c['tiles']} tiles active, "
                      f"{c['pruned']} rows pruned, err "
                      f"{c['max_abs_err']:.3g} (tol {c['tol']:.3g}) label "
                      f"diffs {c['label_diffs']} {c['ms']:.4f} ms, plain "
                      f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                      f"({c['bound_by']})")
        del cache
        # the rejection kernels: K12 over K1's balls at the seeding tiles
        _, centers, radii, _ = kd.seed_prologue(pts, ops.choose_block_n(n, d,
                                                                        50))
        for name, c in zip(("K11", "K12"), rejection_kernel_cases(
                torch, kd, pts, centers, radii, gen)):
            cases[name].append(c)
            print(f"{name} n={n} d={d} P={c['p']}"
                  + (f" tiles={c['tiles']}" if name == "K12" else "")
                  + f": bitwise the plain version at count 0, 1, P; "
                  f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, bound "
                  f"{c['bound_ms']:.6f} ms ({c['bound_by']})")
        del centers, radii
    report["cases"] = cases
    del wide
    torch.cuda.empty_cache()

    # 3. the main path: gated (the default) on shuffled and sorted blobs,
    #    then the ungated path, each counted on its own
    eng = ClusterEngine(device="cuda")
    ungated = ClusterEngine(device="cuda", bounds=False)
    fused = ClusterEngine("fused", device="cuda", bounds=False)
    launches = {name: 0 for name in ops.LAUNCHES}
    runs = []
    for layout, pts in (("shuffled", paper), ("sorted", paper_sorted)):
        for sampler in ("cdf", "tiled"):
            draws = Draws.sample(pts.shape[0], k,
                                 generator=torch.Generator().manual_seed(0),
                                 device=dev)
            res, total_s, got = kmeans_run(torch, ops, eng, pts, k, sampler,
                                           draws)
            for name in launches:
                launches[name] += got[name]
            what = f"gated kmeans[{sampler}, {layout}]"
            check(got["seed_prologue"] == 1
                  and got["distance_min_update_gated"] == k
                  and got["lloyd_assign_gated"] == res.n_iters
                  and got["distance_min_update"] == 0
                  and got["lloyd_assign_tiled"] == 0,
                  f"{what}: launches {got}, want K1 1, K5 {k}, K6 "
                  f"{res.n_iters}, K2/K3 0")
            check(tuple(res.centroids.shape) == (k, FULL.dim)
                  and bool(torch.isfinite(res.centroids).all())
                  and bool(torch.isfinite(res.inertia))
                  and int(res.assignment.min()) >= 0
                  and int(res.assignment.max()) < k,
                  f"{what}: output malformed")
            off, off_s, off_got = kmeans_run(torch, ops, ungated, pts, k,
                                             sampler, draws)
            check(off_got["distance_min_update"] == k
                  and off_got["lloyd_assign_tiled"] == off.n_iters
                  and off_got["seed_prologue"] == 0
                  and off_got["distance_min_update_gated"] == 0
                  and off_got["lloyd_assign_gated"] == 0,
                  f"ungated kmeans[{sampler}, {layout}]: launches {off_got}")
            for name in ("distance_min_update", "lloyd_assign_tiled"):
                launches[name] += off_got[name]
            check(same_fit(torch, res, off),
                  f"{what}: not bitwise the bounds=False kmeans")
            seeds, fit, seed_ms, lloyd_ms = phase_ms(torch, eng, pts, k,
                                                     sampler, draws)
            oseeds, ofit, oseed_ms, olloyd_ms = phase_ms(
                torch, ungated, pts, k, sampler, draws)
            check(torch.equal(seeds.indices, oseeds.indices)
                  and torch.equal(seeds.min_d2, oseeds.min_d2)
                  and same_fit(torch, fit, ofit) and same_fit(torch, fit, res),
                  f"{what}: seed/fit not bitwise the ungated ones")
            check(int(seeds.recovered.sum()) == 0
                  and int(fit.recovered.sum()) == 0,
                  f"{what}: a guard healed a round")
            run = dict(layout=layout, sampler=sampler, n_iters=res.n_iters,
                       inertia=float(res.inertia), kmeans_s=total_s,
                       ungated_kmeans_s=off_s, seed_ms=seed_ms,
                       lloyd_ms_per_iter=lloyd_ms, ungated_seed_ms=oseed_ms,
                       ungated_lloyd_ms_per_iter=olloyd_ms, launches=got,
                       seed_skipped=int(seeds.skipped.sum()),
                       seed_pruned=int(seeds.pruned.sum()),
                       fit_skipped=int(res.skipped.sum()),
                       fit_pruned=int(res.pruned.sum()),
                       bitwise_ungated=True)
            if layout == "sorted":
                check(run["seed_skipped"] + run["fit_skipped"] > 0,
                      f"{what}: nothing skipped on sorted blobs")
            again, _, _ = kmeans_run(torch, ops, eng, pts, k, sampler, draws)
            check(same_fit(torch, again, res), f"{what}: two runs differ")
            run["repeat_bitwise"] = True
            if layout == "shuffled":
                # the plain twins from the same draws, ungated
                fseeds = fused.seed(pts, k, draws=draws, sampler=sampler)
                fres = fused.kmeans(pts, k, draws=draws, sampler=sampler,
                                    max_iters=FULL.max_iters)
                same = int((fseeds.indices == seeds.indices).sum())
                rel = abs(float(fres.inertia) - float(res.inertia)) / float(
                    res.inertia)
                if same < k:
                    # diverged seeds make a different fit: compare the
                    # Lloyd phase from the kernels' own seeds instead
                    fres = fused.fit(pts, seeds.centroids,
                                     max_iters=FULL.max_iters)
                    rel = abs(float(fres.inertia) - float(fit.inertia)) \
                        / float(fit.inertia)
                # 1e-4: both fits take the same Lloyd steps; they differ
                # only in the fp32 summation order of partials and sums
                check(rel <= 1e-4,
                      f"{sampler}: fused inertia differs by {rel:.3g}")
                run.update(fused_seed_matches=same, inertia_rel_diff=rel)
            runs.append(run)
            print(f"kmeans[{sampler}, {layout}]: gated {total_s:.3f} s, "
                  f"ungated {off_s:.3f} s end to end (bitwise equal); "
                  f"seeding {seed_ms:.2f} ms gated / {oseed_ms:.2f} ms "
                  f"ungated, Lloyd {lloyd_ms:.3f} / {olloyd_ms:.3f} ms/iter; "
                  f"n_iters {res.n_iters}, inertia {run['inertia']:.6g}; "
                  f"seeding skipped {run['seed_skipped']} tiles, pruned "
                  f"{run['seed_pruned']} rows; Lloyd skipped "
                  f"{run['fit_skipped']} tiles, pruned {run['fit_pruned']} "
                  f"rows; launches {got}"
                  + (f"; fused: {run['fused_seed_matches']}/{k} seeds "
                     f"match, inertia rel diff {run['inertia_rel_diff']:.3g}"
                     if layout == "shuffled" else ""))
    report["main_path"] = runs

    # 4. rejection seeding at the paper's size: both layouts, both proposals
    rej_runs = rejection_phase(
        torch, ops, kd, bounds, telemetry, Draws, eng, ungated,
        (("shuffled", paper), ("sorted", paper_sorted)), k, dev, launches)
    report["rejection"] = rej_runs

    # 5. batched problems: the PQ codebook sweep, bounds off
    del paper_sorted
    torch.cuda.empty_cache()
    kvq_pts = blobs_batched(KVQ.batch, KVQ.n_points, KVQ.dim, KVQ.k,
                            generator=torch.Generator(device=dev)
                            .manual_seed(0))
    bcases, brun = batched_phase(torch, ops, kd, la, bounds, ClusterEngine,
                                 Draws, kvq_pts, KVQ, dev, launches, gen)
    cases.update(bcases)
    report["batched"] = brun
    report["launches"] = launches

    if args.profile:
        report["profile"] = {}
        paper_sorted = torch.from_numpy(
            paper_np[np.argsort(labels, kind="stable")]).to(dev)
        bseeds = ungated.seed_batched(
            kvq_pts, KVQ.k, generator=torch.Generator().manual_seed(0))
        phases = {f"batched seed[{s}]": (
            lambda s=s: ungated.seed_batched(
                kvq_pts, KVQ.k, sampler=s,
                generator=torch.Generator().manual_seed(0)))
            for s in ("cdf", "tiled")}
        phases["batched fit"] = (lambda: ungated.fit_batched(
            kvq_pts, bseeds.centroids, max_iters=KVQ.max_iters))
        for tag, e, pts in (("ungated", ungated, paper),
                            ("gated", eng, paper),
                            ("gated sorted", eng, paper_sorted)):
            seeds = e.seed(pts, k, generator=torch.Generator().manual_seed(0))
            for s in ("cdf", "tiled"):
                phases[f"{tag} seed[{s}]"] = (
                    lambda s=s, e=e, pts=pts: e.seed(
                        pts, k, generator=torch.Generator().manual_seed(0),
                        sampler=s))
            for prop in ("hier", "flat"):
                phases[f"{tag} seed[rejection {prop}]"] = (
                    lambda prop=prop, e=e, pts=pts: e.seed(
                        pts, k, generator=torch.Generator().manual_seed(0),
                        sampler="rejection", proposal=prop))
            phases[f"{tag} fit"] = (lambda e=e, pts=pts, c=seeds.centroids:
                                    e.fit(pts, c, max_iters=FULL.max_iters))
        for name, fn in phases.items():
            fn()                                   # warm
            p = profile_call(torch, fn)
            report["profile"][name] = p
            top = ", ".join(f"{kname[:48]} {v['ms']:.3f} ms x{v['count']}"
                            for kname, v in list(p["kernels"].items())[:5])
            print(f"profile {name}: wall {p['wall_ms']:.2f} ms, device "
                  f"busy {p['busy_ms']:.2f} ms, idle share "
                  f"{p['idle_share']:.3f}; {top}")

    def main_case(name, pick):
        return next(c for c in cases[name]
                    if c["n"] == FULL.n_points and pick(c))

    def entry(fn, src, replaces, case, errs):
        # the error over the cases at the shape the main path gives it
        return {"name": fn, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": replaces, "launches": launches[fn],
                "max_abs_err": max(c["max_abs_err"] for c in cases[errs]
                                   if c["n"] == case["n"]),
                "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
                "library_ms": None}

    record = {"kernels": [
        entry("seed_prologue", "seed_prologue.cu",
              "src/repro/kernels/kmeans_distance.py:405",
              main_case("K1", lambda c: True), "K1"),
        entry("distance_min_update", "kmeans_distance.cu",
              "src/repro/kernels/kmeans_distance.py:99",
              main_case("K2", lambda c: c["m"] == 1 and c["resident"]), "K2"),
        entry("lloyd_assign_tiled", "lloyd_assign.cu",
              "src/repro/kernels/lloyd_assign.py:324",
              main_case("K3", lambda c: c["k"] == FULL.k), "K3"),
        entry("distance_min_update_gated", "kmeans_distance.cu",
              "src/repro/kernels/kmeans_distance.py:192",
              main_case("K5", lambda c: c["m"] == 1 and c["resident"]
                        and c["mask"] == "gate"), "K5"),
        entry("lloyd_assign_gated", "lloyd_assign.cu",
              "src/repro/kernels/lloyd_assign.py:416",
              main_case("K6", lambda c: c["k"] == FULL.k
                        and c["mask"] == "gate"), "K6"),
        entry("row_min_d2", "rejection.cu",
              "src/repro/kernels/kmeans_distance.py:293",
              main_case("K11", lambda c: True), "K11"),
        entry("tile_cap", "rejection.cu",
              "src/repro/kernels/kmeans_distance.py:351",
              main_case("K12", lambda c: True), "K12"),
        entry("distance_min_update_batched", "kmeans_distance.cu",
              "src/repro/kernels/kmeans_distance.py:466",
              next(c for c in cases["K7"] if c["m"] == 1), "K7"),
        entry("lloyd_assign_tiled_batched", "lloyd_assign.cu",
              "src/repro/kernels/lloyd_assign.py:530", cases["K10a"][0],
              "K10a"),
    ]}
    report.update(record)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    print(f"card: {card_line()}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
