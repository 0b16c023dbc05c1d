#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH] [--profile]

Phases, each of which exits non-zero on failure:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all at once) and print the build time and ptxas report.
2. Hold every kernel against its plain PyTorch twin on the card, at the
   paper's shape (n = 4,000,000, d = 2) and a ragged wide one
   (n = 100,003, d = 128): K2 (seeding round) with resident centroids on and
   off at m = 1 and m = 8, K3 (tiled assignment) at k = 50 or 64 (tps > 1)
   and at k = 1. Two launches must give identical bits. Each kernel's median
   time (CUDA events) is printed beside its plain twin's and its bound.
3. Drive the main path, ``ClusterEngine(device="cuda", bounds=False).kmeans``
   on blobs(4M, 2, 50) with k = 50, 25 iterations, for sampler cdf and
   tiled, with the launch counters zeroed just before and read just after;
   then the same draws through the plain ``FusedBackend`` on the card.
4. With ``--profile`` only: trace one seeding run per sampler and one Lloyd
   fit at that shape with torch.profiler, and print the device time by
   kernel and the device's idle share.

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
    # sums/counts against a float64 segment sum over the KERNEL's labels:
    # counts exact, sums within 1e-4 of the rows' absolute sum (the
    # sequential fp32 adds of <= tps * block_n rows)
    s_of = torch.arange(n, device=pts.device) // (bn * tps)
    slot = (s_of * k + lab.long())
    n_super = ssums.shape[0]
    want_c = torch.bincount(slot, minlength=n_super * k).view(n_super, k)
    check(torch.equal(scounts, want_c.float()), f"K3 k={k}: counts differ")
    x64 = pts.double()
    want_s = torch.zeros(n_super * k, d, dtype=torch.float64,
                         device=pts.device).index_add_(0, slot, x64)
    abs_s = torch.zeros_like(want_s).index_add_(0, slot, x64.abs())
    err_s = (ssums.double().view(-1, d) - want_s).abs()
    check(bool((err_s <= 1e-4 * abs_s + 1e-6).all()),
          f"K3 k={k}: sums outside tolerance")
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
    from repro_torch.core import ClusterEngine, Draws, bounds
    from repro_torch.configs import FULL
    from repro_torch.data import blobs
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
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    paper_np, _ = blobs(FULL.n_points, FULL.dim, FULL.k, seed=0)
    paper = torch.from_numpy(paper_np).to(dev)
    wide = torch.rand((100_003, 128), generator=gen, device=dev)
    cases = {"K2": [], "K3": []}
    for pts, k_wide in ((paper, FULL.k), (wide, 64)):
        norms = bounds.point_norms(pts)
        for m in (1, 8):
            for resident in (True, False):
                c = k2_case(torch, kd, ops, pts, norms, m, resident, gen)
                cases["K2"].append(c)
                print(f"K2 n={c['n']} d={c['d']} m={m} resident={resident}: "
                      f"err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}) "
                      f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
                      f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
        for k in (k_wide, 1):
            c = k3_case(torch, la, ops, bounds, pts, norms, k, gen)
            cases["K3"].append(c)
            print(f"K3 n={c['n']} d={c['d']} k={k} tps={c['tps']}: "
                  f"err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}) "
                  f"label diffs {c['label_diffs']} {c['ms']:.4f} ms, "
                  f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} "
                  f"ms ({c['bound_by']})")
    report["cases"] = cases
    del wide

    # 3. the main path
    k = FULL.k
    eng = ClusterEngine(device="cuda", bounds=False)
    fused = ClusterEngine("fused", device="cuda", bounds=False)
    launches = {name: 0 for name in ops.LAUNCHES}
    runs = []
    for sampler in ("cdf", "tiled"):
        def gen0():
            return torch.Generator().manual_seed(0)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.kmeans(paper, k, generator=gen0(), sampler=sampler,
                         max_iters=FULL.max_iters)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        got = dict(ops.LAUNCHES)
        for name in launches:
            launches[name] += got[name]
        check(got["distance_min_update"] == k,
              f"K2 launched {got['distance_min_update']} times, want {k}")
        check(got["lloyd_assign_tiled"] == res.n_iters,
              f"K3 launched {got['lloyd_assign_tiled']} times, want "
              f"{res.n_iters}")
        check(tuple(res.centroids.shape) == (k, FULL.dim)
              and bool(torch.isfinite(res.centroids).all())
              and bool(torch.isfinite(res.inertia))
              and int(res.assignment.min()) >= 0
              and int(res.assignment.max()) < k, "kmeans output malformed")

        # the two phases apart, for the breakdown
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seeds = eng.seed(paper, k, generator=gen0(), sampler=sampler)
        torch.cuda.synchronize()
        seed_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        fit = eng.fit(paper, seeds.centroids, max_iters=FULL.max_iters)
        torch.cuda.synchronize()
        lloyd_ms = (time.perf_counter() - t0) * 1e3 / max(fit.n_iters, 1)

        # the same draws through the plain twins
        draws = Draws.sample(paper.shape[0], k, generator=gen0(),
                             device=dev)
        fseeds = fused.seed(paper, k, draws=draws, sampler=sampler)
        fres = fused.kmeans(paper, k, draws=draws, sampler=sampler,
                            max_iters=FULL.max_iters)
        same = int((fseeds.indices == seeds.indices).sum())
        rel = abs(float(fres.inertia) - float(res.inertia)) / float(
            res.inertia)
        if same < k:
            # diverged seeds make a different fit: compare the Lloyd phase
            # from the kernels' own seeds instead
            fres = fused.fit(paper, seeds.centroids,
                             max_iters=FULL.max_iters)
            rel = abs(float(fres.inertia) - float(fit.inertia)) / float(
                fit.inertia)
        # 1e-4: both fits take the same Lloyd steps; they differ only in the
        # fp32 summation order of partials and per-cluster sums
        check(rel <= 1e-4, f"{sampler}: fused inertia differs by {rel:.3g}")
        run = dict(sampler=sampler, n_iters=res.n_iters,
                   inertia=float(res.inertia), kmeans_s=total_s,
                   seed_ms=seed_ms, lloyd_ms_per_iter=lloyd_ms,
                   launches=got, fused_seed_matches=same,
                   fused_inertia=float(fres.inertia), inertia_rel_diff=rel,
                   split_equals_kmeans=bool(
                       torch.equal(fit.inertia, res.inertia)))
        runs.append(run)
        print(f"kmeans[{sampler}]: {total_s:.3f} s end to end, seeding "
              f"{seed_ms:.2f} ms, Lloyd {lloyd_ms:.3f} ms/iter, n_iters "
              f"{res.n_iters}, inertia {run['inertia']:.6g}, launches "
              f"K2 {got['distance_min_update']} K3 "
              f"{got['lloyd_assign_tiled']}; fused: {same}/{k} seeds match, "
              f"inertia rel diff {rel:.3g}")
    report["main_path"] = runs

    if args.profile:
        gen0 = torch.Generator().manual_seed(0)
        seeds = eng.seed(paper, k, generator=gen0)
        phases = {f"seed[{s}]": (lambda s=s: eng.seed(
            paper, k, generator=torch.Generator().manual_seed(0), sampler=s))
            for s in ("cdf", "tiled")}
        phases["fit"] = lambda: eng.fit(paper, seeds.centroids,
                                        max_iters=FULL.max_iters)
        report["profile"] = {}
        for name, fn in phases.items():
            fn()                                   # warm
            p = profile_call(torch, fn)
            report["profile"][name] = p
            top = ", ".join(f"{kname[:48]} {v['ms']:.3f} ms x{v['count']}"
                            for kname, v in list(p["kernels"].items())[:5])
            print(f"profile {name}: wall {p['wall_ms']:.2f} ms, device busy "
                  f"{p['busy_ms']:.2f} ms, idle share {p['idle_share']:.3f}; "
                  f"{top}")

    k2 = [c for c in cases["K2"] if c["n"] == FULL.n_points]
    k3 = [c for c in cases["K3"] if c["n"] == FULL.n_points]
    k2_main = next(c for c in k2 if c["m"] == 1 and c["resident"])
    k3_main = next(c for c in k3 if c["k"] == FULL.k)
    record = {"kernels": [
        {"name": "distance_min_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/kmeans_distance.cu",
         "replaces": "src/repro/kernels/kmeans_distance.py:99",
         "launches": launches["distance_min_update"],
         "max_abs_err": max(c["max_abs_err"] for c in k2),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
         "library_ms": None},
        {"name": "lloyd_assign_tiled", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lloyd_assign.cu",
         "replaces": "src/repro/kernels/lloyd_assign.py:324",
         "launches": launches["lloyd_assign_tiled"],
         "max_abs_err": max(c["max_abs_err"] for c in k3),
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"],
         "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
         "library_ms": None},
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
