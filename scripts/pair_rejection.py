#!/usr/bin/env python3
"""Time rejection seeding and the prologue (K1) of several checkouts of the
port on one NVIDIA card, in turn, at the paper's ``FULL`` shape
(``configs/kmeans_paper.py``: n = 4,000,000, d = 2, k = 50) and K1 also at
``kvquant-gemma2-2b`` (``configs/kvquant.py``: B = 1664, n = 16384, d = 16).

    python3 scripts/pair_rejection.py TREE [TREE ...] [--reps N]
        [--out PATH]

Each TREE is the root of a checkout (its ``src/`` holds ``repro_torch``).
Each is run in a process of its own, in the order given (say parent,
change, change, parent; repeat the list for more pairs), which builds that
tree's kernels and measures, on the same blobs made from seed 0 and the
same injected draws:

- rejection seeding, gated (the engine default), ``proposal`` hier and
  flat, ``refresh_block`` 8, ``max_attempts`` 8, unweighted and with
  integer weights 1-8: the median host-clock ms of ``reps`` synchronised
  ``ClusterEngine.seed`` calls (unweighted), the launches of one counted
  call, the bits of its outputs (indices and every counter as lists,
  ``min_d2`` and the centroids as a hash of their bytes), and one call
  under torch.profiler (device busy ms, the device's idle share of that
  call's wall time, an upper bound: the profiler's own host cost
  lengthens the wall; and the device kernels by name with their counts);
- K1: the median of ``reps`` launches (CUDA events, queued behind a
  device-side sleep) at ``FULL`` (4,096-row tiles) and of the batched K1 at
  ``kvquant``.

Prints the card's name and power limit, one JSON line per tree, and (with
``--out``) writes them all there. Two versions compare only within one call
on one card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def gpu_ms(torch, fn, reps: int, warmup: int = 3) -> float:
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


def wall_ms(torch, fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profiled(torch, fn) -> dict:
    """Wall ms, device busy ms and idle share of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(evt.self_device_time_total / 1e3 for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA)
    kernels = {evt.key[:60]: evt.count for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA}
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                kernels=kernels)


def bits(res) -> dict:
    """A seeding's outputs: indices and every counter as lists, min_d2 and
    the centroids as the sha256 of their bytes."""
    out = {f: hashlib.sha256(getattr(res, f).cpu().numpy().tobytes())
           .hexdigest()[:16] for f in ("min_d2", "centroids")}
    for f in ("indices", "proposals", "accepts", "recovered", "tightened",
              "supers", "skipped", "pruned"):
        v = getattr(res, f)
        out[f] = None if v is None else v.tolist()
    return out


def one(tree: Path, reps: int) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.configs import FULL
    from repro_torch.configs import KVQUANT_GEMMA2_2B as KVQ
    from repro_torch.core import ClusterEngine, Draws
    from repro_torch.data import blobs, blobs_batched
    from repro_torch.kernels import kmeans_distance as kd
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    pts = torch.from_numpy(blobs(FULL.n_points, FULL.dim, FULL.k,
                                 seed=0)[0]).to(dev)
    k = FULL.k
    draws = Draws.sample(FULL.n_points, k, max_attempts=8, device=dev,
                         generator=torch.Generator().manual_seed(0))
    wdraws = Draws.sample(FULL.n_points, k, max_attempts=8, device=dev,
                          generator=torch.Generator().manual_seed(0),
                          weighted=True)
    wts = torch.randint(1, 9, (FULL.n_points,),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev).float()
    eng = ClusterEngine(device="cuda")
    res = dict(tree=str(tree))
    for prop in ("hier", "flat"):
        for tag, kw in (("", dict(draws=draws)),
                        (" weighted", dict(draws=wdraws, weights=wts))):
            def seed(prop=prop, kw=kw):
                return eng.seed(pts, k, sampler="rejection", proposal=prop,
                                refresh_block=8, max_attempts=8, **kw)
            ops.reset_launches()
            out = seed()
            torch.cuda.synchronize()
            launches = {name: v for name, v in ops.LAUNCHES.items() if v}
            run = dict(bits=bits(out), launches=launches,
                       profiled=profiled(torch, seed))
            if not tag:
                run["ms"] = wall_ms(torch, seed, reps)
            res[f"rejection {prop}{tag}"] = run
    res["K1 FULL ms"] = gpu_ms(torch, lambda: kd.seed_prologue(pts, 4096),
                               reps)
    del pts
    gen = torch.Generator(device=dev).manual_seed(0)
    xb = blobs_batched(KVQ.batch, KVQ.n_points, KVQ.dim, KVQ.k,
                       generator=gen)
    bn = ops.choose_block_n(KVQ.n_points, KVQ.dim, 1)
    res["K1 kvquant ms"] = gpu_ms(
        torch, lambda: kd.seed_prologue_batched(xb, bn), max(3, reps // 3))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.trees[0].resolve(), args.reps)))
        return 0
    print(card_line())
    rows, failed = [], 0
    for tree in args.trees:
        run = subprocess.run(
            [sys.executable, __file__, "--one", "--reps", str(args.reps),
             str(tree)], capture_output=True, text=True)
        if run.returncode != 0:
            failed += 1
            print(f"{tree}: exit {run.returncode}\n{run.stderr[-4000:]}",
                  flush=True)
            continue
        rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card_line(), runs=rows),
                                       indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
