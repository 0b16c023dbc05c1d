#!/usr/bin/env python3
"""Time the batched seeding and assignment rounds of several checkouts of
the port on one NVIDIA card, in turn, at ``kvquant-gemma2-2b``
(``configs/kvquant.py``: B = 1664 problems of n = 16384 rows, d = 16,
k = 256).

    python3 scripts/pair_rounds.py TREE [TREE ...] [--dim D] [--reps N]
                                   [--out PATH]

Each TREE is the root of a checkout (its ``src/`` holds ``repro_torch``).
Each is run in a process of its own, in the order given (say parent,
change, change, parent), which builds that tree's kernels and times K7
(``distance_min_update_batched``, m = 1 and 8), K8
(``distance_min_update_gated_batched``, m = 1, each problem's gate), K10a
(``lloyd_assign_tiled_batched``) and K9 (``lloyd_assign_batched``) on the
fp32 and the bf16 stream: the median of ``reps`` launches (CUDA events,
queued behind a device-side sleep) and each kernel's device time a launch
(torch.profiler). The same data, made on the card from seed 0, goes to
every tree; ``--dim`` draws the problems at another width (8: the IVF
build's PQ sweep). Prints the card's name and power limit, one JSON line per
tree, and (with ``--out``) writes them all there. Two versions compare
only within one call on one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
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


def kernel_ms(torch, fn, calls: int = 3) -> dict:
    """Device time a call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key[:80]] = evt.self_device_time_total / 1e3 / calls
    return out


def one(tree: Path, reps: int, dim: int | None) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.configs import KVQUANT_GEMMA2_2B as KVQ
    from repro_torch.core import bounds
    from repro_torch.data import blobs_batched
    from repro_torch.kernels import kmeans_distance as kd
    from repro_torch.kernels import lloyd_assign as la
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = blobs_batched(KVQ.batch, KVQ.n_points, dim or KVQ.dim, KVQ.k,
                        generator=gen)
    bsz, n, d = pts.shape
    k = KVQ.k
    idx = torch.randint(n, (bsz, k, 1), generator=gen, device=dev)
    cents = torch.take_along_dim(pts, idx, dim=1).contiguous()
    bn = ops.choose_block_n(n, d, k)
    tps = bounds.tiles_per_super(-(-n // bn))
    res = dict(tree=str(tree), batch=bsz, n=n, d=d, k=k, block_n=bn,
               tps=tps)
    norms = bounds.point_norms(pts)   # fp32 on both streams
    # the seeding rounds: D² to two earlier seeds, the next 1 or 8 folded
    bn1 = ops.choose_block_n(n, d, 1)
    cache = bounds.RoundCache(*kd.seed_prologue_batched(pts, bn1))
    md = kd.distance_min_update_batched_torch(
        pts, cache.norms, cents[:, 8:10].contiguous(),
        torch.full((bsz, n), torch.inf, device=dev), block_n=bn1)[0]
    parts = kd.tile_partials(md, bn1)
    tmax = bounds.tile_reduce_max(md, bn1)
    gate = bounds.seed_gate(cents[:, :1].contiguous(), cache, tmax)
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        p, c = pts.to(dtype), cents.to(dtype)
        c1, c8 = c[:, :1].contiguous(), c[:, :8].contiguous()
        calls = {
            "K7 m=1": lambda: kd.distance_min_update_batched(
                p, cache.norms, c1, md, block_n=bn1),
            "K7 m=8": lambda: kd.distance_min_update_batched(
                p, cache.norms, c8, md, block_n=bn1),
            "K8 m=1": lambda: kd.distance_min_update_gated_batched(
                p, cache.norms, c1, md, cache.center_d, gate[1], gate[2],
                parts, tmax, gate[0], block_n=bn1)}
        calls.update({
            "K10a": lambda: la.lloyd_assign_tiled_batched(
                p, norms, c, block_n=bn, tps=tps),
            "K9": lambda: la.lloyd_assign_batched(p, norms, c, block_n=bn)})
        for name, fn in calls.items():
            res[f"{name}_{tag}"] = dict(ms=gpu_ms(torch, fn, reps),
                                        kernels_ms=kernel_ms(torch, fn))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--dim", type=int)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.trees[0].resolve(), args.reps,
                             args.dim)))
        return 0
    print(card_line())
    rows, failed = [], 0
    for tree in args.trees:
        run = subprocess.run(
            [sys.executable, __file__, "--one", "--reps", str(args.reps),
             *(("--dim", str(args.dim)) if args.dim else ()), str(tree)],
            capture_output=True, text=True)
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
