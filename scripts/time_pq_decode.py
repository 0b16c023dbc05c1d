#!/usr/bin/env python3
"""Time K16 (PQ decode attention) on one NVIDIA card beside its template
entry (the kernel before its redesign) and the launch floor.

    python3 scripts/time_pq_decode.py [--reps N] [--out PATH]

At gemma2-2b's attention width (``src/repro/configs/gemma2_2b.py:8-11``:
8 query heads over 4 kv heads, head_dim 256; the PQ cache of
``serve.kvquant.compress_transformer_cache`` with 16 sub-spaces; batch 1,
``cache_len`` 8,192) and at qwen2-vl-7b's heads (``qwen2_vl_7b.py:8``: 7
query heads a kv head, head_dim 128) with 32 sub-spaces, whose table the
template refuses, on random codes and codebooks made from seed 0:

- K16: the median CUDA-event ms of ``reps`` launches queued behind a
  device-side sleep, the largest |kernel - twin|, whether a second launch
  gives the same bits, and the blocks' plan (``pq_decode.plan``);
- the template entry's ms, and the launch floor: the ms of a one-element
  ``torch`` add on the same stream;
- at gemma2-2b's width, K16 and the template entry at a short cache
  (``cache_len`` 1,024 of the 8,192 positions), whose plan is the full
  cache's;
- a 26-layer decode step (one launch a layer, gemma2-2b's 26 layers) by
  CUDA events, for K16 and the template entry;
- at gemma2-2b's width, each kernel's mean device time by name over
  ``reps`` calls from torch.profiler, for K16 and the template entry.

Prints the card's name and power limit and one JSON object, and (with
``--out``) writes it there.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


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


def kernel_ms(torch, fn, reps: int) -> dict:
    """Mean device ms a call of each kernel ``fn`` launches, by name, from
    torch.profiler over ``reps`` calls, with its launches a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {evt.key[:48]: dict(ms=evt.self_device_time_total / 1e3 / evt.count,
                               per_call=evt.count / reps)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA}


def layer(torch, gen, dev, S, KH, G, hd, n_sub):
    dsub = hd // n_sub
    q = torch.randn((1, 1, KH * G, hd), generator=gen, device=dev)
    codes = [torch.randint(0, 256, (1, S, KH, n_sub), generator=gen,
                           device=dev, dtype=torch.uint8) for _ in range(2)]
    cbs = [torch.randn((KH, n_sub, 256, dsub), generator=gen, device=dev)
           for _ in range(2)]
    return [q, *codes, *cbs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_pq_decode: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import KernelFailureError
    from repro_torch.kernels import pq_decode as pqd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    reps = args.reps
    res = dict(card=card_line(), device=torch.cuda.get_device_name(0))
    one = torch.zeros(1, device=dev)
    res["launch_floor_ms"] = gpu_ms(torch, lambda: one.add_(1.0), reps)
    S = 8192
    for name, (KH, G, hd, n_sub) in (("gemma2-2b", (4, 2, 256, 16)),
                                     ("qwen2-vl-7b", (4, 7, 128, 32))):
        x = layer(torch, gen, dev, S, KH, G, hd, n_sub)
        twin = pqd.pq_decode_attention_torch(*x, S)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        chunk, dims = pqd.plan(1, S, KH, hd, n_sub, sms)
        out = pqd.pq_decode_attention(*x, S)
        shape = dict(
            S=S, KH=KH, G=G, hd=hd, n_sub=n_sub, chunk=chunk, dims=dims,
            ms=gpu_ms(torch, lambda: pqd.pq_decode_attention(*x, S), reps),
            max_abs_err=float((out - twin).abs().max()),
            repeat_bitwise=torch.equal(out,
                                       pqd.pq_decode_attention(*x, S)))
        try:
            old = pqd.pq_decode_attention_template(*x, S)
            shape["template_ms"] = gpu_ms(
                torch, lambda: pqd.pq_decode_attention_template(*x, S), reps)
            shape["template_max_abs_err"] = float((old - twin).abs().max())
        except KernelFailureError as e:
            shape["template_ms"] = f"refused: {e}"
        if name == "gemma2-2b":
            short = 1024
            out = pqd.pq_decode_attention(*x, short)
            shape[f"cache_len {short}"] = dict(
                ms=gpu_ms(torch, lambda: pqd.pq_decode_attention(*x, short),
                          reps),
                template_ms=gpu_ms(
                    torch, lambda: pqd.pq_decode_attention_template(
                        *x, short), reps),
                max_abs_err=float((out - pqd.pq_decode_attention_torch(
                    *x, short)).abs().max()))
            shape["kernels"] = {
                what: kernel_ms(torch, lambda: fn(*x, S), reps)
                for what, fn in (("K16", pqd.pq_decode_attention),
                                 ("template",
                                  pqd.pq_decode_attention_template))}
        res[name] = shape
        print(json.dumps({name: shape}), flush=True)
    # a decode step: 26 layers of gemma2-2b's width, one launch each
    layers = [layer(torch, gen, dev, S, 4, 2, 256, 16) for _ in range(26)]
    for what, fn in (("K16", pqd.pq_decode_attention),
                     ("template", pqd.pq_decode_attention_template)):
        res[f"decode step ms, {what}"] = gpu_ms(
            torch, lambda: [fn(*x, S) for x in layers], max(3, reps // 3))
    print(f"card: {res['card']}")
    print(json.dumps(res))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
