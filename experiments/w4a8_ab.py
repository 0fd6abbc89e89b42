#!/usr/bin/env python3
"""The W4A8 kernels and the W4A8 path of the H100 port, one checkout
against another, on one card.

    python3 experiments/w4a8_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (this one, or an
older commit unpacked with `git archive`); each is measured in a process of
its own, in the order given, so `parent change change parent` shows the
spread between runs. For each ROOT it prints one JSON line:

  decode: the W4A8 decode product at the 8B fused gate|up (K 4096, N 28672,
     T = 1, bf16 x): the wrapper's call time (CUDA events, L2 flushed
     before each call, as chip_smoke.py times kernels), every CUDA kernel
     the call launches with its device time (torch.profiler), the launch
     counter's count a call, the time of the checkout's activation
     quantization alone (`ops/cuda/w4a8.py::_activations`), and
     torch.matmul on the pre-dequantized bf16 weight;
  tile: the W4A8 T > 1 product at gate|up, T = 512, the same way;
  path: the synthetic 8B in W4A8 (chip_smoke.py's `build_synth`) through
     Engine.benchmark (512-token prefill, 64 decoded tokens) and bench.py's
     B = 1 batched step (chip_smoke.py's `bench_b1`), with the step's
     device time and CUDA kernels per step over 8 profiled steps.

It imports chip_smoke.py and the port from ROOT, so it runs against any
checkout whose chip_smoke.py has `build_synth`, `bench_b1`, `Timer`,
`random_wplanes` and `skewed_x`. The card's name and power limit are
printed first.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    return smi.stdout.strip().splitlines()[0]


def kernels_of(torch, fn, calls: int) -> dict:
    """CUDA kernels that `calls` calls of fn launch: name -> (ms, count)
    per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:70]: (e.self_device_time_total / 1e3 / calls,
                         e.count / calls)
            for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0}


def product(torch, fn, library, timer) -> dict:
    ms = timer.compare({"call": fn, "library": library})
    ks = kernels_of(torch, fn, 10)
    return {"call_ms": ms["call"], "library_ms": ms["library"],
            "device_ms": sum(v[0] for v in ks.values()),
            "kernels_per_call": sum(v[1] for v in ks.values()),
            "kernels": {k: {"ms": v[0], "per_call": v[1]}
                        for k, v in ks.items()}}


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_root", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                       batched_decode_step)
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    from ntransformer_tpu_torch.ops.cuda import w4a8 as cw4
    from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
    assert torch.cuda.is_available(), "this measurement needs a CUDA card"
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root, "card": card()}
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda")
    g.manual_seed(2468)
    k, n = 4096, 28672
    planes = cs.random_wplanes(torch, g, DType.W4A8, k, n)
    w = dequant_planes_torch(planes, DType.W4A8, k, n,
                             out_dtype=torch.bfloat16)
    x1 = cs.skewed_x(torch, g, 1, k)
    before = cw4.launches
    cw4.w4a8_decode_cuda(x1, planes)
    torch.cuda.synchronize()
    per_call = cw4.launches - before
    out["decode"] = product(torch, lambda: cw4.w4a8_decode_cuda(x1, planes),
                            lambda: torch.matmul(x1, w), timer)
    out["decode"]["counter_launches_per_call"] = per_call
    out["decode"]["act_quant_ms"] = timer.compare(
        {"q": lambda: cw4._activations(x1)})["q"]
    x512 = cs.skewed_x(torch, g, 512, k)
    out["tile"] = product(torch, lambda: nm.nibble_matmul_cuda(
        x512, planes, DType.W4A8), lambda: torch.matmul(x512, w), timer)
    del planes, w

    cfg, arch, weights, per_token = cs.build_synth(torch, "w4a8")
    engine = Engine(LoadedModel(cfg, arch, weights, None, None,
                                torch.device("cuda")))
    ids = torch.randint(0, arch.vocab_size, (512,),
                        generator=torch.Generator().manual_seed(9)).tolist()
    engine.benchmark(prompt_ids=ids, n_tokens=8)  # warm-up
    stats = engine.benchmark(prompt_ids=ids, n_tokens=64)
    counters = {"w4a8_decode": cw4, "w4a8_matmul": nm.KERNELS[DType.W4A8]}
    b1 = cs.bench_b1(torch, counters, arch, weights, per_token)
    import dataclasses
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    bkv = BatchedKV.create(arch1k, 1, device="cuda")
    tok = torch.full((1,), 3, dtype=torch.long, device="cuda")
    act = torch.ones(1, dtype=torch.bool, device="cuda")

    def step(i):
        nonlocal tok, bkv
        pos = torch.full((1,), 160 + i, dtype=torch.long, device="cuda")
        logits, bkv = batched_decode_step(arch1k, weights, bkv, tok, pos,
                                          act, s_live=256)
        tok = torch.argmax(logits, -1)

    ctr = iter(range(10 ** 6))
    ks = kernels_of(torch, lambda: step(next(ctr)), 8)
    t0 = time.perf_counter()
    for _ in range(8):
        step(next(ctr))
    torch.cuda.synchronize()
    out["path"] = {
        "prefill_tokens": stats.prefill_tokens,
        "prefill_ms": stats.prefill_ms,
        "decode_ms_per_token": stats.decode_ms / stats.decode_tokens,
        "b1_ms_per_step": b1["ms_per_step"],
        "b1_launches_per_step": {kn: v / 128 for kn, v in
                                 b1["launches"].items()},
        "b1_unprofiled_wall_ms_per_step": (time.perf_counter() - t0) / 8
        * 1e3,
        "b1_device_ms_per_step": sum(v[0] for v in ks.values()),
        "b1_kernels_per_step": sum(v[1] for v in ks.values()),
        "b1_top": sorted(({"kernel": kn, "ms": v[0], "per_step": v[1]}
                          for kn, v in ks.items()),
                         key=lambda r: -r["ms"])[:8]}
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(card(), flush=True)
    for root in sys.argv[1:]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root], capture_output=True, text=True,
                           timeout=900)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if r.returncode or not lines:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
