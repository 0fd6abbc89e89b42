#!/usr/bin/env python3
"""How often torch.profiler loses CUDA kernel records on this card, and
whether chip_smoke.py's `profile_calls` still reads whole counts.

    python3 experiments/profiler_loss.py [--traces 60] [--reads 20]
                                          [--rounds 2]

On one card, for the Q8_0 and the W8A8 product of the port at the 8B fused
qkv shape (K 4096, N 6144) at T = 1 and 512, it takes `--traces` traces of
10 calls each in two ways and counts the traces that lost a record (the
counter's launches are known: one a Q8_0 call, two a W8A8 call):

  cold: one trace over the 10 calls (no warm-up step);
  warm1, warm5: a warm-up step of one or five calls whose records are
     dropped, then the 10 calls in the active step (chip_smoke.py's
     `profile_calls` takes five);

then calls `profile_calls` of chip_smoke.py `--reads` times and counts the
reads whose kernels per call differ from the counter's. The cases run in
turn, `--rounds` times, in one process: the profiler loses more the more
traces a process has taken. Prints the card's name and power limit first,
then one JSON line a case and round.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    return smi.stdout.strip().splitlines()[0]


def trace_counts(torch, fn, warm: int, calls: int = 10) -> dict:
    """Kernel name -> records of one trace over `calls` calls of fn."""
    from torch.profiler import ProfilerActivity, profile, schedule
    kw = {}
    if warm:
        kw["schedule"] = schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CUDA], **kw) as prof:
        if warm:
            for _ in range(warm):
                fn()
            torch.cuda.synchronize()
            prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        if warm:
            prof.step()
    return {e.key[:60]: e.count for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traces", type=int, default=60)
    ap.add_argument("--reads", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.cuda import w8a8 as cw8

    if not torch.cuda.is_available():
        print("profiler_loss: no CUDA device", file=sys.stderr)
        return 1
    print(card(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    k, n = 4096, 6144
    qs = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                       generator=g)
    d = (torch.rand(k // 32, n, device="cuda", generator=g) * 0.01
         + 1e-3).to(torch.float16).view(torch.int16)
    q8 = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                       generator=g)
    s8 = torch.rand(1, n, device="cuda", generator=g) * 0.01
    cases = []
    for t in (1, 512):
        x = torch.randn(t, k, device="cuda", generator=g).to(torch.bfloat16)
        cases.append((f"q8_0 qkv T={t}", 1,
                      lambda x=x: cm.quant_matmul_cuda(x, qs, d)))
        cases.append((f"w8a8 qkv T={t}", 2,
                      lambda x=x: cw8.w8a8_matmul_cuda(x, q8, s8)))
    for r in range(args.rounds):
        for name, per, fn in cases:
            fn()
            torch.cuda.synchronize()
            row = {"case": name, "round": r, "launches_per_call": per,
                   "traces": args.traces}
            for warm in (0, 1, 5):
                lost = []
                for _ in range(args.traces):
                    got = sum(trace_counts(torch, fn, warm).values())
                    if got != 10 * per:
                        lost.append(got)
                key = f"warm{warm}" if warm else "cold"
                row[f"{key}_lost"] = len(lost)
                row[f"{key}_lost_records"] = lost
            wrong, t0 = [], time.perf_counter()
            for _ in range(args.reads):
                prof = chip_smoke.profile_calls(torch, fn)
                got = sum(v["per_call"] for v in prof.values())
                if got != per:
                    wrong.append(got)
            row["profile_calls_reads"] = args.reads
            row["profile_calls_wrong"] = wrong
            row["profile_calls_s_per_read"] = ((time.perf_counter() - t0)
                                               / args.reads)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
