#!/usr/bin/env python3
"""Sweep of the launch plans of the Q8_0 and W8A8 matmul kernels
(`ntransformer_tpu_torch/ops/cuda/plans.py`) on one card.

    python3 experiments/matmul_plans.py

At the 8B shapes (fused qkv, wo, fused gate|up, down, the 128256-token
head) it times each kernel's C entry under every plan its plan function
chooses among, with the profiler's device time of 10 calls (after a warm-up
call; the L2 cache is not flushed):

  skinny: T = 1, 8 and 32, K split over 1 to 8 clusters of 128-row units
     (the splits that `skinny_plan` would pick to give every SM one, two
     or four blocks);
  tile: T = 64, 128, 256 and 512, 128 or 256 rows, K split in 1, 2 or 4.

Each line is one shape and T, with the device ms of every plan, the plan
the plan function picks and the fastest measured; every product is checked
against its plain twin (Q8_0 within 1e-3 of max|plain|, W8A8 bit-equal).
The card's name and power limit are printed first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("qkv", 4096, 6144), ("wo", 4096, 4096), ("gate|up", 4096, 28672),
          ("down", 14336, 4096), ("head", 4096, 128256))


def device_ms(torch, fn, calls: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if "CUDA" in str(e.device_type)) / 1e3 / calls
        if ms > 0:
            return ms
    return float("nan")


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from ntransformer_tpu_torch.ops.cuda import build, plans
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.cuda import w8a8 as cw8
    assert torch.cuda.is_available(), "this sweep needs a CUDA card"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with ThreadPoolExecutor(2) as ex:
        list(ex.map(build.build, [cm.NAME, cw8.NAME]))
    lq = build.load(cm.NAME, cm._SIGNATURES)
    lw = build.load(cw8.NAME, cw8._SIGNATURES)
    sms = plans.sm_count(torch.device("cuda"))
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    for label, k, n in SHAPES:
        qs = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                           device="cuda", generator=g)
        d = (torch.rand(k // 32, n, device="cuda", generator=g) * 0.01
             + 1e-3).to(torch.float16).view(torch.int16)
        s = 1e-4 + 2e-4 * torch.rand(1, n, device="cuda", generator=g)
        for t in (1, 8, 32, 64, 128, 256, 512):
            ramp = torch.linspace(0.5, 2.0, k, device="cuda")
            x = (torch.randn(t, k, device="cuda", generator=g) * ramp
                 + 0.1 * ramp).to(torch.bfloat16)
            y = torch.empty(t, n, device="cuda")
            kp = -(-k // 128) * 128
            work = torch.empty(t * kp + 4 * t, dtype=torch.uint8,
                               device="cuda")
            want = {"q8_0": cm.quant_matmul_plain(x, qs, d),
                    "w8a8": cw8.w8a8_matmul_plain(x, qs, s)}
            st = torch.cuda.current_stream().cuda_stream
            cands = []  # (path, bm, nsplit, split_k by format)
            if t <= plans.SKINNY_ROWS:
                units = -(-k // plans.SPLIT_UNIT)
                for ns in sorted({plans.skinny_plan(c * sms, t, k, n)[0]
                                  for c in (1, 2, 4)} | {1, 8}):
                    ns = min(ns, units)
                    per = -(-units // ns) * plans.SPLIT_UNIT
                    cands.append((0, 0, -(-k // per), {"q8_0": per,
                                                       "w8a8": per}))
                pick = {"q8_0": plans.skinny_plan(sms, t, k, n),
                        "w8a8": plans.skinny_plan(sms, t, k, n)}
            else:
                for bm in (128, 256):
                    for ns in (1, 2, 4):
                        per = {}
                        for fmt, sk in (("q8_0", 64), ("w8a8", 128)):
                            stages = -(-k // sk)
                            per[fmt] = -(-stages // ns) * sk
                        cands.append((1, bm, ns, per))
                pick = {"q8_0": plans.tile_plan(sms, t, k, n, 64),
                        "w8a8": plans.tile_plan(sms, t, k, n, 128)}
            row = {"shape": label, "T": t, "plan": pick, "ms": {}}
            for path, bm, ns, per in cands:
                for fmt in ("q8_0", "w8a8"):
                    nsp = -(-k // per[fmt])
                    if fmt == "q8_0":
                        def fn(nsp=nsp, sk=per[fmt], bm=bm, path=path):
                            return lq.q8_0_matmul(
                                x.data_ptr(), qs.data_ptr(), d.data_ptr(),
                                y.data_ptr(), t, k, n, path, nsp, sk, bm, 1,
                                st)
                    else:
                        def fn(nsp=nsp, sk=per[fmt], bm=bm, path=path):
                            return lw.w8a8_matmul(
                                x.data_ptr(), 0, k, 1, qs.data_ptr(),
                                s.data_ptr(), y.data_ptr(), work.data_ptr(),
                                t, k, n, path, nsp, sk, bm, 1, st)
                    assert fn() == 0
                    torch.cuda.synchronize()
                    ref = want[fmt]
                    if fmt == "q8_0":
                        ok = float((y - ref).abs().max()) <= \
                            1e-3 * float(ref.abs().max())
                    else:
                        ok = bool(torch.equal(y, ref))
                    assert ok, f"{fmt} {label} T={t} bm={bm} ns={nsp}"
                    key = (f"{fmt} split {nsp}" if path == 0 else
                           f"{fmt} rows {bm} split {nsp}")
                    row["ms"][key] = round(device_ms(torch, fn), 5)
            for fmt in ("q8_0", "w8a8"):
                mine = {kk: v for kk, v in row["ms"].items()
                        if kk.startswith(fmt)}
                row[f"fastest {fmt}"] = min(mine, key=mine.get)
            print(json.dumps(row), flush=True)
            del x, y, work, want
        del qs, d, s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
