#!/usr/bin/env python3
"""What paces the wgmma tile of `ntransformer_tpu_torch/csrc/hopper_tile.cuh`
(the Q8_0 and W8A8 products past 32 tokens), on one card.

    python3 experiments/tile_ablation.py

It builds this checkout's `q8_0_matmul.cu` and `w8a8_matmul.cu` against
copies of the header with one part of the tile's pipeline switched off
(results are wrong then; only the time is read), and reports the
profiler's device ms of the 8B gate|up and down products at T = 512 under
each:

  base:   the tile as it is;
  noA:    the consumers copy no activations (the A tiles keep stale data);
  noT:    the producer leaves the B tiles as they are (no dequant or
          transpose);
  noRaw:  the producer copies no raw weight rows;
  noMMA:  the consumers issue no wgmma.

Every barrier stays, so what is left is the pipeline's skeleton with the
other parts. The copies are written beside the header in csrc/ as
`_tv_*` files (removed once built) and the libraries under
`scratch_chip/tv/` (a directory .gitignore lists). The card's name and
power limit are printed first.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "ntransformer_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "scratch_chip", "tv")
VARIANTS = {
    "base": [],
    "noA": [("        cp_async16(a + sw128(r, c), src, bytes);",
             "        if (bytes < 0) cp_async16(a + sw128(r, c), src, bytes);")],
    "noT": [("    F::transform(args, sm + L::RAW_OFF",
             "    if (steps < 0) F::transform(args, sm + L::RAW_OFF")],
    "noRaw": [("      F::issue_raw(args, sm + L::RAW_OFF",
               "      if (steps < 0) F::issue_raw(args, sm + L::RAW_OFF")],
    "noMMA": [("        F::mma(acc[mi], desc_sw128(a + mi * 64 * 128 + 32 * kk),",
               "        if (steps < 0) F::mma(acc[mi], "
               "desc_sw128(a + mi * 64 * 128 + 32 * kk),")],
}
SOURCES = ("q8_0_matmul", "w8a8_matmul")


def build_all(build) -> dict:
    header = open(os.path.join(CSRC, "hopper_tile.cuh")).read()
    os.makedirs(OUT, exist_ok=True)
    made, procs = [], {}
    for vn, edits in VARIANTS.items():
        h = header
        for a, b in edits:
            assert a in h, (vn, a)
            h = h.replace(a, b)
        hp = os.path.join(CSRC, f"_tv_{vn}.cuh")
        open(hp, "w").write(h)
        made.append(hp)
        for src in SOURCES:
            s = open(os.path.join(CSRC, src + ".cu")).read().replace(
                '#include "hopper_tile.cuh"', f'#include "_tv_{vn}.cuh"')
            sp = os.path.join(CSRC, f"_tv_{vn}_{src}.cu")
            open(sp, "w").write(s)
            made.append(sp)
            out = os.path.join(OUT, f"lib{vn}_{src}.so")
            procs[(vn, src)] = (subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, sp],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                out)
    libs = {}
    for key, (pr, out) in procs.items():
        _, err = pr.communicate()
        if pr.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{err[-2000:]}")
        libs[key] = ctypes.CDLL(out)
    for p in made:
        os.remove(p)
    return libs


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    from ntransformer_tpu_torch.ops.cuda import build, plans
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.cuda import w8a8 as cw8
    from experiments.matmul_plans import device_ms
    assert torch.cuda.is_available(), "this measurement needs a CUDA card"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build_all(build)
    for (vn, src), lib in libs.items():
        fn = getattr(lib, src)
        fn.argtypes = (cm._SIGNATURES[cm.NAME] if src == cm.NAME
                       else cw8._SIGNATURES[cw8.NAME])
    sms = plans.sm_count(torch.device("cuda"))
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    t = 512
    for label, k, n in (("gate|up", 4096, 28672), ("down", 14336, 4096)):
        qs = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                           device="cuda", generator=g)
        d = (torch.rand(k // 32, n, device="cuda", generator=g) * 0.01
             + 1e-3).to(torch.float16).view(torch.int16)
        s = 1e-4 + 2e-4 * torch.rand(1, n, device="cuda", generator=g)
        x = torch.randn(t, k, device="cuda", generator=g).to(torch.bfloat16)
        y = torch.empty(t, n, device="cuda")
        work = torch.empty(t * (-(-k // 128) * 128) + 4 * t,
                           dtype=torch.uint8, device="cuda")
        st = torch.cuda.current_stream().cuda_stream
        row = {"shape": label, "T": t}
        for (vn, src), lib in libs.items():
            if src == cm.NAME:
                bm, ns, sk = plans.tile_plan(sms, t, k, n, 64)

                def fn(lib=lib, bm=bm, ns=ns, sk=sk):
                    return lib.q8_0_matmul(
                        x.data_ptr(), qs.data_ptr(), d.data_ptr(),
                        y.data_ptr(), t, k, n, 1, ns, sk, bm, 1, st)
            else:
                bm, ns, sk = plans.tile_plan(sms, t, k, n, 128)

                def fn(lib=lib, bm=bm, ns=ns, sk=sk):
                    return lib.w8a8_matmul(
                        x.data_ptr(), 0, k, 1, qs.data_ptr(), s.data_ptr(),
                        y.data_ptr(), work.data_ptr(), t, k, n, 1, ns, sk,
                        bm, 1, st)
            assert fn() == 0
            row[f"{src} {vn}"] = round(device_ms(torch, fn), 5)
        print(json.dumps(row), flush=True)
        del qs, d, s, x, y, work
    return 0


if __name__ == "__main__":
    sys.exit(main())
