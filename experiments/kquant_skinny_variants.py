#!/usr/bin/env python3
"""Variants of the Q4_K / Q6_K skinny kernel (csrc/kquant_matmul.cu, T <= 32)
on one card: each a small text change to the source, compiled with nvcc
into a library of its own under scratch_chip/kquant_variants/ (listed in
.gitignore) and timed against the others in turns.

    python3 experiments/kquant_skinny_variants.py [NAME ...]

With no NAME every variant of VARIANTS runs. Shapes: Q4_K at the 8B fused
gate|up (T = 1, 8, 32), qkv and wo (T = 1); Q6_K at the 8B down (T = 1, 8,
32) and the 128256-token head (T = 1). Each call is timed with
chip_smoke.py's Timer (CUDA events, L2 flushed before every call), the
launch made straight through ctypes with the wrapper's plan
(`plans.skinny_plan`, times `sm_mult` SMs where a variant asks for more
blocks). Beside each call time, the profiler's device time of a call
(`chip_smoke.profile_calls`: calls back to back, no flush). A variant that
changes what is computed (the copy-only floors) prints its error against
the plain twin as a marker, not a check. Prints
the card's name and power limit, then one JSON line a shape, and writes
chiprun_out/kquant_skinny_variants.json.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "ntransformer_tpu_torch", "csrc",
                   "kquant_matmul.cu")
HDR = os.path.join(HERE, "ntransformer_tpu_torch", "csrc", "hopper_tile.cuh")
OUT = os.path.join(HERE, "scratch_chip", "kquant_variants")

_LOOP = ("    F::scales(slot, scr, lane);\n    __syncwarp();\n"
         "    F::template compute<NT>(slot, scr, acc, lane, p.magic, "
         "k0 + STRIDE * i);")
# the copy ring alone: every step's copies land, nothing is computed
_COPY_ONLY = [(_LOOP, "    acc[0][0][0] += __uint_as_float("
                      "*reinterpret_cast<const uint32_t*>(slot + 4 * lane));")]
_NO_SCALE_COPIES = [("copy_u8(slot + SC_OFF", "if (0) copy_u8(slot + SC_OFF"),
                    ("copy_u16(slot + D_OFF", "if (0) copy_u16(slot + D_OFF")]
_NO_X = [("copy_x(slot + X_OFF", "if (0) copy_x(slot + X_OFF")]
_BOUNDS = "__global__ void __launch_bounds__(Skinny<F, NT>::THREADS)"
_WARPS = "4 * (STAGES * SLOT + F::SCR) <= SMEM_TWO ? 4 : 3;"
_CP = "    cp_async16(smem_u32(dst), in ? src : plane, in ? 16 : 0);"
_L2_FN = ("// 16 bytes of a u8 plane, row `row`",
          "__device__ __forceinline__ void cp_async16_l2(uint32_t dst, "
          "const void* src, int n) {\n  asm volatile(\"cp.async.cg.shared."
          "global.L2::256B [%0], [%1], 16, %2;\\n\" ::\"r\"(dst), \"l\"(src), "
          "\"r\"(n) : \"memory\");\n}\n// 16 bytes of a u8 plane, row `row`")
VARIANTS = {
    "base": {"subs": []},
    # the f32 2^23 as a known constant: it takes the byte permutes'
    # immediate operand and each selector is copied into a register
    "magic_const": {"subs": [("__byte_perm(u, mg, 0x7650 | j)",
                              "__byte_perm(u, 0x4B000000u, 0x7650 | j)")]},
    "slots3": {"subs": [("static constexpr int STAGES = 2;",
                         "static constexpr int STAGES = 3;")]},
    "slots4": {"subs": [("static constexpr int STAGES = 2;",
                         "static constexpr int STAGES = 4;")]},
    # 8 warps a block where their slots fit one block an SM
    "warps8": {"subs": [(_WARPS, "8 * (STAGES * SLOT + F::SCR) <= SMEM_MAX"
                                 " ? 8 : 4;")]},
    # 4 warps a block always (Q6_K at 17-32 tokens: one block an SM)
    "warps4": {"subs": [(_WARPS, "4;")]},
    "blocks3_splits2x": {"subs": [(_BOUNDS, _BOUNDS[:-1] + ", 3)")],
                         "sm_mult": 2},
    "no_scale_decode": {"subs": [("    F::scales(slot, scr, lane);\n"
                                  "    __syncwarp();\n", "")]},
    # plane copies with an L2 prefetch-size hint: a 256-byte fetch also
    # brings the neighbouring strip's 128 bytes of the row
    "l2_256": {"subs": [_L2_FN, (_CP, _CP.replace("cp_async16(",
                                                 "cp_async16_l2("))]},
    "copy_only": {"subs": _COPY_ONLY},
    "copy_only_codes": {"subs": _COPY_ONLY + _NO_SCALE_COPIES + _NO_X},
}
SHAPES = (("q4_k", "gate|up", 4096, 28672, (1, 8, 32)),
          ("q4_k", "qkv", 4096, 6144, (1,)), ("q4_k", "wo", 4096, 4096, (1,)),
          ("q6_k", "down", 14336, 4096, (1, 8, 32)),
          ("q6_k", "head", 4096, 128256, (1,)))


def make(name: str):
    """Write and compile variant `name`: (name, library path or None,
    nvcc's register report or its error)."""
    from ntransformer_tpu_torch.ops.cuda import build
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    s = open(SRC).read()
    for old, new in VARIANTS[name]["subs"]:
        if old not in s:
            return name, None, f"variant text not in the source: {old!r}"
        s = s.replace(old, new)
    open(os.path.join(d, "kquant_matmul.cu"), "w").write(s)
    shutil.copy(HDR, d)
    so = os.path.join(d, "kquant_matmul.so")
    p = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so,
                        os.path.join(d, "kquant_matmul.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        return name, None, p.stderr[-3000:]
    return name, so, "\n".join(ln.strip() for ln in p.stderr.splitlines()
                               if "registers" in ln or "spill" in ln)


def main() -> int:
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    from ntransformer_tpu_torch.ops.cuda import plans
    assert torch.cuda.is_available(), "this measurement needs a CUDA card"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(min(8, len(names))) as ex:  # nvcc in parallel
        built = list(ex.map(make, names))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {}
    for name, so, rep in built:
        print(f"== {name}\n{rep[-1200:]}", flush=True)
        if so is None:
            return 1
        lib = ctypes.CDLL(so)
        for dt in nm.KQUANT:
            f = getattr(lib, nm.KERNELS[dt].name)
            f.argtypes = nm._KQ_SIGNATURES[nm.KERNELS[dt].name]
            f.restype = ctypes.c_int
        libs[name] = lib
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    timer = cs.Timer(torch)
    sms = plans.sm_count(torch.device("cuda"))
    res = {}
    for fmt, label, k, n, ts in SHAPES:
        dtype = DType(fmt)
        planes = cs.random_planes(torch, g, dtype, k, n)
        by_slot = {nm._SLOT_OF.get(a, a): v for a, v in planes.items()}
        ptrs = [by_slot[s].data_ptr() if s in by_slot else None
                for s in nm.SLOTS]
        for t in ts:
            x = torch.randn(t, k, device="cuda", generator=g).to(
                torch.bfloat16)
            y0 = nm.nibble_matmul_plain(x, planes, dtype)
            key = f"{fmt} {label} T={t}"
            row, fns = {}, {}
            for name, lib in libs.items():
                ns, sk = plans.skinny_plan(
                    sms * VARIANTS[name].get("sm_mult", 1), t, k, n,
                    plans.KQUANT_UNIT)
                y = torch.empty(t, n, device="cuda")
                fn = getattr(lib, nm.KERNELS[dtype].name)

                def call(fn=fn, y=y, x=x, ns=ns, sk=sk):
                    rc = fn(x.data_ptr(), *ptrs, y.data_ptr(), t, k, n, 0, ns,
                            sk, 0, 1, nm._MAGIC,
                            torch.cuda.current_stream().cuda_stream)
                    assert rc == 0, f"{name}: CUDA error {rc}"
                call()
                torch.cuda.synchronize()
                row[f"{name} rel_err"] = float((y - y0).abs().max()
                                               / y0.abs().max())
                fns[name] = call
            row.update(timer.compare(fns))
            # the profiler's device time (no L2 flush between calls)
            for name, fn in fns.items():
                prof = cs.profile_calls(torch, fn)
                row[f"{name} device_ms"] = sum(v["ms"] for v in prof.values())
            res[key] = row
            print(key, json.dumps(row), flush=True)
        del planes
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           "kquant_skinny_variants.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
