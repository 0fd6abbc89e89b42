#!/usr/bin/env python3
"""The Q8_0 and W8A8 matmul kernels of the H100 port (csrc/q8_0_matmul.cu,
csrc/w8a8_matmul.cu) and the paths they carry, one checkout against
another, on one card.

    python3 experiments/matmul_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (this one, or an
older commit unpacked with `git archive` into a directory .gitignore lists);
each is measured in a process of its own that builds that checkout's
kernels from its own csrc/, in the order given, so `parent change change
parent` shows the spread between runs. For each ROOT it prints one JSON
line:

  products: the Q8_0 and the W8A8 product at the 8B shapes (fused qkv, wo,
     fused gate|up, down, the 128256-token head) at T = 1, 8, 32 and 512:
     the wrapper's call time (CUDA events, L2 flushed before each call,
     chip_smoke.py's Timer), torch.matmul on the pre-dequantized bf16
     weight beside it, the profiler's device time and CUDA kernels per
     call, and the launch counter's launches per call;
  paths: the synthetic 8B of chip_smoke.py's `build_synth` in Q8_0 and in
     W8A8 through Engine.benchmark (512-token prefill, 64 decoded tokens),
     bench.py's B = 1 batched step (`bench_b1`) and the B = 32 int8 step
     chained from mid-context under "f32" and "int8_v" in turns, with its
     profile (device ms and kernels a step); for Q8_0 also CPEngine (4
     shards on the one card, ctx 9,216) and the resident Engine over a
     4,600-token prompt, and a profile of CPEngine's prefill chunk [2048,
     2560) with the matmul kernels' share of its device time.

It imports chip_smoke.py and the port from ROOT, so it runs against any
checkout whose chip_smoke.py has `build_synth`, `bench_b1`,
`batched_chain`, `profile_batched`, `random_wplanes`, `skewed_x`, `Timer`
and the CP constants. The card's name and power limit are printed first.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SHAPES = (("qkv", 4096, 6144), ("wo", 4096, 4096), ("gate|up", 4096, 28672),
          ("down", 14336, 4096), ("head", 4096, 128256))
TOKENS = (1, 8, 32, 512)
# CUDA kernels of the matmul products, old and new names
MATMUL_MARKERS = ("q8_gemv", "q8_mma", "splitk_reduce", "skinny_kernel",
                  "tile_kernel", "w8_", "quant_kernel")


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    return smi.stdout.strip().splitlines()[0]


def kernels_of(torch, fn, calls: int) -> dict:
    """CUDA kernels that `calls` calls of fn launch: name -> (ms, count)
    per call (a trace that caught no kernel is taken once more)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    got = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got = {e.key[:70]: (e.self_device_time_total / 1e3 / calls,
                            e.count / calls)
               for e in prof.key_averages()
               if "CUDA" in str(e.device_type)
               and e.self_device_time_total > 0}
        if got:
            break
    return got


def product_rows(torch, cs, timer) -> dict:
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.cuda import w8a8 as cw8
    from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
    g = torch.Generator(device="cuda")
    g.manual_seed(2024)
    out = {}
    for label, k, n in SHAPES:
        qs = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                           device="cuda", generator=g)
        d = (torch.rand(k // 32, n, device="cuda", generator=g) * 0.01
             + 1e-3).to(torch.float16).view(torch.int16)
        wp = cs.random_wplanes(torch, g, DType.W8A8, k, n)
        for fmt, mod, fn_of, w in (
                ("q8_0", cm, lambda x: cm.quant_matmul_cuda(x, qs, d),
                 dequant_planes_torch({"qs": qs, "d": d}, DType.Q8_0, k, n,
                                      out_dtype=torch.bfloat16)),
                ("w8a8", cw8,
                 lambda x: cw8.w8a8_matmul_cuda(x, wp["q"], wp["s"]),
                 dequant_planes_torch(wp, DType.W8A8, k, n,
                                      out_dtype=torch.bfloat16))):
            for t in TOKENS:
                x = cs.skewed_x(torch, g, t, k)
                before = mod.launches
                fn_of(x)
                torch.cuda.synchronize()
                per_call = mod.launches - before
                ms = timer.compare({"call": lambda: fn_of(x),
                                    "library": lambda: torch.matmul(x, w)})
                ks = kernels_of(torch, lambda: fn_of(x), 10)
                out[f"{fmt} {label} T={t}"] = {
                    "call_ms": ms["call"], "library_ms": ms["library"],
                    "device_ms": sum(v[0] for v in ks.values()),
                    "kernels_per_call": sum(v[1] for v in ks.values()),
                    "launches_per_call": per_call,
                    "kernels": {kn: round(v[0], 5) for kn, v in ks.items()}}
                del x
            del w
        del qs, d, wp
        torch.cuda.empty_cache()
    return out


def chunk_profile(torch, cp, ids, off: int = 2048) -> dict:
    """One torch.profiler trace of CPEngine's prefill chunk [off, off +
    512) after the chunks before it: wall and device ms, and the matmul
    kernels' device ms and share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    c = cp.PREFILL_CHUNK
    kv = cp._make_kv()
    toks = np.asarray(ids, dtype=np.int64)
    for o in range(0, off, c):
        cp._prefill_chunk(kv, toks[o:o + c], o, c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cp._prefill_chunk(kv, toks[off:off + c], off, c)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = {e.key[:80]: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0}
    dev = sum(v[0] for v in kern.values())
    mm = sum(v[0] for kn, v in kern.items()
             if any(m in kn for m in MATMUL_MARKERS))
    del kv
    torch.cuda.empty_cache()
    return {"wall_ms": wall, "device_ms": dev, "matmul_device_ms": mm,
            "matmul_share_of_device": mm / dev if dev else None,
            "cuda_kernels": sum(v[1] for v in kern.values())}


def path_rows(torch, cs, fmt: str) -> dict:
    from ntransformer_tpu_torch.inference.engine import CPEngine, Engine
    from ntransformer_tpu_torch.models.batched import BatchedKV
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.cuda import w8a8 as cw8
    from ntransformer_tpu_torch.ops.layers import rope_table
    from ntransformer_tpu_torch.parallel.cp import make_cp_mesh
    cfg, arch, weights, per_token = cs.build_synth(torch, fmt)
    out = {}
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    engine = Engine(model)
    ids = torch.randint(0, arch.vocab_size, (512,),
                        generator=torch.Generator().manual_seed(9)).tolist()
    engine.benchmark(prompt_ids=ids, n_tokens=8)  # warm-up
    runs = [engine.benchmark(prompt_ids=ids, n_tokens=64) for _ in range(2)]
    out["engine_prefill_ms"] = [r.prefill_ms for r in runs]
    out["engine_decode_ms_per_token"] = [r.decode_ms / r.decode_tokens
                                         for r in runs]
    del engine
    counters = {cm.NAME: cm, cw8.NAME: cw8}
    b1 = cs.bench_b1(torch, counters, arch, weights, per_token)
    out["b1_ms_per_step"] = b1["ms_per_step"]
    out["b1_launches_per_step"] = {kn: v / 128 for kn, v in
                                   b1["launches"].items()}
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    bkv = BatchedKV.create(arch1k, 32, quant=True, device="cuda")
    tok = torch.arange(32, device="cuda") + 3
    tok = cs.batched_chain(torch, arch1k, weights, bkv, 32, 24, 512, tok)
    times = {"f32": [], "int8_v": []}
    for dot in ("f32", "int8_v", "int8_v", "f32"):
        t0 = time.perf_counter()
        tok = cs.batched_chain(torch, arch1k, weights, bkv, 32, 24, 512, tok,
                               dot)
        times[dot].append((time.perf_counter() - t0) / 24 * 1e3)
    out["b32_int8_step_ms"] = times
    for dot in ("f32", "int8_v"):
        prof = cs.profile_batched(torch, arch1k, weights, bkv, 32, 700,
                                  dot_impl=dot)
        out[f"b32_int8_{dot}_profile"] = {
            k: prof[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                 "kernels_per_step")}
        out[f"b32_int8_{dot}_profile"]["matmul_device_ms_per_step"] = sum(
            r["ms_per_step"] for r in prof["top"]
            if any(m in r["kernel"] for m in MATMUL_MARKERS))
    del bkv
    if fmt == "q8_0":
        arch_cp = dataclasses.replace(arch, max_seq_len=cs.CP_CTX)
        cos, sin = rope_table(cs.CP_CTX, arch.head_dim, arch.rope_theta,
                              device="cuda")
        w_cp = dataclasses.replace(weights, rope_cos=cos, rope_sin=sin)
        model = LoadedModel(cfg, arch_cp, w_cp, None, None,
                            torch.device("cuda"))
        ids = torch.randint(0, arch.vocab_size, (cs.CP_PROMPT,),
                            generator=torch.Generator().manual_seed(46)
                            ).tolist()
        cp = CPEngine(model, make_cp_mesh(cs.CP_SHARDS,
                                          ["cuda:0"] * cs.CP_SHARDS))
        for tag, eng in (("cp", cp), ("resident", Engine(model))):
            eng.benchmark(prompt_ids=ids[:600], n_tokens=2)  # warm-up
            runs = [eng.benchmark(prompt_ids=ids, n_tokens=4)
                    for _ in range(2)]
            out[f"{tag}_prefill_ms"] = [r.prefill_ms for r in runs]
            out[f"{tag}_prefill_tok_s"] = [r.prefill_tps for r in runs]
            del eng
            torch.cuda.empty_cache()
        out["cp_chunk_2048"] = chunk_profile(torch, cp, ids)
        del cp
    del weights, model
    torch.cuda.empty_cache()
    return out


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_root", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from ntransformer_tpu_torch.ops.cuda import build
    assert torch.cuda.is_available(), "this measurement needs a CUDA card"
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    names = ("q8_0_matmul", "w8a8_matmul", "flash_attention",
             "batched_attention", "kv_update")
    with ThreadPoolExecutor(len(names)) as ex:  # one compiler per source
        list(ex.map(build.build, names))
    out = {"root": root, "card": card(),
           "build_s": time.perf_counter() - t0}
    timer = cs.Timer(torch)
    out["products"] = product_rows(torch, cs, timer)
    del timer
    torch.cuda.empty_cache()
    out["paths"] = {fmt: path_rows(torch, cs, fmt)
                    for fmt in ("q8_0", "w8a8")}
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(card(), flush=True)
    runs = []
    for root in sys.argv[1:]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root], capture_output=True, text=True,
                           timeout=900)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if r.returncode or not lines:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
        runs.append(json.loads(lines[-1]))
    # the runs side by side, in the order measured: call ms (device ms,
    # kernels a call)
    for key in runs[0]["products"]:
        print(f"{key}: " + " | ".join(
            f"{r['products'][key]['call_ms']:.4f} "
            f"({r['products'][key]['device_ms']:.4f}, "
            f"{r['products'][key]['kernels_per_call']:g})" for r in runs)
            + f" | library {runs[0]['products'][key]['library_ms']:.4f}")
    for fmt in runs[0]["paths"]:
        for key in runs[0]["paths"][fmt]:
            print(f"{fmt} {key}: " + " | ".join(
                json.dumps(r["paths"][fmt][key]) for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
