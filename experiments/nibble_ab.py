#!/usr/bin/env python3
"""The Q4_K and Q6_K matmul kernels of the H100 port (the Q4_K_M pair,
reached through ops/cuda/nibble_matmul.py) and the paths they carry, one
checkout against another, on one card.

    python3 experiments/nibble_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (this one, or an
older commit unpacked with `git archive` into a directory .gitignore lists,
e.g. scratch_chip/parent); each is measured in a process of its own that
builds that checkout's kernels from its own csrc/, in the order given, so
`parent change change parent` shows the spread between runs. For each ROOT
it prints one JSON line:

  products: Q4_K at the 8B fused qkv, wo and fused gate|up, Q6_K at the 8B
     down and the 128256-token head, at T = 1, 8, 32 and 512: the wrapper's
     call time (CUDA events, L2 flushed before each call, chip_smoke.py's
     Timer), torch.matmul on the pre-dequantized bf16 weight beside it, the
     profiler's device time and CUDA kernels per call, and the launch
     counter's launches per call;
  paths: the synthetic 8B Q4_K_M of chip_smoke.py's `build_synth` through
     Engine.benchmark (512-token prefill, 64 decoded tokens; a warm-up run,
     then two), bench.py's B = 1 batched step (`bench_b1`, with its launches
     a step) and the B = 32 int8 step chained from mid-context under "f32"
     and "int8_v" in turns, each with its profile (device ms, kernels and
     the matmul kernels' device ms a step).

It imports chip_smoke.py and the port from ROOT, so it runs against any
checkout whose chip_smoke.py has `build_synth`, `bench_b1`,
`batched_chain`, `profile_batched`, `random_planes`, `skewed_x` and
`Timer`. The card's name and power limit are printed first.
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

SHAPES = (("q4_k", "qkv", 4096, 6144), ("q4_k", "wo", 4096, 4096),
          ("q4_k", "gate|up", 4096, 28672), ("q6_k", "down", 14336, 4096),
          ("q6_k", "head", 4096, 128256))
TOKENS = (1, 8, 32, 512)
# CUDA kernels of the nibble products, old and new names
MATMUL_MARKERS = ("nib_gemv", "nib_mma", "splitk_reduce", "skinny_kernel",
                  "tile_kernel", "q8_", "w8_", "quant_kernel")
# the kernel sources the paths build (the K-quant one where ROOT has it)
SOURCES = ("nibble_matmul", "kquant_matmul", "flash_attention",
           "batched_attention", "kv_update")


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    return smi.stdout.strip().splitlines()[0]


def kernels_of(torch, cs, fn) -> dict:
    """CUDA kernels a call of fn launches: name -> (device ms, count) per
    call, through chip_smoke.py's `profile_calls` where ROOT has it (it
    retakes traces that lost records)."""
    prof = cs.profile_calls(torch, fn)
    return {k: (v["ms"], v["per_call"]) for k, v in prof.items()}


def product_rows(torch, cs, timer) -> dict:
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
    g = torch.Generator(device="cuda")
    g.manual_seed(2025)
    out = {}
    for fmt, label, k, n in SHAPES:
        dtype = DType(fmt)
        kern = nm.KERNELS[dtype]
        planes = cs.random_planes(torch, g, dtype, k, n)
        w = dequant_planes_torch(planes, dtype, k, n,
                                 out_dtype=torch.bfloat16)
        for t in TOKENS:
            x = cs.skewed_x(torch, g, t, k)
            before = kern.launches
            nm.nibble_matmul_cuda(x, planes, dtype)
            torch.cuda.synchronize()
            per_call = kern.launches - before
            ms = timer.compare({
                "call": lambda: nm.nibble_matmul_cuda(x, planes, dtype),
                "library": lambda: torch.matmul(x, w)})
            ks = kernels_of(torch, cs,
                            lambda: nm.nibble_matmul_cuda(x, planes, dtype))
            out[f"{fmt} {label} T={t}"] = {
                "call_ms": ms["call"], "library_ms": ms["library"],
                "device_ms": sum(v[0] for v in ks.values()),
                "kernels_per_call": sum(v[1] for v in ks.values()),
                "launches_per_call": per_call,
                "kernels": {kn: round(v[0], 5) for kn, v in ks.items()}}
            del x
        del planes, w
        torch.cuda.empty_cache()
    return out


def path_rows(torch, cs) -> dict:
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models.batched import BatchedKV
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    cfg, arch, weights, per_token = cs.build_synth(torch, "q4_k_m")
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
    counters = {k.name: k for k in nm.KERNELS.values()}
    b1 = cs.bench_b1(torch, counters, arch, weights, per_token)
    out["b1_ms_per_step"] = b1["ms_per_step"]
    out["b1_launches_per_step"] = {kn: v / 128 for kn, v in
                                   b1["launches"].items() if v}
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
    del bkv, weights, model
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
    names = [s for s in SOURCES
             if os.path.exists(os.path.join(build.CSRC_DIR, s + ".cu"))]
    with ThreadPoolExecutor(len(names)) as ex:  # one compiler per source
        list(ex.map(build.build, names))
    out = {"root": root, "card": card(),
           "build_s": time.perf_counter() - t0}
    timer = cs.Timer(torch)
    out["products"] = product_rows(torch, cs, timer)
    del timer
    torch.cuda.empty_cache()
    out["paths"] = path_rows(torch, cs)
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
    for key in runs[0]["paths"]:
        print(f"q4_k_m {key}: " + " | ".join(
            json.dumps(r["paths"][key]) for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
