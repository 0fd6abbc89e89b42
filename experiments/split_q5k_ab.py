#!/usr/bin/env python3
"""Batched flash's split kernel (the "f32" and "int8_s" cache-dot forms of
csrc/batched_attention.cu) and the Q5_K matmul (ops/cuda/nibble_matmul.py)
of the H100 port, and the paths they carry, one checkout against another,
on one card.

    python3 experiments/split_q5k_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (this one, or an
older commit unpacked with `git archive` into a directory .gitignore lists,
e.g. scratch_chip/parent); each is measured in a process of its own that
builds that checkout's kernels from its own csrc/, in the order given, so
`parent change change parent` shows the spread between runs. For each ROOT
it prints one JSON line:

  flash: batched flash under "f32" and "int8_s" at the 8B widths (Hq 32,
     Hkv 8, D 128) at the B = 32 int8 decode step (S 1,024, positions
     512-600, slot 5 inactive), and under "f32" at B = 1 bf16 (S 4,096),
     a T = 4 verify at B = 8 bf16 (S 4,096) and a T = 8 verify at B = 4
     int8 (S 1,024, 32 query rows): the wrapper's call time (CUDA events, L2
     flushed before each call, chip_smoke.py's Timer), SDPA over the
     dequantized cache beside it, the profiler's device time of the call
     and of the split kernel alone, CUDA kernels and counted launches a
     call;
  q5k: the Q5_K product at the 8B fused gate|up and down at T = 1, 32 and
     512, the same way, torch.matmul on the pre-dequantized bf16 weight
     beside it;
  paths: the synthetic 8B Q4_K_M of chip_smoke.py's `build_synth`, its
     B = 32 int8 batched step chained from mid-context under "f32" and
     "int8_s" in turns (wall) and profiled (device time, kernels and the
     split kernel's device time a step); then a synthetic 8B all-Q5_K
     through Engine.benchmark (512-token prefill, 64 decoded tokens; a
     warm-up run, then two) and bench.py's B = 1 batched step (`bench_b1`,
     with its launches a step), profiled.

It imports chip_smoke.py and the port from ROOT, so it runs against any
checkout whose chip_smoke.py has `build_synth`, `bench_b1`,
`batched_chain`, `profile_batched`, `profile_calls`, `random_planes`,
`skewed_x` and `Timer`. The card's name and power limit are printed first.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# the kernel sources the measured paths build (those ROOT has)
SOURCES = ("batched_attention", "kquant_matmul", "nibble_matmul",
           "flash_attention", "kv_update")
Q5K_SHAPES = (("gate|up", 4096, 28672), ("down", 14336, 4096))
TOKENS = (1, 32, 512)
# label, B, S, T, int8 cache, positions, active, forms
FLASH_CASES = (
    ("B=32 int8 S=1024 pos 512-600, slot 5 inactive", 32, 1024, 1, True,
     [512 + (37 * i) % 89 for i in range(32)], [i != 5 for i in range(32)],
     ("f32", "int8_s")),
    ("B=1 bf16 S=4096 pos=4000", 1, 4096, 1, False, [4000], [True],
     ("f32",)),
    ("B=8 bf16 verify T=4 S=4096", 8, 4096, 4, False,
     [3, 64, 500, 1023, 2000, 2999, 3500, 4000], [i != 2 for i in range(8)],
     ("f32",)),
    ("B=4 int8 verify T=8 S=1024", 4, 1024, 8, True, [300, 512, 900, 1000],
     [True, True, False, True], ("f32",)),
)


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    return smi.stdout.strip().splitlines()[0]


def kernels_of(torch, cs, fn) -> dict:
    """CUDA kernels a call of fn launches: name -> (device ms, count) per
    call, through chip_smoke.py's `profile_calls` (it retakes traces that
    lost records)."""
    prof = cs.profile_calls(torch, fn)
    return {k: (v["ms"], v["per_call"]) for k, v in prof.items()}


def flash_rows(torch, cs, timer) -> dict:
    import torch.nn.functional as F
    from ntransformer_tpu_torch.ops.cuda import batched_attention as cb
    g = torch.Generator(device="cuda")
    g.manual_seed(1111)
    hq, hkv, dh = 32, 8, 128
    scale = 1.0 / math.sqrt(dh)
    out = {}
    for label, b_n, s, t, int8, pos_l, act_l, forms in FLASH_CASES:
        shape = (2, b_n, hkv, s, dh)
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        act = torch.tensor(act_l, device="cuda").to(torch.int32)
        if int8:
            kc, vc = (torch.randint(-127, 128, shape, dtype=torch.int8,
                                    device="cuda", generator=g)
                      for _ in range(2))
            ks, vs = (torch.rand(shape[:-1], device="cuda", generator=g)
                      * 0.02 for _ in range(2))
            kn, vn = (torch.randint(-127, 128, (b_n, hkv, t, dh),
                                    dtype=torch.int8, device="cuda",
                                    generator=g) for _ in range(2))
            kns, vns = (torch.rand(b_n, hkv, t, device="cuda", generator=g)
                        * 0.02 for _ in range(2))
            kcache, vcache, knew, vnew = (kc, ks), (vc, vs), (kn, kns), \
                (vn, vns)
            kf = (kc[1].float() * ks[1][..., None]).to(torch.bfloat16)
            vf = (vc[1].float() * vs[1][..., None]).to(torch.bfloat16)
        else:
            kc, vc = (torch.randn(shape, device="cuda", generator=g).to(
                torch.bfloat16) for _ in range(2))
            kn, vn = (torch.randn(b_n, hkv, t, dh, device="cuda",
                                  generator=g) for _ in range(2))
            kcache, vcache, knew, vnew = kc, vc, kn, vn
            kf, vf = kc[1].clone(), vc[1].clone()
        q = torch.randn((b_n, t, hq, dh), device="cuda", generator=g)
        kpos = torch.arange(s, device="cuda")
        qpos = pos.long()[:, None] + torch.arange(t, device="cuda")
        mask = kpos[None, None, :] <= qpos[:, :, None]
        qb = q.transpose(1, 2).to(torch.bfloat16)
        kb = kf.repeat_interleave(hq // hkv, 1)
        vb = vf.repeat_interleave(hq // hkv, 1)
        for dot in forms:
            def call():
                return cb.flash_verify_batched(q, kcache, vcache, knew, vnew,
                                               pos, scale, layer=1,
                                               active=act, dot_impl=dot)
            before = cb.launches_by_dot[dot]
            call()
            torch.cuda.synchronize()
            per_call = cb.launches_by_dot[dot] - before
            ms = timer.compare({
                "call": call,
                "library": lambda: F.scaled_dot_product_attention(
                    qb, kb, vb, attn_mask=mask[:, None], scale=scale)})
            ks_ = kernels_of(torch, cs, call)
            out[f"{dot} {label}"] = {
                "call_ms": ms["call"], "library_ms": ms["library"],
                "device_ms": sum(v[0] for v in ks_.values()),
                "split_kernel_device_ms": sum(
                    v[0] for k, v in ks_.items() if "split_kernel" in k),
                "kernels_per_call": sum(v[1] for v in ks_.values()),
                "launches_per_call": per_call,
                "kernels": {k: round(v[0], 5) for k, v in ks_.items()}}
        del kc, vc, kf, vf, kb, vb
        torch.cuda.empty_cache()
    return out


def q5k_rows(torch, cs, timer) -> dict:
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
    g = torch.Generator(device="cuda")
    g.manual_seed(2026)
    dtype = DType.Q5_K
    kern = nm.KERNELS[dtype]
    out = {}
    for label, k, n in Q5K_SHAPES:
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
            ks_ = kernels_of(torch, cs,
                             lambda: nm.nibble_matmul_cuda(x, planes, dtype))
            out[f"q5_k {label} T={t}"] = {
                "call_ms": ms["call"], "library_ms": ms["library"],
                "device_ms": sum(v[0] for v in ks_.values()),
                "kernels_per_call": sum(v[1] for v in ks_.values()),
                "launches_per_call": per_call,
                "kernels": {kn: round(v[0], 5) for kn, v in ks_.items()}}
            del x
        del planes, w
        torch.cuda.empty_cache()
    return out


def _profile_summary(prof: dict) -> dict:
    out = {k: prof[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                "kernels_per_step",
                                "batched_flash_device_ms_per_step")}
    out["split_kernel_device_ms_per_step"] = sum(
        r["ms_per_step"] for r in prof["top"] if "split_kernel" in r["kernel"])
    return out


def path_rows(torch, cs) -> dict:
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models.batched import BatchedKV
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    out = {}
    # the 8B Q4_K_M B = 32 int8 step
    cfg, arch, weights, per_token = cs.build_synth(torch, "q4_k_m")
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    bkv = BatchedKV.create(arch1k, 32, quant=True, device="cuda")
    tok = torch.arange(32, device="cuda") + 3
    tok = cs.batched_chain(torch, arch1k, weights, bkv, 32, 24, 512, tok)
    times = {"f32": [], "int8_s": []}
    for dot in ("f32", "int8_s", "int8_s", "f32"):
        t0 = time.perf_counter()
        tok = cs.batched_chain(torch, arch1k, weights, bkv, 32, 24, 512, tok,
                               dot)
        times[dot].append((time.perf_counter() - t0) / 24 * 1e3)
    out["q4_k_m_b32_int8_step_ms"] = times
    for dot in ("f32", "int8_s"):
        prof = cs.profile_batched(torch, arch1k, weights, bkv, 32, 700,
                                  dot_impl=dot)
        out[f"q4_k_m_b32_int8_{dot}_profile"] = _profile_summary(prof)
    del bkv, weights
    torch.cuda.empty_cache()
    # the 8B all-Q5_K: Engine.benchmark and the B = 1 step
    cfg, arch, weights, per_token = cs.build_synth(torch, "q5_k")
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    engine = Engine(model)
    ids = torch.randint(0, arch.vocab_size, (512,),
                        generator=torch.Generator().manual_seed(9)).tolist()
    engine.benchmark(prompt_ids=ids, n_tokens=8)  # warm-up
    runs = [engine.benchmark(prompt_ids=ids, n_tokens=64) for _ in range(2)]
    out["q5_k_engine_prefill_ms"] = [r.prefill_ms for r in runs]
    out["q5_k_engine_decode_ms_per_token"] = [r.decode_ms / r.decode_tokens
                                              for r in runs]
    del engine
    counters = {k.name: k for k in nm.KERNELS.values()}
    b1 = cs.bench_b1(torch, counters, arch, weights, per_token)
    out["q5_k_b1_ms_per_step"] = b1["ms_per_step"]
    out["q5_k_b1_launches_per_step"] = {kn: v / 128 for kn, v in
                                        b1["launches"].items() if v}
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    bkv = BatchedKV.create(arch1k, 1, device="cuda")
    prof = cs.profile_batched(torch, arch1k, weights, bkv, 1, 300)
    out["q5_k_b1_profile"] = {
        **_profile_summary(prof),
        "q5_k_device_ms_per_step": sum(
            r["ms_per_step"] for r in prof["top"]
            if any(m in r["kernel"] for m in ("skinny_kernel", "nib_gemv",
                                              "splitk_reduce")))}
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
    out["flash"] = flash_rows(torch, cs, timer)
    out["q5k"] = q5k_rows(torch, cs, timer)
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
    for part in ("flash", "q5k"):
        for key in runs[0][part]:
            print(f"{key}: " + " | ".join(
                f"{r[part][key]['call_ms']:.4f} "
                f"({r[part][key]['device_ms']:.4f}, "
                f"{r[part][key]['kernels_per_call']:g})" for r in runs)
                + f" | library {runs[0][part][key]['library_ms']:.4f}")
    for key in runs[0]["paths"]:
        print(f"{key}: " + " | ".join(
            json.dumps(r["paths"][key]) for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
