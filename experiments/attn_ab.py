#!/usr/bin/env python3
"""The two attention kernels of the H100 port, one checkout against another,
on one card: csrc/flash_attention.cu (prefill flash attention and its
context-parallel partials entry) and csrc/batched_attention.cu (batched
flash decode with its cache-dot forms).

    python3 experiments/attn_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (this one, or an
older commit unpacked with `git archive` into a directory .gitignore lists);
each is measured in a process of its own that builds that checkout's
kernels from its own csrc/, in the order given, so `parent change change
parent` shows the spread between runs. For each ROOT it prints one JSON
line:

  flash: prefill flash attention at 8B widths (Hq 32, Hkv 8, D 128, bf16
     cache) at T = 512, pos 0, S 4,096 (the resident prefill's row), and
     the partials entry at the context-parallel shapes: a 9,216-key cache
     in 4 shards at pos 2,048 (shards 0 and 1) and a 32,768-key cache in 4
     shards at pos 20,000 (shards 0 and 2). Per shape: the wrapper's call
     time (CUDA events, L2 flushed before each call, chip_smoke.py's Timer),
     SDPA over the same keys beside it, and the profiler's device time and
     CUDA kernels per call;
  dots: batched flash at the B = 32 int8 decode step (S 1,024, positions
     512-600, slot 5 inactive) in every cache-dot form, and at an s_live of
     2,176 (17 key blocks of 128, B = 4) in the per-block forms, the same
     way, with the launch counter's launches per call;
  path: the synthetic 8B Q8_0 of chip_smoke.py's `build_synth` through
     CPEngine (4 shards on the one card, ctx 9,216, a 4,600-token prompt)
     and the resident Engine, Engine.benchmark's prefill each, and the
     B = 32 int8 batched step chained from mid-context under "f32" and
     "int8_v" in turns, with the batched flash kernels' device time a step.

It imports chip_smoke.py and the port from ROOT, so it runs against any
checkout whose chip_smoke.py has `build_synth`, `batched_chain`,
`profile_batched`, `Timer` and `CP_CTX`. The card's name and power limit
are printed first.
"""
from __future__ import annotations

import importlib.util
import json
import math
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
    per call (a trace that caught no kernel is taken once more)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
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


def timed(torch, timer, fn, library, marker: str) -> dict:
    ms = timer.compare({"call": fn, "library": library})
    ks = kernels_of(torch, fn, 10)
    return {"call_ms": ms["call"], "library_ms": ms["library"],
            "device_ms": sum(v[0] for v in ks.values()),
            "kernel_device_ms": sum(v[0] for k, v in ks.items()
                                    if marker in k),
            "kernels_per_call": sum(v[1] for v in ks.values())}


def flash_rows(torch, timer) -> dict:
    import torch.nn.functional as F
    from ntransformer_tpu_torch.ops.cuda import attention as ca
    g = torch.Generator(device="cuda")
    g.manual_seed(66)
    t, hq, hkv, d = 512, 32, 8, 128
    scale = 1.0 / math.sqrt(d)
    q = torch.randn(t, hq, d, device="cuda", generator=g)
    qb = q.to(torch.bfloat16).transpose(0, 1)[None]

    def cache(s):
        return tuple(torch.randn(hkv, s, d, device="cuda", generator=g)
                     .to(torch.bfloat16) for _ in range(2))

    def sdpa(kc, vc, pos, off):
        s = kc.shape[1]
        mask = ((off + torch.arange(s, device="cuda"))[None, :]
                <= (pos + torch.arange(t, device="cuda"))[:, None])
        kb = kc.repeat_interleave(hq // hkv, 0)[None]
        vb = vc.repeat_interleave(hq // hkv, 0)[None]
        return lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask, scale=scale)

    out = {}
    kc, vc = cache(4096)
    out["row2 T=512 pos=0 S=4096"] = timed(
        torch, timer, lambda: ca.flash_attention_cuda(q, kc, vc, 0, t, scale),
        sdpa(kc, vc, 0, 0), "flash_fwd_kernel")
    for s_all, pos, shards in ((9216, 2048, (0, 1)), (32768, 20000, (0, 2))):
        kc, vc = cache(s_all)
        sl = s_all // 4
        for i in shards:
            k_i = kc[:, i * sl:(i + 1) * sl].contiguous()
            v_i = vc[:, i * sl:(i + 1) * sl].contiguous()
            out[f"row2p S={s_all} pos={pos} shard {i}"] = timed(
                torch, timer, lambda: ca.flash_attention_partials(
                    q, k_i, v_i, pos, scale, kpos_offset=i * sl),
                sdpa(k_i, v_i, pos, i * sl), "flash_fwd_kernel")
        del kc, vc
    return out


def dot_rows(torch, timer) -> dict:
    import torch.nn.functional as F
    from ntransformer_tpu_torch.ops.cuda import batched_attention as cb
    g = torch.Generator(device="cuda")
    g.manual_seed(5150)
    hq, hkv, d = 32, 8, 128
    scale = 1.0 / math.sqrt(d)
    out = {}
    cases = [("B=32 int8 S=1024 pos 512-600", 32, 1024,
              [512 + (37 * i) % 89 for i in range(32)],
              [i != 5 for i in range(32)], None,
              ("f32", "int8", "int8_s", "int8_v", "bf16")),
             ("B=4 int8 S=4096 s_live=2176", 4, 4096, [2100, 1500, 2175, 2000],
              [True, False, True, True], 2176, ("int8", "int8_v", "bf16"))]
    for label, b_n, s, pos_l, act_l, s_live, forms in cases:
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        act = torch.tensor(act_l, device="cuda").to(torch.int32)
        shape = (2, b_n, hkv, s, d)
        kc, vc = (torch.randint(-127, 128, shape, dtype=torch.int8,
                                device="cuda", generator=g) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], device="cuda", generator=g) * 0.02
                  for _ in range(2))
        kn, vn = (torch.randint(-127, 128, (b_n, hkv, 1, d), dtype=torch.int8,
                                device="cuda", generator=g) for _ in range(2))
        kns, vns = (torch.rand(b_n, hkv, 1, device="cuda", generator=g)
                    * 0.02 for _ in range(2))
        q = torch.randn((b_n, 1, hq, d), device="cuda", generator=g)
        kf = (kc[1].float() * ks[1][..., None]).to(torch.bfloat16)
        vf = (vc[1].float() * vs[1][..., None]).to(torch.bfloat16)
        mask = (torch.arange(s, device="cuda")[None, None, None, :]
                <= pos.long()[:, None, None, None])
        qb = q.transpose(1, 2).to(torch.bfloat16)
        kb = kf.repeat_interleave(hq // hkv, 1)
        vb = vf.repeat_interleave(hq // hkv, 1)
        for dot in forms:
            def kern(dot=dot):
                return cb.flash_verify_batched(
                    q, (kc, ks), (vc, vs), (kn, kns), (vn, vns), pos, scale,
                    layer=1, active=act, s_live=s_live, dot_impl=dot)
            before = cb.launches
            kern()
            torch.cuda.synchronize()
            per_call = cb.launches - before
            row = timed(torch, timer, kern, lambda: F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=mask, scale=scale),
                "split_kernel" if dot in ("f32", "int8_s") else "group_kernel")
            row["launches_per_call"] = per_call
            out[f"{label} {dot}"] = row
        del kc, vc, kf, vf, kb, vb
    return out


def path_rows(torch, cs) -> dict:
    import dataclasses
    from ntransformer_tpu_torch.inference.engine import CPEngine, Engine
    from ntransformer_tpu_torch.models.batched import BatchedKV
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.ops.layers import rope_table
    from ntransformer_tpu_torch.parallel.cp import make_cp_mesh
    cfg, arch, weights, _ = cs.build_synth(torch)
    out = {}
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
                                 "kernels_per_step",
                                 "batched_flash_device_ms_per_step")}
    del bkv
    arch_cp = dataclasses.replace(arch, max_seq_len=cs.CP_CTX)
    cos, sin = rope_table(cs.CP_CTX, arch.head_dim, arch.rope_theta,
                          device="cuda")
    w_cp = dataclasses.replace(weights, rope_cos=cos, rope_sin=sin)
    model = LoadedModel(cfg, arch_cp, w_cp, None, None, torch.device("cuda"))
    ids = torch.randint(0, arch.vocab_size, (cs.CP_PROMPT,),
                        generator=torch.Generator().manual_seed(46)).tolist()
    for tag, eng in (("cp", CPEngine(model, make_cp_mesh(
            cs.CP_SHARDS, ["cuda:0"] * cs.CP_SHARDS))), ("resident",
                                                          Engine(model))):
        eng.benchmark(prompt_ids=ids[:600], n_tokens=2)  # warm-up
        runs = [eng.benchmark(prompt_ids=ids, n_tokens=4) for _ in range(2)]
        out[f"{tag}_prefill_ms"] = [r.prefill_ms for r in runs]
        out[f"{tag}_prefill_tok_s"] = [r.prefill_tps for r in runs]
        del eng
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
    for name in ("flash_attention", "batched_attention", "q8_0_matmul",
                 "kv_update"):
        build.build(name)
    out = {"root": root, "card": card(),
           "build_s": time.perf_counter() - t0}
    timer = cs.Timer(torch)
    out["flash"] = flash_rows(torch, timer)
    out["dots"] = dot_rows(torch, timer)
    out["path"] = path_rows(torch, cs)
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
    # the runs side by side, in the order measured: call ms (device ms)
    for sec in ("flash", "dots"):
        for key in runs[0][sec]:
            print(f"{sec} {key}: " + " | ".join(
                f"{r[sec][key]['call_ms']:.4f} ({r[sec][key]['device_ms']:.4f})"
                for r in runs) + f" | library {runs[0][sec][key]['library_ms']:.4f}")
    for key in runs[0]["path"]:
        print(f"path {key}: " + " | ".join(
            json.dumps(r["path"][key]) for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
