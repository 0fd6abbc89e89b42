#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (ntransformer_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

  1. set-up: the card's name and power limit, TF32 off, both kernels built
     from csrc/ with nvcc (in parallel) and nvcc's register report printed;
  2. kernels: each kernel against its plain PyTorch twin on the card at the
     main path's full-width shapes (Llama-3.1-8B and repolm512), with times
     (CUDA events, L2 flushed before every launch, runs in turns), the
     least time the card could take, and one PyTorch library call as a
     yardstick;
  3. real model: models/repolm512_q8.gguf through the CLI on the card,
     Engine greedy generation on the card against the CPU, teacher-forced
     on the CPU's tokens with every step's logits compared, and each layer
     of the kernel path against the card's plain path on the same input;
  4. full width: a synthetic Llama-3.1-8B Q8_0 (random int8 codes from a
     seeded generator) through Engine.benchmark — the main path, with the
     kernel launch counts read around it — then a 2-layer view of the same
     weights with the kernels on and off, prefill logits compared.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
MATMUL_RTOL = 1e-3             # max|kernel-plain| <= 1e-3 * max|plain|
# flash, for every query row: max|kernel-plain| <= 1e-2 * max|plain| over
# the row's heads and lanes. The kernel rounds p to bf16 before PV (as the
# TPU kernel does) where the twin keeps f32 probabilities: 2^-9 of each
# term, so at most ~2e-3 of a row's largest output however many keys it
# sees. A row scale keeps the limit tight at long context, where outputs
# are ~0.03 and a dropped or mis-masked KV tile moves them by ~1e-2.
FLASH_RTOL = 1e-2
# repolm512 on the card, kernel path against the card's plain path, one
# layer at a time, each layer fed the plain path's input and cache: the
# prefill's flash kernel rounds p to bf16 (~2e-3 of an attention output;
# 1.2e-3 of a layer output measured); a decode step differs only in f32
# summation order (1.6e-7 measured), and a bf16 flip that such an order
# change can cause moves a layer output by ~1e-4
LAYER_RTOL = {"prefill": 5e-3, "decode": 1e-4}
# repolm512 end to end, teacher-forced on the CPU's tokens: every step's
# max|dlogit| / max|logit| of the kernel path against the CPU is at most
# max(REAL_LOGIT_RTOL, 2 * r), r the card's plain path against the CPU at
# that step. A step where r is large is one where the model amplifies
# roundings: at step 4 layer 4 turns a 1e-3 difference in its input into
# 2e-2 for every pair of paths (card plain vs CPU included); the kernel
# path's own roundings may move it by as much again
# (experiments/real_logit_steps.py).
REAL_LOGIT_RTOL = 1e-2
# 8B 2-layer prefill logits, kernels on vs off on the card: the flash
# kernel rounds p to bf16 where the plain path keeps f32 probabilities (the
# JAX package's own kernel-vs-CPU spread on repolm512's prefill is 1.2e-2,
# experiments/logit_spread.py)
FULL_LOGIT_RTOL = 2e-2
PROMPT = ("def rms_norm(x, weight, eps):\n"
          "    xf = x.astype(jnp.float32)\n"
          "    var = jnp.mean(xf * xf, axis=-1, keepdims=True)\n"
          "    return ")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


# ------------------------------------------------------------------ timing
class Timer:
    """Per-launch CUDA-event times with the L2 cache flushed before each
    launch (the main path reads every weight once per token)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8,
                                     device="cuda")

    def once(self, fn, iters: int) -> list[float]:
        torch = self.torch
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in pairs]

    def compare(self, fns: dict, iters: int = 5, rounds: int = 3) -> dict:
        """Median ms of each fn, timed in turns (a, b, c, a, b, c, ...)
        after one warm-up call each."""
        for fn in fns.values():
            fn()
        self.torch.cuda.synchronize()
        got = {k: [] for k in fns}
        for _ in range(rounds):
            for k, fn in fns.items():
                got[k] += self.once(fn, iters)
        return {k: sorted(v)[len(v) // 2] for k, v in got.items()}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------- phase 2
def kernel_phase(torch, timer, card: str) -> tuple[dict, dict]:
    from ntransformer_tpu_torch.ops.cuda import attention as ca
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
    from ntransformer_tpu_torch.core.dtypes import DType
    import torch.nn.functional as F

    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    mm_cases = []
    shapes = [("8b qkv", 4096, 6144), ("8b wo", 4096, 4096),
              ("8b gate|up", 4096, 28672), ("8b head", 4096, 128256),
              ("8b down", 14336, 4096)]
    for label, k, n in shapes:
        qs = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                           generator=g)
        scales = (torch.rand(k // 32, n, device="cuda", generator=g) * 0.01
                  + 1e-3)
        d = scales.to(torch.float16).view(torch.int16)
        w_bf16 = dequant_planes_torch({"qs": qs, "d": d}, DType.Q8_0, k, n,
                                      out_dtype=torch.bfloat16)
        for t in (1, 70, 512):
            mm_cases.append((f"{label} T={t}", t, qs, d, w_bf16))
    # a stacked [L, K, N] plane read through its free layer view
    qs2 = torch.randint(-127, 128, (2, 4096, 4096), dtype=torch.int8,
                        device="cuda", generator=g)
    d2 = (torch.rand(2, 128, 4096, device="cuda", generator=g) * 0.01
          + 1e-3).to(torch.float16).view(torch.int16)
    w2 = dequant_planes_torch({"qs": qs2[1], "d": d2[1]}, DType.Q8_0, 4096,
                              4096, out_dtype=torch.bfloat16)
    for t in (1, 70):
        mm_cases.append((f"8b stacked[1] 4096x4096 T={t}", t, qs2[1], d2[1],
                         w2))
    # repolm512's tied head: N = 384, not a multiple of 128
    qs3 = torch.randint(-127, 128, (512, 384), dtype=torch.int8,
                        device="cuda", generator=g)
    d3 = (torch.rand(16, 384, device="cuda", generator=g) * 0.01
          + 1e-3).to(torch.float16).view(torch.int16)
    w3 = dequant_planes_torch({"qs": qs3, "d": d3}, DType.Q8_0, 512, 384,
                              out_dtype=torch.bfloat16)
    for t in (1, 70):
        mm_cases.append((f"repolm512 head 512x384 T={t}", t, qs3, d3, w3))
    # N = 200, not a multiple of 16: the kernels' scalar (ragged) loads
    qs4, d4 = qs3[:, :200].contiguous(), d3[:, :200].contiguous()
    w4 = w3[:, :200].contiguous()
    for t in (1, 70):
        mm_cases.append((f"ragged 512x200 T={t}", t, qs4, d4, w4))

    mm_rows = []
    for label, t, qs, d, w in mm_cases:
        k, n = qs.shape
        x = torch.randn(t, k, device="cuda", generator=g).to(torch.bfloat16)
        y = cm.quant_matmul_cuda(x, qs, d)
        y0 = cm.quant_matmul_plain(x, qs, d)
        torch.cuda.synchronize()
        err = float((y - y0).abs().max())
        tol = MATMUL_RTOL * float(y0.abs().max())
        check(bool(torch.isfinite(y).all()), f"matmul {label}: non-finite")
        check(err <= tol, f"matmul {label}: max|kernel-plain| {err} > {tol}")
        ms = timer.compare({"kernel": lambda: cm.quant_matmul_cuda(x, qs, d),
                            "plain": lambda: cm.quant_matmul_plain(x, qs, d),
                            "library": lambda: torch.matmul(x, w)})
        b_ms, b_by = bound(k * n + (k // 32) * n * 2 + t * k * 2 + t * n * 4,
                           2.0 * t * k * n)
        row = {"shape": label, "T": t, "K": k, "N": n, "max_abs_err": err,
               "tol": tol, "ms": ms["kernel"], "plain_ms": ms["plain"],
               "library_ms": ms["library"], "bound_ms": b_ms,
               "bound_by": b_by}
        mm_rows.append(row)
        print(json.dumps({"matmul": row}), flush=True)

    fa_cases = []
    for t, p in ((64, 0), (64, 512), (64, 3584), (128, 0), (128, 512),
                 (128, 3584), (512, 0), (512, 512), (512, 3584)):
        fa_cases.append((f"8b T={t} pos={p}", t, 32, 8, 4096, 128, p,
                         torch.bfloat16, None, 0.0))
    fa_cases += [
        ("8b T=70 pos=100", 70, 32, 8, 4096, 128, 100, torch.bfloat16, None,
         0.0),
        ("8b f32-cache T=128 pos=512", 128, 32, 8, 4096, 128, 512,
         torch.float32, None, 0.0),
        ("8b T=128 pos=512 window=256 softcap=50", 128, 32, 8, 4096, 128, 512,
         torch.bfloat16, 256, 50.0),
        ("repolm512 T=128 pos=0", 128, 8, 4, 512, 64, 0, torch.bfloat16, None,
         0.0)]
    fa_rows = []
    for label, t, hq, hkv, s, dh, p, dt, win, cap in fa_cases:
        q = torch.randn(t, hq, dh, device="cuda", generator=g)
        kc = torch.randn(hkv, s, dh, device="cuda", generator=g).to(dt)
        vc = torch.randn(hkv, s, dh, device="cuda", generator=g).to(dt)
        scale = 1.0 / math.sqrt(dh)
        kw = {"window": win, "softcap": cap}
        o = ca.flash_attention_cuda(q, kc, vc, p, t, scale, **kw)
        # an f32 cache: the kernel rounds its operands to bf16 (the TPU
        # kernel's default-precision dots), so the twin gets them rounded
        rq, rk, rv = ((x.to(torch.bfloat16).to(dt) for x in (q, kc, vc))
                      if dt == torch.float32 else (q, kc, vc))
        o0 = ca.flash_attention_plain(rq, rk, rv, p, t, scale, **kw)
        torch.cuda.synchronize()
        err = float((o - o0).abs().max())
        row_rel = float(((o - o0).abs().amax(dim=(1, 2))
                         / o0.abs().amax(dim=(1, 2))).max())
        check(bool(torch.isfinite(o).all()), f"flash {label}: non-finite")
        check(row_rel <= FLASH_RTOL,
              f"flash {label}: a query row's max|kernel-plain| is {row_rel} "
              f"of its max|plain| (> {FLASH_RTOL}; max abs err {err})")
        # yardstick: SDPA with the same mask, heads expanded to Hq (SDPA
        # has no softcap, so a soft-capped case has none)
        qb = q.to(dt).transpose(0, 1)[None]
        kb = kc.repeat_interleave(hq // hkv, 0)[None]
        vb = vc.repeat_interleave(hq // hkv, 0)[None]
        kpos = torch.arange(s, device="cuda")[None, :]
        qpos = p + torch.arange(t, device="cuda")[:, None]
        mask = (kpos <= qpos) & (kpos > qpos - (win or s + t))
        fns = {"kernel": lambda: ca.flash_attention_cuda(q, kc, vc, p, t,
                                                         scale, **kw),
               "plain": lambda: ca.flash_attention_plain(q, kc, vc, p, t,
                                                         scale, **kw)}
        if not cap:
            fns["library"] = lambda: F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=mask, scale=scale)
        ms = timer.compare(fns)
        esz = kc.element_size()
        w_eff = win or s + t
        keys = min(s, p + t) - max(0, p + 1 - w_eff)
        visible = sum(min(p + i + 1, w_eff) for i in range(t))
        b_ms, b_by = bound(t * hq * dh * esz + 2 * keys * hkv * dh * esz
                           + t * hq * dh * 4, 4.0 * hq * dh * visible)
        row = {"shape": label, "T": t, "pos": p, "Hq": hq, "Hkv": hkv,
               "S": s, "D": dh, "max_abs_err": err, "row_rel_err": row_rel,
               "tol": FLASH_RTOL,
               "window": win, "softcap": cap,
               "ms": ms["kernel"], "plain_ms": ms["plain"],
               "library_ms": ms.get("library"), "bound_ms": b_ms,
               "bound_by": b_by}
        fa_rows.append(row)
        print(json.dumps({"flash": row}), flush=True)
        del q, kc, vc, qb, kb, vb
    print(f"kernel phase done on {card}", flush=True)
    return ({"rows": mm_rows, "main": "8b gate|up T=1"},
            {"rows": fa_rows, "main": "8b T=512 pos=0"})


# ---------------------------------------------------------------- phase 3
def greedy_pass(engine, torch, ids, n: int, forced=None):
    """Prefill `ids`, then n greedy steps (or steps fed with `forced`).
    Returns (tokens, [logits of each step as f32 CPU tensors])."""
    from ntransformer_tpu_torch.models.llama import KVCache
    kv = KVCache.create(engine.arch, device=engine.device)
    logits, kv, _ = engine._prefill(kv, ids)
    toks, out = [], [logits[0].float().cpu()]
    pos = len(ids)
    for i in range(n):
        tok = int(torch.argmax(out[-1])) if forced is None else forced[i]
        toks.append(tok)
        logits, kv, _ = engine._decode_step(kv, tok, pos + i)
        out.append(logits[0].float().cpu())
    return toks, out


def layer_by_layer(torch, engine, ids) -> dict:
    """Each layer of the kernel path against the plain path on the card,
    both fed the plain path's input and cache: the bucketed prefill of
    `ids`, then one decode step. Returns the worst max|d| / max|plain| of a
    layer's output rows, per phase."""
    from ntransformer_tpu_torch.inference.engine import _bucket
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.ops import linear
    arch, w = engine.arch, engine.model.weights
    n = len(ids)
    padded = torch.zeros(_bucket(n), dtype=torch.long)
    padded[:n] = torch.tensor(ids)
    kv = llama.KVCache.create(arch, device="cuda")
    worst = {}
    with torch.inference_mode():
        for phase, toks, pos, n_valid in (("prefill", padded, 0, n),
                                          ("decode", None, n, None)):
            if toks is None:
                toks = torch.argmax(logits[0]).reshape(1).cpu()
            x, cos_t, sin_t = llama.embed_positions(arch, w, toks.cuda(), pos)
            rows = x.shape[0] if n_valid is None else n_valid
            worst[phase] = 0.0
            for li in range(arch.n_layers):
                kk, vv = kv.k[li].clone(), kv.v[li].clone()
                y = llama.layer_step(arch, x, w.layers, kk, vv, pos, cos_t,
                                     sin_t, n_valid, layer=li)
                linear.KERNEL_MODE = "off"
                try:
                    y0 = llama.layer_step(arch, x, w.layers, kv.k[li],
                                          kv.v[li], pos, cos_t, sin_t,
                                          n_valid, layer=li)
                finally:
                    linear.KERNEL_MODE = "auto"
                r = float((y - y0)[:rows].abs().max() / y0[:rows].abs().max())
                worst[phase] = max(worst[phase], r)
                x = y0
            logits = llama.head_logits(arch, w, x, n_valid)
    return worst


def real_model_phase(torch, counters, card: str):
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.inference.engine import Engine, GenerateConfig
    gguf = os.path.join(HERE, "models", "repolm512_q8.gguf")
    reset(counters)
    rc = cli.main(["-m", gguf, "-p", PROMPT, "-n", "32", "-t", "0",
                   "--repeat-penalty", "1.0", "--device", "cuda"])
    torch.cuda.synchronize()
    got = read(counters)
    print(f"cli launches {got}", flush=True)
    check(rc == 0, f"cli exit code {rc}")
    check(all(v > 0 for v in got.values()),
          f"CLI run on the card launched a kernel zero times: {got}")

    gpu = Engine.load(gguf, device="cuda", fuse=True)
    cpu = Engine.load(gguf, device="cpu", fuse=True)
    ids = gpu._encode(PROMPT)
    check(len(ids) >= 70, f"prompt is {len(ids)} tokens; want >= 70")
    cfg = GenerateConfig(max_tokens=32, temperature=0.0, repeat_penalty=1.0)
    text_gpu, st_gpu = gpu.generate(PROMPT, cfg)
    text_cpu, _ = cpu.generate(PROMPT, cfg)
    print(f"repolm512 gpu: {text_gpu!r}", flush=True)
    print(f"repolm512 cpu: {text_cpu!r}", flush=True)
    print(f"repolm512 gpu generate on {card}: {st_gpu.report()!r}",
          flush=True)
    cpu_toks, cpu_logits = greedy_pass(cpu, torch, ids, 32)
    gpu_toks, _ = greedy_pass(gpu, torch, ids, 32)
    _, forced_logits = greedy_pass(gpu, torch, ids, 32, forced=cpu_toks)
    from ntransformer_tpu_torch.ops import linear
    linear.KERNEL_MODE = "off"  # the same run on the card, plain PyTorch
    try:
        _, plain_logits = greedy_pass(gpu, torch, ids, 32, forced=cpu_toks)
    finally:
        linear.KERNEL_MODE = "auto"
    agree = sum(a == b for a, b in zip(gpu_toks, cpu_toks))

    def rels(got):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, cpu_logits)]
    for a in forced_logits:
        check(bool(torch.isfinite(a).all()), "repolm512: non-finite logits")
    kern, plain = rels(forced_logits), rels(plain_logits)
    limits = [max(REAL_LOGIT_RTOL, 2 * r) for r in plain]
    print(f"repolm512: {agree}/{len(cpu_toks)} greedy tokens agree; "
          f"teacher-forced max|dlogit|/max|logit| per step, kernels vs CPU: "
          f"{[round(r, 4) for r in kern]}; card plain path vs CPU: "
          f"{[round(r, 4) for r in plain]}", flush=True)
    for i, (r, lim) in enumerate(zip(kern, limits)):
        check(r <= lim, f"repolm512 step {i}: teacher-forced logits differ "
              f"by {r} of their range (> {lim})")
    layers = layer_by_layer(torch, gpu, ids)
    print(f"repolm512 layer by layer, kernels vs plain on the card: "
          f"{layers} (tol {LAYER_RTOL})", flush=True)
    for phase, r in layers.items():
        check(r <= LAYER_RTOL[phase],
              f"repolm512 {phase}: a layer's kernel output differs by {r} "
              f"of its range from the plain path's (> {LAYER_RTOL[phase]})")
    worst = max(kern)
    return {"tokens_agree": agree, "tokens": len(cpu_toks),
            "logit_rel_err": worst, "layer_rel_err": layers,
            "gpu_text": text_gpu, "cpu_text": text_cpu}


# ---------------------------------------------------------------- phase 4
def full_width_phase(torch, counters, card: str):
    import dataclasses
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.models.synth import model_nbytes, synth_model
    from ntransformer_tpu_torch.ops import linear

    t0 = time.perf_counter()
    cfg, arch, weights = synth_model("8b", "q8_0", fuse=True,
                                     max_seq_len=4096)
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    planes = [weights.embed.planes["qs"], weights.lm_head.planes["qs"]]
    for f in weights.layers.__dataclass_fields__:
        v = getattr(weights.layers, f)
        if isinstance(v, linear.QLinear):
            planes.append(v.planes["qs"])
    for p in planes:  # codes of a realistic spread: |w| ~ 0.02 at d = 0.004
        p.random_(-8, 9, generator=g)
    torch.cuda.synchronize()
    nbytes = model_nbytes(weights)
    per_token = nbytes - weights.embed.nbytes - (weights.rope_cos.numel()
                                                 + weights.rope_sin.numel()) * 4
    print(f"8b q8_0 synth: {nbytes / 1e9:.3f} GB of planes, "
          f"{per_token / 1e9:.3f} GB read per decoded token, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    engine = Engine(model)
    ids = torch.randint(0, arch.vocab_size, (512,),
                        generator=torch.Generator().manual_seed(9)).tolist()
    reset(counters)
    stats = engine.benchmark(prompt_ids=ids, n_tokens=64)
    torch.cuda.synchronize()
    launches = read(counters)
    print(f"main path launches {launches}", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"the main path launched a kernel zero times: {launches}")
    ms_tok = stats.decode_ms / stats.decode_tokens
    summary = {"card": card, "prefill_tokens": stats.prefill_tokens,
               "prefill_ms": stats.prefill_ms,
               "prefill_tok_s": stats.prefill_tps,
               "decode_tokens": stats.decode_tokens,
               "decode_ms_per_token": ms_tok, "decode_tok_s": stats.decode_tps,
               "effective_GB_s": per_token * stats.decode_tps / 1e9,
               "decode_bound_ms_per_token": per_token / HBM_BYTES_PER_S * 1e3}
    print(json.dumps({"full_width_8b": summary}), flush=True)

    kv = engine._make_kv()
    logits, kv, _ = llama.forward(arch, weights, kv, ids, 0, n_valid=512)
    nxt = int(torch.argmax(logits[0]))
    logits2, kv, _ = llama.forward(arch, weights, kv, [nxt], 512)
    check(bool(torch.isfinite(logits).all() and torch.isfinite(logits2).all()),
          "8b: non-finite logits")
    check(tuple(logits2.shape) == (1, arch.vocab_size), "8b: logits shape")
    summary["decode_profile"] = profile_decode(torch, arch, weights, kv,
                                               logits2, 513)
    del kv

    # kernels on vs off on a 2-layer view of the same weights
    layers2 = llama.LayerWeights(**{
        f: (None if v is None else
            linear.QLinear(v.dtype, v.k, v.n,
                           {nm: a[:2] for nm, a in v.planes.items()})
            if isinstance(v, linear.QLinear) else v[:2])
        for f, v in ((f, getattr(weights.layers, f))
                     for f in weights.layers.__dataclass_fields__)})
    arch2 = dataclasses.replace(arch, n_layers=2)
    w2 = dataclasses.replace(weights, layers=layers2)
    outs = {}
    for mode in ("auto", "off"):
        linear.KERNEL_MODE = mode
        try:
            reset(counters)
            kv2 = llama.KVCache.create(arch2, device="cuda")
            lg, _, _ = llama.forward(arch2, w2, kv2, ids, 0, all_logits=True)
            torch.cuda.synchronize()
            outs[mode] = (lg, read(counters))
        finally:
            linear.KERNEL_MODE = "auto"
    check(all(v > 0 for v in outs["auto"][1].values()),
          f"2-layer kernel run launched {outs['auto'][1]}")
    check(all(v == 0 for v in outs["off"][1].values()),
          f"2-layer plain run launched kernels: {outs['off'][1]}")
    a, b = outs["auto"][0], outs["off"][0]
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"8b 2-layer prefill logits, kernels on vs off: "
          f"max|d|/max|off| = {rel:.3e} (tol {FULL_LOGIT_RTOL})", flush=True)
    check(bool(torch.isfinite(a).all()), "8b 2-layer: non-finite logits")
    check(rel <= FULL_LOGIT_RTOL,
          f"8b 2-layer logits differ by {rel} of their range")
    summary["two_layer_logit_rel_err"] = rel
    return summary, launches


def profile_decode(torch, arch, weights, kv, logits, pos: int,
                   steps: int = 4) -> dict:
    """Device time by kernel over a few greedy decode steps (torch.profiler
    with CUDA activity), and the share of the wall time the card was busy.
    The profiler's own host cost inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from ntransformer_tpu_torch.models import llama
    tok = torch.argmax(logits[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, kv, _ = llama.forward(arch, weights, kv, tok.reshape(1),
                                          pos + i)
            tok = torch.argmax(logits[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' time
        if "CUDA" not in str(e.device_type):
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.count // steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = {"steps": steps, "wall_ms_per_token": wall_ms / steps,
           "device_ms_per_token": busy,
           "device_busy_share": busy * steps / wall_ms if wall_ms else 0.0,
           "top": [{"kernel": k[:80], "ms_per_token": ms, "per_token": c}
                   for ms, c, k in rows[:12]]}
    print(json.dumps({"decode_profile": out}), flush=True)
    return out


# ------------------------------------------------------------------- main
def reset(counters):
    for mod in counters.values():
        mod.launches = 0


def read(counters) -> dict:
    return {name: mod.launches for name, mod in counters.items()}


def main() -> int:
    if not os.path.exists(os.path.join(HERE, "ntransformer_tpu_torch",
                                       "__init__.py")):
        fail("run chip_smoke.py from the root of the repository: "
             "ntransformer_tpu_torch/ is not beside it")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ntransformer_tpu_torch.ops.cuda import attention as ca
    from ntransformer_tpu_torch.ops.cuda import build
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:  # one nvcc per source, together
        reports = list(ex.map(build.build, [cm.NAME, ca.NAME]))
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for rep in reports:
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)
    counters = {cm.NAME: cm, ca.NAME: ca}

    timer = Timer(torch)
    phases = sys.argv[1].split(",") if len(sys.argv) > 1 else \
        ["kernels", "real", "full"]
    mm = fa = None
    if "kernels" in phases:
        mm, fa = kernel_phase(torch, timer, card)
    if "real" in phases:
        real_model_phase(torch, counters, card)
    launches = {}
    if "full" in phases:
        _, launches = full_width_phase(torch, counters, card)

    kernels = []
    tols = {cm.NAME: f"max|kernel-plain| <= {MATMUL_RTOL} * max|plain|",
            ca.NAME: f"max|kernel-plain| <= {FLASH_RTOL} * max|plain| "
                     f"in every query row"}
    for mod, res, route_src in ((cm, mm, "csrc/q8_0_matmul.cu"),
                                (ca, fa, "csrc/flash_attention.cu")):
        if res is None:
            continue
        main_row = next(r for r in res["rows"] if r["shape"] == res["main"])
        err = max(r["max_abs_err"] for r in res["rows"])
        kernels.append({
            "name": mod.NAME, "route": "cuda",
            "source": "ntransformer_tpu_torch/" + route_src,
            "replaces": mod.REPLACES, "launches": launches.get(mod.NAME, 0),
            "max_abs_err": err, "max_err": err, "tol": tols[mod.NAME],
            "ms": main_row["ms"], "kernel_ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "shape": res["main"],
            "card": card, "cases": res["rows"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
