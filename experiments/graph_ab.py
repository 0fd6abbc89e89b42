#!/usr/bin/env python3
"""The batched steps and the resident Engine's programs replayed as CUDA
graphs (models/graphs.py) against the same steps launched from the host,
one checkout against another, on one card.

    python3 experiments/graph_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (this one, or an
older commit unpacked with `git archive` into a directory .gitignore lists,
e.g. scratch_chip/parent). The roots' kernels are built side by side first
(one process a root, each from its own csrc/); then each ROOT is measured
in a process of its own, in the order given, so `parent change change
parent` shows the spread between runs. A checkout with models/graphs.py
replays its steps (and one with models/graphs.ForwardGraphs the Engine's);
an older one calls them. For each ROOT it prints one JSON line, for the
synthetic 8B Q4_K_M and Q8_0 of chip_smoke.py's `build_synth`:

  b1: bench.py's B = 1 bf16 chain as chip_smoke.py's `bench_b1` times it
     (S 1,024, the 256 rung, best of two 64-step runs): wall ms a step, and
     the device ms and CUDA kernels of one step (a replay where the
     checkout captures) by `profile_calls`;
  b32_int8: the B = 32 int8 step from mid-context, delta-timed as phase
     bfull times it (24 then 72 chained steps under the 768 rung), with
     its device ms and kernels the same way;
  server (Q4_K_M only): BatchServer(B = 8) over bfull's eight requests
     (9-1,000 prompt tokens, 16 new each), warmed up, then run twice:
     served tok/s, wall, steps and the warmup's seconds;
  engine: Engine.benchmark at ctx 4,096 after phase full's 512-token
     prompt, 64 tokens, three runs (the first one warms up): decode ms a
     token, the best and each; the device ms and CUDA kernels of one
     decode step at position 512 by `profile_calls` (a replay where the
     checkout's Engine captures), and the busy share, device ms over the
     best ms a token.

It imports chip_smoke.py and the port from ROOT, so it runs against any
checkout whose chip_smoke.py has `build_synth`, `bench_b1`,
`batched_chain`, `s_live_bucket`, `profile_calls` and `IdsTokenizer`. The
card's name and power limit are printed first.
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

# the kernel sources the measured paths build
SOURCES = ("q8_0_matmul", "kquant_matmul", "batched_attention", "kv_update",
           "flash_attention")
LENS = [700, 130, 64, 9, 300, 20, 90, 1000]   # bfull's requests


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    return smi.stdout.strip().splitlines()[0]


def load_root(root: str):
    """(chip_smoke module of ROOT, whether ROOT captures its steps), with
    ROOT's package first on the path."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_root", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    graphs = os.path.exists(os.path.join(root, "ntransformer_tpu_torch",
                                         "models", "graphs.py"))
    return cs, graphs


def build(root: str) -> float:
    load_root(root)
    from ntransformer_tpu_torch.ops.cuda import build as b
    t0 = time.perf_counter()
    names = [s for s in SOURCES
             if os.path.exists(os.path.join(b.CSRC_DIR, s + ".cu"))]
    with ThreadPoolExecutor(len(names)) as ex:  # one compiler per source
        list(ex.map(b.build, names))
    return time.perf_counter() - t0


def step_profile(torch, cs, fn) -> dict:
    prof = cs.profile_calls(torch, fn)
    return {"device_ms": sum(v["ms"] for v in prof.values()),
            "kernels": sum(v["per_call"] for k, v in prof.items()
                           if not k.startswith(("Memcpy", "Memset")))}


def chain_cells(torch, cs, captures: bool, synth, counters) -> dict:
    """b1 and b32_int8 of one synthetic 8B."""
    from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                       batched_decode_step)
    _, arch, weights, per_token = synth
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    out = {"b1": cs.bench_b1(torch, counters, arch, weights, per_token)}
    out["b1"].pop("launches")
    for b_n, quant, cell, sl, pos0 in ((1, False, "b1", 256, 200),
                                       (32, True, "b32_int8", 768, 700)):
        bkv = BatchedKV.create(arch1k, b_n, quant=quant, device="cuda")
        tok = torch.arange(b_n, device="cuda") + 3
        act = torch.ones(b_n, dtype=torch.bool, device="cuda")
        pos = torch.full((b_n,), pos0, dtype=torch.long, device="cuda")
        kw = {}
        if captures:
            from ntransformer_tpu_torch.models.graphs import StepGraphs
            kw["graphs"] = sg = StepGraphs(arch1k, weights, bkv)

            def step():
                return sg.run(bkv, "decode", tok, pos, act, sl)
        else:
            def step():
                return batched_decode_step(arch1k, weights, bkv, tok, pos,
                                           act, s_live=sl)[0]
        if b_n == 32:
            # bfull's delta-timed rounds: 24 and 72 steps, the difference
            t = cs.batched_chain(torch, arch1k, weights, bkv, 32, 24, 512,
                                 tok, **kw)
            t0 = time.perf_counter()
            t = cs.batched_chain(torch, arch1k, weights, bkv, 32, 24, 544, t,
                                 **kw)
            t1 = time.perf_counter()
            t = cs.batched_chain(torch, arch1k, weights, bkv, 32, 72, 576, t,
                                 **kw)
            t2 = time.perf_counter()
            dt = ((t2 - t1) - (t1 - t0)) / 48
            out[cell] = {"ms_per_step": dt * 1e3,
                         "tok_s_aggregate": 32 / dt,
                         "effective_GB_s": per_token / dt / 1e9}
        out[cell]["profile"] = step_profile(torch, cs, step)
        del bkv, kw
    return out


def engine_cell(torch, cs, synth) -> dict:
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models.loader import LoadedModel
    cfg, arch, weights, _ = synth
    eng = Engine(LoadedModel(cfg, arch, weights, None, None,
                             torch.device("cuda")))
    ids = torch.randint(0, arch.vocab_size, (512,),
                        generator=torch.Generator().manual_seed(9)).tolist()
    runs = []
    for _ in range(3):
        st = eng.benchmark(prompt_ids=ids, n_tokens=64)
        runs.append(st.decode_ms / st.decode_tokens)
    # the engine's own cache where it keeps one (its step then replays)
    kv = eng._start_kv() if hasattr(eng, "_start_kv") else eng._make_kv()
    logits, kv, _ = eng._prefill(kv, ids)
    tok = torch.argmax(logits[0])
    prof = step_profile(torch, cs,
                        lambda: eng._decode_step(kv, tok, len(ids)))
    best = min(runs[1:])
    out = {"ms_per_token": best, "runs_ms_per_token": runs,
           "captures": getattr(eng, "_graphs_of", lambda kv: None)(kv)
           is not None,
           "profile": prof, "busy_share": prof["device_ms"] / best}
    del eng, kv
    return out


def server(torch, cs, synth) -> dict:
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import LoadedModel
    cfg, arch, weights, _ = synth
    model = LoadedModel(cfg, arch, weights, cs.IdsTokenizer(), None,
                        torch.device("cuda"))
    rng = torch.Generator().manual_seed(21)
    prompts = [torch.randint(3, arch.vocab_size, (n,),
                             generator=rng).tolist() for n in LENS]
    srv = BatchServer(model, batch_size=8,
                      sampler_cfg=SamplerConfig(temperature=0.0))
    out = {"warmup_s": srv.warmup(), "runs": []}
    for _ in range(2):
        reqs = [Request(prompt="", max_tokens=16, prompt_ids=list(p))
                for p in prompts]
        st = srv.run(reqs)
        torch.cuda.synchronize()
        out["runs"].append({"tok_s": st.tokens_per_s, "wall_s": st.wall_s,
                            "steps": st.steps})
    out["tokens"] = [r.output_ids for r in reqs]
    del srv
    return out


def one(root: str) -> dict:
    cs, captures = load_root(root)
    import torch
    assert torch.cuda.is_available(), "this measurement needs a CUDA card"
    torch.backends.cuda.matmul.allow_tf32 = False
    from ntransformer_tpu_torch.ops.cuda import (batched_attention, kv_update,
                                                 matmul, nibble_matmul)
    counters = {m.NAME: m for m in (matmul, batched_attention, kv_update)}
    counters.update({k.name: k for k in nibble_matmul.KERNELS.values()})
    out = {"root": os.path.abspath(root), "card": card(),
           "captures": captures}
    for fmt in ("q4_k_m", "q8_0"):
        synth = cs.build_synth(torch, fmt)
        out[fmt] = chain_cells(torch, cs, captures, synth, counters)
        if fmt == "q4_k_m":
            out[fmt]["server"] = server(torch, cs, synth)
        out[fmt]["engine"] = engine_cell(torch, cs, synth)
        del synth
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] in ("--one", "--build"):
        if sys.argv[1] == "--build":
            print(json.dumps({"build_s": build(sys.argv[2])}), flush=True)
        else:
            print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(card(), flush=True)
    me = os.path.abspath(__file__)
    roots = list(dict.fromkeys(sys.argv[1:]))
    builds = [subprocess.Popen([sys.executable, me, "--build", r])
              for r in roots]
    if any(p.wait(timeout=900) for p in builds):
        return 1
    runs = []
    for root in sys.argv[1:]:
        r = subprocess.run([sys.executable, me, "--one", root],
                           capture_output=True, text=True, timeout=900)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if r.returncode or not lines:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return 1
        got = json.loads(lines[-1])
        tokens = got["q4_k_m"]["server"].pop("tokens")
        print(json.dumps(got), flush=True)
        runs.append((got, tokens))
    # side by side, in the order measured
    for fmt in ("q4_k_m", "q8_0"):
        for cell in ("b1", "b32_int8"):
            row = [f"{g[fmt][cell]['ms_per_step']:.2f} "
                   f"({g[fmt][cell]['profile']['device_ms']:.2f}, "
                   f"{g[fmt][cell]['profile']['kernels']:g})"
                   for g, _ in runs]
            print(f"{fmt} {cell} ms a step (device ms, kernels): "
                  + " | ".join(row))
    for fmt in ("q4_k_m", "q8_0"):
        row = [f"{g[fmt]['engine']['ms_per_token']:.2f} "
               f"({g[fmt]['engine']['profile']['device_ms']:.2f}, "
               f"{g[fmt]['engine']['profile']['kernels']:g}, "
               f"{g[fmt]['engine']['busy_share']:.3f})" for g, _ in runs]
        print(f"{fmt} Engine.benchmark ms a token (device ms, kernels, busy "
              "share): " + " | ".join(row))
    print("q4_k_m server tok/s: " + " | ".join(
        "/".join(f"{x['tok_s']:.1f}" for x in g["q4_k_m"]["server"]["runs"])
        for g, _ in runs))
    same = all(t == runs[0][1] for _, t in runs)
    print(f"served tokens equal across the roots: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
