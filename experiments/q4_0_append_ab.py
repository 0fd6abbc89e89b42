#!/usr/bin/env python3
"""The Q4_0 matmul (ops/cuda/nibble_matmul.py) and the in-place KV append
(ops/cuda/kv_update.py) of the H100 port, and the paths they carry, one
checkout against another, on one card.

    python3 experiments/q4_0_append_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (this one, or an
older commit unpacked with `git archive` into a directory .gitignore lists,
e.g. scratch_chip/parent); each is measured in a process of its own that
builds that checkout's kernels from its own csrc/, in the order given, so
`parent change change parent` shows the spread between runs. For each ROOT
it prints one JSON line:

  q4_0: the Q4_0 product at the 8B fused gate|up, down and head at T = 1,
     32 and 512: the wrapper's call time (CUDA events, L2 flushed before
     each call, chip_smoke.py's Timer), torch.matmul on the pre-dequantized
     bf16 weight beside it, the profiler's device time of a call, CUDA
     kernels and counted launches a call, and the least time the card
     could take (bytes over 3.35 TB/s or operations over 989 TFLOP/s);
  q4_0_units: where the checkout's plans have Q4_0_UNIT, the skinny
     kernel's device time at the 8B qkv, wo, gate|up and down at T = 1 and
     8 with the split unit set to 64, 128 and 256 K elements;
  append: the KV append at rows 4 and 5's shapes (one layer B = 8 bf16,
     S 4,096; L = 32 B = 8 bf16, S 4,096; L = 32 B = 32 int8 codes and
     scales, S 1,024; one slot in seven inactive): call time, device time,
     kernels and launches a call, the indexed assignment beside it, and
     the wrapper's host time a call split into its parts (dtype checks,
     torch.as_tensor, the int32 conversions, torch.cuda.device, the
     current stream as a Stream object and as a raw handle, the C entry's
     ctypes call with its launch);
  paths: a synthetic 8B all-Q4_0 (chip_smoke.py's `build_synth`) through
     Engine.benchmark (512-token prefill, 64 decoded tokens; a warm-up run,
     then two), the prefill's device time (torch.profiler), and bench.py's
     B = 1 batched step (`bench_b1`, with its launches a step), profiled;
     then the 8B Q4_K_M B = 32 int8 step profiled, with the append's share
     of its device time.

It imports chip_smoke.py and the port from ROOT, so it runs against any
checkout whose chip_smoke.py has `build_synth`, `bench_b1`,
`profile_batched`, `profile_calls`, `random_planes`, `skewed_x`, `bound`
and `Timer`. The card's name and power limit are printed first.
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

# the kernel sources the measured paths build (those ROOT has)
SOURCES = ("batched_attention", "kquant_matmul", "nibble_matmul",
           "flash_attention", "kv_update")
Q4_0_SHAPES = (("gate|up", 4096, 28672), ("down", 14336, 4096),
               ("head", 4096, 128256))
UNIT_SHAPES = (("qkv", 4096, 6144), ("wo", 4096, 4096),
               ("gate|up", 4096, 28672), ("down", 14336, 4096))
TOKENS = (1, 32, 512)
# the kernels of a Q4_0 product, this tree's and the parent's
Q4_0_MARKERS = ("skinny_kernel", "tile_kernel", "nib_gemv", "splitk_reduce",
                "nib_mma")
# label, layers, B, S, int8, stacked
APPEND_CASES = (("one layer B=8 bf16 S=4096", 1, 8, 4096, False, False),
                ("L=32 B=8 bf16 S=4096", 32, 8, 4096, False, True),
                ("L=32 B=32 int8 codes+scales S=1024", 32, 32, 1024, True,
                 True))
HOST_REPS = 2000


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


def q4_0_rows(torch, cs, timer) -> dict:
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
    g = torch.Generator(device="cuda")
    g.manual_seed(2027)
    dtype = DType.Q4_0
    kern = nm.KERNELS[dtype]
    out = {}
    for label, k, n in Q4_0_SHAPES:
        planes = cs.random_planes(torch, g, dtype, k, n)
        pbytes = sum(a.numel() * a.element_size() for a in planes.values())
        w = dequant_planes_torch(planes, dtype, k, n,
                                 out_dtype=torch.bfloat16)
        for t in TOKENS:
            x = cs.skewed_x(torch, g, t, k)
            before = kern.launches
            y = nm.nibble_matmul_cuda(x, planes, dtype)
            torch.cuda.synchronize()
            per_call = kern.launches - before
            y0 = torch.matmul(x.float(), w.float())
            err = float((y - y0).abs().max() / y0.abs().max())
            del y, y0
            ms = timer.compare({
                "call": lambda: nm.nibble_matmul_cuda(x, planes, dtype),
                "library": lambda: torch.matmul(x, w)})
            ks_ = kernels_of(torch, cs,
                             lambda: nm.nibble_matmul_cuda(x, planes, dtype))
            b_ms, b_by = cs.bound(pbytes + t * k * 2 + t * n * 4,
                                  2.0 * t * k * n)
            out[f"q4_0 {label} T={t}"] = {
                "call_ms": ms["call"], "library_ms": ms["library"],
                "device_ms": sum(v[0] for v in ks_.values()),
                "kernels_per_call": sum(v[1] for v in ks_.values()),
                "launches_per_call": per_call, "bound_ms": b_ms,
                "bound_by": b_by, "rel_err_vs_f32": err,
                "kernels": {kn: round(v[0], 5) for kn, v in ks_.items()}}
            del x
        del planes, w
        torch.cuda.empty_cache()
    return out


def q4_0_unit_rows(torch, cs) -> dict:
    """The skinny kernel's device time with each split unit (the wrapper
    reads plans.Q4_0_UNIT at every call)."""
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    from ntransformer_tpu_torch.ops.cuda import plans
    if not hasattr(plans, "Q4_0_UNIT"):
        return {}
    g = torch.Generator(device="cuda")
    g.manual_seed(2028)
    keep = plans.Q4_0_UNIT
    out = {}
    try:
        for label, k, n in UNIT_SHAPES:
            planes = cs.random_planes(torch, g, DType.Q4_0, k, n)
            for t in (1, 8):
                x = cs.skewed_x(torch, g, t, k)
                row = {}
                for unit in (64, 128, 256):
                    plans.Q4_0_UNIT = unit
                    ks_ = kernels_of(torch, cs, lambda: nm.nibble_matmul_cuda(
                        x, planes, DType.Q4_0))
                    sms = plans.sm_count(x.device)
                    row[str(unit)] = {
                        "device_ms": sum(v[0] for v in ks_.values()),
                        "plan": plans.skinny_plan(sms, t, k, n, unit)}
                out[f"q4_0 {label} T={t}"] = row
                del x
            del planes
    finally:
        plans.Q4_0_UNIT = keep
    return out


def _host_us(fn, reps: int = HOST_REPS) -> float:
    """Host microseconds a call of fn, over reps calls (the card is not
    waited for: it runs behind)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def _raw_launch(torch, ck, caches, rows, pos32, act32, stacked: bool):
    """The C entry called straight through ctypes with its arguments made
    beforehand, in whichever signature the checkout has: the parent's 28
    arguments (each array's five), or a descriptor and its launch plan."""
    lib = ck.build.load(ck.NAME, ck._SIGNATURES)
    lead = caches[0].shape[:4] if stacked else (1,) + tuple(
        caches[0].shape[:3])
    l_n, b_n, h_n, s = lead
    nd = 4 if stacked else 3
    dcs = [c.shape[nd] if c.dim() > nd else 1 for c in caches]
    rows = [r.contiguous() for r in rows]
    stream = torch.cuda.current_stream().cuda_stream
    if len(ck._SIGNATURES["kv_append"]) == 28:
        args = []
        for c, r, dc in zip(caches, rows, dcs):
            args += [c.data_ptr(), r.data_ptr(), ck._KINDS[c.dtype],
                     ck._KINDS[r.dtype], dc]
        args += [None, None, 0, 0, 1] * (4 - len(caches))
        full = [len(caches), *args, l_n, b_n, h_n, s, pos32.data_ptr(),
                act32.data_ptr(), stream]
        return lambda: lib.kv_append(*full)
    arrays = [(c.element_size(), r.element_size(), dc,
               c.data_ptr() % 16 == 0 and r.data_ptr() % 16 == 0)
              for c, r, dc in zip(caches, rows, dcs)]
    plan, blocks = ck.launch_plan(arrays, l_n, h_n)
    desc = ck._DESC()
    for i, (c, r, dc) in enumerate(zip(caches, rows, dcs)):
        desc[8 * i:8 * i + 8] = (c.data_ptr(), r.data_ptr(),
                                 ck._KINDS[c.dtype], ck._KINDS[r.dtype], dc,
                                 *plan[i])
    full = [desc, len(caches), blocks, l_n, b_n, h_n, s, pos32.data_ptr(),
            act32.data_ptr(), stream]
    return lambda: lib.kv_append(*full)


def append_rows(torch, cs, timer) -> dict:
    from ntransformer_tpu_torch.ops.cuda import kv_update as ck
    g = torch.Generator(device="cuda")
    g.manual_seed(4322)
    hkv, dh = 8, 128
    out = {}
    for label, layers, b_n, s, int8, stacked in APPEND_CASES:
        pos_l = [(977 * i + 13) % s for i in range(b_n)]
        act_l = [i % 7 != 3 for i in range(b_n)]
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        act = torch.tensor(act_l, device="cuda").to(torch.int32)
        shape = (layers, b_n, hkv, s, dh)
        if int8:
            caches = [torch.randint(-127, 128, shape, dtype=torch.int8,
                                    device="cuda", generator=g)
                      for _ in range(2)]
            caches = [caches[0], torch.rand(shape[:-1], device="cuda",
                                            generator=g),
                      caches[1], torch.rand(shape[:-1], device="cuda",
                                            generator=g)]
            rows = [torch.randint(-127, 128, (layers, b_n, hkv, 1, dh),
                                  dtype=torch.int8, device="cuda",
                                  generator=g),
                    torch.rand(layers, b_n, hkv, 1, 1, device="cuda",
                               generator=g)] * 2
        else:
            caches = [torch.randn(shape, device="cuda", generator=g).to(
                torch.bfloat16) for _ in range(2)]
            rows = [torch.randn(layers, b_n, hkv, 1, dh, device="cuda",
                                generator=g) for _ in range(2)]
        if not stacked:
            caches = [c[0] for c in caches]
            rows = [r[0] for r in rows]
        launch = ck.append_rows_stacked if stacked else ck.append_rows
        plain = (ck.append_rows_stacked_plain if stacked
                 else ck.append_rows_plain)
        ref = [c.clone() for c in caches]
        launch(caches, rows, pos, act)
        plain(ref, rows, pos, act)
        torch.cuda.synchronize()
        equal = all(torch.equal(c, r) for c, r in zip(caches, ref))
        del ref
        sel = torch.tensor([i for i in range(b_n) if act_l[i]],
                           device="cuda")
        psel = pos.long()[sel]
        lib_rows = []
        for c, r in zip(caches, rows):
            codes = c.dim() == (5 if stacked else 4)
            rr = r.reshape(tuple(r.shape[:-2])
                           + ((r.shape[-1],) if codes else ())).to(c.dtype)
            lib_rows.append(rr[:, sel].movedim(1, 0) if stacked
                            else rr[sel])

        def library():
            for c, rr in zip(caches, lib_rows):
                if stacked:
                    c[:, sel, :, psel] = rr
                else:
                    c[sel, :, psel] = rr

        def call():
            launch(caches, rows, pos, act)
        before = ck.launches
        call()
        per_call = ck.launches - before
        ms = timer.compare({"call": call, "library": library})
        ks_ = kernels_of(torch, cs, call)
        dev = caches[0].device
        raw = _raw_launch(torch, ck, caches, rows, pos, act, stacked)

        def ctx():
            with torch.cuda.device(dev):
                pass
        host = {"call": _host_us(call), "library": _host_us(library),
                "check_dtypes": _host_us(
                    lambda: ck._check_dtypes(tuple(caches), tuple(rows))),
                "as_tensor_x2": _host_us(
                    lambda: (torch.as_tensor(pos), torch.as_tensor(act))),
                "to_int32_contiguous_x2": _host_us(
                    lambda: (pos.to(dev, torch.int32).contiguous(),
                             act.to(dev, torch.int32).contiguous())),
                "cuda_device_ctx": _host_us(ctx),
                "current_stream": _host_us(
                    lambda: torch.cuda.current_stream(dev).cuda_stream),
                "current_raw_stream": _host_us(
                    lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
                "ctypes_launch": _host_us(raw)}
        n_act = sum(act_l)
        moved = sum(r.numel() // b_n * n_act * (r.element_size()
                                                + c.element_size())
                    for c, r in zip(caches, rows))
        b_ms, b_by = cs.bound(moved + 2 * b_n * 4, 0.0)
        out[label] = {
            "bit_equal": equal, "call_ms": ms["call"],
            "library_ms": ms["library"],
            "device_ms": sum(v[0] for v in ks_.values()),
            "kernels_per_call": sum(v[1] for v in ks_.values()),
            "launches_per_call": per_call, "bound_ms": b_ms,
            "bound_by": b_by, "host_us": host,
            "kernels": {kn: round(v[0], 5) for kn, v in ks_.items()}}
        del caches, rows, lib_rows
        torch.cuda.empty_cache()
    return out


def _prefill_device(torch, engine, ids) -> dict:
    """The device time of one 512-token prefill (torch.profiler; a lost
    record reads short) and the Q4_0 kernels' share of it."""
    from torch.profiler import ProfilerActivity, profile
    engine._prefill(engine._make_kv(), ids)
    torch.cuda.synchronize()
    kv = engine._make_kv()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine._prefill(kv, ids)
        torch.cuda.synchronize()
    total = q = 0.0
    n = 0
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type) and e.self_device_time_total > 0:
            total += e.self_device_time_total / 1e3
            n += e.count
            if any(m in e.key for m in Q4_0_MARKERS):
                q += e.self_device_time_total / 1e3
    return {"device_ms": total, "q4_0_device_ms": q, "kernels": n}


def _step_device(torch, arch, weights, bkv, b_n: int, pos0: int,
                 steps: int = 4) -> dict:
    """Device time a batched decode step (torch.profiler over `steps`
    chained steps, s_live 768) and the append's share of it, from every
    kernel of the trace."""
    from torch.profiler import ProfilerActivity, profile
    from ntransformer_tpu_torch.models.batched import batched_decode_step
    tok = torch.arange(b_n, device="cuda") + 3
    act = torch.ones(b_n, dtype=torch.bool, device="cuda")

    def step(i, tok):
        pos = torch.full((b_n,), pos0 + i, dtype=torch.long, device="cuda")
        logits, _ = batched_decode_step(arch, weights, bkv, tok, pos, act,
                                        s_live=768)
        return torch.argmax(logits, -1)
    tok = step(0, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            tok = step(i + 1, tok)
        torch.cuda.synchronize()
    total = app = 0.0
    n = 0
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type) and e.self_device_time_total > 0:
            total += e.self_device_time_total / 1e3 / steps
            n += e.count
            if "kv_append" in e.key:
                app += e.self_device_time_total / 1e3 / steps
    return {"device_ms_per_step": total, "kernels_per_step": n / steps,
            "kv_append_device_ms_per_step": app}


def path_rows(torch, cs) -> dict:
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models.batched import BatchedKV
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    out = {}
    cfg, arch, weights, per_token = cs.build_synth(torch, "q4_0")
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    engine = Engine(model)
    ids = torch.randint(0, arch.vocab_size, (512,),
                        generator=torch.Generator().manual_seed(9)).tolist()
    engine.benchmark(prompt_ids=ids, n_tokens=8)  # warm-up
    runs = [engine.benchmark(prompt_ids=ids, n_tokens=64) for _ in range(2)]
    out["q4_0_engine_prefill_ms"] = [r.prefill_ms for r in runs]
    out["q4_0_engine_decode_ms_per_token"] = [r.decode_ms / r.decode_tokens
                                              for r in runs]
    out["q4_0_prefill_profile"] = _prefill_device(torch, engine, ids)
    del engine
    counters = {k.name: k for k in nm.KERNELS.values()}
    b1 = cs.bench_b1(torch, counters, arch, weights, per_token)
    out["q4_0_b1_ms_per_step"] = b1["ms_per_step"]
    out["q4_0_b1_launches_per_step"] = {kn: v / 128 for kn, v in
                                        b1["launches"].items() if v}
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    bkv = BatchedKV.create(arch1k, 1, device="cuda")
    prof = cs.profile_batched(torch, arch1k, weights, bkv, 1, 300)
    out["q4_0_b1_profile"] = {
        k: prof[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                             "kernels_per_step")}
    out["q4_0_b1_profile"]["q4_0_device_ms_per_step"] = sum(
        r["ms_per_step"] for r in prof["top"]
        if any(m in r["kernel"] for m in Q4_0_MARKERS))
    del bkv, weights, model
    torch.cuda.empty_cache()
    # the 8B Q4_K_M B = 32 int8 step and its append
    cfg, arch, weights, per_token = cs.build_synth(torch, "q4_k_m")
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    bkv = BatchedKV.create(arch1k, 32, quant=True, device="cuda")
    out["q4_k_m_b32_int8_profile"] = _step_device(torch, arch1k, weights,
                                                  bkv, 32, 700)
    del bkv, weights
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
    out["q4_0"] = q4_0_rows(torch, cs, timer)
    out["q4_0_units"] = q4_0_unit_rows(torch, cs)
    out["append"] = append_rows(torch, cs, timer)
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
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "q4_0_append_ab.json"), "w") as f:
        json.dump(runs, f, indent=1)
    # the runs side by side, in the order measured: call ms (device ms,
    # kernels a call)
    for part in ("q4_0", "append"):
        for key in runs[0][part]:
            print(f"{key}: " + " | ".join(
                f"{r[part][key]['call_ms']:.4f} "
                f"({r[part][key]['device_ms']:.4f}, "
                f"{r[part][key]['kernels_per_call']:g})" for r in runs)
                + f" | library {runs[0][part][key]['library_ms']:.4f}"
                + f" | bound {runs[0][part][key]['bound_ms']:.5f}")
    for key in runs[0]["append"]:
        print(f"{key} host us: " + " | ".join(
            json.dumps({k: round(v, 2) for k, v in
                        r["append"][key]["host_us"].items()}) for r in runs))
    for r in runs:
        for key, row in r["q4_0_units"].items():
            print(f"units {key}: " + json.dumps(
                {u: round(v["device_ms"], 5) for u, v in row.items()}))
    for key in runs[0]["paths"]:
        print(f"{key}: " + " | ".join(
            json.dumps(r["paths"][key]) for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
