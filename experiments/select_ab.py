#!/usr/bin/env python3
"""The T = 1 skinny matmul kernels of the H100 port (csrc/q8_0_matmul.cu,
csrc/kquant_matmul.cu, csrc/w8a8_matmul.cu, csrc/w4a8_decode.cu) with and
without the device-side expert select, one checkout against another, on
one card.

    python3 experiments/select_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repository (this one, or an
older commit unpacked with `git archive` into a directory .gitignore
lists). The roots' kernels are first built side by side (one nvcc a
source and root, each root into its own _build/); then each root is
measured in a process of its own, in the order given, so `parent change
change parent` shows the spread between runs. For each ROOT it prints one
JSON line with, for each product at the Mixtral-8x7B expert shapes (the
rows of chip_smoke.py's SELECT_ROWS: expert 5 of stacked [8, K, N]
planes, x of chip_smoke.py's `skewed_x`, T = 1):

  host: the wrapper on the host-int view of the expert (what every dense
     decode product runs): the call time (CUDA events, L2 flushed before
     each call, chip_smoke.py's Timer), the profiler's device time and
     CUDA kernels per call (chip_smoke.py's `profile_calls`);
  select: the same with the index a CUDA int32 tensor (`sel=`), where the
     root's wrapper takes one (null otherwise).

It imports chip_smoke.py and the port from ROOT, so it runs against any
checkout whose chip_smoke.py has `random_planes`, `random_wplanes`,
`skewed_x`, `profile_calls` and `Timer`. The card's name and power limit
are printed first.
"""
from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys

SOURCES = ("q8_0_matmul", "kquant_matmul", "w8a8_matmul", "w4a8_decode")
ROWS = (("q4_k", "gate|up", 4096, 14336), ("q6_k", "down", 14336, 4096),
        ("q8_0", "gate|up", 4096, 14336), ("q4_0", "gate|up", 4096, 14336),
        ("q5_k", "gate|up", 4096, 14336), ("w8a8", "gate|up", 4096, 14336),
        ("w4a8", "gate|up", 4096, 14336), ("w4a8", "down", 14336, 4096))
N_EXP, EXPERT = 8, 5


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    return smi.stdout.strip().splitlines()[0]


def product(torch, cs, g, fmt: str, k: int, n: int):
    """(stacked planes, fn(x, planes, sel=None) or None where the root's
    wrapper takes no sel, fn(x, planes) of the host-int path)."""
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as cn
    from ntransformer_tpu_torch.ops.cuda import w4a8 as cw4
    from ntransformer_tpu_torch.ops.cuda import w8a8 as cw8
    dt = DType(fmt)
    if fmt == "q8_0":
        planes = {"qs": torch.randint(-127, 128, (N_EXP, k, n),
                                      dtype=torch.int8, device="cuda",
                                      generator=g),
                  "d": (torch.rand((N_EXP, k // 32, n), device="cuda",
                                   generator=g) * 0.01 + 1e-3)
                  .to(torch.float16).view(torch.int16)}
        wrap = cm.quant_matmul_cuda

        def call(x, p, *s):
            return wrap(x, p["qs"], p["d"], *s)
    else:
        one = (cs.random_wplanes if fmt in ("w8a8", "w4a8")
               else cs.random_planes)
        stack = [one(torch, g, dt, k, n) for _ in range(N_EXP)]
        planes = {nm: torch.stack([p[nm] for p in stack]) for nm in stack[0]}
        del stack
        if fmt == "w8a8":
            wrap = cw8.w8a8_matmul_cuda

            def call(x, p, *s):
                return wrap(x, p["q"], p["s"], *s)
        elif fmt == "w4a8":
            wrap = cw4.w4a8_decode_cuda

            def call(x, p, *s):
                return wrap(x, p, *s)
        else:
            wrap = cn.nibble_matmul_cuda

            def call(x, p, *s):
                return wrap(x, p, dt, *s)
    has_sel = "sel" in inspect.signature(wrap).parameters
    return planes, call, has_sel


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_root", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    assert torch.cuda.is_available(), "this measurement needs a CUDA card"
    out = {"root": root, "card": card(), "rows": {}}
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda")
    g.manual_seed(41)
    sel = torch.tensor([EXPERT], dtype=torch.int32, device="cuda")
    for fmt, label, k, n in ROWS:
        planes, call, has_sel = product(torch, cs, g, fmt, k, n)
        view = {nm: a[EXPERT] for nm, a in planes.items()}
        x = cs.skewed_x(torch, g, 1, k)
        fns = {"host": lambda: call(x, view)}
        if has_sel:
            fns["select"] = lambda: call(x, planes, sel)
        ms = timer.compare(fns)
        row = {}
        for path, fn in fns.items():
            prof = cs.profile_calls(torch, fn)
            row[path] = {"call_ms": ms[path],
                         "device_ms": sum(v["ms"] for v in prof.values()),
                         "kernels_per_call": sum(v["per_call"]
                                                 for v in prof.values())}
        row.setdefault("select", None)
        out["rows"][f"{fmt} {label} K={k} N={n} T=1"] = row
        del planes, view, x
        torch.cuda.empty_cache()
    return out


def build(root: str) -> None:
    """Compile the root's four sources, one nvcc each, side by side."""
    from concurrent.futures import ThreadPoolExecutor
    sys.path.insert(0, os.path.abspath(root))
    from ntransformer_tpu_torch.ops.cuda import build as b
    with ThreadPoolExecutor(len(SOURCES)) as ex:
        list(ex.map(b.build, SOURCES))


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] in ("--one", "--build"):
        if sys.argv[1] == "--build":
            build(sys.argv[2])
        else:
            print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(card(), flush=True)
    me = os.path.abspath(__file__)
    roots = list(dict.fromkeys(os.path.abspath(r) for r in sys.argv[1:]))
    builds = [subprocess.Popen([sys.executable, me, "--build", r])
              for r in roots]
    if any(p.wait(timeout=900) for p in builds):
        print("a build failed", file=sys.stderr)
        return 1
    runs = []
    for root in sys.argv[1:]:
        r = subprocess.run([sys.executable, me, "--one", root],
                           capture_output=True, text=True, timeout=900)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if r.returncode or not lines:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
        runs.append(json.loads(lines[-1]))
    # the runs side by side, in the order measured: device ms (call ms)
    for key in runs[0]["rows"]:
        for path in ("host", "select"):
            cells = [r["rows"][key][path] for r in runs]
            print(f"{key} {path}: " + " | ".join(
                "-" if c is None else
                f"{c['device_ms']:.4f} ({c['call_ms']:.4f}, "
                f"{c['kernels_per_call']:g} kernels)" for c in cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
