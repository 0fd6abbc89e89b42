#!/usr/bin/env python3
"""How long nvcc takes on each kernel translation unit of the port, all at
once and the two longest alone.

    python3 experiments/build_times.py

Compiles every `ntransformer_tpu_torch/csrc/*.cu` (each library's main
source and its parts, `ops/cuda/build.py` `sources`) with the flags of
`ops/cuda/build.py` into object files in a temporary directory (the
`_build/` cache is neither read nor written), one nvcc process a
translation unit, all started together as `chip_smoke.py`'s build starts
them, then links each library; prints each unit's seconds and exit code,
each library's wall (its slowest unit and its link), the wall of the whole
build and the host's core count, then compiles the two slowest units once
more, each alone.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from ntransformer_tpu_torch.ops.cuda import build  # noqa: E402

def compile_one(src: str, out_dir: str) -> tuple[str, float, int]:
    t0 = time.perf_counter()
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-c", "-o",
                           os.path.join(out_dir, os.path.basename(src) + ".o"),
                           src], capture_output=True, text=True)
    return src, time.perf_counter() - t0, proc.returncode


def link(name: str, out_dir: str) -> tuple[float, int]:
    objs = [os.path.join(out_dir, os.path.basename(s) + ".o")
            for s in build.sources(name)]
    t0 = time.perf_counter()
    proc = subprocess.run([build.nvcc_path(), "-shared", "-o",
                           os.path.join(out_dir, f"lib{name}.so"), *objs],
                          capture_output=True, text=True)
    return time.perf_counter() - t0, proc.returncode


def main() -> int:
    names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith(".cu") and f.count(".") == 1)
    units = [s for n in names for s in build.sources(n)]
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(units)) as ex:
            got = list(ex.map(lambda u: compile_one(u, out), units))
        secs = {src: t for src, t, _ in got}
        with ThreadPoolExecutor(len(names)) as ex:
            links = dict(zip(names, ex.map(lambda n: link(n, out), names)))
        wall = time.perf_counter() - t0
        for src, t, rc in got:
            print(f"{os.path.basename(src)}: {t:.1f} s rc {rc}", flush=True)
        for n in names:
            lt, rc = links[n]
            slow = max(secs[s] for s in build.sources(n))
            print(f"library {n}: {len(build.sources(n))} units, slowest "
                  f"{slow:.1f} s, link {lt:.1f} s rc {rc}", flush=True)
        print(f"all together: {wall:.1f} s on {os.cpu_count()} cores",
              flush=True)
        for src, _, _ in sorted(got, key=lambda g: -g[1])[:2]:
            _, t, rc = compile_one(src, out)
            print(f"{os.path.basename(src)} alone: {t:.1f} s rc {rc}",
                  flush=True)
    ok = all(rc == 0 for _, _, rc in got) and all(
        rc == 0 for _, rc in links.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
