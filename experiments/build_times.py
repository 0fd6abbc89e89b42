#!/usr/bin/env python3
"""How long nvcc takes on each kernel source of the port, all at once and
the two longest alone.

    python3 experiments/build_times.py

Compiles every `ntransformer_tpu_torch/csrc/*.cu` with the flags of
`ops/cuda/build.py` into a temporary directory (the `_build/` cache is
neither read nor written), one nvcc process a source, all started
together as `chip_smoke.py` starts them; prints each source's seconds and
exit code, the wall of the whole build and the host's core count, then
builds the two slowest sources once more, each alone.
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


def compile_one(name: str, out_dir: str) -> tuple[str, float, int]:
    src, _ = build.library_path(name)
    t0 = time.perf_counter()
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           os.path.join(out_dir, f"lib{name}.so"), src],
                          capture_output=True, text=True)
    return name, time.perf_counter() - t0, proc.returncode


def main() -> int:
    names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith(".cu"))
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(names)) as ex:
            got = list(ex.map(lambda n: compile_one(n, out), names))
        wall = time.perf_counter() - t0
        for name, secs, rc in got:
            print(f"{name}: {secs:.1f} s rc {rc}", flush=True)
        print(f"all together: {wall:.1f} s on {os.cpu_count()} cores",
              flush=True)
        for name, _, _ in sorted(got, key=lambda g: -g[1])[:2]:
            _, secs, rc = compile_one(name, out)
            print(f"{name} alone: {secs:.1f} s rc {rc}", flush=True)
    return 0 if all(rc == 0 for _, _, rc in got) else 1


if __name__ == "__main__":
    sys.exit(main())
