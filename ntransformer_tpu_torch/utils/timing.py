"""The phase profiler and the device memory report (PyTorch).

Port of ntransformer_tpu/utils/timing.py. PyTorch returns before the card
finishes, so a phase begins and ends with `torch.cuda.synchronize()` when
CUDA is in use; otherwise a phase would time the enqueue, not the work.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profiler:
    """Named-phase aggregate profiler: begin/end; `summary()` lists totals
    sorted by time."""

    def __init__(self):
        self._open: dict[str, float] = {}
        self._total = defaultdict(float)
        self._count = defaultdict(int)
        self.enabled = True

    def begin(self, name: str):
        if self.enabled:
            _sync()
            self._open[name] = time.perf_counter()

    def end(self, name: str):
        if not self.enabled or name not in self._open:
            return
        _sync()
        dt = time.perf_counter() - self._open.pop(name)
        self._total[name] += dt
        self._count[name] += 1

    def summary(self) -> str:
        rows = sorted(self._total.items(), key=lambda kv: -kv[1])
        lines = [f"{'phase':<28} {'total ms':>10} {'count':>7} {'avg ms':>9}"]
        for name, tot in rows:
            c = self._count[name]
            lines.append(f"{name:<28} {tot*1e3:>10.1f} {c:>7} "
                         f"{tot*1e3/c:>9.2f}")
        return "\n".join(lines)


PROFILER = Profiler()
PROFILER.enabled = False  # opt in via the CLI's -v


def device_memory_report() -> str:
    """Device memory in use, reserved and at peak, per visible card."""
    if not torch.cuda.is_available():
        return "cuda: not available"
    lines = []
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        gib = 1 << 30
        used = st.get("allocated_bytes.all.current", 0) / gib
        reserved = st.get("reserved_bytes.all.current", 0) / gib
        peak = st.get("allocated_bytes.all.peak", 0) / gib
        total = torch.cuda.get_device_properties(i).total_memory / gib
        lines.append(f"cuda:{i} {torch.cuda.get_device_name(i)}: "
                     f"{used:.2f} GiB allocated, {reserved:.2f} reserved, "
                     f"{total:.2f} total (peak {peak:.2f})")
    return "\n".join(lines)
