"""The phase profiler and the device memory report (PyTorch).

Port of ntransformer_tpu/utils/timing.py. PyTorch returns before the card
finishes, so a phase begins and ends with `torch.cuda.synchronize()` when
CUDA is in use; otherwise a phase would time the enqueue, not the work. A
phase with sync=False times host work only (the streamer's waits, which must
not drain the card), and `record_copy` keeps a pair of CUDA events around a
copy on another stream until the copy completes, then adds its bytes and
device time to running totals.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from contextlib import contextmanager

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
        self._copies = defaultdict(deque)  # name -> [(start, end, nbytes)]
        self._copy_total = defaultdict(lambda: [0, 0, 0.0])  # n, bytes, ms
        self.enabled = True

    def begin(self, name: str, sync: bool = True):
        if self.enabled:
            if sync:
                _sync()
            self._open[name] = time.perf_counter()

    def end(self, name: str, sync: bool = True):
        if not self.enabled or name not in self._open:
            return
        if sync:
            _sync()
        dt = time.perf_counter() - self._open.pop(name)
        self._total[name] += dt
        self._count[name] += 1

    @contextmanager
    def phase(self, name: str, sync: bool = True):
        self.begin(name, sync)
        try:
            yield
        finally:
            self.end(name, sync)

    def record_copy(self, name: str, start, end, nbytes: int):
        """A copy of nbytes between two recorded CUDA events (timing
        events); read in copy_stats. Copies that have completed are folded
        into running totals here, so only those in flight keep events."""
        if self.enabled:
            self._copies[name].append((start, end, nbytes))
            self._fold(name)

    def _fold(self, name: str) -> None:
        """Move the completed copies of `name` (one stream: they complete
        in order) from the pending events into the totals."""
        pending, tot = self._copies[name], self._copy_total[name]
        while pending and pending[0][1].query():
            s, e, n = pending.popleft()
            tot[0] += 1
            tot[1] += n
            tot[2] += s.elapsed_time(e)

    def copy_stats(self, name: str) -> tuple[int, int, float]:
        """(copies, bytes, device ms) of the copies recorded under `name`
        (waits for them)."""
        pending = self._copies.get(name)
        if pending:
            pending[-1][1].synchronize()
            self._fold(name)
        n, nb, ms = self._copy_total.get(name, (0, 0, 0.0))
        return n, nb, ms

    def reset(self):
        self._open.clear()
        self._total.clear()
        self._count.clear()
        self._copies.clear()
        self._copy_total.clear()

    def summary(self) -> str:
        rows = sorted(self._total.items(), key=lambda kv: -kv[1])
        lines = [f"{'phase':<28} {'total ms':>10} {'count':>7} {'avg ms':>9}"]
        for name, tot in rows:
            c = self._count[name]
            lines.append(f"{name:<28} {tot*1e3:>10.1f} {c:>7} "
                         f"{tot*1e3/c:>9.2f}")
        for name in sorted(self._copies):
            n, nb, ms = self.copy_stats(name)
            if not n:
                continue
            rate = nb / ms / 1e6 if ms else 0.0
            lines.append(f"{name:<28} {ms:>10.1f} {n:>7} {ms / n:>9.2f}  "
                         f"(device, {nb / 1e9:.2f} GB at {rate:.1f} GB/s)")
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
