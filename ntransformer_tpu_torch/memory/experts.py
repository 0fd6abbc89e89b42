"""(layer, expert) streaming for tiered mixture-of-experts decode (PyTorch +
CUDA).

Port of ntransformer_tpu/memory/experts.py. A dense streamer moves whole
layers; an MoE layer uses k of its E experts a token, so the streaming unit
here is one expert's weight set {w_gate, w_up, w_down}:

  card: an LRU of `hbm_slots` expert sets, each one device buffer of the
        expert's pack bytes with its planes as views (memory/pack.expert_views)
  RAM:  whole-layer pack blobs read once into page-locked (pinned), 4096-
        aligned host buffers; an expert is a slice of its layer's blob
  disk: one expert's 4096-aligned sub-range of the pack, read with O_DIRECT
        (memory/native.py) into one of a ring of pinned staging buffers

  prefetch_token_start  every layer's experts of the last token: RAM
                        experts start their host -> device copy on the copy
                        stream, disk experts start their read on a worker
  get(layer, e)         a cached set (the compute stream waits for its copy
                        event), a prefetched disk read landing now, or a
                        demand load (a miss: the router names the expert only
                        after the layer's attention, so nothing hides it)
  note(layer, ids)      this token's routing: the next token's prediction

Copies run on one copy stream and are ordered by events: the compute stream
waits on a set's `ready` event before its kernels read it, and a staging
buffer is reused only after the event of the copy that last read it. A
device buffer is allocated on the copy stream, which writes it, and every
stream that reads it is recorded on it (`record_stream` in `get`): the
caching allocator hands an evicted set's memory to the next copy only
after the kernels queued on those streams before the eviction finished,
so a copy never overwrites a set that queued work still reads.
Nothing here reads a device value to the host; the one synchronization of
a tiered MoE decode step is the router's k ids (models/tiered_moe.py).

On CPU tensors (device="cpu", the tests) the same protocol runs with plain
copies and no events; there is nothing to pin.
"""
from __future__ import annotations

import sys
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from .native import DIRECT_ALIGN, StagePool, aligned_empty
from .pack import PackReader, expert_views


def _round_up(n: int) -> int:
    return (n + DIRECT_ALIGN - 1) // DIRECT_ALIGN * DIRECT_ALIGN


@dataclass
class _Stage:
    """A pinned staging buffer of the disk tier."""

    host: np.ndarray
    host_t: torch.Tensor
    key: tuple | None = None   # the expert whose read it holds
    job: object = None         # the StagePool read in flight
    read_by: object = None     # the event of the copy that last read it


@dataclass
class _Entry:
    weights: dict              # {w_gate, w_up, w_down} QLinears on device
    buf: torch.Tensor          # the device bytes the weights view
    ready: object = None       # the event after its host -> device copy


class ExpertStreamer:
    """Serves (layer, expert) weight sets ({w_gate, w_up, w_down} QLinears on
    `device`) through an LRU of `hbm_slots` sets backed by RAM and disk
    tiers. ram_layers: the layers whose blobs stay in RAM (default all);
    direct_io: reads bypass the page cache where O_DIRECT allows;
    n_stage: pinned staging buffers of the disk tier (default 4)."""

    def __init__(self, pack: PackReader, layers, *, hbm_slots: int,
                 ram_layers=None, device="cuda", direct_io: bool = True,
                 n_threads: int = 8, n_stage: int | None = None):
        self.pack = pack
        self.layers = list(layers)
        self.hbm_slots = max(int(hbm_slots), 1)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.direct_io = direct_io
        self.pool = StagePool(n_threads)
        self.copy_stream = torch.cuda.Stream(self.device) if self.cuda \
            else None
        self._pinned: list[int] = []
        ram = set(ram_layers if ram_layers is not None else self.layers)
        # RAM tier: whole-layer blobs (parallel chunked reads)
        self.ram_blobs: dict[int, torch.Tensor] = {}
        blobs, jobs = {}, []
        for layer in self.layers:
            if layer not in ram:
                continue
            size = pack.layer_nbytes(layer)
            blobs[layer] = aligned_empty(_round_up(size))
            jobs.append(self.pool.read(pack.path,
                                       pack.layer_meta(layer)["offset"],
                                       size, blobs[layer], direct=direct_io))
        for j in jobs:
            self.pool.wait(j)
        for layer, blob in blobs.items():
            self._pin(blob)
            self.ram_blobs[layer] = torch.from_numpy(blob)
        # disk tier: the staging ring, sized to the largest expert
        disk = [layer for layer in self.layers if layer not in ram]
        self.stages: list[_Stage] = []
        if disk:
            biggest = max(pack.expert_nbytes(layer, e) for layer in disk
                          for e in range(pack.n_experts(layer)))
            for _ in range(n_stage or 4):
                host = aligned_empty(_round_up(biggest))
                self._pin(host)
                self.stages.append(_Stage(host, torch.from_numpy(host)))
        self._cache: OrderedDict[tuple[int, int], _Entry] = OrderedDict()
        # disk reads started by a prefetch: (layer, e) -> its stage
        self._pending: dict[tuple[int, int], _Stage] = {}
        # last token's routing per layer: the temporal prediction
        self.last_sel: dict[int, list[int]] = {}
        self.hits = self.misses = self.demand_loads = self.prefetches = 0
        self.evictions = self.h2d_bytes = self.disk_bytes = 0
        self.timed = False  # record each copy's events (copy_seconds)
        self.copy_events: list[tuple] = []
        if self.ram_blobs:
            gb = sum(b.numel() for b in self.ram_blobs.values()) / (1 << 30)
            print(f"experts: {len(self.ram_blobs)} layers' experts in "
                  f"{'pinned ' if self.cuda else ''}RAM ({gb:.2f} GiB), "
                  f"{len(disk)} from disk, LRU {self.hbm_slots} sets",
                  file=sys.stderr)

    # -- host memory --------------------------------------------------------
    def _pin(self, a: np.ndarray) -> None:
        """Page-lock `a` (cudaHostRegister) so copies from it are async
        DMA; raises if CUDA refuses."""
        if not self.cuda or a.nbytes == 0:
            return
        err = torch.cuda.cudart().cudaHostRegister(a.ctypes.data, a.nbytes,
                                                   0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {a.nbytes} bytes failed "
                               f"(error {int(err)})")
        self._pinned.append(a.ctypes.data)

    # -- internals ------------------------------------------------------------
    def _free_stage(self, wait: bool) -> _Stage | None:
        """A staging buffer holding no pending read (its last copy waited
        for), or None when every one is pending and `wait` is false. With
        `wait`, the oldest pending prefetch is admitted to free its
        buffer."""
        for st in self.stages:
            if st.key is None:
                if st.read_by is not None:
                    st.read_by.synchronize()
                    st.read_by = None
                return st
        if not wait:
            return None
        key = next(iter(self._pending))
        self._admit(*key)
        return self._free_stage(wait)

    def _start_read(self, layer: int, e: int, st: _Stage) -> None:
        lmeta = self.pack.layer_meta(layer)
        emeta = lmeta["experts"][e]
        st.key = (layer, e)
        st.job = self.pool.read(self.pack.path,
                                lmeta["offset"] + emeta["off"],
                                emeta["size"], st.host,
                                direct=self.direct_io)
        self.disk_bytes += emeta["size"]

    def _source(self, layer: int, e: int):
        """(host bytes of the expert, its stage or None)."""
        emeta = self.pack.expert_meta(layer, e)
        if layer in self.ram_blobs:
            off = emeta["off"]
            return self.ram_blobs[layer][off: off + emeta["size"]], None
        key = (layer, e)
        st = self._pending.pop(key, None)
        if st is None:
            st = self._free_stage(wait=True)
            self._start_read(layer, e, st)
        self.pool.wait(st.job)
        st.job = None
        return st.host_t[: emeta["size"]], st

    def _admit(self, layer: int, e: int) -> _Entry:
        """Copy one expert set to the device (async on the copy stream)
        and put it in the LRU."""
        src, st = self._source(layer, e)
        emeta = self.pack.expert_meta(layer, e)
        size = emeta["size"]
        if self.cuda:
            # allocated on the copy stream, which writes it; the streams
            # that read it are recorded on it in _wait
            with torch.cuda.stream(self.copy_stream):
                buf = torch.empty(size, dtype=torch.uint8,
                                  device=self.device)
                start = (torch.cuda.Event(enable_timing=True)
                         if self.timed else None)
                if start is not None:
                    start.record(self.copy_stream)
                buf.copy_(src, non_blocking=True)
                ready = torch.cuda.Event(enable_timing=self.timed)
                ready.record(self.copy_stream)
            if start is not None:
                self.copy_events.append((start, ready, size))
        else:
            buf, ready = src.clone(), None
        if st is not None:
            st.key, st.read_by = None, ready
        self.h2d_bytes += size
        entry = _Entry(expert_views(buf, emeta, base=emeta["off"]), buf,
                       ready)
        key = (layer, e)
        self._cache[key] = entry
        self._cache.move_to_end(key)
        while len(self._cache) > self.hbm_slots:
            self._cache.popitem(last=False)
            self.evictions += 1
        return entry

    def _wait(self, entry: _Entry) -> dict:
        """The set's weights for the current stream: it waits for their
        copy, and their memory is not reused before its work queued so far
        (at the set's eviction) has run."""
        if entry.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(entry.ready)
            entry.buf.record_stream(stream)
        return entry.weights

    # -- API --------------------------------------------------------------------
    def prefetch_token_start(self) -> None:
        """Start loading every layer's predicted experts (the last token's
        set): RAM experts copy on the copy stream, disk experts start their
        read (a prediction that finds no free staging buffer waits for its
        get)."""
        for layer in self.layers:
            for e in self.last_sel.get(layer, ()):
                key = (layer, e)
                if key in self._cache:
                    self._cache.move_to_end(key)
                    continue
                if key in self._pending:
                    continue
                if layer in self.ram_blobs:
                    self._admit(layer, e)
                else:
                    st = self._free_stage(wait=False)
                    if st is None:
                        continue
                    self._start_read(layer, e, st)
                    self._pending[key] = st
                self.prefetches += 1

    def get(self, layer: int, e: int) -> dict:
        """The expert's weights on the device (the compute stream ordered
        after their copy); counts prediction hits and misses."""
        key = (layer, e)
        entry = self._cache.get(key)
        if entry is not None:
            self.hits += 1
            self._cache.move_to_end(key)
            return self._wait(entry)
        if key in self._pending:
            self.hits += 1  # the disk prefetch lands now
        else:
            self.misses += 1
            self.demand_loads += 1
        return self._wait(self._admit(layer, e))

    def note(self, layer: int, expert_ids) -> None:
        """Record this token's routing for the next token's prefetch."""
        self.last_sel[layer] = [int(x) for x in expert_ids]

    def copy_seconds(self) -> float:
        """Seconds the copy stream spent on the timed copies (timed=True)
        since the last reset; synchronizes on them."""
        total = 0.0
        for start, end, _ in self.copy_events:
            end.synchronize()
            total += start.elapsed_time(end) / 1e3
        return total

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "demand_loads": self.demand_loads,
                "prefetches": self.prefetches,
                "hit_rate": self.hits / total if total else 0.0,
                "cached": len(self._cache), "slots": self.hbm_slots,
                "evictions": self.evictions, "h2d_bytes": self.h2d_bytes,
                "disk_bytes": self.disk_bytes}

    def reset_stats(self) -> None:
        self.hits = self.misses = self.demand_loads = self.prefetches = 0
        self.evictions = self.h2d_bytes = self.disk_bytes = 0
        self.copy_events = []
        self.pool.direct_reads = self.pool.buffered_reads = 0

    def close(self) -> None:
        """Drain the pending reads and copies, then release the pinned host
        memory and the pool."""
        for st in self.stages:
            if st.job is not None:
                self.pool.wait(st.job)
                st.job = None
        self._pending.clear()
        if self.cuda:
            torch.cuda.synchronize(self.device)
            cudart = torch.cuda.cudart()
            for ptr in self._pinned:
                cudart.cudaHostUnregister(ptr)
        self._pinned.clear()
        self._cache.clear()
        self.pool.close()
