"""Tier sizing: how many layers live in device memory, in host RAM and on
disk (PyTorch).

Port of ntransformer_tpu/memory/tiers.py. Tier A is the free device memory
(torch.cuda.mem_get_info) minus a reserve the loader computes from the model
(resident weights, KV cache, streaming slots, workspace) and a margin; tier B
is the host's MemAvailable minus a safety margin; the remaining layers go to
tier C, the disk. Layers are assigned in order.

The JAX package's 16 GiB fallback when the platform reports no memory
statistics is dropped: without CUDA and without an explicit budget there is
nothing to size against, and `compute` raises. Overrides are keyword
arguments; the CLI reads NT_MAX_HBM_LAYERS / NT_MAX_RAM_LAYERS and passes
them on.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

RAM_SAFETY_BYTES = 6 << 30          # left to the OS and the page cache
HBM_MARGIN_BYTES = 512 << 20        # allocator fragmentation and slack


def hbm_free_bytes(device=None) -> int:
    """Free device memory of `device` (the current CUDA device by
    default); raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: tier sizing reads the "
                           "card's free memory; pass hbm_bytes to size "
                           "tiers without one")
    free, _ = torch.cuda.mem_get_info(device)
    return int(free)


def ram_available_bytes() -> int:
    """Host MemAvailable (/proc/meminfo)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30


@dataclass
class TierConfig:
    """Per-tier layer counts. Layers are assigned in order: the first
    n_hbm are resident, the next n_ram stream from host RAM, the rest
    stream from disk."""

    n_hbm: int
    n_ram: int
    n_disk: int

    @property
    def n_layers(self) -> int:
        return self.n_hbm + self.n_ram + self.n_disk

    @property
    def n_streamed(self) -> int:
        return self.n_ram + self.n_disk

    def tier_of(self, layer: int) -> str:
        if layer < self.n_hbm:
            return "hbm"
        if layer < self.n_hbm + self.n_ram:
            return "ram"
        return "disk"

    @classmethod
    def compute(cls, n_layers: int, layer_bytes: int, reserve_bytes: int, *,
                hbm_bytes: int | None = None, ram_bytes: int | None = None,
                max_hbm_layers: int | None = None,
                max_ram_layers: int | None = None,
                ram_layer_bytes: int | None = None) -> "TierConfig":
        """Size the tiers. reserve_bytes: the device memory the model needs
        besides its resident layers (non-layer weights, KV cache, streaming
        slots, workspace). ram_layer_bytes: a layer's RAM cost when it
        differs from its device cost (a tier-B requant shrinks it).
        hbm_bytes / ram_bytes default to the card's free memory and the
        host's available memory."""
        hbm = hbm_free_bytes() if hbm_bytes is None else hbm_bytes
        ram = ram_available_bytes() if ram_bytes is None else ram_bytes

        usable_hbm = max(0, hbm - reserve_bytes - HBM_MARGIN_BYTES)
        n_hbm = min(n_layers, usable_hbm // layer_bytes if layer_bytes
                    else n_layers)
        if max_hbm_layers is not None:
            n_hbm = min(n_hbm, max_hbm_layers)

        rest = n_layers - n_hbm
        usable_ram = max(0, ram - RAM_SAFETY_BYTES)
        rlb = ram_layer_bytes if ram_layer_bytes is not None else layer_bytes
        n_ram = min(rest, usable_ram // rlb if rlb else rest)
        if max_ram_layers is not None:
            n_ram = min(n_ram, max_ram_layers)
        return cls(int(n_hbm), int(n_ram), int(n_layers - n_hbm - n_ram))

    def describe(self, layer_bytes: int) -> str:
        gb = layer_bytes / (1 << 30)
        return (f"tiers: {self.n_hbm} HBM + {self.n_ram} RAM + "
                f"{self.n_disk} disk layers ({gb:.2f} GiB/layer; "
                f"streamed {self.n_streamed * gb:.1f} GiB/token)")
