"""Context parallelism: the KV cache split along the SEQUENCE axis.

Port of ntransformer_tpu/parallel/cp.py. A context too large for one card's
memory splits its cache over shards: shard i holds global positions
[i * S/n, (i+1) * S/n) of every layer, and each step runs each shard's
attention partials over its slice and combines them exactly
(ops/layers.py attention_cp*).

One process drives every shard, as JAX's single controller drives a mesh. A
mesh is a tuple of torch devices, one per shard, in which a device may
repeat: the counterpart of XLA's virtual host devices (four shards on one
card; on a host with four cards, one shard on each). The work JAX
replicates on every device (embedding, norms, the quantized matmuls, the LM
head) runs once, on the mesh's first device, where the weights live; only
the cache slices and the attention partials live per shard, q and the new
k/v rows copied to the shards' devices and the partials copied back
(`forward(..., cp=mesh)` in models/llama.py). On one card nothing is
copied.

CP x TP (make_cp_tp_mesh): a (cp, tp) mesh of cp rows of tp devices, TP
innermost. The weights are Megatron-split over tp (parallel/tp.py) and live
on the first row; the cache splits over both axes, heads on tp and the
sequence on cp, each [L, Hkv/tp, S/cp, D] slice on its own device, so a
long context divides its cache over the whole mesh while every product
still runs tp-wide. Each TP shard's attention runs as CP over its column of
slices; the int8 cache stays refused, as CP refuses it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.llama import Arch, KVCache
from .tp import entry_mesh, local_arch, make_mesh_of


def make_cp_mesh(n: int, devices=None) -> tuple[torch.device, ...]:
    """The first n of `devices` as a CP mesh; by default the first n CUDA
    devices. Raises if there are fewer (a list given may repeat a device)."""
    return make_mesh_of("CP", n, devices)


def shard_rows(arch: Arch, n: int) -> int:
    """Cache rows per shard of an n-way split, or ValueError."""
    if arch.max_seq_len % n:
        raise ValueError(f"max_seq_len {arch.max_seq_len} does not split "
                         f"into {n} equal shards")
    return arch.max_seq_len // n


def make_cp_kv(arch: Arch, mesh) -> list[KVCache]:
    """The bf16 cache of an n-way CP mesh: shard i's [L, Hkv, S/n, D] slice
    created on its own device (never a whole cache that is then split)."""
    local = dataclasses.replace(arch, max_seq_len=shard_rows(arch, len(mesh)))
    return [KVCache.create(local, device=d) for d in mesh]


def make_cp_tp_mesh(cp: int, tp: int, devices=None) -> tuple:
    """A (cp, tp) mesh: cp rows of tp devices, TP innermost, from the first
    cp * tp of `devices` (by default the first cp * tp CUDA devices; raises
    if there are fewer; a list given may repeat a device)."""
    flat = make_mesh_of("CP x TP", cp * tp, devices)
    return tuple(flat[c * tp:(c + 1) * tp] for c in range(cp))


def cp_tp_mesh(cp: int, tp: int, device="cuda") -> tuple:
    """The (cp, tp) mesh the entry points place their positions on
    (tp.entry_mesh: one a card for "cuda", all on a device with an index or
    "cpu")."""
    return entry_mesh(lambda n, devices=None: make_cp_tp_mesh(cp, tp,
                                                              devices),
                      cp * tp, device)


def make_cp_tp_kv(arch: Arch, mesh) -> list[list[KVCache]]:
    """The bf16 cache of a (cp, tp) mesh as a [tp][cp] grid: TP shard s's
    heads, CP slice c's rows, [L, Hkv/tp, S/cp, D] created on mesh[c][s]
    (never a whole cache that is then split)."""
    tp = len(mesh[0])
    local = dataclasses.replace(local_arch(arch, tp),
                                max_seq_len=shard_rows(arch, len(mesh)))
    return [[KVCache.create(local, device=row[s]) for row in mesh]
            for s in range(tp)]

