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
copied. Tensor parallelism (parallel/tp.py) runs on its own, with the int8
cache that CP refuses; the JAX package's CP x TP compose is ROADMAP queue 1
item 14d.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.llama import Arch, KVCache
from ..models.loader import resolve_device


def make_cp_mesh(n: int, devices=None) -> tuple[torch.device, ...]:
    """The first n of `devices` as a CP mesh; by default the first n CUDA
    devices. Raises if there are fewer (a list given may repeat a device)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n < 1 or len(devices) < n:
        raise ValueError(f"a {n}-way CP mesh needs {n} devices; "
                         f"{len(devices)} given")
    return tuple(devices[:n])


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
