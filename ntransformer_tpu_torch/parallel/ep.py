"""Expert parallelism: the expert planes of a mixture-of-experts model split
on their expert axis.

Port of ntransformer_tpu/parallel/ep.py. The plan:

  w_{gate,up,down}_exps : each stacked [L, E, rows, N] plane split on E:
                          shard s holds experts [s*E/ep, (s+1)*E/ep) as one
                          contiguous [L, E/ep, rows, N] plane on its device
                          (the split never touches rows or lanes, so every
                          format's layout holds unchanged);
  router, attention, norms, embedding, LM head, KV cache: once, on the
                          mesh's first device (JAX replicates them on every
                          shard and computes them there redundantly).

One process drives every shard, as in parallel/cp.py and parallel/tp.py: a
mesh is a tuple of torch devices in which a device may repeat (two shards
on one card; on a host with several cards, one shard on each).
`forward(..., ep=mesh)` in models/llama.py runs each MoE layer's experts
shard by shard (moe_ffn): at T = 1 each shard runs the k routed experts
masked to its own range, a selection that another shard holds running the
clamped local expert at weight 0, all of it on the device; at T > 1 each
shard runs the dense loop over its E/ep experts. The shards' outputs are
summed in shard order on the first device, where JAX psums once a MoE
layer.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.llama import Arch, ModelWeights
from ..ops.linear import QLinear
from .dp import replicate
from .tp import entry_mesh, make_mesh_of

EXPERT_FIELDS = ("w_gate_exps", "w_up_exps", "w_down_exps")


def make_ep_mesh(n: int, devices=None) -> tuple[torch.device, ...]:
    """The first n of `devices` as an EP mesh; by default the first n CUDA
    devices (raises without CUDA). Raises if there are fewer (a list given
    may repeat a device)."""
    return make_mesh_of("EP", n, devices)


def ep_mesh(n: int, device="cuda") -> tuple[torch.device, ...]:
    """The mesh the entry points place n shards on (tp.entry_mesh)."""
    return entry_mesh(make_ep_mesh, n, device)


def _check_moe(weights: ModelWeights) -> None:
    lw = weights.layers
    if lw is None or lw.ffn_gate_inp is None:
        raise ValueError("expert parallelism needs a mixture-of-experts "
                         "model")


def weight_specs_ep(weights: ModelWeights) -> dict[str, str]:
    """The plan as a plain description: {field: "expert" | "replicate"} for
    every tensor the weights hold ("layers.w_gate_exps", "embed", ...).
    Raises for a dense model."""
    _check_moe(weights)
    specs = {"embed": "replicate", "lm_head": "replicate",
             "output_norm": "replicate", "rope_cos": "replicate",
             "rope_sin": "replicate"}
    lw = weights.layers
    for f in dataclasses.fields(lw):
        if getattr(lw, f.name) is not None:
            specs["layers." + f.name] = ("expert" if f.name in EXPERT_FIELDS
                                         else "replicate")
    return specs


def _expert_slice(a: torch.Tensor, s: int, e_local: int, dev) -> torch.Tensor:
    """Shard s's experts of a [..., E, rows, N] plane, one contiguous copy
    on dev."""
    part = a.narrow(-3, s * e_local, e_local)
    return torch.empty(part.shape, dtype=part.dtype,
                       device=dev).copy_(part)


def shard_weights_ep(weights: ModelWeights, mesh, arch: Arch
                     ) -> list[ModelWeights]:
    """One ModelWeights per shard of `mesh` with the plan above. Every
    shard's object holds its own expert planes on its device and the same
    replicated tensors, placed once on the mesh's first device (a tensor
    already there is not copied; a tied head stays the embedding's object).
    The planes are split one at a time, and each unsharded plane is dropped
    from `weights` once its shards exist, so the peak is the model plus one
    plane: a model on the card is split in place, and `weights`' expert
    matrices are left without planes."""
    _check_moe(weights)
    ep = len(mesh)
    if arch.n_experts % ep:
        raise ValueError(f"{arch.n_experts} experts do not divide over {ep} "
                         "EP shards")
    mesh = [torch.device(d) for d in mesh]
    lw = weights.layers
    rest = dataclasses.replace(
        weights, layers=dataclasses.replace(
            lw, **{f: None for f in EXPERT_FIELDS}))
    base = replicate(rest, mesh[0])
    e_local = arch.n_experts // ep
    experts = [{} for _ in mesh]
    for f in EXPERT_FIELDS:
        ql = getattr(lw, f)
        planes = [{} for _ in mesh]
        for nm in list(ql.planes):
            for s, dev in enumerate(mesh):
                planes[s][nm] = _expert_slice(ql.planes[nm], s, e_local, dev)
            del ql.planes[nm]
        for s in range(ep):
            experts[s][f] = QLinear(ql.dtype, ql.k, ql.n, planes[s])
    return [dataclasses.replace(
        base, layers=dataclasses.replace(base.layers, **experts[s]))
        for s in range(ep)]
