"""Data-parallel (and DP x TP) sharding of the batched decode step: the
multi-device serving path of the continuous-batching server.

Port of ntransformer_tpu/parallel/dp.py. Plan over a (dp, tp) mesh
(parallel/multihost.make_mesh):

  batch slots : split over dp in contiguous blocks; dp group g serves slots
                [g * B/dp, (g+1) * B/dp) with no exchange between groups;
  weights     : replicated over dp, Megatron-split over tp
                (parallel/tp.shard_weights), placed once per distinct
                (device, tp index): groups on one card share the tensors
                (at tp = 1 the weights are moved whole, so on their own
                device nothing is copied and a mixture-of-experts model
                serves too);
  batched KV  : one contiguous BatchedKV [L, B/dp, Hkv/tp, S, D] per (dp,
                tp) position on its device (the append kernel refuses a view
                sliced out of a larger cache);
  logits      : each group's [B/dp, V] gathered as [B, V] in slot order on
                the mesh's first device of this process.

One process drives every position it owns; a group's step is the unsharded
models/batched.py step at tp = 1 (the same kernels and plans as serving the
group's slots alone) and the TP form (batched_decode_step_tp) past it. The
groups run one after another on the host; on separate cards their kernels
overlap, since nothing waits on a card until the logits are gathered.

Each group's step replays a captured program (the JAX package's one
jitted shard_map step, as one CUDA graph a group on one card, a
models/graphs.CardGraph over several): group_graphs binds a
models/graphs.StepGraphs to each group's caches and weights, and the
sharded steps replay them; the gather of the groups' logits in slot order
stays outside the graphs. A mesh over several processes replays where the
processes run over NCCL, a row across them with its collectives inside
each process's graphs; over gloo, which stages collectives through host
memory (models/graphs.check_capturable), it keeps the host path, by the
explicit check of group_graphs.
"""
from __future__ import annotations

import dataclasses

from ..models.batched import (BatchedKV, batched_decode_step,
                              batched_decode_step_tp, batched_verify_step,
                              batched_verify_step_tp)
from ..models.graphs import StepGraphs, one_card
from ..models.llama import (Arch, LayerWeights, ModelWeights,
                            fuse_layer_weights)
from ..ops.linear import QLinear
from .multihost import Mesh, gather_groups
from .tp import FUSED, local_arch, shard_weights


def group_size(mesh: Mesh, batch: int) -> int:
    """Slots per dp group; a batch that does not divide over dp is
    refused."""
    if batch % mesh.dp:
        raise ValueError(f"batch size {batch} does not divide over "
                         f"dp={mesh.dp}")
    return batch // mesh.dp


def shard_server_state(mesh: Mesh, arch: Arch, weights: ModelWeights,
                       batch: int, quant: bool = False, with_kv: bool = True,
                       fuse: bool = False) -> tuple[list, list | None]:
    """Place the weights and (with_kv) the dp groups' batched caches.
    Returns ([dp][tp] ModelWeights, [dp][tp] BatchedKV or None), None at
    the positions of other processes. Shards on the same device at the
    same tp index are one object; fuse as in shard_weights."""
    group_size(mesh, batch)
    placed = {}
    grid = []
    for g in range(mesh.dp):
        row = mesh.row(g)
        need = [s for s in row.owned if (row[s], s) not in placed]
        if need and mesh.tp == 1:
            placed[(row[0], 0)] = replicate(weights, row[0], fuse)
        elif need:
            got = shard_weights(weights, row, arch, fuse=fuse, only=need)
            placed.update({(row[s], s): got[s] for s in need})
        grid.append([placed[(row[s], s)] if s in row.owned else None
                     for s in range(mesh.tp)])
    if not with_kv:
        return grid, None
    return grid, make_server_kv(mesh, arch, batch, quant)


def _move(v, dev):
    if isinstance(v, QLinear):
        return QLinear(v.dtype, v.k, v.n,
                       {nm: a.to(dev) for nm, a in v.planes.items()})
    return None if v is None else v.to(dev)


def replicate(weights: ModelWeights, dev, fuse: bool = False
              ) -> ModelWeights:
    """The whole weights on dev (a tensor already there is not copied; a
    tied head stays the embedding's object); fuse builds the fused q|k|v
    and gate|up of unfused weights."""
    lw = weights.layers
    if lw is not None:
        lw = LayerWeights(**{f.name: _move(getattr(lw, f.name), dev)
                             for f in dataclasses.fields(lw)})
        if fuse and all(getattr(lw, nm) is None for nm in FUSED):
            lw = fuse_layer_weights(lw)
    embed = _move(weights.embed, dev)
    tied = weights.lm_head is weights.embed
    return ModelWeights(embed=embed, layers=lw,
                        output_norm=weights.output_norm.to(dev),
                        lm_head=embed if tied
                        else _move(weights.lm_head, dev),
                        rope_cos=weights.rope_cos.to(dev),
                        rope_sin=weights.rope_sin.to(dev))


def make_server_kv(mesh: Mesh, arch: Arch, batch: int,
                   quant: bool = False) -> list:
    """[dp][tp] BatchedKV of B/dp slots and Hkv/tp heads, each created on
    its own device (None at another process's position)."""
    per = group_size(mesh, batch)
    local = local_arch(arch, mesh.tp)
    out = []
    for g in range(mesh.dp):
        row = mesh.row(g)
        out.append([BatchedKV.create(local, per, quant=quant, device=d)
                    if s in row.owned else None for s, d in enumerate(row)])
    return out


def insert_slot(mesh: Mesh, bkv: list, kv: list, slot: int, batch: int):
    """Copy an admission's per-shard caches (kv, one KVCache a tp index,
    None where another process holds it) into batch slot `slot`, in place:
    into the caches of the dp group that owns the slot."""
    per = group_size(mesh, batch)
    g, local = divmod(slot, per)
    for s, c in enumerate(bkv[g]):
        if c is not None:
            c.insert(local, kv[s])
    return bkv


def captured(mesh: Mesh) -> bool:
    """Whether the mesh's group steps can replay captured programs
    (models/graphs.check_capturable): the groups this process drives, on
    one card or several, a row's shards in this process or in NCCL
    processes, unless the mesh spans processes over another backend than
    NCCL (gloo stages collectives through host memory)."""
    return one_card(mesh)


def group_graphs(mesh: Mesh, arch: Arch, weights: list, kv: list) -> list:
    """One StepGraphs a dp group this process drives, bound to that group's
    caches and weights (kv[g], weights[g]: the unsharded step at tp = 1,
    the TP row's step past it), None for another process's group. The mesh
    must be captured(mesh) (ValueError otherwise)."""
    if not captured(mesh):
        raise ValueError("the mesh's group steps keep the host path: the "
                         "processes run over gloo, or a position is not "
                         "a CUDA card")
    out = []
    for g in range(mesh.dp):
        if not mesh.touches(g):
            out.append(None)
        elif mesh.tp == 1:
            out.append(StepGraphs(arch, weights[g][0], kv[g][0]))
        else:
            out.append(StepGraphs(arch, weights[g], kv[g], mesh.row(g)))
    return out


def _sharded(mesh: Mesh, run_one, run_tp, kind: str = "decode",
             n_layers: int | None = None, dot_impl: str = "f32",
             graphs: list | None = None):
    """The step over every dp group this process drives: group g's slots
    through run_one (tp = 1) or run_tp, or with graphs (group_graphs') a
    replay of group g's StepGraphs of `kind`, the logits gathered in slot
    order on the mesh's first device of this process."""
    home = mesh.home

    def step(weights, kv, tokens, pos, active):
        per = group_size(mesh, len(pos))
        parts = []
        for g in range(mesh.dp):
            if not mesh.touches(g):
                parts.append(None)
                continue
            sl = slice(g * per, (g + 1) * per)
            args = (tokens[sl], pos[sl], active[sl])
            if graphs is not None:
                parts.append(graphs[g].run(
                    kv[g][0] if mesh.tp == 1 else kv[g], kind, *args,
                    n_layers=n_layers, dot_impl=dot_impl))
                continue
            if mesh.tp == 1:
                logits, _ = run_one(weights[g][0], kv[g][0], *args)
            else:
                logits, _ = run_tp(weights[g], kv[g], *args, mesh.row(g))
            parts.append(logits)
        return gather_groups(parts, mesh, home), kv
    return step


def make_batched_decode_sharded(mesh: Mesh, arch: Arch,
                                dot_impl: str = "f32",
                                n_layers: int | None = None,
                                graphs: list | None = None):
    """step(weights, kv, tokens, pos, active) -> (logits [B, V], kv) over
    the mesh (weights and kv from shard_server_state / make_server_kv;
    tokens, pos, active [B] tensors). The batch must divide over dp.
    n_layers: the draft step through the first n layers. graphs: the
    group_graphs of (weights, kv), whose replays then take each group's
    step (kv must be the caches they are bound to)."""
    return _sharded(
        mesh,
        lambda w, kv, t, p, a: batched_decode_step(
            arch, w, kv, t, p, a, n_layers=n_layers, dot_impl=dot_impl),
        lambda w, kv, t, p, a, row: batched_decode_step_tp(
            arch, w, kv, t, p, a, row, n_layers=n_layers,
            dot_impl=dot_impl),
        "decode" if n_layers is None else "draft", n_layers, dot_impl,
        graphs)


def make_batched_draft_sharded(mesh: Mesh, arch: Arch, n_layers: int,
                               dot_impl: str = "f32",
                               graphs: list | None = None):
    """The sharded draft step of speculative serving: the decode step
    through the first n_layers layers."""
    return make_batched_decode_sharded(mesh, arch, dot_impl, n_layers,
                                       graphs)


def make_batched_verify_sharded(mesh: Mesh, arch: Arch,
                                dot_impl: str = "f32",
                                graphs: list | None = None):
    """The sharded verify window: tokens [B, K+1] split over dp with the
    slots; logits come back [B, K+1, V] in slot order."""
    return _sharded(
        mesh,
        lambda w, kv, t, p, a: batched_verify_step(
            arch, w, kv, t, p, a, dot_impl=dot_impl),
        lambda w, kv, t, p, a, row: batched_verify_step_tp(
            arch, w, kv, t, p, a, row, dot_impl=dot_impl),
        "verify", None, dot_impl, graphs)
