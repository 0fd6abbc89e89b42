"""Pipeline parallelism (PP) for the batched decode step.

Port of ntransformer_tpu/parallel/pp.py. The plan over S stages (L % S ==
0) and M microbatches of B/M sequences (B % M == 0):

  layer-stacked weights [L, ...] : stage s holds layers [s*L/S, (s+1)*L/S)
                                   on its device (a free view of the
                                   stacked planes where the stage's device
                                   is theirs, a copy elsewhere);
  batched KV                     : one contiguous BatchedKV [L/S, B/M, Hkv,
                                   S, D] per (stage, microbatch) on the
                                   stage's device (batched flash and the
                                   append kernel refuse a view sliced out of
                                   a larger cache, as in parallel/dp.py);
  embedding, final norm, LM head, rope tables: once, on the mesh's first
                                   device; the head serves the last stage.

One process drives every stage, as in parallel/cp.py: a mesh is a tuple of
torch devices in which a device may repeat. pp_decode_step runs GPipe's
schedule on the host: in tick t = 0 .. S+M-2 every stage s with
0 <= t-s < M runs its layers over microbatch m = t-s (stage 0 embeds it
first; the [B/M, H] activation then moves to stage s+1's device), and the
last stage's output goes through the final norm and the head once per
microbatch. JAX runs every stage in every tick, a bubble with its slots
inactive, and the head in each; here a bubble runs nothing, and the logits
are the same. Launches follow tick order, so on separate cards stage s+1's
kernels on microbatch m overlap stage s's on m+1.

make_pp_decode is the JAX make_pp_decode's form: all S + M - 1 ticks as
one program, on a CUDA card with every stage on it one CUDA graph of
pp_decode_step over static tokens, pos and active, replayed each step.

A stage's layer loop is models/batched.py's over the stage's local arch
(n_layers = L/S): each microbatch's logits and cache are those of the
unsharded step over its slots alone. Sliding-window families are refused,
as in the JAX package: layer_window keys on the global layer index while a
stage indexes its weights locally.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..models.batched import (BatchedKV, _head, _rope_rows, _run_layers,
                              _vec, resolve_impl)
from ..models.llama import Arch, LayerWeights, ModelWeights
from ..ops.linear import QLinear, embed_lookup
from .dp import replicate
from .tp import make_mesh_of


def make_pp_mesh(n: int, devices=None) -> tuple[torch.device, ...]:
    """The first n of `devices` as a PP mesh, one stage each; by default
    the first n CUDA devices (raises without CUDA). Raises if there are
    fewer (a list given may repeat a device)."""
    return make_mesh_of("PP", n, devices)


@dataclass
class PPState:
    """The placed state of a PP mesh: `arch` a stage's (n_layers = L/S);
    stages[s] stage s's ModelWeights (its layers on its device, the
    embedding, head, final norm and rope the mesh's first device's, shared);
    kv[s][m] the cache of stage s's layers for microbatch m."""

    arch: Arch
    stages: list
    kv: list


def _check(arch: Arch, n_stages: int) -> None:
    if arch.n_layers % n_stages:
        raise ValueError(f"n_layers {arch.n_layers} not divisible by "
                         f"{n_stages} pp stages")
    if arch.sliding_window:
        raise NotImplementedError(
            "PP v1 refuses sliding-window families: layer_window keys on "
            "the GLOBAL layer index but stages index weights locally — "
            "use TP/DP (or tiered streaming) for gemma2/3, or thread the "
            "global index through the stage step first")


def _micro(batch: int, n_micro: int) -> int:
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by {n_micro} "
                         "microbatches")
    return batch // n_micro


def _slice(v, lo: int, n: int, dev):
    if v is None:
        return None
    if isinstance(v, QLinear):
        return QLinear(v.dtype, v.k, v.n, {nm: a[lo:lo + n].to(dev)
                                           for nm, a in v.planes.items()})
    return v[lo:lo + n].to(dev)


def _stage_layers(lw: LayerWeights, s: int, n: int, dev) -> LayerWeights:
    """Layers [s*n, (s+1)*n) of stacked weights on dev."""
    return LayerWeights(**{f.name: _slice(getattr(lw, f.name), s * n, n, dev)
                           for f in dataclasses.fields(lw)})


def shard_pp_state(mesh, arch: Arch, weights: ModelWeights, batch: int,
                   n_micro: int, quant: bool = False) -> PPState:
    """Place each stage's layers and each (stage, microbatch)'s cache
    (bf16, or int8 with quant=True) by the plan above."""
    mesh = [torch.device(d) for d in mesh]
    n_stages = len(mesh)
    _check(arch, n_stages)
    per = _micro(batch, n_micro)
    local = dataclasses.replace(arch, n_layers=arch.n_layers // n_stages)
    base = replicate(dataclasses.replace(weights, layers=None), mesh[0])
    stages = [dataclasses.replace(base, layers=_stage_layers(
        weights.layers, s, local.n_layers, dev)) for s, dev in enumerate(mesh)]
    kv = [[BatchedKV.create(local, per, quant=quant, device=dev)
           for _ in range(n_micro)] for dev in mesh]
    return PPState(local, stages, kv)


@torch.inference_mode()
def pp_decode_step(mesh, arch: Arch, state: PPState, tokens, pos, active,
                   n_micro: int):
    """One batched decode step over the pipeline (the JAX make_pp_decode's
    step): tokens, pos, active [B] as in models/batched.py
    batched_decode_step, B = n_micro * the microbatch of `state`. The
    caches are written in place. Returns (logits [B, V] f32 on the mesh's
    first device, state)."""
    mesh = [torch.device(d) for d in mesh]
    n_stages, home = len(mesh), mesh[0]
    _check(arch, n_stages)
    tokens = _vec(tokens, home, torch.long).reshape(-1)
    pos = _vec(pos, home, torch.long).reshape(-1)
    active = _vec(active, home, torch.bool).reshape(-1)
    per = _micro(tokens.shape[0], n_micro)
    base = state.stages[0]
    impl, kv_append = resolve_impl(None, None, per, state.kv[0][0].k)
    acts, logits = [None] * n_micro, [None] * n_micro
    for t in range(n_stages + n_micro - 1):
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue                      # a bubble: nothing runs
            dev, sl = mesh[s], slice(m * per, (m + 1) * per)
            if s == 0:
                x = embed_lookup(base.embed, tokens[sl],
                                 out_dtype=torch.float32)
                if arch.embed_scale != 1.0:
                    x = x * arch.embed_scale
            else:
                x = acts[m].to(dev)
            cos_t, sin_t = _rope_rows(base, pos[sl][:, None])
            x = _run_layers(state.arch, state.stages[s], state.kv[s][m], x,
                            pos[sl].to(dev), active[sl].to(dev),
                            cos_t.to(dev), sin_t.to(dev), impl, kv_append,
                            state.arch.n_layers, None, "f32")
            if s == n_stages - 1:
                logits[m] = _head(arch, base, x.to(home))
            else:
                acts[m] = x
    return torch.cat(logits), state


def _graphed(device) -> bool:
    """Whether make_pp_decode's step replays a captured program on
    `device`: iff it is a CUDA device."""
    return torch.device(device).type == "cuda"


def make_pp_decode(mesh, arch: Arch, state: PPState, n_micro: int):
    """The pipelined batched decode step as one program (the JAX
    make_pp_decode: the S + M - 1 GPipe ticks in one jitted scan). Returns
    step(tokens, pos, active) -> logits [B, V] f32, pp_decode_step's
    logits, its caches (state's) written in place.

    With every stage on one CUDA card (models/graphs.check_capturable), the
    first call captures the whole schedule as one CUDA graph (an uncaptured
    warm-up with every slot inactive at position 0, which writes no cache
    row, then the capture on a stream of its own); every call copies its
    inputs into static tokens, pos and active and replays it, and the
    logits are the graph's static output, valid until the next call.
    step.replays counts the replays. A capture that fails raises. Elsewhere
    each call runs pp_decode_step."""
    from ..models import graphs
    from ..ops.cuda import batched_attention
    mesh = tuple(torch.device(d) for d in mesh)
    _check(arch, len(mesh))
    home = mesh[0]

    def direct(tokens, pos, active):
        return pp_decode_step(mesh, arch, state, tokens, pos, active,
                              n_micro)[0]
    if not (_graphed(home) and graphs.one_card(mesh)):
        return direct
    b_n = n_micro * state.kv[0][0].k.shape[1]
    stream = torch.cuda.Stream(home) if home.type == "cuda" else None
    tok = torch.zeros(b_n, dtype=torch.long, device=home)
    pos_s = torch.zeros(b_n, dtype=torch.long, device=home)
    act = torch.zeros(b_n, dtype=torch.bool, device=home)
    held = {}

    @torch.inference_mode()
    def step(tokens, pos, active):
        if "graph" not in held:
            with graphs._on_stream(home, stream):
                for t in (tok, pos_s, act):
                    t.zero_()
                direct(tok, pos_s, act)
                graph = graphs.GRAPH()
                held["out"] = graph.capture(lambda: direct(tok, pos_s, act))
                held["graph"] = graph
            if stream is not None:
                # the batched flash scratch the graph addresses
                held["scratch"] = batched_attention.scratch_buffer(home,
                                                                   stream)
        for dst, src in ((tok, tokens), (pos_s, pos), (act, active)):
            dst.copy_(torch.as_tensor(src).reshape(b_n))
        held["graph"].replay()
        step.replays += 1
        return held["out"]
    step.replays = 0
    return step


def gather_kv(state: PPState, device) -> BatchedKV:
    """The pipeline's caches as one BatchedKV [L, B, ...] on device (stages
    along the layers, microbatches along the slots): a copy, for checks."""
    def cat(name):
        parts = [[getattr(kv, name) for kv in row] for row in state.kv]
        if parts[0][0] is None:
            return None
        return torch.cat([torch.cat([p.to(device) for p in row], dim=1)
                          for row in parts], dim=0)
    return BatchedKV(cat("k"), cat("v"), cat("ks"), cat("vs"))
