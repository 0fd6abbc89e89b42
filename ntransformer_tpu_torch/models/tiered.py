"""Tiered model: a device-resident layer prefix plus streamed layers
(PyTorch + CUDA).

Port of ntransformer_tpu/models/tiered.py, one device. The first n_hbm layers
are stacked and resident (tier A), unfused as in the JAX tiered loader; the
rest stream every token from pinned host RAM (tier B) or disk (tier C)
through the two-slot pipeline of memory/streamer.py, compute overlapping the
next layer's host -> device copy. The skip schedule drops streamed layers
(their I/O too), `draft_only` runs the resident prefix alone (the
self-speculative draft, `TieredModel.n_resident` layers), and early exit
stops streaming once a late layer's hidden-state cosine (the previous
layer's, so the check does not stall on the layer just queued) passes the
threshold.

A streamed layer's weights are views into its slot buffer, presented to the
model's layer_step as a stack of one (`layer=0`) with its depth as
`abs_layer` (sliding window, rope table). A mixture-of-experts model
streams (layer, expert) sets instead of layers: `load_model_tiered` and
`forward_tiered` hand it to models/tiered_moe.py.

Over a tensor-parallel mesh (`mesh=`, parallel/tp.py) the resident
prefix, embedding and head are sharded as TPEngine's are, the cache splits
on its heads, and each shard receives its own slice of every streamed
layer (memory/streamer.py stages the slices shard-major on the host);
every layer then runs models/llama.tp_layer_step, so a tiered TP token
runs the kernels and sums of resident TP. The tiers are sized by the bytes
that land on the busiest card (`tier_budget`): with one shard a card a
layer and the fixed reserve divide by tp (the JAX rule); with every shard
on one card that card holds them whole. gemma3 (dual rope tables) and
mixture-of-experts models are refused over a mesh, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass

import torch

from ..core.dtypes import DType
from ..core.gguf import GGUFReader
from ..inference.tokenizer import Tokenizer
from ..memory.pack import PackReader, ensure_pack, requant_layer_meta
from ..memory.streamer import LayerStreamer
from ..memory.tiers import TierConfig, hbm_free_bytes, ram_available_bytes
from ..ops.layers import rope_table
from ..ops.linear import QLinear
from .config import ModelConfig
from .llama import (Arch, KVCache, LayerWeights, ModelWeights, _cosine,
                    embed_positions, head_logits, layer_step, stack_layers,
                    tp_embed_positions, tp_head_logits, tp_layer_step)
from .loader import (load_norm, load_qlinear_host, qlinear_to_device,
                     resolve_device, rope_freq_factors)

WORKSPACE_BYTES = 64 << 20


@dataclass
class TieredKV:
    """KV caches of the resident prefix and of the streamed layers: each an
    int8 (codes, scales) or bf16 KVCache, or None when its tier is empty."""

    res: KVCache | None
    str: KVCache | None

    @classmethod
    def create(cls, arch: Arch, tiers: TierConfig, quant: bool = False,
               device="cuda", mesh=None) -> "TieredKV":
        """mesh: a TP mesh; each tier's cache is then the list of the
        shards' head slices (parallel/tp.make_tp_kv)."""
        from ..parallel.tp import make_tp_kv

        def make(n):
            if not n:
                return None
            a = dataclasses.replace(arch, n_layers=n)
            if mesh is not None:
                return make_tp_kv(a, mesh, quant)
            return KVCache.create(a, quant=quant, device=device)
        return cls(make(tiers.n_hbm), make(tiers.n_streamed))


@dataclass
class TieredModel:
    config: ModelConfig
    arch: Arch
    tiers: TierConfig
    # .layers = stacked [n_hbm] (or None); under TP a list, one a shard
    resident: ModelWeights
    streamer: LayerStreamer | None
    tokenizer: Tokenizer | None
    pack: PackReader
    device: torch.device            # the mesh's first device under TP
    mesh: tuple | None = None       # a TP mesh (parallel/tp.py)

    @property
    def n_resident(self) -> int:
        """Layers resident on the device (the self-speculative draft)."""
        return self.tiers.n_hbm

    def close(self):
        if self.streamer is not None:
            self.streamer.close()


def _map_tensors(lw: LayerWeights, fn) -> LayerWeights:
    """LayerWeights with fn applied to every tensor (planes included)."""
    def one(v):
        if v is None:
            return None
        if isinstance(v, QLinear):
            return QLinear(v.dtype, v.k, v.n,
                           {nm: fn(a) for nm, a in v.planes.items()})
        return fn(v)
    return LayerWeights(**{f.name: one(getattr(lw, f.name))
                           for f in dataclasses.fields(lw)})


def _stack_of_one(lw: LayerWeights) -> LayerWeights:
    """A single layer's weights with a leading axis of 1 (free views)."""
    return _map_tensors(lw, lambda a: a.unsqueeze(0))


def _to_device(lw: LayerWeights, dev) -> LayerWeights:
    return _map_tensors(lw, lambda a: a.to(dev))


@torch.inference_mode()
def forward_tiered(tm: TieredModel, kv: TieredKV, tokens, pos: int, *,
                   n_valid=None, all_logits: bool = False,
                   with_cosine: bool = False,
                   skip: frozenset[int] = frozenset(),
                   draft_only: bool = False,
                   early_exit_threshold: float = 0.0):
    """The tiered forward. tokens [T]; pos: the write offset of the cache;
    skip: layers left out (a skipped streamed layer is not transferred);
    draft_only: the resident prefix only (no streaming I/O);
    early_exit_threshold > 0: stop streaming once a layer at or past
    n_layers / 2 has a hidden-state cosine above it (checked one layer
    late). The caches are written in place. Returns (logits, kv, cosines
    [n_layers] f32 CPU tensor or None; a layer that did not run reads 0).
    A TieredMoEModel runs forward_tiered_moe."""
    from .tiered_moe import TieredMoEModel, forward_tiered_moe
    if isinstance(tm, TieredMoEModel):
        return forward_tiered_moe(
            tm, kv, tokens, pos, n_valid=n_valid, all_logits=all_logits,
            with_cosine=with_cosine, skip=skip, draft_only=draft_only,
            early_exit_threshold=early_exit_threshold)
    arch = tm.arch
    tokens = torch.as_tensor(tokens, device=tm.device).reshape(-1)
    pos = int(pos)
    if tm.mesh is None:
        x, cos_t, sin_t = embed_positions(arch, tm.resident, tokens, pos)
        res_layers = tm.resident.layers

        def step(x, lw, caches, idx, layer, abs_layer=None):
            kk, vv = caches.layer(idx)
            return layer_step(arch, x, lw, kk, vv, pos, cos_t, sin_t,
                              n_valid, layer=layer, abs_layer=abs_layer)
    else:
        arch_l = arch.local_arch(len(tm.mesh))
        x, ropes = tp_embed_positions(arch, tm.resident, tokens, pos)
        res_layers = [w.layers for w in tm.resident]

        def step(x, lws, caches, idx, layer, abs_layer=None):
            return tp_layer_step(arch_l, x, lws,
                                 [c.layer(idx) for c in caches], pos, ropes,
                                 n_valid, layer=layer, abs_layer=abs_layer)
    cos_parts: list[tuple[int, torch.Tensor]] = []
    for i in range(tm.tiers.n_hbm):
        if i in skip:
            continue
        x2 = step(x, res_layers, kv.res, i, i)
        if with_cosine:
            cos_parts.append((i, _cosine(x, x2)))
        x = x2

    s = tm.streamer
    sched = s.schedule(skip) if (s is not None and not draft_only) else []
    if sched:
        s.prefetch_staging(sched[0], 0)
        s.begin_h2d(sched[0], 0)
        if len(sched) > 1:
            s.prefetch_staging(sched[1], 1)
        half = arch.n_layers // 2
        want_cos = with_cosine or early_exit_threshold > 0
        pending = None  # (layer, device scalar) of the previous late layer
        for i, layer in enumerate(sched):
            if (pending is not None and pending[0] >= half
                    and float(pending[1]) > early_exit_threshold):
                break  # the remaining layers' streaming I/O is skipped
            slot = i % 2
            lw = s.get_weights(slot)
            lw = (_stack_of_one(lw) if tm.mesh is None
                  else [_stack_of_one(w) for w in lw])
            if i + 1 < len(sched):
                s.begin_h2d(sched[i + 1], (i + 1) % 2)
            if i + 2 < len(sched):
                s.prefetch_staging(sched[i + 2], slot)
            x2 = step(x, lw, kv.str, layer - s.first, 0, layer)
            cos_l = _cosine(x, x2) if want_cos else None
            x = x2
            s.signal_compute_done(slot)
            if with_cosine:
                cos_parts.append((layer, cos_l))
            if early_exit_threshold > 0 and layer >= half:
                pending = (layer, cos_l)

    if tm.mesh is None:
        logits = head_logits(arch, tm.resident, x, n_valid, all_logits)
    else:
        logits = tp_head_logits(arch, tm.resident, x, n_valid, all_logits)
    cosines = None
    if with_cosine:
        cosines = torch.zeros(arch.n_layers, dtype=torch.float32)
        for layer, c in cos_parts:
            cosines[layer] = float(c)
    return logits, kv, cosines


def kv_cache_bytes(arch: Arch, quant: bool = False) -> int:
    """Device bytes of the full-depth KV cache: bf16 k and v, or int8 codes
    plus one f32 scale per (head, position)."""
    rows = arch.n_layers * arch.n_kv_heads * arch.max_seq_len
    per_row = (arch.head_dim + 4) if quant else arch.head_dim * 2
    return rows * per_row * 2  # k and v


def tier_budget(mesh, layer_bytes: int, fixed_bytes: int) -> tuple[int, int]:
    """(a streamed layer's bytes, the fixed device bytes: non-layer weights
    and cache) that land on the busiest card of a TP mesh (no mesh: as
    given). Each shard holds 1/tp of both, so a card holding c shards
    holds c/tp: with one shard a card the JAX loader's per-shard rule
    (both divided by tp), with every shard on one card the whole."""
    if mesh is None:
        return layer_bytes, fixed_bytes
    tp = len(mesh)
    c = max(list(mesh).count(d) for d in mesh)
    return layer_bytes * c // tp, fixed_bytes * c // tp


def _device_nbytes(ql: QLinear) -> int:
    """Bytes of a host QLinear once placed (a float 'w' plane as bf16)."""
    return sum(a.size * (2 if nm == "w" else a.itemsize)
               for nm, a in ql.planes.items())


def load_model_tiered(path: str, *, max_seq_len: int | None = None,
                      requant: DType | None = None,
                      hbm_bytes: int | None = None,
                      ram_bytes: int | None = None,
                      max_hbm_layers: int | None = None,
                      max_ram_layers: int | None = None,
                      with_tokenizer: bool = True, mesh=None,
                      kv_quant: bool = False,
                      requant_ram: DType | None = None, device="cuda",
                      direct_io: bool = True,
                      h2d: str = "blob",
                      reserve_extra_bytes: int = 0) -> TieredModel:
    """Load a GGUF with HBM / RAM / disk tier assignment (the card by
    default; raises without CUDA unless device="cpu", where the host's
    available memory stands for the device's).

    requant: requantize Q6_K tensors to it in the pack (a second pack file).
    requant_ram: requantize the tier-B (RAM) copies of Q6_K tensors to it as
    they load, tier C untouched; the RAM sizer budgets the smaller size.
    hbm_bytes / ram_bytes: the budgets (default: the card's free memory and
    the host's available memory); max_hbm_layers / max_ram_layers cap the
    tiers. direct_io: tier-B and tier-C reads bypass the page cache where
    O_DIRECT allows; h2d: "blob" (one copy per layer) or "planes".
    reserve_extra_bytes: device memory promised to state the loader does
    not see, such as a separate draft model's cache (the draft itself loads
    first and is gone from the free memory already). mesh: a TP mesh
    (parallel/tp.make_tp_mesh; it replaces `device`): the model is sharded
    over it (the module docstring) and hbm_bytes defaults to the least free
    memory of its cards. A mixture-of-experts file loads as a
    TieredMoEModel (load_model_tiered_moe: its ram_bytes budget; the layer
    caps, requant and h2d do not apply)."""
    if mesh is not None:
        mesh = tuple(resolve_device(d) for d in mesh)
        dev = mesh[0]
    else:
        dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata, max_seq_len)
    arch = Arch.from_config(cfg)
    if arch.rope_local_theta and mesh is not None:
        raise NotImplementedError(
            "gemma3 (dual rope tables) x TP tiered streaming is not "
            "supported yet — run tiered single-chip, or resident TP")
    if arch.n_experts:
        # experts stream as (layer, expert) sets (tiered_moe.py)
        if mesh is not None or requant is not None \
                or requant_ram is not None:
            raise NotImplementedError(
                "tiered MoE does not compose with TP meshes or requant yet "
                "— drop those flags, or serve resident/EP")
        from .tiered_moe import load_model_tiered_moe
        return load_model_tiered_moe(
            path, max_seq_len=max_seq_len, ram_bytes=ram_bytes,
            with_tokenizer=with_tokenizer, device=dev, direct_io=direct_io)
    pack = ensure_pack(reader, path, requant)

    embed = load_qlinear_host(reader, "token_embd.weight")
    tied = "output.weight" not in reader
    head = None if tied else load_qlinear_host(reader, "output.weight")
    # the device holds the resident prefix, the non-layer weights, the KV
    # cache, a workspace and the two streaming slots. A slot is one layer's
    # blob and the layer's weights are views into it: 2 x layer_bytes. (The
    # JAX loader reserves 4 x: each of its slots holds the transferred blob
    # and the planes unpacked from it.) Over a mesh: the busiest card's
    # share of each (tier_budget)
    layer_bytes, fixed_bytes = tier_budget(
        mesh, pack.max_layer_nbytes,
        _device_nbytes(embed) + (0 if tied else _device_nbytes(head))
        + kv_cache_bytes(arch, quant=kv_quant))
    slot_bytes = 2 * ((layer_bytes + 4095) // 4096 * 4096)
    reserve = (fixed_bytes + WORKSPACE_BYTES + slot_bytes
               + reserve_extra_bytes)
    # host RAM holds every shard of a tier-B layer: the whole layer
    ram_layer_bytes = None if mesh is None else pack.max_layer_nbytes
    if requant_ram is not None:
        rq_bytes = requant_layer_meta(pack.layer_meta(0),
                                      requant_ram)["size"]
        if rq_bytes == pack.layer_meta(0)["size"]:
            print("requant_ram: no Q6_K tensors to requantize; ignored",
                  file=sys.stderr)
            requant_ram = None
        else:
            ram_layer_bytes = rq_bytes
    if hbm_bytes is None and dev.type == "cpu":
        hbm_bytes = ram_available_bytes()
    elif hbm_bytes is None and mesh is not None:
        hbm_bytes = min(hbm_free_bytes(d) for d in dict.fromkeys(mesh))
    tiers = TierConfig.compute(
        cfg.n_layers, layer_bytes, reserve, hbm_bytes=hbm_bytes,
        ram_bytes=ram_bytes, max_hbm_layers=max_hbm_layers,
        max_ram_layers=max_ram_layers, ram_layer_bytes=ram_layer_bytes)
    print(tiers.describe(layer_bytes), file=sys.stderr)

    # tier A: the resident stacked prefix, read from the pack; over a mesh
    # it is built on the host and goes straight to its shards
    home = dev if mesh is None else torch.device("cpu")
    stacked = stack_layers([
        _to_device(pack.layer_weights(i, pack.read_layer(i)), home)
        for i in range(tiers.n_hbm)]) if tiers.n_hbm else None

    embed_dev = qlinear_to_device(embed, home)
    lm_head = embed_dev if tied else qlinear_to_device(head, home)
    output_norm = torch.from_numpy(
        load_norm(reader, "output_norm.weight")).to(home)
    cos, sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                          rope_freq_factors(reader), device=home)
    if cfg.rope_local_theta:
        # gemma3: the local layers rotate with their own base
        lcos, lsin = rope_table(cfg.max_seq_len, cfg.head_dim,
                                cfg.rope_local_theta, device=home)
        cos, sin = torch.stack([cos, lcos]), torch.stack([sin, lsin])
    resident = ModelWeights(embed=embed_dev, layers=stacked,
                            output_norm=output_norm, lm_head=lm_head,
                            rope_cos=cos, rope_sin=sin)
    if mesh is not None:
        from ..parallel.tp import check_shardable, shard_weights
        # the streamed layers are held to the plan too (layer 0's shapes)
        template = pack.layer_weights(0, pack.read_layer(0))
        check_shardable(arch, dataclasses.replace(resident, layers=template),
                        len(mesh), dev.type == "cuda")
        resident = shard_weights(resident, mesh, arch)
    streamer = (LayerStreamer(pack, tiers, device=dev,
                              requant_ram=requant_ram, direct_io=direct_io,
                              h2d=h2d, mesh=mesh)
                if tiers.n_streamed else None)
    tok = (Tokenizer.from_gguf_metadata(reader.metadata) if with_tokenizer
           else None)
    return TieredModel(cfg, arch, tiers, resident, streamer, tok, pack, dev,
                       mesh)
