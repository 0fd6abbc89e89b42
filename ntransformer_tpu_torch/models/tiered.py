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
`abs_layer` (sliding window, rope table). Mixture-of-experts models and
device meshes are refused: their tiered forms wait for ROADMAP queue 1
items 4 and 14.
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
from ..memory.tiers import TierConfig, ram_available_bytes
from ..ops.layers import rope_table
from ..ops.linear import QLinear
from .config import ModelConfig
from .llama import (Arch, KVCache, LayerWeights, ModelWeights, _cosine,
                    embed_positions, head_logits, layer_step, stack_layers)
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
               device="cuda") -> "TieredKV":
        def make(n):
            if not n:
                return None
            return KVCache.create(dataclasses.replace(arch, n_layers=n),
                                  quant=quant, device=device)
        return cls(make(tiers.n_hbm), make(tiers.n_streamed))


@dataclass
class TieredModel:
    config: ModelConfig
    arch: Arch
    tiers: TierConfig
    resident: ModelWeights          # .layers = stacked [n_hbm] (or None)
    streamer: LayerStreamer | None
    tokenizer: Tokenizer | None
    pack: PackReader
    device: torch.device

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
    [n_layers] f32 CPU tensor or None; a layer that did not run reads 0)."""
    arch = tm.arch
    tokens = torch.as_tensor(tokens, device=tm.device).reshape(-1)
    pos = int(pos)
    x, cos_t, sin_t = embed_positions(arch, tm.resident, tokens, pos)
    cos_parts: list[tuple[int, torch.Tensor]] = []
    for i in range(tm.tiers.n_hbm):
        if i in skip:
            continue
        kk, vv = kv.res.layer(i)
        x2 = layer_step(arch, x, tm.resident.layers, kk, vv, pos, cos_t,
                        sin_t, n_valid, layer=i)
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
            lw = _stack_of_one(s.get_weights(slot))
            if i + 1 < len(sched):
                s.begin_h2d(sched[i + 1], (i + 1) % 2)
            if i + 2 < len(sched):
                s.prefetch_staging(sched[i + 2], slot)
            kk, vv = kv.str.layer(layer - s.first)
            x2 = layer_step(arch, x, lw, kk, vv, pos, cos_t, sin_t, n_valid,
                            layer=0, abs_layer=layer)
            cos_l = _cosine(x, x2) if want_cos else None
            x = x2
            s.signal_compute_done(slot)
            if with_cosine:
                cos_parts.append((layer, cos_l))
            if early_exit_threshold > 0 and layer >= half:
                pending = (layer, cos_l)

    logits = head_logits(arch, tm.resident, x, n_valid, all_logits)
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
    first and is gone from the free memory already)."""
    dev = resolve_device(device)
    if mesh is not None:
        raise NotImplementedError(
            "tiered streaming over a device mesh is not ported yet (ROADMAP "
            "queue 1 item 14: the multi-GPU axes)")
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata, max_seq_len)
    arch = Arch.from_config(cfg)
    if arch.n_experts:
        raise NotImplementedError(
            "tiered mixture-of-experts models (per-expert streaming) are not "
            "ported yet (ROADMAP queue 1 item 4: moe_ffn)")
    pack = ensure_pack(reader, path, requant)

    embed = load_qlinear_host(reader, "token_embd.weight")
    tied = "output.weight" not in reader
    head = None if tied else load_qlinear_host(reader, "output.weight")
    layer_bytes = pack.max_layer_nbytes
    # the device holds the resident prefix, the non-layer weights, the KV
    # cache, a workspace and the two streaming slots. A slot is one layer's
    # blob and the layer's weights are views into it: 2 x layer_bytes. (The
    # JAX loader reserves 4 x: each of its slots holds the transferred blob
    # and the planes unpacked from it.)
    slot_bytes = 2 * ((layer_bytes + 4095) // 4096 * 4096)
    reserve = (_device_nbytes(embed) + (0 if tied else _device_nbytes(head))
               + kv_cache_bytes(arch, quant=kv_quant) + WORKSPACE_BYTES
               + slot_bytes + reserve_extra_bytes)
    ram_layer_bytes = None
    if requant_ram is not None:
        ram_layer_bytes = requant_layer_meta(pack.layer_meta(0),
                                             requant_ram)["size"]
        if ram_layer_bytes == pack.layer_meta(0)["size"]:
            print("requant_ram: no Q6_K tensors to requantize; ignored",
                  file=sys.stderr)
            requant_ram = ram_layer_bytes = None
    if hbm_bytes is None and dev.type == "cpu":
        hbm_bytes = ram_available_bytes()
    tiers = TierConfig.compute(
        cfg.n_layers, layer_bytes, reserve, hbm_bytes=hbm_bytes,
        ram_bytes=ram_bytes, max_hbm_layers=max_hbm_layers,
        max_ram_layers=max_ram_layers, ram_layer_bytes=ram_layer_bytes)
    print(tiers.describe(layer_bytes), file=sys.stderr)

    # tier A: the resident stacked prefix, read from the pack
    stacked = stack_layers([
        _to_device(pack.layer_weights(i, pack.read_layer(i)), dev)
        for i in range(tiers.n_hbm)]) if tiers.n_hbm else None

    embed_dev = qlinear_to_device(embed, dev)
    lm_head = embed_dev if tied else qlinear_to_device(head, dev)
    output_norm = torch.from_numpy(
        load_norm(reader, "output_norm.weight")).to(dev)
    cos, sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                          rope_freq_factors(reader), device=dev)
    if cfg.rope_local_theta:
        # gemma3: the local layers rotate with their own base
        lcos, lsin = rope_table(cfg.max_seq_len, cfg.head_dim,
                                cfg.rope_local_theta, device=dev)
        cos, sin = torch.stack([cos, lcos]), torch.stack([sin, lsin])
    resident = ModelWeights(embed=embed_dev, layers=stacked,
                            output_norm=output_norm, lm_head=lm_head,
                            rope_cos=cos, rope_sin=sin)
    streamer = (LayerStreamer(pack, tiers, device=dev,
                              requant_ram=requant_ram, direct_io=direct_io,
                              h2d=h2d)
                if tiers.n_streamed else None)
    tok = (Tokenizer.from_gguf_metadata(reader.metadata) if with_tokenizer
           else None)
    return TieredModel(cfg, arch, tiers, resident, streamer, tok, pack, dev)
