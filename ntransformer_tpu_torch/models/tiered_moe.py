"""Tiered mixture-of-experts: routed (layer, expert) streaming (PyTorch +
CUDA).

Port of ntransformer_tpu/models/tiered_moe.py. Dense tiering streams whole
layers; an MoE layer uses k of its E experts a token, so this path keeps
every layer's attention, router and norms resident on the device (a small
share of an MoE model's bytes) and streams the expert weight sets through
the LRU of memory/experts.py with temporal prefetch.

Per decode token:
  prefetch_token_start()      start loading each layer's last-token experts
  for each layer l:
    attention + ffn_norm + the router's top-k (resident weights)
    the k expert ids read to the host: the one synchronization a layer (the
                              router names the experts; nothing can be
                              copied for them before it ran)
    estreamer.get(l, e)       a cached (prefetched) set or a demand load
    the k expert FFNs, weighted, added to the residual
    estreamer.note(l, ids)    this token's routing, the next one's prediction
  final norm and head

Prefill (T > 1) streams every expert of a layer once and weighs each row by
its routing (moe_ffn's dense strategy). Both strategies compute what the
resident `moe_ffn` computes in the same order: the select kernels are
bit-equal to the kernels on a single expert's planes.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import torch

from ..core.gguf import GGUFReader
from ..inference.tokenizer import Tokenizer
from ..memory.experts import ExpertStreamer
from ..memory.pack import PackReader, ensure_pack
from ..ops.layers import rms_norm, rope_table
from .config import ModelConfig
from .llama import (Arch, KVCache, ModelWeights, _cosine, _norm_w,
                    attn_block, embed_positions, expert_ffn, head_logits,
                    route, stack_layers)
from .loader import (load_norm, load_qlinear_host, qlinear_to_device,
                     resolve_device, rope_freq_factors)
from .tiered import _to_device


@dataclass
class TieredMoEModel:
    config: ModelConfig
    arch: Arch
    resident: ModelWeights     # stacked attention + router, every layer
    estreamer: ExpertStreamer
    tokenizer: Tokenizer | None
    pack: PackReader
    device: torch.device

    @property
    def n_resident(self) -> int:
        return self.arch.n_layers  # the attention stack is all resident

    @property
    def streamer(self) -> ExpertStreamer:
        return self.estreamer

    def close(self):
        self.estreamer.close()


def _experts_ffn(arch: Arch, hf, experts, weights) -> torch.Tensor:
    """sum_j weights[:, j] * expert_j(hf), j in order, in f32."""
    out = torch.zeros(hf.shape[0], hf.shape[-1], dtype=torch.float32,
                      device=hf.device)
    for j, ew in enumerate(experts):
        d = expert_ffn(arch, hf, ew["w_gate"], ew["w_up"], ew["w_down"])
        out = out + weights[:, j:j + 1] * d
    return out


@torch.inference_mode()
def forward_tiered_moe(tm: TieredMoEModel, kv: KVCache, tokens, pos: int, *,
                       n_valid=None, all_logits: bool = False,
                       with_cosine: bool = False,
                       skip: frozenset = frozenset(),
                       draft_only: bool = False,
                       early_exit_threshold: float = 0.0):
    """The tiered MoE forward, with forward_tiered's signature so
    TieredEngine drives either. kv: one full-depth KVCache (every layer's
    attention is resident), written in place. Layer skip, the resident
    draft and early exit stream layers, which this path does not: they
    raise. Returns (logits, kv, cosines [n_layers] f32 CPU tensor or
    None)."""
    if skip or draft_only or early_exit_threshold:
        raise NotImplementedError(
            "layer-skip / draft / early-exit are dense-tiered capabilities; "
            "the MoE-tiered path streams experts, not layers")
    arch = tm.arch
    E = arch.n_experts
    tokens = torch.as_tensor(tokens, device=tm.device).reshape(-1)
    T = int(tokens.shape[0])
    pos = int(pos)
    lw = tm.resident.layers
    est = tm.estreamer
    x, cos_t, sin_t = embed_positions(arch, tm.resident, tokens, pos)
    decode = T == 1
    if decode:
        est.prefetch_token_start()
    cosines = []
    for layer in range(arch.n_layers):
        x0 = x
        kk, vv = kv.layer(layer)
        x = attn_block(arch, x, lw, kk, vv, pos, cos_t, sin_t, n_valid,
                       layer=layer)
        hf = rms_norm(x, _norm_w(arch, lw.ffn_norm, layer),
                      arch.norm_eps).to(torch.bfloat16)
        topv, tope = route(arch, hf, lw.ffn_gate_inp, layer)
        if decode:
            ids = tope[0].tolist()  # the one synchronization of the layer
            experts = [est.get(layer, e) for e in ids]
            x = x + _experts_ffn(arch, hf, experts, topv)
            est.note(layer, ids)
        else:
            cols = torch.zeros(T, E, dtype=torch.float32, device=x.device)
            cols.scatter_(1, tope, topv)
            acc = torch.zeros_like(x)
            for e in range(E):
                ew = est.get(layer, e)
                acc = acc + cols[:, e:e + 1] * expert_ffn(
                    arch, hf, ew["w_gate"], ew["w_up"], ew["w_down"])
            x = x + acc
            # the last valid row's routing predicts the next decode token
            row = T - 1 if n_valid is None else int(n_valid) - 1
            est.note(layer, tope[row].tolist())
        if with_cosine:
            cosines.append(float(_cosine(x0, x)))
    logits = head_logits(arch, tm.resident, x, n_valid, all_logits)
    cos = torch.tensor(cosines, dtype=torch.float32) if with_cosine else None
    return logits, kv, cos


def load_model_tiered_moe(path: str, *, max_seq_len: int | None = None,
                          hbm_expert_slots: int | None = None,
                          ram_bytes: int | None = None,
                          with_tokenizer: bool = True, device="cuda",
                          direct_io: bool = True) -> TieredMoEModel:
    """Load an MoE GGUF with attention, router and norms resident on
    `device` (the card by default; raises without CUDA unless
    device="cpu") and the experts streamed through an LRU.

    hbm_expert_slots: the LRU's capacity in expert sets (default twice a
    token's working set, 2 * n_layers * n_experts_used: the current token's
    experts and the next token's prefetch). ram_bytes: the host budget for
    whole-layer blobs (the RAM tier, default every layer); the layers past
    it read each expert from the pack (the disk tier). The engine makes the
    cache (one full-depth KVCache)."""
    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata, max_seq_len)
    arch = Arch.from_config(cfg)
    if not arch.n_experts:
        raise ValueError("not an MoE model — use load_model_tiered")
    pack = ensure_pack(reader, path)
    if not pack.n_experts(0):
        raise RuntimeError("pack has no per-expert ranges — delete the "
                           f"stale .ntp next to {path} and reload")
    L = cfg.n_layers
    # resident: each layer's attention, router and vectors, the blob's
    # bytes before its first expert
    layers = []
    for i in range(L):
        head = pack.layer_meta(i)["experts"][0]["off"]
        lw = pack.layer_weights(i, pack.read_layer(i, nbytes=head))
        layers.append(_to_device(lw, dev))
    stacked = stack_layers(layers)
    embed = qlinear_to_device(load_qlinear_host(reader, "token_embd.weight"),
                              dev)
    tied = "output.weight" not in reader
    lm_head = embed if tied else qlinear_to_device(
        load_qlinear_host(reader, "output.weight"), dev)
    output_norm = torch.from_numpy(
        load_norm(reader, "output_norm.weight")).to(dev)
    cos, sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                          rope_freq_factors(reader), device=dev)
    resident = ModelWeights(embed=embed, layers=stacked,
                            output_norm=output_norm, lm_head=lm_head,
                            rope_cos=cos, rope_sin=sin)
    if hbm_expert_slots is None:
        hbm_expert_slots = 2 * L * arch.n_experts_used
    ram_layers = set()
    if ram_bytes is None:
        ram_layers = set(range(L))
    else:
        used = 0
        for i in range(L):
            used += pack.layer_nbytes(i)
            if used > ram_bytes:
                break
            ram_layers.add(i)
    est = ExpertStreamer(pack, range(L), hbm_slots=hbm_expert_slots,
                         ram_layers=ram_layers, device=dev,
                         direct_io=direct_io,
                         n_stage=max(4, 2 * arch.n_experts_used))
    print(f"tiered-moe: {L} layers resident (attn+router), "
          f"E={arch.n_experts} k={arch.n_experts_used} experts streamed "
          f"({len(ram_layers)} layers' experts in RAM, LRU "
          f"{hbm_expert_slots} expert sets)", file=sys.stderr)
    tok = (Tokenizer.from_gguf_metadata(reader.metadata) if with_tokenizer
           else None)
    return TieredMoEModel(cfg, arch, resident, est, tok, pack, dev)
