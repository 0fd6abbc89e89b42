"""Llama-family model: forward passes over quantized weights (PyTorch).

Port of ntransformer_tpu/models/llama.py. Two things change with the
framework:

  * a Python loop over the layers takes the place of `lax.scan`; each
    quantized matmul reads its layer of the stacked [L, ...] planes as a
    free view;
  * the KV cache is written IN PLACE (`kv.k[l][:, pos:pos+T] = k`) where
    the JAX package donates the cache buffer to a jitted forward; `forward`
    still returns the cache so callers read the same as in the JAX package.

Dense FFN only: mixture-of-experts models raise until their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..ops.layers import apply_rope, attention, rms_norm, swiglu
from ..ops.linear import QLinear, embed_lookup, qmatmul


@dataclass(frozen=True)
class Arch:
    """Static architecture facts (see the JAX package's Arch)."""

    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    hidden_size: int
    intermediate_size: int
    vocab_size: int
    norm_eps: float
    rope_theta: float
    rope_interleaved: bool
    max_seq_len: int
    act: str = "silu"
    norm_bias: float = 0.0
    embed_scale: float = 1.0
    post_norms: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0
    swa_pattern: int = 0
    query_scale: float = 0.0
    qk_norm: bool = False
    rope_local_theta: float = 0.0
    n_experts: int = 0
    n_experts_used: int = 0
    moe_inter: int = 0

    @classmethod
    def from_config(cls, cfg) -> "Arch":
        return cls(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cls)})


@dataclass
class LayerWeights:
    """One block's weights; in a model every tensor is stacked [L, ...].
    wqkv / w_gate_up are the fused matrices (fuse_layer_weights); the
    optional vectors are the qwen2 biases, gemma2 post norms and qwen3/gemma3
    q/k norms."""

    attn_norm: torch.Tensor
    wq: QLinear | None
    wk: QLinear | None
    wv: QLinear | None
    wo: QLinear
    ffn_norm: torch.Tensor
    w_gate: QLinear | None
    w_up: QLinear | None
    w_down: QLinear | None
    wqkv: QLinear | None = None
    w_gate_up: QLinear | None = None
    wqk: QLinear | None = None
    bq: torch.Tensor | None = None
    bk: torch.Tensor | None = None
    bv: torch.Tensor | None = None
    attn_post_norm: torch.Tensor | None = None
    ffn_post_norm: torch.Tensor | None = None
    q_norm: torch.Tensor | None = None
    k_norm: torch.Tensor | None = None


@dataclass
class KVCache:
    """Cache [L, Hkv, S, D], written in place by `forward`: bf16, or int8
    codes with per-(head, position) absmax scales ks/vs [L, Hkv, S, 1] f32
    (quant=True; half the memory)."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor | None = None
    vs: torch.Tensor | None = None

    @classmethod
    def create(cls, arch: Arch, quant: bool = False, device="cuda"):
        shape = (arch.n_layers, arch.n_kv_heads, arch.max_seq_len,
                 arch.head_dim)
        if quant:
            sshape = shape[:-1] + (1,)
            return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
                       torch.zeros(sshape, dtype=torch.float32,
                                   device=device))
        return cls(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device))

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    def layer(self, index: int):
        """(k, v) of one layer as views: tensors, or (codes, scales)
        tuples for the int8 cache."""
        if self.quantized:
            return ((self.k[index], self.ks[index]),
                    (self.v[index], self.vs[index]))
        return self.k[index], self.v[index]

    def clone(self) -> "KVCache":
        return KVCache(*(None if t is None else t.clone()
                         for t in (self.k, self.v, self.ks, self.vs)))


@dataclass
class ModelWeights:
    embed: QLinear            # token_embd, transposed planes [H, V]
    layers: LayerWeights      # stacked: every tensor has a leading [L]
    output_norm: torch.Tensor
    lm_head: QLinear          # output.weight, or embed when tied
    rope_cos: torch.Tensor    # [max_seq, D/2] (or [2, max_seq, D/2])
    rope_sin: torch.Tensor


def stack_layers(layers: list[LayerWeights]) -> LayerWeights:
    """Stack per-layer weights into one LayerWeights of [L, ...] tensors."""
    def stack(vals):
        if vals[0] is None:
            return None
        if isinstance(vals[0], QLinear):
            q = vals[0]
            return QLinear(q.dtype, q.k, q.n, {
                nm: torch.stack([v.planes[nm] for v in vals])
                for nm in q.planes})
        return torch.stack(vals)
    names = [f.name for f in dataclasses.fields(LayerWeights)]
    return LayerWeights(**{nm: stack([getattr(lw, nm) for lw in layers])
                           for nm in names})


def _concat_qlinear(parts: list[QLinear]) -> QLinear | None:
    """Concatenate QLinears along the output (lane) axis when they share
    dtype and K (single device, tp = 1)."""
    if any(p is None for p in parts):
        return None
    if len({p.dtype for p in parts}) != 1 or len({p.k for p in parts}) != 1:
        return None
    planes = {nm: torch.cat([p.planes[nm] for p in parts], dim=-1)
              for nm in parts[0].planes}
    return QLinear(parts[0].dtype, parts[0].k, sum(p.n for p in parts),
                   planes)


def fuse_layer_weights(lw: LayerWeights) -> LayerWeights:
    """Build fused wqkv / w_gate_up (dropping the unfused copies); a
    mixed-dtype triple fuses q|k alone."""
    wqkv = _concat_qlinear([lw.wq, lw.wk, lw.wv])
    w_gate_up = _concat_qlinear([lw.w_gate, lw.w_up])
    out = lw
    if wqkv is not None:
        out = dataclasses.replace(out, wqkv=wqkv, wq=None, wk=None, wv=None)
    else:
        wqk = _concat_qlinear([lw.wq, lw.wk])
        if wqk is not None:
            out = dataclasses.replace(out, wqk=wqk, wq=None, wk=None)
    if w_gate_up is not None:
        out = dataclasses.replace(out, w_gate_up=w_gate_up, w_gate=None,
                                  w_up=None)
    return out


def layer_window(arch: Arch, layer: int):
    """(window, local) of one layer of an alternating sliding-window model,
    or (None, None); a global layer's window of max_seq_len masks nothing."""
    if not arch.swa_pattern:
        return None, None
    local = (layer % arch.swa_pattern) < (arch.swa_pattern - 1)
    return (arch.sliding_window if local else arch.max_seq_len), local


def _norm_w(arch: Arch, w: torch.Tensor, layer: int) -> torch.Tensor:
    w = w[layer]
    return w if arch.norm_bias == 0.0 else w + arch.norm_bias


def attn_block(arch: Arch, x, lw: LayerWeights, kv_k, kv_v, pos: int, cos_t,
               sin_t, n_valid=None, layer: int = 0, abs_layer=None):
    """The attention half of one block through its residual add. x [T, H]
    f32; kv_k/kv_v [Hkv, S, D] views of this layer's cache, written in
    place at rows [pos, pos + n_valid). `layer` indexes the stacked
    weights; abs_layer (default `layer`) is the layer's depth in the model,
    which picks its sliding window and rope table (a streamed layer's
    weights are a stack of one)."""
    T = x.shape[0]
    Hq, Hkv, D = arch.n_heads, arch.n_kv_heads, arch.head_dim
    q_scale = arch.query_scale if arch.query_scale else 1.0 / math.sqrt(D)
    window, local = layer_window(arch, layer if abs_layer is None
                                 else abs_layer)

    h = rms_norm(x, _norm_w(arch, lw.attn_norm, layer),
                 arch.norm_eps).to(torch.bfloat16)
    if lw.wqkv is not None:
        qkv = qmatmul(h, lw.wqkv, layer=layer)
        nq, nkv = Hq * D, Hkv * D
        q = qkv[:, :nq].reshape(T, Hq, D)
        k = qkv[:, nq:nq + nkv].reshape(T, Hkv, D)
        v = qkv[:, nq + nkv:].reshape(T, Hkv, D)
    elif lw.wqk is not None:
        qk = qmatmul(h, lw.wqk, layer=layer)
        nq = Hq * D
        q = qk[:, :nq].reshape(T, Hq, D)
        k = qk[:, nq:].reshape(T, Hkv, D)
        v = qmatmul(h, lw.wv, layer=layer).reshape(T, Hkv, D)
    else:
        q = qmatmul(h, lw.wq, layer=layer).reshape(T, Hq, D)
        k = qmatmul(h, lw.wk, layer=layer).reshape(T, Hkv, D)
        v = qmatmul(h, lw.wv, layer=layer).reshape(T, Hkv, D)
    if lw.bq is not None:
        q = q + lw.bq[layer].reshape(Hq, D)
        k = k + lw.bk[layer].reshape(Hkv, D)
        v = v + lw.bv[layer].reshape(Hkv, D)
    if arch.qk_norm:
        q = rms_norm(q, _norm_w(arch, lw.q_norm, layer), arch.norm_eps)
        k = rms_norm(k, _norm_w(arch, lw.k_norm, layer), arch.norm_eps)
    if cos_t.dim() == 3:
        # dual rope tables [2, T, d2]: row 1 for gemma3's local layers
        cos_t, sin_t = cos_t[int(bool(local))], sin_t[int(bool(local))]
    q = apply_rope(q, cos_t, sin_t, arch.rope_interleaved)
    k = apply_rope(k, cos_t, sin_t, arch.rope_interleaved)
    k = k.transpose(0, 1)  # [Hkv, T, D] f32
    v = v.transpose(0, 1)
    n = T if n_valid is None else int(n_valid)
    rows = (kv_k[0] if isinstance(kv_k, tuple) else kv_k).shape[1]
    if pos + T > rows:
        raise ValueError(f"rows [{pos}, {pos + T}) exceed the {rows}-row "
                         "cache")
    # padding rows beyond n_valid keep the cache's previous contents
    if isinstance(kv_k, tuple):
        # int8 cache (codes, scales): absmax-quantize the new rows per
        # (head, position), write them, then attend a bf16 dequant
        (kc, ksc), (vc, vsc) = kv_k, kv_v
        kq, ks_new, vq, vs_new = quantize_rows(k, v)
        kc[:, pos:pos + n] = kq[:, :n]
        ksc[:, pos:pos + n] = ks_new[:, :n]
        vc[:, pos:pos + n] = vq[:, :n]
        vsc[:, pos:pos + n] = vs_new[:, :n]
        kf = kc.to(torch.bfloat16) * ksc.to(torch.bfloat16)
        vf = vc.to(torch.bfloat16) * vsc.to(torch.bfloat16)
    else:
        kv_k[:, pos:pos + n] = k[:, :n].to(kv_k.dtype)
        kv_v[:, pos:pos + n] = v[:, :n].to(kv_v.dtype)
        kf, vf = kv_k, kv_v
    att = attention(q, kf, vf, pos, T, q_scale, window=window,
                    softcap=arch.attn_softcap)
    o = qmatmul(att.reshape(T, Hq * D).to(torch.bfloat16), lw.wo,
                layer=layer)
    if arch.post_norms:
        o = rms_norm(o, _norm_w(arch, lw.attn_post_norm, layer),
                     arch.norm_eps)
    return x + o


def quantize_rows(k: torch.Tensor, v: torch.Tensor):
    """Absmax int8 quantization of new k/v rows, one f32 scale per row of
    the last axis: (k codes, k scales, v codes, v scales), scales keeping a
    trailing axis of 1."""
    ks = k.abs().amax(-1, keepdim=True) / 127.0 + 1e-9
    vs = v.abs().amax(-1, keepdim=True) / 127.0 + 1e-9
    return (torch.round(k / ks).to(torch.int8), ks,
            torch.round(v / vs).to(torch.int8), vs)


def layer_step(arch: Arch, x, lw: LayerWeights, kv_k, kv_v, pos: int, cos_t,
               sin_t, n_valid=None, layer: int = 0, abs_layer=None):
    """One transformer block (dense FFN). x [T, H] f32; kv_k/kv_v this
    layer's cache views ((codes, scales) tuples for an int8 cache);
    layer / abs_layer as in attn_block; returns x."""
    if arch.n_experts:
        raise NotImplementedError(
            "mixture-of-experts FFNs are not ported yet (ROADMAP queue 1 "
            "item 4: moe_ffn)")
    x = attn_block(arch, x, lw, kv_k, kv_v, pos, cos_t, sin_t, n_valid,
                   layer, abs_layer)
    hf = rms_norm(x, _norm_w(arch, lw.ffn_norm, layer),
                  arch.norm_eps).to(torch.bfloat16)
    if lw.w_gate_up is not None:
        gu = qmatmul(hf, lw.w_gate_up, layer=layer)
        it = gu.shape[-1] // 2
        g, u = gu[:, :it], gu[:, it:]
    else:
        g = qmatmul(hf, lw.w_gate, layer=layer)
        u = qmatmul(hf, lw.w_up, layer=layer)
    dn = qmatmul(swiglu(g, u, arch.act).to(torch.bfloat16), lw.w_down,
                 layer=layer)
    if arch.post_norms:
        dn = rms_norm(dn, _norm_w(arch, lw.ffn_post_norm, layer),
                      arch.norm_eps)
    return x + dn


def embed_positions(arch: Arch, weights: ModelWeights, tokens: torch.Tensor,
                    pos: int):
    """Token embedding (f32) + the RoPE table rows of this window."""
    T = tokens.shape[0]
    x = embed_lookup(weights.embed, tokens, out_dtype=torch.float32)
    if arch.embed_scale != 1.0:
        x = x * arch.embed_scale
    return (x, weights.rope_cos[..., pos:pos + T, :],
            weights.rope_sin[..., pos:pos + T, :])


def head_logits(arch: Arch, weights: ModelWeights, x, n_valid=None,
                all_logits: bool = False):
    """Final norm + LM-head projection of the selected positions."""
    w = weights.output_norm
    x = rms_norm(x, w + arch.norm_bias if arch.norm_bias != 0.0 else w,
                 arch.norm_eps)
    if all_logits:
        sel = x
    elif n_valid is not None:
        sel = x[int(n_valid) - 1:int(n_valid)]
    else:
        sel = x[-1:]
    logits = qmatmul(sel.to(torch.bfloat16), weights.lm_head)
    if logits.shape[-1] > arch.vocab_size:
        logits = logits[:, :arch.vocab_size]
    if arch.final_softcap:
        logits = arch.final_softcap * torch.tanh(logits / arch.final_softcap)
    return logits


@torch.inference_mode()
def forward(arch: Arch, weights: ModelWeights, kv: KVCache, tokens, pos: int,
            layer_sel=None, n_valid=None, all_logits: bool = False,
            with_cosine: bool = False):
    """Forward pass over (a subset of) the layer stack.

    tokens [T] int; pos: write offset into the cache. layer_sel: indices of
    the layers to run, in order (None = all). n_valid: real tokens of a
    bucketed prefill. The cache is updated in place. Returns (logits
    [T or 1, V] f32, kv, cosines [len(layers)] f32 or None)."""
    dev = weights.output_norm.device
    tokens = torch.as_tensor(tokens, device=dev).reshape(-1)
    pos = int(pos)
    x, cos_t, sin_t = embed_positions(arch, weights, tokens, pos)
    indices = (range(kv.k.shape[0]) if layer_sel is None
               else [int(i) for i in layer_sel])
    cosines = []
    for li in indices:
        kk, vv = kv.layer(li)
        x2 = layer_step(arch, x, weights.layers, kk, vv, pos, cos_t, sin_t,
                        n_valid, layer=li)
        if with_cosine:
            cosines.append(_cosine(x, x2))
        x = x2
    logits = head_logits(arch, weights, x, n_valid, all_logits)
    return logits, kv, (torch.stack(cosines) if with_cosine else None)


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of flattened hiddens (layer-skip calibration)."""
    af = a.to(torch.float32).reshape(-1)
    bf = b.to(torch.float32).reshape(-1)
    return torch.dot(af, bf) / (torch.sqrt(torch.dot(af, af)
                                           * torch.dot(bf, bf)) + 1e-12)
