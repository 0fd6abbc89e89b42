"""Batched decode: B sequences, one token each, per-sequence positions
(PyTorch).

Port of ntransformer_tpu/models/batched.py, the compute core of the
continuous-batching server (inference/serve.py). A batch of B decode tokens
is a [B, K] x [K, N] product through the same quantized matmul kernel, so
the weight read is shared by the B sequences. Two step implementations with
the same semantics:

  * "kernel": attention reads the stacked [L, B, Hkv, S, D] cache inside
    the batched flash kernel (ops/cuda/batched_attention.py) with the
    current token's k/v row as a virtual block, and every layer's cache
    write happens in one in-place append after the layer loop
    (ops/cuda/kv_update.py; the plain indexed write at B = 1 and for a
    layer-prefix step, as the JAX package picks its DUS path);
  * "plain" (the JAX package's "jnp" path): per layer, write the new rows
    into the cache, then attend the whole cache in plain PyTorch.

`impl` defaults to "kernel" when kernels are on for the tensors' device
(ops/linear.kernels_enabled: CUDA and KERNEL_MODE "auto"), else "plain"; on
CPU tensors the kernel path runs its wrappers' plain twins. Inactive slots
keep their cache rows frozen. The cache is written IN PLACE (the JAX
package donates it); the steps still return it. A Python loop over the
layers takes the place of `lax.scan`; models/graphs.py captures the steps
as CUDA graphs, the counterpart of the JAX package's `jax.jit` over them,
which the server replays on the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..ops.cuda import kv_update
from ..ops.cuda.batched_attention import (flash_decode_batched,
                                          flash_verify_batched)
from ..ops.layers import _psum, apply_rope, handoff, rms_norm
from ..ops.linear import embed_lookup, kernels_enabled, qmatmul
from .llama import (Arch, KVCache, LayerWeights, ModelWeights, _home,
                    _norm_w, dense_ffn, layer_window, moe_ffn, quantize_rows,
                    tp_embed, tp_head_logits)


def attention_rows(q, kf, vf, pos, scale: float, window=None,
                   softcap: float = 0.0) -> torch.Tensor:
    """Masked GQA attention of a batch of windows over whole caches (the
    JAX package's vmap of attention_jnp): q [B, T, Hq, D], kf/vf [B, Hkv,
    S, D], pos [B]; window token t of sequence b sits at pos[b] + t and
    sees keys (pos[b] + t - window, pos[b] + t]. Returns [B, T, Hq, D]
    f32."""
    b_n, t_n, hq, d = q.shape
    hkv, s = kf.shape[1], kf.shape[2]
    group = hq // hkv
    qf = q.to(torch.float32).reshape(b_n, t_n, hkv, group, d)
    scores = torch.einsum("bthgd,bhsd->bhgts", qf,
                          kf.to(torch.float32)) * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    key_pos = torch.arange(s, device=q.device).view(1, 1, s)
    q_pos = (pos.to(q.device, torch.long).view(b_n, 1, 1)
             + torch.arange(t_n, device=q.device).view(1, t_n, 1))
    mask = key_pos <= q_pos                                 # [B, T, S]
    if window is not None:
        mask = mask & (key_pos > q_pos - window)
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bhsd->bthgd", probs, vf.to(torch.float32))
    return out.reshape(b_n, t_n, hq, d)


def _dequant(kv):
    """A cache as attention reads it on the plain path: a tensor, or the
    bf16 dequant of an int8 (codes, S-minor scales) tuple."""
    if not isinstance(kv, tuple):
        return kv
    c, s = kv
    if s.dim() == c.dim() - 1:
        s = s[..., None]
    return c.to(torch.bfloat16) * s.to(torch.bfloat16)


def batched_attention(q, kv_k, kv_v, pos, scale: float, window=None,
                      softcap: float = 0.0) -> torch.Tensor:
    """Plain reference attention of a decode batch: q [B, Hq, D]; kv [B,
    Hkv, S, D] tensors or int8 (codes, scales) tuples (attended through a
    bf16 dequant, which the kernel path never writes); pos [B] with the
    current row already written (keys [0, pos] live). Returns [B, Hq, D]
    f32."""
    b_n, hq, d = q.shape
    att = attention_rows(q.reshape(b_n, 1, hq, d), _dequant(kv_k),
                         _dequant(kv_v), pos, scale, window, softcap)
    return att.reshape(b_n, hq, d)


@dataclass
class BatchedKV:
    """Stacked cache [L, B, Hkv, S, D] of B sequence slots: bf16, or int8
    codes with per-(sequence, head, position) scales ks/vs [L, B, Hkv, S]
    f32 (S minor, as the kernels read them)."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor | None = None
    vs: torch.Tensor | None = None

    @classmethod
    def create(cls, arch: Arch, batch: int, quant: bool = False,
               device="cuda") -> "BatchedKV":
        shape = (arch.n_layers, batch, arch.n_kv_heads, arch.max_seq_len,
                 arch.head_dim)
        if quant:
            z = lambda sh, dt: torch.zeros(sh, dtype=dt, device=device)
            return cls(z(shape, torch.int8), z(shape, torch.int8),
                       z(shape[:-1], torch.float32),
                       z(shape[:-1], torch.float32))
        return cls(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device))

    @property
    def quantized(self) -> bool:
        return self.ks is not None

    @property
    def caches(self) -> tuple:
        """The tensors a bulk append writes, in the order its rows come."""
        return ((self.k, self.ks, self.v, self.vs) if self.quantized
                else (self.k, self.v))

    def insert(self, slot: int, kv: KVCache) -> "BatchedKV":
        """Copy a single-sequence cache (from a prefill) into batch slot
        `slot`, in place. Both caches are int8 or both bf16."""
        if kv.quantized != self.quantized:
            raise ValueError("prefill cache quantization must match the "
                             "batched cache")
        return _insert(self, kv, slot)


def _insert(bkv: BatchedKV, kv: KVCache, slot: int) -> BatchedKV:
    bkv.k[:, slot].copy_(kv.k)
    bkv.v[:, slot].copy_(kv.v)
    if bkv.quantized:
        # single-sequence scales are [L, Hkv, S, 1]; the batched buffer
        # keeps S minor ([L, B, Hkv, S])
        bkv.ks[:, slot].copy_(kv.ks.reshape(kv.ks.shape[:-1]))
        bkv.vs[:, slot].copy_(kv.vs.reshape(kv.vs.shape[:-1]))
    return bkv


def _qkv_rows(arch: Arch, x, lw: LayerWeights, cos_t, sin_t, layer: int):
    """Shared front half of a batched layer: norm, the (fused) QKV
    products, biases, q/k norms and RoPE. x [B, H] (decode) or [B, T, H]
    (a verify window); cos_t/sin_t [B, T, d2] or [B, 2, T, d2] (dual
    tables). Returns (q [B, T, Hq, D], k_t [B, Hkv, T, D] f32, v_t)."""
    b_n = x.shape[0]
    t_n = 1 if x.dim() == 2 else x.shape[1]
    hq, hkv, d = arch.n_heads, arch.n_kv_heads, arch.head_dim
    h = rms_norm(x, _norm_w(arch, lw.attn_norm, layer),
                 arch.norm_eps).to(torch.bfloat16).reshape(b_n * t_n, -1)
    if lw.wqkv is not None:
        qkv = qmatmul(h, lw.wqkv, layer=layer)
        nq, nkv = hq * d, hkv * d
        q = qkv[:, :nq].reshape(b_n, t_n, hq, d)
        k = qkv[:, nq:nq + nkv].reshape(b_n, t_n, hkv, d)
        v = qkv[:, nq + nkv:].reshape(b_n, t_n, hkv, d)
    elif lw.wqk is not None:
        qk = qmatmul(h, lw.wqk, layer=layer)
        nq = hq * d
        q = qk[:, :nq].reshape(b_n, t_n, hq, d)
        k = qk[:, nq:].reshape(b_n, t_n, hkv, d)
        v = qmatmul(h, lw.wv, layer=layer).reshape(b_n, t_n, hkv, d)
    else:
        q = qmatmul(h, lw.wq, layer=layer).reshape(b_n, t_n, hq, d)
        k = qmatmul(h, lw.wk, layer=layer).reshape(b_n, t_n, hkv, d)
        v = qmatmul(h, lw.wv, layer=layer).reshape(b_n, t_n, hkv, d)
    if lw.bq is not None:
        q = q + lw.bq[layer].reshape(hq, d)
        k = k + lw.bk[layer].reshape(hkv, d)
        v = v + lw.bv[layer].reshape(hkv, d)
    if arch.qk_norm:
        q = rms_norm(q, _norm_w(arch, lw.q_norm, layer), arch.norm_eps)
        k = rms_norm(k, _norm_w(arch, lw.k_norm, layer), arch.norm_eps)
    if cos_t.dim() == 4:
        # dual rope tables: row 1 for gemma3's local layers
        _, local = layer_window(arch, layer)
        cos_t, sin_t = cos_t[:, int(bool(local))], sin_t[:, int(bool(local))]
    d2 = cos_t.shape[-1]
    cos_f, sin_f = cos_t.reshape(-1, d2), sin_t.reshape(-1, d2)
    q = apply_rope(q.reshape(b_n * t_n, hq, d), cos_f, sin_f,
                   arch.rope_interleaved).reshape(b_n, t_n, hq, d)
    k = apply_rope(k.reshape(b_n * t_n, hkv, d), cos_f, sin_f,
                   arch.rope_interleaved).reshape(b_n, t_n, hkv, d)
    return q, k.transpose(1, 2), v.transpose(1, 2)


def _ffn_tail(arch: Arch, x, att, lw: LayerWeights, layer: int):
    """Shared back half: o-projection, residual, FFN. A mixture-of-experts
    layer runs moe_ffn on the [B(*T), H] rows: at one row the k routed
    experts through the device-side select, past it the dense loop over
    every expert with each row's own routing (JAX batched.py:201-208)."""
    hq, d = arch.n_heads, arch.head_dim
    o = qmatmul(att.reshape(-1, hq * d).to(torch.bfloat16), lw.wo,
                layer=layer).reshape(x.shape)
    if arch.post_norms:
        o = rms_norm(o, _norm_w(arch, lw.attn_post_norm, layer),
                     arch.norm_eps)
    x = x + o
    hf = rms_norm(x, _norm_w(arch, lw.ffn_norm, layer), arch.norm_eps) \
        .to(torch.bfloat16).reshape(-1, x.shape[-1])
    ffn = moe_ffn if arch.n_experts else dense_ffn
    dn = ffn(arch, hf, lw, layer).reshape(x.shape)
    if arch.post_norms:
        dn = rms_norm(dn, _norm_w(arch, lw.ffn_post_norm, layer),
                      arch.norm_eps)
    return x + dn


def _scale(arch: Arch) -> float:
    return arch.query_scale if arch.query_scale else \
        1.0 / math.sqrt(arch.head_dim)


def _attend_plain(arch: Arch, q, k_t, v_t, bkv: BatchedKV, pos, active,
                  layer: int):
    """Plain-path attention of a decode or verify window: write the T new
    rows of each active sequence at [pos, pos + T) of this layer's cache,
    then attend the whole cache. Returns att [B, T, Hq, D] f32."""
    if bkv.quantized:
        kq, ks_new, vq, vs_new = quantize_rows(k_t, v_t)
        rows = (kq, ks_new, vq, vs_new)
    else:
        rows = (k_t, v_t)
    caches = tuple(c[layer:layer + 1] for c in bkv.caches)
    kv_update.append_rows_stacked_dus(caches, tuple(r[None] for r in rows),
                                      pos, active)
    k_cache = (bkv.k[layer], bkv.ks[layer]) if bkv.quantized \
        else bkv.k[layer]
    v_cache = (bkv.v[layer], bkv.vs[layer]) if bkv.quantized \
        else bkv.v[layer]
    window, _ = layer_window(arch, layer)
    return attention_rows(q, _dequant(k_cache), _dequant(v_cache), pos,
                          _scale(arch), window, arch.attn_softcap)


def _attend_deferred(arch: Arch, q, k_t, v_t, bkv: BatchedKV, pos, active,
                     layer: int, decode: bool, s_live=None,
                     dot_impl: str = "f32"):
    """Kernel-path attention: the flash kernel reads this layer of the
    stacked cache plus the T new rows as a virtual block, with cache dots
    of form `dot_impl`; nothing is written here, the rows are returned for
    the bulk append after the layer loop. Returns (att, rows tuple)."""
    window, _ = layer_window(arch, layer)
    fn = flash_decode_batched if decode else flash_verify_batched
    qq = q[:, 0] if decode else q
    kw = dict(layer=layer, active=active, window=window,
              softcap=arch.attn_softcap, s_live=s_live, dot_impl=dot_impl)
    if bkv.quantized:
        kq, ks_new, vq, vs_new = quantize_rows(k_t, v_t)
        att = fn(qq, (bkv.k, bkv.ks), (bkv.v, bkv.vs), (kq, ks_new),
                 (vq, vs_new), pos, _scale(arch), **kw)
        return att, (kq, ks_new, vq, vs_new)
    att = fn(qq, bkv.k, bkv.v, k_t, v_t, pos, _scale(arch), **kw)
    return att, (k_t, v_t)


def _layer_step_plain(arch: Arch, x, lw: LayerWeights, bkv: BatchedKV, pos,
                      active, cos_t, sin_t, layer: int):
    """Plain-path layer step (decode or verify window). x [B, H] or
    [B, T, H]."""
    q, k_t, v_t = _qkv_rows(arch, x, lw, cos_t, sin_t, layer)
    att = _attend_plain(arch, q, k_t, v_t, bkv, pos, active, layer)
    return _ffn_tail(arch, x, att, lw, layer)


def _layer_step_deferred(arch: Arch, x, lw: LayerWeights, bkv: BatchedKV,
                         pos, active, cos_t, sin_t, layer: int, s_live=None,
                         dot_impl: str = "f32"):
    """Kernel-path layer step (decode or verify window). Returns (x, rows
    tuple)."""
    q, k_t, v_t = _qkv_rows(arch, x, lw, cos_t, sin_t, layer)
    att, rows = _attend_deferred(arch, q, k_t, v_t, bkv, pos, active, layer,
                                 x.dim() == 2, s_live, dot_impl)
    return _ffn_tail(arch, x, att, lw, layer), rows


def resolve_impl(impl: str | None, kv_append: str | None, batch: int,
                 ref: torch.Tensor):
    """The implementation switches: impl "kernel" | "plain" (default
    "kernel" iff kernels are on for `ref`'s device); kv_append "kernel" |
    "dus" (default "dus" at B = 1, a single indexed write per cache, and
    the append kernel at B > 1, as the JAX package measured them)."""
    if impl is None:
        impl = "kernel" if kernels_enabled(ref) else "plain"
    if kv_append is None:
        kv_append = "dus" if batch == 1 else "kernel"
    if impl not in ("kernel", "plain") or kv_append not in ("kernel",
                                                            "dus"):
        raise ValueError(f"impl {impl!r} / kv_append {kv_append!r}: want "
                         "'kernel' or 'plain' / 'kernel' or 'dus'")
    return impl, kv_append


def _vec(x, device, dtype) -> torch.Tensor:
    """x as a tensor of `dtype` on `device`. Inside a CUDA graph capture
    it must already be one (models/graphs.py's static inputs): a host
    array's copy would be a pageable copy, which a capture refuses, and the
    graph would keep the first call's values."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing() \
            and not (isinstance(x, torch.Tensor) and x.device == device
                     and x.dtype == dtype):
        raise ValueError(f"a captured step takes tokens, pos and active as "
                         f"{dtype} tensors on {device}")
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def _rope_rows(weights: ModelWeights, positions: torch.Tensor):
    """RoPE table rows at positions [B, T]: [B, T, d2], or [B, 2, T, d2]
    for dual tables."""
    s = weights.rope_cos.shape[-2]
    p = positions.clamp(0, s - 1)
    if weights.rope_cos.dim() == 3:
        return (weights.rope_cos[:, p].transpose(0, 1),
                weights.rope_sin[:, p].transpose(0, 1))
    return weights.rope_cos[p], weights.rope_sin[p]


def _head(arch: Arch, weights: ModelWeights, x) -> torch.Tensor:
    w = weights.output_norm
    x = rms_norm(x, w + arch.norm_bias if arch.norm_bias != 0.0 else w,
                 arch.norm_eps)
    logits = qmatmul(x.reshape(-1, x.shape[-1]).to(torch.bfloat16),
                     weights.lm_head)
    if logits.shape[-1] > arch.vocab_size:
        logits = logits[:, :arch.vocab_size]
    if arch.final_softcap:
        logits = arch.final_softcap * torch.tanh(logits / arch.final_softcap)
    return logits


def _run_layers(arch: Arch, weights: ModelWeights, kv: BatchedKV, x, pos,
                active, cos_t, sin_t, impl: str, kv_append: str,
                n_sel: int, s_live, dot_impl: str):
    """The layer loop of both steps; the kernel path ends in one bulk
    append (the indexed write for a layer prefix, a verify window, or
    kv_append "dus"). dot_impl reaches the kernel path's attention only:
    the plain path attends in f32, as the JAX package's jnp path does."""
    if impl != "kernel":
        for li in range(n_sel):
            x = _layer_step_plain(arch, x, weights.layers, kv, pos, active,
                                  cos_t, sin_t, li)
        return x
    # the kernels' int32 vectors, made once per step rather than per layer
    pos, active = pos.to(torch.int32), active.to(torch.int32)
    rows = []
    for li in range(n_sel):
        x, r = _layer_step_deferred(arch, x, weights.layers, kv, pos, active,
                                    cos_t, sin_t, li, s_live, dot_impl)
        rows.append(r)
    _bulk_append(arch, kv, rows, pos, active, kv_append, n_sel,
                 x.dim() == 3)
    return x


def _bulk_append(arch: Arch, kv: BatchedKV, rows: list, pos, active,
                 kv_append: str, n_sel: int, verify: bool) -> None:
    """The kernel path's cache write after the layer loop: every layer's
    rows in one in-place append (the indexed write for a layer prefix, a
    verify window, or kv_append "dus")."""
    stacked = tuple(torch.stack(parts) for parts in zip(*rows))
    if kv_append == "dus" or n_sel < arch.n_layers or verify:
        kv_update.append_rows_stacked_dus(kv.caches, stacked, pos, active)
    else:
        kv_update.append_rows_stacked(kv.caches, stacked, pos, active)


@torch.inference_mode()
def batched_decode_step(arch: Arch, weights: ModelWeights, kv: BatchedKV,
                        tokens, pos, active, impl: str | None = None,
                        kv_append: str | None = None,
                        n_layers: int | None = None, s_live=None,
                        dot_impl: str = "f32"):
    """One decode step for B sequences.

    tokens [B] int; pos [B] (each sequence's write position); active [B]
    bool (inactive slots compute but neither write KV nor advance). impl /
    kv_append: see resolve_impl. n_layers: run only the first n layers (a
    speculative draft through the resident prefix); rows are written for
    those layers only. s_live: the caller guarantees max(pos) < s_live
    (inactive slots' frozen row included); attention reads no cache row at
    or past it. dot_impl: the kernel path's cache-dot form ("f32", "bf16",
    "int8", "int8_s", "int8_v"; ops/cuda/batched_attention.py). The cache
    is written in place. Returns (logits [B, V] f32, kv)."""
    dev = weights.output_norm.device
    tokens = _vec(tokens, dev, torch.long).reshape(-1)
    pos = _vec(pos, dev, torch.long).reshape(-1)
    active = _vec(active, dev, torch.bool).reshape(-1)
    impl, kv_append = resolve_impl(impl, kv_append, tokens.shape[0],
                                   kv.k)
    x = embed_lookup(weights.embed, tokens, out_dtype=torch.float32)
    if arch.embed_scale != 1.0:
        x = x * arch.embed_scale
    cos_t, sin_t = _rope_rows(weights, pos[:, None])
    n_sel = n_layers if n_layers is not None else arch.n_layers
    x = _run_layers(arch, weights, kv, x, pos, active, cos_t, sin_t, impl,
                    kv_append, n_sel, s_live, dot_impl)
    return _head(arch, weights, x), kv


@torch.inference_mode()
def batched_verify_step(arch: Arch, weights: ModelWeights, kv: BatchedKV,
                        tokens, pos, active, impl: str | None = None,
                        s_live=None, dot_impl: str = "f32"):
    """Speculative verify over the whole batch: tokens [B, T] = [anchor,
    draft_0 .. draft_{T-2}] per sequence, written and attended at positions
    [pos, pos + T). Rows past a sequence's accepted prefix are dead: never
    attended (attention masks by position) and overwritten by later steps.
    impl and dot_impl as in batched_decode_step; the kernel path attends the
    stacked cache plus a causal T-row virtual block, then writes all rows
    with one indexed write per cache. Returns (logits [B, T, V] f32, kv)."""
    dev = weights.output_norm.device
    tokens = _vec(tokens, dev, torch.long)
    b_n, t_n = tokens.shape
    pos = _vec(pos, dev, torch.long).reshape(-1)
    active = _vec(active, dev, torch.bool).reshape(-1)
    impl, _ = resolve_impl(impl, "dus", b_n, kv.k)
    x = embed_lookup(weights.embed, tokens.reshape(-1),
                     out_dtype=torch.float32).reshape(b_n, t_n, -1)
    if arch.embed_scale != 1.0:
        x = x * arch.embed_scale
    cos_t, sin_t = _rope_rows(
        weights, pos[:, None] + torch.arange(t_n, device=dev))
    x = _run_layers(arch, weights, kv, x, pos, active, cos_t, sin_t, impl,
                    "dus", arch.n_layers, s_live, dot_impl)
    return _head(arch, weights, x).reshape(b_n, t_n, -1), kv


# --- tensor parallelism (parallel/tp.py, parallel/dp.py) ---------------------
# The batched step over one tp row of a mesh, the JAX package's step body
# with tp_axis: each shard runs its column products, batched flash and the
# KV append on its own heads, over a BatchedKV of its own ([L, B, Hkv/tp, S,
# D]); the row products' f32 partials and the LM head's partial logits are
# summed in shard order on the first shard's device (ops/layers._psum), the
# embedding's K-slices concatenated (models/llama.tp_embed). Entries of
# another process's shards are None.


def _tp_layer(arch_l: Arch, x, lws: list, kvs: list, vecs: list, ropes: list,
              layer: int, impl: str, dot_impl: str, row):
    """One block over tp shards (arch_l: the shards' local arch). vecs:
    each shard's (pos, active) on its device. Returns (x, each shard's
    rows for the bulk append, or None on the plain path)."""
    home = x.device
    decode = x.dim() == 2
    hq, d = arch_l.n_heads, arch_l.head_dim
    parts, rows = [], []
    xs = [None if lw is None else handoff(x, dev)
          for lw, dev in zip(lws, row)]
    for lw, kv, vec, rope, xd in zip(lws, kvs, vecs, ropes, xs):
        if lw is None:
            parts.append(None)
            rows.append(None)
            continue
        pos, active = vec
        q, k_t, v_t = _qkv_rows(arch_l, xd, lw, rope[0], rope[1], layer)
        if impl == "kernel":
            att, r = _attend_deferred(arch_l, q, k_t, v_t, kv, pos, active,
                                      layer, decode, dot_impl=dot_impl)
        else:
            att, r = _attend_plain(arch_l, q, k_t, v_t, kv, pos, active,
                                   layer), None
        parts.append(qmatmul(att.reshape(-1, hq * d).to(torch.bfloat16),
                             lw.wo, layer=layer))
        rows.append(r)
    lw0 = _home(lws)
    o = _psum(parts, home, row).reshape(x.shape)
    if arch_l.post_norms:
        o = rms_norm(o, _norm_w(arch_l, lw0.attn_post_norm, layer),
                     arch_l.norm_eps)
    x = x + o
    hf = rms_norm(x, _norm_w(arch_l, lw0.ffn_norm, layer), arch_l.norm_eps) \
        .to(torch.bfloat16).reshape(-1, x.shape[-1])
    hfs = [None if lw is None else handoff(hf, dev)
           for lw, dev in zip(lws, row)]
    dn = _psum([None if lw is None else dense_ffn(arch_l, hh, lw, layer)
                for lw, hh in zip(lws, hfs)], home, row).reshape(x.shape)
    if arch_l.post_norms:
        dn = rms_norm(dn, _norm_w(arch_l, lw0.ffn_post_norm, layer),
                      arch_l.norm_eps)
    return x + dn, rows


def _tp_step(arch: Arch, shards: list, kvs: list, tokens, pos, active, row,
             kv_append, n_layers, dot_impl: str):
    if len(shards) != len(row) or len(kvs) != len(row):
        raise ValueError(f"{len(shards)} weight and {len(kvs)} cache shards "
                         f"for a {len(row)}-way TP row")
    if arch.n_experts:
        raise NotImplementedError(
            "MoE x TP serving not supported - DP replicates and works")
    arch_l = arch.local_arch(len(row))
    dev = _home(shards).output_norm.device
    tokens = _vec(tokens, dev, torch.long)
    pos = _vec(pos, dev, torch.long).reshape(-1)
    active = _vec(active, dev, torch.bool).reshape(-1)
    verify = tokens.dim() == 2
    b_n = tokens.shape[0]
    impl, kv_append = resolve_impl(None, kv_append, b_n, _home(kvs).k)
    positions = pos[:, None]
    if verify:
        positions = positions + torch.arange(tokens.shape[1], device=dev)
    x = tp_embed(arch, shards, tokens.reshape(-1), row)
    if verify:
        x = x.reshape(b_n, tokens.shape[1], -1)
    vtype = (torch.int32, torch.int32) if impl == "kernel" \
        else (torch.long, torch.bool)
    vecs, ropes = [], []
    for w, d in zip(shards, row):
        vecs.append((handoff(pos, d, vtype[0]), handoff(active, d, vtype[1]))
                    if w is not None else None)
        ropes.append(_rope_rows(w, handoff(positions, d)) if w is not None
                     else None)
    n_sel = n_layers if n_layers is not None else arch.n_layers
    lws = [None if w is None else w.layers for w in shards]
    rows = [[] for _ in shards]
    for li in range(n_sel):
        x, r = _tp_layer(arch_l, x, lws, kvs, vecs, ropes, li, impl,
                         dot_impl, row)
        for s, rs in enumerate(r):
            if rs is not None:
                rows[s].append(rs)
    if impl == "kernel":
        for s, kv in enumerate(kvs):
            if kv is not None:
                _bulk_append(arch, kv, rows[s], *vecs[s], kv_append, n_sel,
                             verify)
    logits = tp_head_logits(arch, shards, x.reshape(-1, x.shape[-1]),
                            all_logits=True, row=row)
    return logits.reshape(b_n, -1, logits.shape[-1]) if verify else logits


@torch.inference_mode()
def batched_decode_step_tp(arch: Arch, shards: list, kvs: list, tokens, pos,
                           active, row, n_layers: int | None = None,
                           dot_impl: str = "f32"):
    """batched_decode_step over a tp row (the JAX batched_decode_body with
    tp_axis): shards (parallel/tp.shard_weights) and kvs (one BatchedKV of
    the shard's heads each) on the row's devices; arch the whole model's;
    impl and kv_append as batched_decode_step's defaults. Returns (logits
    [B, V] f32 on the first shard's device, kvs)."""
    tokens = torch.as_tensor(tokens).reshape(-1)
    return _tp_step(arch, shards, kvs, tokens, pos, active, row, None,
                    n_layers, dot_impl), kvs


@torch.inference_mode()
def batched_verify_step_tp(arch: Arch, shards: list, kvs: list, tokens, pos,
                           active, row, dot_impl: str = "f32"):
    """batched_verify_step over a tp row: tokens [B, T]. Returns (logits
    [B, T, V] f32 on the first shard's device, kvs)."""
    return _tp_step(arch, shards, kvs, tokens, pos, active, row, "dus",
                    None, dot_impl), kvs
