"""Llama-family model: forward passes over quantized weights (PyTorch).

Port of ntransformer_tpu/models/llama.py. Two things change with the
framework:

  * a Python loop over the layers takes the place of `lax.scan`; each
    quantized matmul reads its layer of the stacked [L, ...] planes as a
    free view;
  * the KV cache is written IN PLACE (`kv.k[l][:, pos:pos+T] = k`) where
    the JAX package donates the cache buffer to a jitted forward; `forward`
    still returns the cache so callers read the same as in the JAX package.

`forward(..., tp=mesh)` runs tensor parallelism (parallel/tp.py): one
process drives a list of shards, the replicated work on the first shard's
device and the shards' partials summed there in shard order
(tp_layer_step); with cp= as well, each TP shard's attention runs as
context parallelism over its cache slices (parallel/cp.py).
`forward(..., ep=mesh)` runs expert parallelism (parallel/ep.py): each
MoE layer's experts shard by shard, everything else once.

Mixture-of-experts layers (mixtral, qwen3moe) run `moe_ffn`: at T = 1 the
k routed experts go through the T = 1 kernels' device-side select (the
expert index never leaves the card), at T > 1 a dense loop over every
expert weighs each row by its routing, as the JAX package does.

`pos`, the first cache row a forward writes, is a host int or a 0-d int64
tensor on the weights' device (the JAX forward's traced `pos`), and
`n_valid`, the real tokens of a bucketed prefill, takes the same form.
With tensors nothing reads them on the host: the RoPE rows are an
index_select at pos + arange(T), all T cache rows are written with
index_copy_ (a padded row with the value it held, the JAX forward's
where + dynamic_update_slice), the mask is built on the device, the flash
kernel reads pos on the card and the head picks row n_valid - 1 with
index_select, so the forward can be captured once and replayed at any
position (models/graphs.py). The two forms compute the same values. A
device pos serves every forward, the meshes' included, at any T: each shard
reads it on its own device (a TP shard's RoPE rows and cache write, a CP
shard's masked write of the rows it owns and its attention partials).
"""
from __future__ import annotations

import dataclasses
import math
import operator
from dataclasses import dataclass

import torch

from ..ops.layers import (_on, _psum, apply_rope, attention,
                          attention_cp_dispatch, rms_norm, swiglu)
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

    def local_arch(self, tp: int) -> "Arch":
        """The arch one tensor-parallel shard computes: its share of the
        query and KV heads (parallel/tp.py)."""
        return dataclasses.replace(self, n_heads=self.n_heads // tp,
                                   n_kv_heads=self.n_kv_heads // tp)


@dataclass
class LayerWeights:
    """One block's weights; in a model every tensor is stacked [L, ...].
    wqkv / w_gate_up are the fused matrices (fuse_layer_weights); the
    optional vectors are the qwen2 biases, gemma2 post norms and qwen3/gemma3
    q/k norms. A mixture-of-experts layer has no dense FFN: its router
    ffn_gate_inp [H -> E] and the expert matrices w_*_exps, whose planes
    carry a leading expert axis ([E, rows, N]; [L, E, rows, N] stacked)."""

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
    ffn_gate_inp: QLinear | None = None
    w_gate_exps: QLinear | None = None
    w_up_exps: QLinear | None = None
    w_down_exps: QLinear | None = None


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


def _concat_qlinear(parts: list[QLinear], tp: int = 1) -> QLinear | None:
    """Concatenate QLinears along the output (lane) axis when they share
    dtype and K. tp > 1: the INTERLEAVED lane order [q_0|k_0|v_0 | q_1|k_1|
    v_1 | ...], part_s being a part's s-th N/tp column slice, so a
    contiguous column split over tp shards hands each shard its own q|k|v
    (the JAX package's order; parallel/tp.shard_weights builds the shards'
    planes from it without the interleaved copy). None when a part does not
    split evenly."""
    if any(p is None for p in parts):
        return None
    if len({p.dtype for p in parts}) != 1 or len({p.k for p in parts}) != 1:
        return None
    if tp > 1 and any(p.n % tp for p in parts):
        return None
    planes = {}
    for nm in parts[0].planes:
        chunks = []
        for s in range(tp):
            for p in parts:
                w = p.planes[nm].shape[-1] // tp
                chunks.append(p.planes[nm][..., s * w:(s + 1) * w])
        planes[nm] = torch.cat(chunks, dim=-1)
    return QLinear(parts[0].dtype, parts[0].k, sum(p.n for p in parts),
                   planes)


def fuse_layer_weights(lw: LayerWeights, tp: int = 1) -> LayerWeights:
    """Build fused wqkv / w_gate_up (dropping the unfused copies); a
    mixed-dtype triple fuses q|k alone. Expert planes stay unfused. tp > 1
    builds the interleaved lane order of _concat_qlinear."""
    wqkv = _concat_qlinear([lw.wq, lw.wk, lw.wv], tp)
    w_gate_up = _concat_qlinear([lw.w_gate, lw.w_up], tp)
    out = lw
    if wqkv is not None:
        out = dataclasses.replace(out, wqkv=wqkv, wq=None, wk=None, wv=None)
    else:
        wqk = _concat_qlinear([lw.wq, lw.wk], tp)
        if wqk is not None:
            out = dataclasses.replace(out, wqk=wqk, wq=None, wk=None)
    if w_gate_up is not None:
        out = dataclasses.replace(out, w_gate_up=w_gate_up, w_gate=None,
                                  w_up=None)
    return out


def _flatten_experts(ql: QLinear) -> QLinear:
    """[..., E, rows, N] planes -> [(...·E), rows, N], a free reshape: expert
    e of layer l is matrix l·E + e of the flattened stack."""
    return QLinear(ql.dtype, ql.k, ql.n,
                   {nm: a.reshape((-1,) + tuple(a.shape[-2:]))
                    for nm, a in ql.planes.items()})


def route(arch: Arch, hf: torch.Tensor, router: QLinear,
          layer: int | None = None):
    """(weights [T, K] f32, expert ids [T, K] int64) of the rows hf [T, H]:
    f32 softmax over every router logit, top-k, renormalized."""
    logits = qmatmul(hf, router, layer=layer)                 # [T, E]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    topv, tope = torch.topk(probs, arch.n_experts_used, dim=-1)
    return topv / topv.sum(-1, keepdim=True), tope


def expert_ffn(arch: Arch, hf: torch.Tensor, gate: QLinear, up: QLinear,
               down: QLinear, **at) -> torch.Tensor:
    """One expert's SwiGLU FFN of hf [T, H] -> [T, H] f32; `at` is qmatmul's
    layer= or sel= into stacked expert planes."""
    g = qmatmul(hf, gate, **at)
    u = qmatmul(hf, up, **at)
    return qmatmul(swiglu(g, u, arch.act).to(torch.bfloat16), down, **at)


def moe_ffn(arch: Arch, hf: torch.Tensor, lw: LayerWeights,
            layer: int | None = None, ep: list | None = None) -> torch.Tensor:
    """Mixture-of-experts FFN (mixtral; qwen3moe). hf [T, H] bf16 (after
    ffn_norm); returns [T, H] f32. layer: the host index of stacked
    [L, E, ...] expert planes (None: planes [E, ...] of one layer).

    Routing: f32 softmax over every router logit, top-k, renormalized (the
    JAX package's order: the k weights summed j = 0..k-1, descending).
    T = 1: only the k routed experts run, each through the flattened
    stacked planes with its index as a device tensor (`qmatmul(sel=)`):
    the T = 1 kernels read it on the card, so neither the index nor the
    weight is read to the host. T > 1: the routing weights scattered to a
    [T, E] matrix and out += column e * expert(e) for e = 0..E-1 in f32,
    each expert by host index (the JAX semantics; a token gather would
    change the plans, and so the bits, with the tokens routed).

    ep: expert parallelism (parallel/ep.py), the shards' LayerWeights, each
    holding its E/ep experts' planes on its device; the router is read from
    lw. e_local is read off the planes' shapes. At T = 1 shard s runs
    selection j as local expert e = id - s * e_local, clamped into its
    range and weighted 0 where the selection is another shard's (computed
    on the device, as JAX masks it); at T > 1 its dense loop reads routing
    columns s * e_local + e. The shards' outputs are summed in shard order
    on hf's device (JAX's psum)."""
    E, K = arch.n_experts, arch.n_experts_used
    T = hf.shape[0]
    topv, tope = route(arch, hf, lw.ffn_gate_inp, layer)
    shards = [lw] if ep is None else ep
    e_local = next(iter(shards[0].w_gate_exps.planes.values())).shape[-3]
    base = (layer * e_local) if layer is not None else 0
    if T == 1:
        ids = tope[0].to(torch.int32)                        # on the device
    else:
        cols = torch.zeros(T, E, dtype=torch.float32, device=hf.device)
        cols.scatter_(1, tope, topv)
    parts = []
    for s, sw in enumerate(shards):
        gql = _flatten_experts(sw.w_gate_exps)
        uql = _flatten_experts(sw.w_up_exps)
        dql = _flatten_experts(sw.w_down_exps)
        dev = next(iter(gql.planes.values())).device
        x = hf.to(dev)
        out = torch.zeros(T, hf.shape[-1], dtype=torch.float32, device=dev)
        for j in range(K if T == 1 else e_local):
            if T > 1:
                w, at = cols[:, s * e_local + j:s * e_local + j + 1], \
                    dict(layer=base + j)
            elif ep is None:
                w, at = topv[0, j], dict(sel=ids[j:j + 1] + base)
            else:
                e_loc = ids[j:j + 1] - s * e_local
                w = torch.where((e_loc[0] >= 0) & (e_loc[0] < e_local),
                                topv[0, j], 0.0)
                at = dict(sel=(e_loc.clamp(0, e_local - 1) + base).to(dev))
            out = out + w.to(dev) * expert_ffn(arch, x, gql, uql, dql, **at)
        parts.append(out)
    return _psum(parts, hf.device)


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


def attn_block(arch: Arch, x, lw: LayerWeights, kv_k, kv_v, pos, cos_t,
               sin_t, n_valid=None, layer: int = 0, abs_layer=None,
               cp_plan=None):
    """The attention half of one block through its residual add. x [T, H]
    f32; kv_k/kv_v [Hkv, S, D] views of this layer's cache, written in
    place at rows [pos, pos + n_valid); pos and n_valid host ints or 0-d
    device tensors (forward; then all T rows are written, a padded one
    with what it held). `layer` indexes the stacked weights; abs_layer
    (default `layer`) is the layer's depth in the model,
    which picks its sliding window and rope table (a streamed layer's
    weights are a stack of one). Under context parallelism (parallel/cp.py)
    kv_k/kv_v are lists of the shards' [Hkv, S/n, D] views, shard i holding
    global rows [i*S/n, (i+1)*S/n); cp_plan: a device pos's cp_write_plan,
    made once a forward (None: made here)."""
    h = rms_norm(x, _norm_w(arch, lw.attn_norm, layer),
                 arch.norm_eps).to(torch.bfloat16)
    o = attn_heads(arch, h, lw, kv_k, kv_v, pos, cos_t, sin_t, n_valid,
                   layer, abs_layer, cp_plan)
    if arch.post_norms:
        o = rms_norm(o, _norm_w(arch, lw.attn_post_norm, layer),
                     arch.norm_eps)
    return x + o


def attn_heads(arch: Arch, h, lw: LayerWeights, kv_k, kv_v, pos, cos_t,
               sin_t, n_valid=None, layer: int = 0, abs_layer=None,
               cp_plan=None):
    """Attention from the normed input h [T, H] bf16 through the output
    projection: [T, H] f32, before any post norm. Under tensor parallelism
    `arch` is a shard's local arch and the result its row-parallel partial
    of wo's product (tp_layer_step sums the shards')."""
    T = h.shape[0]
    Hq, Hkv, D = arch.n_heads, arch.n_kv_heads, arch.head_dim
    q_scale = arch.query_scale if arch.query_scale else 1.0 / math.sqrt(D)
    window, local = layer_window(arch, layer if abs_layer is None
                                 else abs_layer)
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
    cp = isinstance(kv_k, list)
    # a device pos: the new rows' indices, built on the device (the caller
    # keeps them inside the cache, on the host), and with a device n_valid
    # the rows to keep; every one of the T rows is written
    idx = keep = None
    if isinstance(pos, torch.Tensor):
        ar = torch.arange(T, device=pos.device)
        idx = pos + ar
        if n_valid is not None:
            keep = (ar < n_valid)[None, :, None]
    n = T if n_valid is None or idx is not None else int(n_valid)
    if cp:
        rows = kv_k[0].shape[1] * len(kv_k)
    else:
        rows = (kv_k[0] if isinstance(kv_k, tuple) else kv_k).shape[1]
    if idx is None and pos + T > rows:
        raise ValueError(f"rows [{pos}, {pos + T}) exceed the {rows}-row "
                         "cache")
    # padding rows beyond n_valid keep the cache's previous contents
    if cp:
        if window is not None or arch.attn_softcap:
            raise NotImplementedError(
                "sliding-window/softcap attention (gemma2) is not supported "
                "under context parallelism")
        # each shard takes the new rows that fall in its slice; the JAX
        # package scatters the others, and padding, out of bounds
        s_local = kv_k[0].shape[1]
        if idx is not None:
            if cp_plan is None:
                cp_plan = cp_write_plan(pos, n_valid, T, kv_k)
            kb, vb = k.to(kv_k[0].dtype), v.to(kv_v[0].dtype)
        for i, (kk, vv) in enumerate(zip(kv_k, kv_v)):
            if idx is not None:
                _write_cp_rows(kk, vv, kb, vb, cp_plan[i])
                continue
            lo, hi = max(pos, i * s_local), min(pos + n, (i + 1) * s_local)
            if lo < hi:
                rows_new = slice(lo - pos, hi - pos)
                dst = slice(lo - i * s_local, hi - i * s_local)
                kk[:, dst] = k[:, rows_new].to(kk.device, kk.dtype)
                vv[:, dst] = v[:, rows_new].to(vv.device, vv.dtype)
        att = attention_cp_dispatch(q, kv_k, kv_v, pos, T,
                                    1.0 / math.sqrt(D))
    elif isinstance(kv_k, tuple):
        # int8 cache (codes, scales): absmax-quantize the new rows per
        # (head, position), write them, then attend a bf16 dequant
        (kc, ksc), (vc, vsc) = kv_k, kv_v
        kq, ks_new, vq, vs_new = quantize_rows(k, v)
        for dst, new in ((kc, kq), (ksc, ks_new), (vc, vq), (vsc, vs_new)):
            if idx is None:
                dst[:, pos:pos + n] = new[:, :n]
            else:
                _write_rows(dst, new, idx, keep)
        kf = kc.to(torch.bfloat16) * ksc.to(torch.bfloat16)
        vf = vc.to(torch.bfloat16) * vsc.to(torch.bfloat16)
    else:
        for dst, new in ((kv_k, k), (kv_v, v)):
            if idx is None:
                dst[:, pos:pos + n] = new[:, :n].to(dst.dtype)
            else:
                _write_rows(dst, new.to(dst.dtype), idx, keep)
        kf, vf = kv_k, kv_v
    if not cp:
        att = attention(q, kf, vf, pos, T, q_scale, window=window,
                        softcap=arch.attn_softcap)
    return qmatmul(att.reshape(T, Hq * D).to(torch.bfloat16), lw.wo,
                   layer=layer)


def _write_rows(dst: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
                keep) -> None:
    """Write new [Hkv, T, ...] into dst's rows idx (axis 1) on the device;
    keep [1, T, 1] (a device n_valid's rows) takes the rows that dst holds
    where it is false, as the JAX forward merges the padding."""
    if keep is not None:
        new = torch.where(keep, new, dst.index_select(1, idx))
    dst.index_copy_(1, idx, new)


def cp_write_plan(pos: torch.Tensor, n_valid, t_n: int,
                  slices: list) -> list:
    """The indices of a device-pos write of t_n new rows at global rows
    pos + t (t < n_valid, every t without it) into a CP cache's shard
    slices (each [Hkv, S_l, D] or [L, Hkv, S_l, D], shard i holding global
    rows [i S_l, (i+1) S_l)), one (rows, keep, src) a shard on its device:
    the same for every layer, so a forward makes them once. Each shard
    reads and rewrites a fixed window of W = min(t_n, S_l) distinct local
    rows that holds every row it owns of the t_n (its start clamped into
    the slice): rows, the window; src, the new row each takes; keep, where
    a valid token lands on it. So no index repeats and the rows outside the
    shard drop out, as the JAX package's scatter drops them."""
    plan = []
    for i, sl in enumerate(slices):
        dev, s_l = sl.device, sl.shape[-2]
        w = min(t_n, s_l)
        p = pos.to(dev)
        rows = (p - i * s_l).clamp(0, s_l - w) + torch.arange(w, device=dev)
        t = rows + i * s_l - p                           # the source token
        keep = (t >= 0) & (t < (t_n if n_valid is None
                                else n_valid.to(dev)))
        plan.append((rows, keep[None, :, None], t.clamp(0, t_n - 1)))
    return plan


def _write_cp_rows(kk: torch.Tensor, vv: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, plan) -> None:
    """One CP shard's part of a device-pos write (cp_write_plan): the new
    rows k/v [Hkv, T, D], in the cache's dtype, merged into the shard's
    window of kk/vv [Hkv, S_l, D] on the device."""
    rows, keep, src = plan
    for dst, new in ((kk, k), (vv, v)):
        new = new.to(dst.device).index_select(1, src)
        dst.index_copy_(1, rows, torch.where(keep, new,
                                             dst.index_select(1, rows)))


def quantize_rows(k: torch.Tensor, v: torch.Tensor):
    """Absmax int8 quantization of new k/v rows, one f32 scale per row of
    the last axis: (k codes, k scales, v codes, v scales), scales keeping a
    trailing axis of 1. The divisor is a tensor, so the division is IEEE on
    the card too (a Python scalar divisor goes through its reciprocal)."""
    ka = k.abs().amax(-1, keepdim=True)
    va = v.abs().amax(-1, keepdim=True)
    ks = ka / torch.full_like(ka, 127.0) + 1e-9
    vs = va / torch.full_like(va, 127.0) + 1e-9
    return (torch.round(k / ks).to(torch.int8), ks,
            torch.round(v / vs).to(torch.int8), vs)


def layer_step(arch: Arch, x, lw: LayerWeights, kv_k, kv_v, pos, cos_t,
               sin_t, n_valid=None, layer: int = 0, abs_layer=None,
               ep: list | None = None, cp_plan=None):
    """One transformer block. x [T, H] f32; kv_k/kv_v this layer's cache
    views ((codes, scales) tuples for an int8 cache; lists of the shards'
    views under context parallelism); pos, layer, abs_layer and cp_plan as
    in attn_block;
    ep: the expert-parallel shards' LayerWeights (moe_ffn); returns x."""
    x = attn_block(arch, x, lw, kv_k, kv_v, pos, cos_t, sin_t, n_valid,
                   layer, abs_layer, cp_plan)
    hf = rms_norm(x, _norm_w(arch, lw.ffn_norm, layer),
                  arch.norm_eps).to(torch.bfloat16)
    if arch.n_experts:
        dn = moe_ffn(arch, hf, lw, layer, ep)
    else:
        dn = dense_ffn(arch, hf, lw, layer)
    if arch.post_norms:
        dn = rms_norm(dn, _norm_w(arch, lw.ffn_post_norm, layer),
                      arch.norm_eps)
    return x + dn


def dense_ffn(arch: Arch, hf: torch.Tensor, lw: LayerWeights,
              layer: int) -> torch.Tensor:
    """The SwiGLU FFN of a dense layer: hf [T, H] bf16 -> [T, H] f32."""
    if lw.w_gate_up is not None:
        gu = qmatmul(hf, lw.w_gate_up, layer=layer)
        it = gu.shape[-1] // 2
        g, u = gu[:, :it], gu[:, it:]
    else:
        g = qmatmul(hf, lw.w_gate, layer=layer)
        u = qmatmul(hf, lw.w_up, layer=layer)
    return qmatmul(swiglu(g, u, arch.act).to(torch.bfloat16), lw.w_down,
                   layer=layer)


def embed_positions(arch: Arch, weights: ModelWeights, tokens: torch.Tensor,
                    pos):
    """Token embedding (f32) + the RoPE table rows of this window (rows
    [pos, pos + T) of [S, d2] or dual [2, S, d2] tables; pos a host int or
    a 0-d device tensor, whose rows are gathered on the device)."""
    T = tokens.shape[0]
    x = embed_lookup(weights.embed, tokens, out_dtype=torch.float32)
    if arch.embed_scale != 1.0:
        x = x * arch.embed_scale
    if isinstance(pos, torch.Tensor):
        idx = pos + torch.arange(T, device=pos.device)
        return (x, weights.rope_cos.index_select(-2, idx),
                weights.rope_sin.index_select(-2, idx))
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
    elif isinstance(n_valid, torch.Tensor):
        # the JAX dynamic_slice at n_valid - 1, on the device
        sel = x.index_select(0, n_valid.reshape(1) - 1)
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


# --- tensor parallelism (parallel/tp.py) -------------------------------------
# One process drives every shard it owns. The replicated work (embedding
# reassembly, norms, residual adds, the LM head's sum) runs on the first
# device of those shards; each shard's column- and row-parallel products,
# its heads' attention and its cache run on its own. Where the JAX package
# psums (after wo, after w_down, the LM head's partial logits) the shards'
# f32 partials are summed here in shard order, so the bits do not depend on
# where the shards live; the embedding's K-slices are concatenated (the JAX
# all-gather). On one card every hand-off is a view; across cards a peer
# copy on the current streams. A mesh row that spans processes
# (parallel/multihost.Row) holds None for the other processes' shards, whose
# partials are all-gathered over the row's process group (ops/layers._psum).


def _home(shards: list):
    """The first shard this process holds (None entries: another
    process's)."""
    return next(w for w in shards if w is not None)


def tp_embed(arch: Arch, shards: list, tokens, row=None):
    """Token embedding from the row-sharded table: each shard dequantizes
    its K-slice of the rows, concatenated in shard order on the first
    shard's device. tokens [N] -> x [N, H] f32."""
    dev = _home(shards).output_norm.device
    parts = [None if w is None else
             embed_lookup(w.embed, tokens.to(w.output_norm.device),
                          out_dtype=torch.float32) for w in shards]
    if row is not None:
        from ..parallel.multihost import gather_shards
        parts = gather_shards(parts, row)
    x = torch.cat([p.to(dev) for p in parts], dim=-1)
    if arch.embed_scale != 1.0:
        x = x * arch.embed_scale
    return x


def tp_embed_positions(arch: Arch, shards: list[ModelWeights], tokens,
                       pos, row=None):
    """tp_embed, and each shard's RoPE rows on its own device (None for
    another process's shard); pos a host int or a 0-d device tensor, whose
    rows each shard gathers on its device. Returns (x [T, H] f32, [(cos,
    sin) of each shard])."""
    T = tokens.shape[0]
    x = tp_embed(arch, shards, tokens, row)
    ropes = []
    for w in shards:
        if w is None:
            ropes.append(None)
        elif isinstance(pos, torch.Tensor):
            dev = w.rope_cos.device
            idx = pos.to(dev) + torch.arange(T, device=dev)
            ropes.append((w.rope_cos.index_select(-2, idx),
                          w.rope_sin.index_select(-2, idx)))
        else:
            ropes.append((w.rope_cos[..., pos:pos + T, :],
                          w.rope_sin[..., pos:pos + T, :]))
    return x, ropes


def tp_layer_step(arch: Arch, x, lws: list[LayerWeights], kvs: list, pos,
                  ropes: list, n_valid=None, layer: int = 0, abs_layer=None,
                  row=None, cp_plans=None):
    """One block over tp shards. arch: the shards' local arch; x [T, H] f32
    on the first shard's device; lws, kvs ((k, v) cache views of this
    layer) and ropes one per shard, each on its shard's device (None for
    another process's shard); pos and n_valid host ints or 0-d device
    tensors, which each shard reads on its device; layer / abs_layer as in
    attn_block; cp_plans: under CP x TP with a device pos, each TP shard's
    cp_write_plan. The norms are replicated: the first shard's are read.
    Returns x."""
    dev = x.device
    lw0 = _home(lws)
    h = rms_norm(x, _norm_w(arch, lw0.attn_norm, layer),
                 arch.norm_eps).to(torch.bfloat16)
    plans = cp_plans if cp_plans is not None else [None] * len(lws)
    o = _psum([None if lw is None else
               attn_heads(arch, h.to(rp[0].device), lw, kv[0], kv[1],
                          _on(pos, rp[0].device), rp[0], rp[1],
                          _on(n_valid, rp[0].device), layer, abs_layer, pl)
               for lw, kv, rp, pl in zip(lws, kvs, ropes, plans)], dev, row)
    if arch.post_norms:
        o = rms_norm(o, _norm_w(arch, lw0.attn_post_norm, layer),
                     arch.norm_eps)
    x = x + o
    hf = rms_norm(x, _norm_w(arch, lw0.ffn_norm, layer),
                  arch.norm_eps).to(torch.bfloat16)
    dn = _psum([None if lw is None else
                dense_ffn(arch, hf.to(rp[0].device), lw, layer)
                for lw, rp in zip(lws, ropes)], dev, row)
    if arch.post_norms:
        dn = rms_norm(dn, _norm_w(arch, lw0.ffn_post_norm, layer),
                      arch.norm_eps)
    return x + dn


def tp_head_logits(arch: Arch, shards: list[ModelWeights], x, n_valid=None,
                   all_logits: bool = False, row=None):
    """Final norm, then the row-parallel LM head: shard s multiplies its
    K-slice of the selected rows by its rows of the head, and the partial
    logits are summed in shard order on the first shard's device. n_valid:
    a host int or a 0-d tensor on x's device (its row picked there)."""
    from ..ops.linear import plane_dims
    w = _home(shards).output_norm
    x = rms_norm(x, w + arch.norm_bias if arch.norm_bias != 0.0 else w,
                 arch.norm_eps)
    if all_logits:
        sel = x
    elif isinstance(n_valid, torch.Tensor):
        sel = x.index_select(0, n_valid.reshape(1) - 1)
    elif n_valid is not None:
        sel = x[int(n_valid) - 1:int(n_valid)]
    else:
        sel = x[-1:]
    sel = sel.to(torch.bfloat16)
    head0 = _home(shards).lm_head
    kl, _ = plane_dims(head0.planes, head0.dtype)
    parts = []
    for s, sw in enumerate(shards):
        if sw is None:
            parts.append(None)
            continue
        head = sw.lm_head
        dev = next(iter(head.planes.values())).device
        parts.append(qmatmul(sel[:, s * kl:(s + 1) * kl].to(dev), head))
    logits = _psum(parts, x.device, row)
    if logits.shape[-1] > arch.vocab_size:
        logits = logits[:, :arch.vocab_size]
    if arch.final_softcap:
        logits = arch.final_softcap * torch.tanh(logits / arch.final_softcap)
    return logits


def _forward_tp(arch: Arch, shards: list[ModelWeights], kv: list,
                tokens, pos, layer_sel, n_valid, all_logits: bool,
                with_cosine: bool, mesh, cp=None):
    tp = len(mesh)
    if len(shards) != tp or len(kv) != tp:
        raise ValueError(f"{len(shards)} weight and {len(kv)} cache shards "
                         f"for a {tp}-way TP mesh")
    if arch.n_experts:
        raise NotImplementedError(
            "MoE x tensor parallelism not supported - shard the experts "
            "instead (parallel/ep.py)")
    if cp is not None:
        _check_cp_kv(kv, cp)
        n_layers = kv[0][0].k.shape[0]
    else:
        n_layers = _home(kv).k.shape[0]
    arch_l = arch.local_arch(tp)
    dev = _home(shards).output_norm.device
    tokens = torch.as_tensor(tokens, device=dev).reshape(-1)
    x, ropes = tp_embed_positions(arch, shards, tokens, pos, mesh)
    indices = (range(n_layers) if layer_sel is None
               else [int(i) for i in layer_sel])
    lws = [None if w is None else w.layers for w in shards]
    plans = None
    if cp is not None and isinstance(pos, torch.Tensor):
        plans = [cp_write_plan(_on(pos, col[0].k.device),
                               _on(n_valid, col[0].k.device),
                               tokens.shape[0], [c.k for c in col])
                 for col in kv]
    cosines = []
    for li in indices:
        if cp is not None:
            views = [([c.k[li] for c in col], [c.v[li] for c in col])
                     for col in kv]
        else:
            views = [None if c is None else c.layer(li) for c in kv]
        x2 = tp_layer_step(arch_l, x, lws, views, pos, ropes, n_valid,
                           layer=li, row=mesh, cp_plans=plans)
        if with_cosine:
            cosines.append(_cosine(x, x2))
        x = x2
    logits = tp_head_logits(arch, shards, x, n_valid, all_logits, mesh)
    return logits, kv, (torch.stack(cosines) if with_cosine else None)


def _check_cp_kv(kv: list, cp) -> None:
    """A CP cache (kv a list of the shards' caches; under CP x TP a list of
    such lists, one a TP shard) of as many shards as the mesh, bf16."""
    n = len(cp)
    for col in kv:
        if len(col) != n:
            raise ValueError(f"{len(col)} cache shards for a {n}-way CP "
                             "mesh")
        if any(shard.quantized for shard in col):
            raise NotImplementedError(
                "int8 KV + context parallelism is not supported (the JAX "
                "package's global-position write would clamp into the "
                "sequence-sharded cache)")


@torch.inference_mode()
def forward(arch: Arch, weights: ModelWeights, kv: KVCache, tokens, pos,
            layer_sel=None, n_valid=None, all_logits: bool = False,
            with_cosine: bool = False, cp=None, tp=None, ep=None):
    """Forward pass over (a subset of) the layer stack.

    tokens [T] int; pos: write offset into the cache, a host int or a 0-d
    (or 1-element) int64 tensor on the weights' device (a mesh's: its first
    device), which nothing reads on the host (the module docstring; the
    caller keeps rows [pos, pos + T) inside the cache). layer_sel: indices
    of the layers to run, in order (None = all). n_valid: real tokens of a
    bucketed prefill, of pos's form (a host int, or with a device pos a 0-d
    int64 tensor beside it). The cache is updated in place. Returns
    (logits [T or 1, V] f32, kv, cosines [len(layers)] f32 or None). The
    meshes (tuples of torch devices, parallel/):

      cp: context parallelism (parallel/cp.py); kv is the list of the
          shards' bf16 caches (cp.make_cp_kv), and everything but
          attention runs on the weights' device;
      tp: tensor parallelism (parallel/tp.py); weights and kv are the lists
          of the shards' ModelWeights (tp.shard_weights) and caches
          (tp.make_tp_kv), and `arch` the whole model's;
      cp and tp together: the (cp, tp) mesh's rows as cp and its first row,
          where the weights live, as tp (parallel/cp.py make_cp_tp_mesh);
          kv is the [tp][cp] grid of cp.make_cp_tp_kv, and each TP shard's
          attention runs as CP over its column of the grid;
      ep: expert parallelism (parallel/ep.py); weights is the list of the
          shards' ModelWeights (ep.shard_weights_ep), the cache one cache
          on the first device, where everything but the experts runs."""
    if isinstance(pos, torch.Tensor):
        if n_valid is not None and not isinstance(n_valid, torch.Tensor):
            raise ValueError("a device pos takes n_valid as a 0-d device "
                             "tensor, not a host int")
        pos = pos.reshape(())
        if n_valid is not None:
            n_valid = n_valid.reshape(())
    else:
        if isinstance(n_valid, torch.Tensor):
            raise ValueError("a device n_valid goes with a device pos")
        pos = operator.index(pos)
    if ep is not None and (cp is not None or tp is not None):
        raise ValueError("--ep is its own mesh (expert axis); it does not "
                         "compose with --tp/--cp")
    if tp is not None:
        return _forward_tp(arch, weights, kv, tokens, pos, layer_sel,
                           n_valid, all_logits, with_cosine, tp, cp)
    lws_ep = None
    if ep is not None:
        if len(weights) != len(ep):
            raise ValueError(f"{len(weights)} weight shards for a "
                             f"{len(ep)}-way EP mesh")
        lws_ep = [w.layers for w in weights]
        weights = weights[0]
    dev = weights.output_norm.device
    tokens = torch.as_tensor(tokens, device=dev).reshape(-1)
    if cp is not None:
        _check_cp_kv([kv], cp)
    x, cos_t, sin_t = embed_positions(arch, weights, tokens, pos)
    n_layers = (kv if cp is None else kv[0]).k.shape[0]
    plan = None
    if cp is not None and isinstance(pos, torch.Tensor):
        plan = cp_write_plan(pos, n_valid, tokens.shape[0],
                             [s.k for s in kv])
    indices = (range(n_layers) if layer_sel is None
               else [int(i) for i in layer_sel])
    cosines = []
    for li in indices:
        if cp is None:
            kk, vv = kv.layer(li)
        else:
            kk, vv = [s.k[li] for s in kv], [s.v[li] for s in kv]
        x2 = layer_step(arch, x, weights.layers, kk, vv, pos, cos_t, sin_t,
                        n_valid, layer=li, ep=lws_ep, cp_plan=plan)
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
