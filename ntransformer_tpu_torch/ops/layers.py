"""Elementwise transformer ops and attention (PyTorch).

Port of ntransformer_tpu/ops/layers.py. RMSNorm, RoPE and SwiGLU stay plain
PyTorch. Attention dispatches to the flash kernel (ops/cuda/attention.py)
for prefill-sized q on CUDA, exactly as the JAX package picks its Pallas
kernel; decode-sized q (q_len < 64) is plain PyTorch on every device, as the
JAX package computes it outside Pallas too.

Under context parallelism the cache is split along the sequence axis into
per-shard slices, each on its shard's device (parallel/cp.py); the
attention_cp* functions take the list of slices, compute each shard's
partials on its device, and combine them exactly on q's device, where the
JAX package's pmax and psums over the mesh axis become a max and sums over
the list.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FLASH_MIN_Q = 64  # q_len at which attention takes the flash kernel


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 accumulation; returns x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.to(torch.float32)).to(x.dtype)


def rope_table(max_seq: int, head_dim: int, theta: float, freq_factors=None,
               device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [max_seq, head_dim//2], f32, computed in f32 on the
    CPU (one table for every device) and then placed on `device`."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32) / head_dim))
    if freq_factors is not None:
        inv_freq = inv_freq / torch.as_tensor(freq_factors,
                                              dtype=torch.float32)
    t = torch.arange(max_seq, dtype=torch.float32)
    ang = torch.outer(t, inv_freq)
    return torch.cos(ang).to(device), torch.sin(ang).to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """Rotary embedding. x [T, H, D]; cos/sin [T, D/2].

    interleaved=False: half-split pairs (i, i+D/2) (HF rotate_half / ggml
    NEOX). interleaved=True: adjacent pairs (2i, 2i+1) (ggml NORM)."""
    d2 = x.shape[-1] // 2
    xf = x.to(torch.float32)
    c = cos[:, None, :]
    s = sin[:, None, :]
    if interleaved:
        x0, x1 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c],
                          dim=-1).reshape(x.shape)
    else:
        x0, x1 = xf[..., :d2], xf[..., d2:]
        out = torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor,
           act: str = "silu") -> torch.Tensor:
    """act(gate) * up in f32: silu (llama/qwen2) or gelu_tanh (gemma)."""
    g = gate.to(torch.float32)
    if act == "gelu_tanh":
        return F.gelu(g, approximate="tanh") * up.to(torch.float32)
    return g * torch.sigmoid(g) * up.to(torch.float32)


def attention_torch(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos_start: int, q_len: int,
                    scale: float, window=None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Masked GQA attention over the full cache buffer (twin of
    attention_jnp). q [T, Hq, D]; k/v [Hkv, S, D]. Query t at position
    pos_start + t sees keys (pos - window, pos]. Returns [T, Hq, D] f32."""
    T, Hq, D = q.shape
    Hkv, S, _ = k_cache.shape
    group = Hq // Hkv
    qf = q.to(torch.float32).reshape(T, Hkv, group, D)
    scores = torch.einsum("thgd,hsd->hgts", qf,
                          k_cache.to(torch.float32)) * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    key_pos = torch.arange(S, device=q.device)[None, :]
    q_pos = pos_start + torch.arange(T, device=q.device)[:, None]
    mask = key_pos <= q_pos
    if window is not None:
        mask = mask & (key_pos > q_pos - window)
    scores = scores.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgts,hsd->thgd", probs, v_cache.to(torch.float32))
    return out.reshape(T, Hq, D)


def attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
              pos_start: int, q_len: int, scale: float, window=None,
              softcap: float = 0.0) -> torch.Tensor:
    """Attention dispatch: the flash kernel for q_len >= 64 when kernels
    are on for q's device (linear.kernels_enabled), plain PyTorch
    otherwise."""
    from .linear import kernels_enabled
    if kernels_enabled(q) and q_len >= FLASH_MIN_Q:
        from .cuda.attention import flash_attention_cuda
        return flash_attention_cuda(q, k_cache, v_cache, pos_start, q_len,
                                    scale, window=window, softcap=softcap)
    return attention_torch(q, k_cache, v_cache, pos_start, q_len, scale,
                           window=window, softcap=softcap)


def _pmax(xs: list[torch.Tensor], device) -> torch.Tensor:
    """The shards' tensors moved to `device`, their elementwise max."""
    return torch.stack([x.to(device) for x in xs]).amax(0)


def _psum(xs: list, device, row=None) -> torch.Tensor:
    """The shards' tensors moved to `device`, summed in shard order. Where
    `row` (a parallel/multihost.Row) spans processes, xs holds None for
    the shards of other processes, which are all-gathered first."""
    if row is not None:
        from ..parallel.multihost import gather_shards
        xs = gather_shards(xs, row)
    out = xs[0].to(device)
    for x in xs[1:]:
        out = out + x.to(device)
    return out


def _on(pos, device):
    """A position (or n_valid) on `device`: a host int or None as it is, a
    device tensor moved (a no-op where it lies there already)."""
    return pos.to(device) if isinstance(pos, torch.Tensor) else pos


def attention_cp(q: torch.Tensor, k_locals: list, v_locals: list,
                 pos_start, q_len: int, scale: float) -> torch.Tensor:
    """Context-parallel GQA attention (twin of the JAX attention_cp): shard
    i holds keys [i*S_l, (i+1)*S_l) as k/v_locals[i] [Hkv, S_l, D] on its
    device. Each shard scores q against its slice with -inf masks; the max
    over shards, then the two sums over shards, combine them exactly.
    pos_start: a host int or a 0-d int64 tensor on q's device. Returns
    [T, Hq, D] f32 on q's device."""
    T, Hq, D = q.shape
    Hkv, s_local, _ = k_locals[0].shape
    group = Hq // Hkv
    scores = []
    for i, k in enumerate(k_locals):
        qf = q.to(k.device, torch.float32).reshape(T, Hkv, group, D)
        sc = torch.einsum("thgd,hsd->hgts", qf, k.to(torch.float32)) * scale
        key_pos = i * s_local + torch.arange(s_local, device=k.device)[None]
        q_pos = _on(pos_start, k.device) + torch.arange(
            T, device=k.device)[:, None]
        scores.append(sc.masked_fill(~(key_pos <= q_pos)[None, None],
                                     float("-inf")))
    # a wholly masked shard's max is -inf; the global max is finite
    # because key 0 is always visible, so its exp(-inf - m) is 0
    m = _pmax([sc.amax(-1) for sc in scores], q.device)     # [Hkv, g, T]
    ps = [torch.exp(sc - m.to(sc.device)[..., None]) for sc in scores]
    l = _psum([p.sum(-1) for p in ps], q.device)
    o = _psum([torch.einsum("hgts,hsd->thgd", p, v.to(torch.float32))
               for p, v in zip(ps, v_locals)], q.device)
    return (o / l.permute(2, 0, 1)[..., None]).reshape(T, Hq, D)


def attention_cp_flash(q: torch.Tensor, k_locals: list, v_locals: list,
                       pos_start, q_len: int,
                       scale: float) -> torch.Tensor:
    """Flash attention under context parallelism (twin of the JAX
    attention_cp_flash): each shard runs the partials kernel over its slice
    (global key positions i*S_l + j, the causal tile skip intact), then the
    unnormalized partials combine exactly on q's device: the max m_g over
    shards, w = exp(m - m_g), and the sums of l*w and acc*w. pos_start: a
    host int or a 0-d int64 tensor on q's device, which each shard's kernel
    reads on its card."""
    from .cuda.attention import flash_attention_partials
    s_local = k_locals[0].shape[1]
    qc = q.to(k_locals[0].dtype)  # the kernel's operand type, cast once
    parts = [flash_attention_partials(qc.to(k.device), k, v,
                                      _on(pos_start, k.device),
                                      scale, kpos_offset=i * s_local)
             for i, (k, v) in enumerate(zip(k_locals, v_locals))]
    m_g = _pmax([m for _, m, _ in parts], q.device)         # [T, Hq]
    ws = [torch.exp(m.to(q.device) - m_g) for _, m, _ in parts]
    l_g = _psum([l.to(q.device) * w for (_, _, l), w in zip(parts, ws)],
                q.device)
    out = _psum([acc.to(q.device) * w[..., None]
                 for (acc, _, _), w in zip(parts, ws)], q.device)
    return out / l_g[..., None]


def attention_cp_dispatch(q: torch.Tensor, k_locals: list, v_locals: list,
                          pos_start, q_len: int,
                          scale: float) -> torch.Tensor:
    """CP attention dispatch, as `attention` dispatches: the partials
    kernel for q_len >= 64 when kernels are on for q's device, the plain
    combine otherwise (so CP decode stays plain PyTorch, as in the JAX
    package). pos_start: a host int or a 0-d device tensor."""
    from .linear import kernels_enabled
    if kernels_enabled(q) and q_len >= FLASH_MIN_Q:
        return attention_cp_flash(q, k_locals, v_locals, pos_start, q_len,
                                  scale)
    return attention_cp(q, k_locals, v_locals, pos_start, q_len, scale)
