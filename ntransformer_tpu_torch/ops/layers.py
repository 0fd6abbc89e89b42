"""Elementwise transformer ops and attention (PyTorch).

Port of ntransformer_tpu/ops/layers.py. RMSNorm, RoPE and SwiGLU stay plain
PyTorch. Attention dispatches to the flash kernel (ops/cuda/attention.py)
for prefill-sized q on CUDA, exactly as the JAX package picks its Pallas
kernel; decode-sized q (q_len < 64) is plain PyTorch on every device, as the
JAX package computes it outside Pallas too.
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
