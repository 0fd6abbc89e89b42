"""Prefill flash attention: the wrapper of `csrc/flash_attention.cu` and its
plain PyTorch twin.

Replaces ntransformer_tpu/ops/pallas/attention.py::_flash_impl /
_attn_kernel (entry flash_attention). Causal GQA attention of q [T,Hq,D]
over the cache k/v [Hkv,S,D]: online softmax in f32, p rounded to bf16
before the PV product, KV tiles past causality or below the window skipped.
Returns [T,Hq,D] f32.

On the H100 it is bound by operations (the tensor cores); the kernel keeps
16 query rows per warp in mma fragments and loops over the visible KV tiles
inside the block — the TPU grid's sequential KV axis becomes that loop, and
nothing carries between blocks. See the source for the details.
"""
from __future__ import annotations

import ctypes

import torch

from ..layers import attention_torch
from . import build

NAME = "flash_attention"
REPLACES = "ntransformer_tpu/ops/pallas/attention.py:120 _flash_impl"
_SIGNATURES = {"flash_attention_fwd": [ctypes.c_void_p] * 4
               + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
               + [ctypes.c_void_p]}
NO_WINDOW = 2 ** 30  # a window larger than any context masks nothing

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def check_shapes(q, k_cache, v_cache, pos: int):
    """(T, Hq, Hkv, S, D) of a flash call, or ValueError."""
    if q.dim() != 3 or k_cache.dim() != 3:
        raise ValueError(f"flash attention wants q [T,Hq,D], k/v [Hkv,S,D]; "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    t, hq, d = q.shape
    hkv, s, dk = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or dk != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)} do not agree")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not supported (64 or 128)")
    if not 0 <= pos <= s - t:
        raise ValueError(f"rows [{pos}, {pos + t}) fall outside the "
                         f"{s}-row cache")
    return t, hq, hkv, s, d


def flash_attention_plain(q, k_cache, v_cache, pos: int, q_len: int,
                          scale: float, *, window=None,
                          softcap: float = 0.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: attention_torch of q cast to
    the cache dtype (the kernel's operand types)."""
    return attention_torch(q.to(k_cache.dtype), k_cache, v_cache, pos, q_len,
                           scale, window=window, softcap=softcap)


def flash_attention_cuda(q, k_cache, v_cache, pos: int, q_len: int,
                         scale: float, *, window=None,
                         softcap: float = 0.0) -> torch.Tensor:
    """Causal GQA flash attention, [T,Hq,D] f32. q is cast to the cache
    dtype (bf16 or f32). On a CPU tensor this is the plain twin; on a CUDA
    tensor it launches the kernel or raises."""
    global launches
    pos = int(pos)
    t, hq, hkv, s, d = check_shapes(q, k_cache, v_cache, pos)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k_cache, v_cache, pos, q_len, scale,
                                     window=window, softcap=softcap)
    if not (q.is_cuda and k_cache.device == q.device
            and v_cache.device == q.device):
        raise ValueError("flash attention wants q, k, v on one CUDA device")
    if k_cache.dtype not in (torch.bfloat16, torch.float32) \
            or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"flash attention wants a bf16 or f32 cache; got "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash attention wants contiguous caches")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash attention wants 16-byte aligned caches")
    q = q.to(k_cache.dtype).contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    lib = build.load(NAME, _SIGNATURES)
    out = torch.empty(t, hq, d, dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        t, hq, hkv, s, d, int(k_cache.dtype == torch.float32), pos,
        NO_WINDOW if window is None else int(window), float(scale),
        float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, NAME)
    launches += 1
    return out
