"""Fused Q8_0 dequant-matmul: the wrapper of `csrc/q8_0_matmul.cu` and its
plain PyTorch twin.

Replaces ntransformer_tpu/ops/pallas/matmul.py::_quant_matmul_impl with the
_q8_0_tile body (entry quant_matmul_pallas). y[T,N] f32 = x[T,K] @ W with
W = bf16(qs * d): bf16 operands, f32 accumulation — the TPU kernel's
default-precision dot and the JAX CPU path alike.

On the H100 it is bound by bytes at T = 1 (1.0625 bytes per weight over
3.35 TB/s) and by operations at prefill T. The kernel streams qs with
coalesced 16-byte loads and splits K across blocks at T = 1 (a fixed-order
second pass sums the partials, so runs repeat bit for bit), and tiles T x N
on the tensor cores (mma.sync) at T > 1; see the source for the details.

A stacked [L, K, N] plane picks its layer as a free view (`planes[l]`): the
TPU kernel's scalar-prefetch layer select is not needed.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.dtypes import DType
from ..dequant_torch import dequant_planes_torch
from . import build

NAME = "q8_0_matmul"
REPLACES = "ntransformer_tpu/ops/pallas/matmul.py:344 _quant_matmul_impl"
_SIGNATURES = {"q8_0_matmul": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
               + [ctypes.c_void_p]}
_GEMV_BLOCK_COLS = 512  # columns per block of the T == 1 kernel

# kernel launches since the last reset (chip_smoke.py reads and resets it):
# a split-K product at T = 1 is two, the GEMV and its reduce pass
launches = 0
_SM_COUNT: dict[int, int] = {}


def check_shapes(x: torch.Tensor, qs: torch.Tensor, d: torch.Tensor):
    """(T, K, N) of a Q8_0 product, or ValueError."""
    if x.dim() != 2 or qs.dim() != 2 or d.dim() != 2:
        raise ValueError("q8_0 matmul wants x [T,K], qs [K,N], d [K/32,N]; "
                         f"got {tuple(x.shape)}, {tuple(qs.shape)}, "
                         f"{tuple(d.shape)}")
    t, k = x.shape
    kq, n = qs.shape
    if k % 32:
        raise ValueError(f"K={k} is not a multiple of 32 (the Q8_0 block)")
    if kq != k or tuple(d.shape) != (k // 32, n):
        raise ValueError(f"planes qs {tuple(qs.shape)} / d {tuple(d.shape)} "
                         f"do not match x {tuple(x.shape)}")
    return t, k, n


def quant_matmul_plain(x: torch.Tensor, qs: torch.Tensor,
                       d: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: bf16 dequant, bf16 x, f32
    products and sums (PyTorch's bf16 matmul would return bf16, so the
    rounded operands are multiplied in f32)."""
    _, k, n = check_shapes(x, qs, d)
    w = dequant_planes_torch({"qs": qs, "d": d}, DType.Q8_0, k, n,
                             out_dtype=torch.bfloat16)
    return x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)


def _split_count(device: torch.device, k: int, n: int) -> int:
    """Blocks along K at T = 1: enough (strip, split) blocks to cover the
    SMs twice, with at least four 32-row groups (one per warp) each."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    groups = k // 32
    strips = -(-n // _GEMV_BLOCK_COLS)
    want = -(-2 * _SM_COUNT[idx] // strips)
    nsplit = max(1, min(want, groups // 4))
    per = -(-groups // nsplit)
    return -(-groups // per)  # no empty split


def quant_matmul_cuda(x: torch.Tensor, qs: torch.Tensor,
                      d: torch.Tensor) -> torch.Tensor:
    """y[T,N] f32 = x[T,K] @ bf16(qs·d). x any float dtype (rounded to
    bf16); qs int8 [K,N]; d int16 [K/32,N] holding f16 bits. On a CPU
    tensor this is the plain twin; on a CUDA tensor it launches the kernel
    or raises."""
    global launches
    t, k, n = check_shapes(x, qs, d)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qs, d)
    if not (x.is_cuda and qs.device == x.device and d.device == x.device):
        raise ValueError(f"q8_0 matmul: tensors on {x.device}, {qs.device}, "
                         f"{d.device}; want one CUDA device")
    if qs.dtype != torch.int8 or d.dtype != torch.int16:
        raise ValueError(f"q8_0 matmul wants qs int8 and d int16 (f16 "
                         f"bits); got {qs.dtype}, {d.dtype}")
    if not (qs.is_contiguous() and d.is_contiguous()):
        raise ValueError("q8_0 matmul wants contiguous planes")
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    lib = build.load(NAME, _SIGNATURES)
    vec = int(n % 16 == 0 and qs.data_ptr() % 16 == 0
              and d.data_ptr() % 16 == 0)
    nsplit = _split_count(x.device, k, n) if t == 1 else 1
    y = torch.empty(t, n, dtype=torch.float32, device=x.device)
    work = (torch.empty(nsplit, n, dtype=torch.float32, device=x.device)
            if nsplit > 1 else y)
    with torch.cuda.device(x.device):
        rc = lib.q8_0_matmul(x.data_ptr(), qs.data_ptr(), d.data_ptr(),
                             y.data_ptr(), work.data_ptr(), t, k, n, nsplit,
                             vec,
                             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, NAME)
    launches += 2 if nsplit > 1 else 1
    return y
