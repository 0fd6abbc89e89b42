"""Fused Q8_0 dequant-matmul: the wrapper of `csrc/q8_0_matmul.cu` and its
plain PyTorch twin.

Replaces ntransformer_tpu/ops/pallas/matmul.py::_quant_matmul_impl with the
_q8_0_tile body (entry quant_matmul_pallas). y[T,N] f32 = x[T,K] @ W with
W = bf16(qs * d): bf16 operands, f32 accumulation — the TPU kernel's
default-precision dot and the JAX CPU path alike.

On the H100 it is bound by bytes at small T (1.0625 bytes per weight over
3.35 TB/s) and by operations at prefill T. Up to `plans.SKINNY_ROWS`
tokens the kernel streams qs once through mma.sync with the weight as the
M side (one launch: the K splits of a column strip are one cluster, summed
in rank order, so runs repeat bit for bit); past it a warp-specialized
wgmma tile dequantizes each weight stage once for 256 or 128 rows of x,
its K split in two where that measured faster (`plans.tile_plan`). See the
source for the details.

A stacked [L, K, N] plane picks its layer as a free view (`planes[l]`)
when the index is a host int. A routed expert's index is a device tensor
(the router's top-k, models/llama.moe_ffn): with `sel` the T = 1 skinny
kernel reads it on the card and offsets its plane pointers (ops/cuda/
select.py), the TPU kernel's scalar-prefetch select, so no path reads it
to the host.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.dtypes import DType
from ..dequant_torch import dequant_planes_torch
from . import build, plans, select

NAME = "q8_0_matmul"
REPLACES = "ntransformer_tpu/ops/pallas/matmul.py:344 _quant_matmul_impl"
_SIGNATURES = {"q8_0_matmul": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
               + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_void_p]}

# kernel launches since the last reset (chip_smoke.py reads and resets it):
# one a product
launches = 0


def check_shapes(x: torch.Tensor, qs: torch.Tensor, d: torch.Tensor,
                 lead: int = 0):
    """(T, K, N) of a Q8_0 product, or ValueError. lead: leading stacked
    axes of the planes (1 for a select's [M, K, N] stack)."""
    if x.dim() != 2 or qs.dim() != 2 + lead or d.dim() != 2 + lead:
        raise ValueError("q8_0 matmul wants x [T,K], qs [K,N], d [K/32,N]; "
                         f"got {tuple(x.shape)}, {tuple(qs.shape)}, "
                         f"{tuple(d.shape)}")
    t, k = x.shape
    kq, n = qs.shape[lead:]
    if k % 32:
        raise ValueError(f"K={k} is not a multiple of 32 (the Q8_0 block)")
    if kq != k or tuple(d.shape[lead:]) != (k // 32, n):
        raise ValueError(f"planes qs {tuple(qs.shape)} / d {tuple(d.shape)} "
                         f"do not match x {tuple(x.shape)}")
    return t, k, n


def quant_matmul_plain(x: torch.Tensor, qs: torch.Tensor,
                       d: torch.Tensor, sel: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: bf16 dequant, bf16 x, f32
    products and sums (PyTorch's bf16 matmul would return bf16, so the
    rounded operands are multiplied in f32). sel: the matrix of stacked
    [M, K, N] planes, gathered on the planes' device."""
    if sel is not None:
        got = select.select_plain({"qs": qs, "d": d}, sel)
        qs, d = got["qs"], got["d"]
    _, k, n = check_shapes(x, qs, d)
    w = dequant_planes_torch({"qs": qs, "d": d}, DType.Q8_0, k, n,
                             out_dtype=torch.bfloat16)
    return x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)


def quant_matmul_cuda(x: torch.Tensor, qs: torch.Tensor,
                      d: torch.Tensor, sel: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """y[T,N] f32 = x[T,K] @ bf16(qs·d). x any float dtype (rounded to
    bf16); qs int8 [K,N]; d int16 [K/32,N] holding f16 bits. sel: an int32
    index (one element) into stacked planes qs [M, K, N] and d [M, K/32, N],
    read on the card by the T <= 8 skinny kernel. On a CPU tensor this is
    the plain twin; on a CUDA tensor it launches the kernel or raises."""
    global launches
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qs, d, sel)
    stack = {"qs": qs, "d": d}
    if sel is not None:
        select.check(x, sel, stack, NAME)
    t, k, n = check_shapes(x, qs, d, int(sel is not None))
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
    qs_stride, d_stride = (select.strides(stack, ("qs", "d"))
                           if sel is not None else (0, 0))
    vec = int(n % 16 == 0 and qs.data_ptr() % 16 == 0
              and d.data_ptr() % 16 == 0 and qs_stride % 16 == 0
              and d_stride % 16 == 0)
    sms = plans.sm_count(x.device)
    if t <= plans.SKINNY_ROWS:
        path, bm = 0, 0
        nsplit, split_k = plans.skinny_plan(sms, t, k, n)
    else:
        path = 1
        bm, nsplit, split_k = plans.tile_plan(sms, t, k, n, 64)
    y = torch.empty(t, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.q8_0_matmul(x.data_ptr(), qs.data_ptr(), d.data_ptr(),
                             y.data_ptr(), t, k, n, path, nsplit, split_k,
                             bm, vec,
                             None if sel is None else sel.data_ptr(),
                             qs_stride, d_stride,
                             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, NAME)
    launches += 1
    return y
