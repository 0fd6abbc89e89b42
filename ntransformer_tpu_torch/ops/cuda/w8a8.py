"""W8A8 int8 serving matmul: the wrapper of `csrc/w8a8_matmul.cu` and its
plain PyTorch twin.

Replaces ntransformer_tpu/ops/pallas/w8a8.py::_w8a8_impl (entry
w8a8_matmul_pallas). y[T,N] f32 = (f32(a . q) * am) * s with (a, am) the
per-row int8 quantization of x (`quantize_rows_torch`, plain PyTorch on
every device, as the JAX package leaves it to XLA), q the int8 [K, N]
weight codes and s their [1, N] column scales. The dot is exact in int32,
so the kernel is bit-equal to its twin; the twin takes the dot in float64,
where every partial sum is an integer below 2^53 (PyTorch has no int32
matmul on CUDA).

On the H100 it is bound by bytes at small T (one byte a weight over 3.35
TB/s) and by operations at prefill T (int8 tensor cores). The kernel runs a
dp4a GEMV with split-K at T = 1 and int8 mma.sync tiles at T > 1; see the
source. Rows are capped at MAX_ROWS, as on the TPU: the port's prefill
chunks and admission chunks are 512 rows, so no path reaches the cap.
"""
from __future__ import annotations

import ctypes

import torch

from ..dequant_torch import quantize_rows_torch
from . import build

NAME = "w8a8_matmul"
REPLACES = "ntransformer_tpu/ops/pallas/w8a8.py:49 _w8a8_impl"
MAX_ROWS = 2048
_SIGNATURES = {NAME: [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
               + [ctypes.c_void_p]}
_GEMV_BLOCK_COLS = 512  # columns per block of the T == 1 kernel
_MAX_K = (2 ** 31 - 1) // (127 * 127)  # int32 dot cannot overflow below it

# kernel launches since the last reset (chip_smoke.py reads and resets it):
# a split-K product at T = 1 is two, the GEMV and its reduce pass
launches = 0
_SM_COUNT: dict[int, int] = {}


def check_shapes(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor):
    """(T, K, N) of a W8A8 product, or ValueError."""
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 2:
        raise ValueError("w8a8 matmul wants x [T,K], q [K,N], s [1,N]; got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(s.shape)}")
    t, k = x.shape
    kq, n = q.shape
    if kq != k or tuple(s.shape) != (1, n):
        raise ValueError(f"planes q {tuple(q.shape)} / s {tuple(s.shape)} "
                         f"do not match x {tuple(x.shape)}")
    return t, k, n


def w8a8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (core/w8a8.py's golden):
    quantize rows, the exact dot in float64, then (p * am) * s in f32."""
    check_shapes(x, q, s)
    a, am = quantize_rows_torch(x.to(torch.float32))
    p = (a.to(torch.float64) @ q.to(torch.float64)).to(torch.float32)
    return p * am * s.to(torch.float32)


def split_plan(device: torch.device, k: int, n: int) -> tuple[int, int]:
    """(K rows per split, splits) at T = 1: enough (strip, split) blocks to
    cover the SMs twice, each split a multiple of 64 rows and at least 256
    (16 rows for each of the block's four warps, four times over)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    strips = -(-n // _GEMV_BLOCK_COLS)
    want = -(-2 * _SM_COUNT[idx] // strips)
    nsplit = max(1, min(want, k // 256))
    per = -(-k // nsplit)
    per = -(-per // 64) * 64
    return per, -(-k // per)  # no empty split


def w8a8_matmul_cuda(x: torch.Tensor, q: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """y[T,N] f32 = W8A8 product of x[T,K] (any float dtype) with q int8
    [K,N] and s f32 [1,N]. On a CPU tensor this is the plain twin; on a
    CUDA tensor it launches the kernel or raises."""
    global launches
    t, k, n = check_shapes(x, q, s)
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, q, s)
    if not (x.is_cuda and q.device == x.device and s.device == x.device):
        raise ValueError(f"w8a8 matmul: tensors on {x.device}, {q.device}, "
                         f"{s.device}; want one CUDA device")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"w8a8 matmul wants q int8 and s float32; got "
                         f"{q.dtype}, {s.dtype}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("w8a8 matmul wants contiguous planes")
    if t > MAX_ROWS:
        raise ValueError(f"w8a8 matmul takes at most {MAX_ROWS} rows, got "
                         f"T={t}")
    if k % 16 or k > _MAX_K:
        raise ValueError(f"w8a8 kernel wants K % 16 == 0 and K <= {_MAX_K}; "
                         f"got K={k}")
    # row-major codes: the layers may hand over a dense transposed view
    # (the embedding lookup's), whose layout an elementwise op keeps
    a, am = quantize_rows_torch(x.to(torch.float32).contiguous())
    lib = build.load(NAME, _SIGNATURES)
    vec = int(n % 16 == 0 and q.data_ptr() % 16 == 0)
    split_rows, nsplit = split_plan(x.device, k, n) if t == 1 else (k, 1)
    y = torch.empty(t, n, dtype=torch.float32, device=x.device)
    work = (torch.empty(nsplit, n, dtype=torch.int32, device=x.device)
            if nsplit > 1 else y)
    with torch.cuda.device(x.device):
        rc = lib.w8a8_matmul(a.data_ptr(), am.data_ptr(), q.data_ptr(),
                             s.data_ptr(), y.data_ptr(), work.data_ptr(), t,
                             k, n, split_rows, nsplit, vec,
                             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, NAME)
    launches += 2 if nsplit > 1 else 1
    return y
