"""W8A8 int8 serving matmul: the wrapper of `csrc/w8a8_matmul.cu` and its
plain PyTorch twin.

Replaces ntransformer_tpu/ops/pallas/w8a8.py::_w8a8_impl (entry
w8a8_matmul_pallas) and the row quantization the JAX package leaves to XLA
in front of it. y[T,N] f32 = (f32(a . q) * am) * s with (a, am) the per-row
int8 quantization of x (core/w8a8.quantize_rows: am = amax / 127 by an IEEE
division, 1 for a zero row; codes rint(x / am) clamped to +-127), q the
int8 [K, N] weight codes and s their [1, N] column scales. The dot is exact
in int32, so the kernel is bit-equal to its twin; the twin quantizes with
`quantize_rows_torch` (a tensor divisor, so IEEE on the card too) and takes
the dot in float64, where every partial sum is an integer below 2^53
(PyTorch has no int32 matmul on CUDA).

The kernel quantizes x itself (bf16 or f32, any strides: the embedding
lookup hands layer 0 a dense transposed view), so a call is its own two
launches and no PyTorch op: a quantize pass writes the codes and row scales
once, and the matmul, launched with programmatic dependent launch, streams
weights while it runs. On the H100 the product is bound by bytes at small
T (one byte a weight over 3.35 TB/s) and by operations at prefill T (int8
tensor cores). Up to `plans.SKINNY_ROWS` tokens the matmul streams q once
through int8 mma.sync with the K splits of a column strip in one cluster;
past it an int8 wgmma tile (`plans.tile_plan`). Rows are capped at
MAX_ROWS, as on the TPU: the port's prefill chunks and admission chunks
are 512 rows, so no path reaches the cap. With `sel` (a device int32 index
into stacked [M, K, N] / [M, 1, N] planes: a routed expert) the skinny
matmul reads the index on the card and offsets q and s by it (ops/cuda/
select.py), up to 8 tokens; the quantize pass reads no plane.
"""
from __future__ import annotations

import ctypes

import torch

from ..dequant_torch import quantize_rows_torch
from . import build, plans, select

NAME = "w8a8_matmul"
REPLACES = "ntransformer_tpu/ops/pallas/w8a8.py:49 _w8a8_impl"
MAX_ROWS = 2048
_SIGNATURES = {NAME: [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong] + [ctypes.c_void_p] * 4
               + [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_longlong,
                                        ctypes.c_longlong, ctypes.c_void_p]}
_MAX_K = (2 ** 31 - 1) // (127 * 127)  # int32 dot cannot overflow below it

# kernel launches since the last reset (chip_smoke.py reads and resets it):
# two a product, the quantize pass and the matmul
launches = 0


def check_shapes(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 lead: int = 0):
    """(T, K, N) of a W8A8 product, or ValueError. lead: leading stacked
    axes of the planes (1 for a select's stack)."""
    if x.dim() != 2 or q.dim() != 2 + lead or s.dim() != 2 + lead:
        raise ValueError("w8a8 matmul wants x [T,K], q [K,N], s [1,N]; got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(s.shape)}")
    t, k = x.shape
    kq, n = q.shape[lead:]
    if kq != k or tuple(s.shape[lead:]) != (1, n):
        raise ValueError(f"planes q {tuple(q.shape)} / s {tuple(s.shape)} "
                         f"do not match x {tuple(x.shape)}")
    return t, k, n


def w8a8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      sel: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (core/w8a8.py's golden):
    quantize rows, the exact dot in float64, then (p * am) * s in f32.
    sel: the matrix of stacked planes, gathered on the planes' device."""
    if sel is not None:
        got = select.select_plain({"q": q, "s": s}, sel)
        q, s = got["q"], got["s"]
    check_shapes(x, q, s)
    a, am = quantize_rows_torch(x.to(torch.float32))
    p = (a.to(torch.float64) @ q.to(torch.float64)).to(torch.float32)
    return p * am * s.to(torch.float32)


def w8a8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     sel: torch.Tensor | None = None) -> torch.Tensor:
    """y[T,N] f32 = W8A8 product of x[T,K] (any float dtype) with q int8
    [K,N] and s f32 [1,N]. sel: an int32 index (one element) into stacked
    planes q [M, K, N] and s [M, 1, N], read on the card (T <= 8). On a CPU
    tensor this is the plain twin; on a CUDA tensor it launches the kernel
    or raises."""
    global launches
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x, q, s, sel)
    stack = {"q": q, "s": s}
    if sel is not None:
        select.check(x, sel, stack, NAME)
    t, k, n = check_shapes(x, q, s, int(sel is not None))
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
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.to(torch.float32)  # exact: no path of the port passes one
    lib = build.load(NAME, _SIGNATURES)
    q_stride, s_stride = (select.strides(stack, ("q", "s"))
                          if sel is not None else (0, 0))
    vec = int(n % 16 == 0 and q.data_ptr() % 16 == 0 and q_stride % 16 == 0
              and s_stride % 16 == 0)
    sms = plans.sm_count(x.device)
    y = torch.empty(t, n, dtype=torch.float32, device=x.device)
    if t <= plans.SKINNY_ROWS:
        path, bm = 0, 0
        nsplit, split_k = plans.skinny_plan(sms, t, k, n)
    else:
        path = 1
        bm, nsplit, split_k = plans.tile_plan(sms, t, k, n, 128)
    # the quantize pass's codes [T, Kp] and row scales [T] f32
    kp = -(-k // 128) * 128
    work = torch.empty(t * kp + 4 * t, dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.w8a8_matmul(x.data_ptr(), int(x.dtype == torch.float32),
                             x.stride(0), x.stride(1), q.data_ptr(),
                             s.data_ptr(), y.data_ptr(), work.data_ptr(), t,
                             k, n, path, nsplit, split_k, bm, vec,
                             None if sel is None else sel.data_ptr(),
                             q_stride, s_stride,
                             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, NAME)
    launches += 2
    return y
