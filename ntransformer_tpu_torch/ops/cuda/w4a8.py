"""W4A8 int8 decode matmul (T = 1): the wrapper of `csrc/w4a8_decode.cu`
and its plain PyTorch twin.

Replaces ntransformer_tpu/ops/pallas/w4a8.py::_w4a8_decode_impl (with
_blockdiag_i8 and _idot; entry w4a8_decode_pallas). x [1, K] is quantized
per 256-group to int8 codes with scales alpha and exact group sums xsum
(`quantize_activations_torch`, plain PyTorch on every device, as the JAX
package leaves it to XLA); each group's dot with the 4-bit codes is exact in
int32, and the scale/min fixup runs in f32 once per (group, column):
  y = sum over group pairs of (alpha_lo (P_lo s_lo) - xsum_lo m_lo)
                            + (alpha_hi (P_hi s_hi) - xsum_hi m_hi)
The twin takes the same steps in PyTorch (the group dots in float64, exact)
and sums the pairs in the kernel's order, so kernel and twin are bit-equal;
both stay within 2e-5 of core/w4a8.w4a8_matmul_golden, which rounds each
product before summing.

On the H100 it is bound by bytes (0.53125 a weight over 3.35 TB/s). The
kernel reads the codes with coalesced row loads, splits K on 512-element
units and sums them in a fixed-order second pass; see the source. T > 1
(prefill, verify, batched steps) is the exact-dequant `w4a8_matmul` entry
of ops/cuda/nibble_matmul.py.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.dtypes import DType
from ...core.layout import LAYOUTS
from ...core.w4a8 import GRP, UNIT
from ..dequant_torch import quantize_activations_torch
from . import build

NAME = "w4a8_decode"
REPLACES = "ntransformer_tpu/ops/pallas/w4a8.py:69 _w4a8_decode_impl"
_SIGNATURES = {NAME: [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3
               + [ctypes.c_void_p]}

# kernel launches since the last reset (chip_smoke.py reads and resets it):
# a product with more than one 512-element unit is two, the decode kernel
# and its pair-sum pass
launches = 0


def check_shapes(x: torch.Tensor, planes: dict):
    """(T, K, N) of a W4A8 decode product, or ValueError: x [1, K], qs
    [K/2, N] and the four f32 planes [K/512, N]."""
    if x.dim() != 2:
        raise ValueError(f"w4a8 decode wants x [1,K]; got {tuple(x.shape)}")
    t, k = x.shape
    if t != 1:
        raise ValueError(f"w4a8 decode is the T = 1 product; got T={t} (T > 1"
                         " is the w4a8_matmul entry of nibble_matmul)")
    if k % UNIT:
        raise ValueError(f"K={k} is not a multiple of {UNIT} (the W4A8 unit)")
    specs = LAYOUTS[DType.W4A8]
    if set(planes) != {s.name for s in specs}:
        raise ValueError(f"w4a8 planes {sorted(planes)}; want "
                         f"{sorted(s.name for s in specs)}")
    n = planes["qs"].shape[-1]
    for s in specs:
        a = planes[s.name]
        if tuple(a.shape) != (k // s.rows_div, n):
            raise ValueError(f"w4a8 plane {s.name} {tuple(a.shape)} does not "
                             f"match x {tuple(x.shape)}")
        want = torch.uint8 if s.name == "qs" else torch.float32
        if a.dtype != want:
            raise ValueError(f"w4a8 plane {s.name} is {a.dtype}; want {want}")
    return t, k, n


def _activations(x: torch.Tensor) -> dict:
    """The kernel's activation inputs: int8 codes (the TPU kernel's int8
    cast of the int32 codes), alpha and xsum, each contiguous."""
    acts = quantize_activations_torch(x.to(torch.float32))
    out = {nm: v.reshape(-1).contiguous() for nm, v in acts.items()}
    for nm in ("a_lo", "a_hi"):
        out[nm] = out[nm].to(torch.int8)
    return out


def w4a8_decode_plain(x: torch.Tensor, planes: dict) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: exact group dots (float64),
    the per-(pair, column) f32 fixup, the pairs summed in order."""
    _, k, n = check_shapes(x, planes)
    acts = _activations(x)
    pairs = k // UNIT
    qs = planes["qs"]
    f32 = torch.float32

    def half(codes, a, alpha, s, xsum, m):
        p = torch.einsum("pr,prn->pn",
                         a.to(torch.float64).reshape(pairs, GRP),
                         codes.to(torch.float64).reshape(pairs, GRP, n))
        return alpha[:, None] * (p.to(f32) * s) - xsum[:, None] * m

    part = (half(qs & 0x0F, acts["a_lo"], acts["alpha_lo"], planes["s_lo"],
                 acts["xsum_lo"], planes["m_lo"])
            + half(qs >> 4, acts["a_hi"], acts["alpha_hi"], planes["s_hi"],
                   acts["xsum_hi"], planes["m_hi"]))
    y = part[0]
    for p in range(1, pairs):
        y = y + part[p]
    return y.reshape(1, n)


def w4a8_decode_cuda(x: torch.Tensor, planes: dict) -> torch.Tensor:
    """y[1,N] f32 = the W4A8 decode product of x[1,K] (any float dtype) with
    the planes of core/layout.py. On a CPU tensor this is the plain twin;
    on a CUDA tensor it launches the kernel or raises."""
    global launches
    _, k, n = check_shapes(x, planes)
    if x.device.type == "cpu":
        return w4a8_decode_plain(x, planes)
    if not x.is_cuda or any(a.device != x.device for a in planes.values()):
        raise ValueError(f"w4a8 decode: tensors on "
                         f"{[str(a.device) for a in planes.values()]} and "
                         f"{x.device}; want one CUDA device")
    if not all(a.is_contiguous() for a in planes.values()):
        raise ValueError("w4a8 decode wants contiguous planes")
    acts = _activations(x)
    lib = build.load(NAME, _SIGNATURES)
    pairs = k // UNIT
    vec = int(n % 8 == 0 and planes["qs"].data_ptr() % 8 == 0)
    y = torch.empty(1, n, dtype=torch.float32, device=x.device)
    work = (torch.empty(pairs, n, dtype=torch.float32, device=x.device)
            if pairs > 1 else y)
    with torch.cuda.device(x.device):
        rc = lib.w4a8_decode(
            *(acts[nm].data_ptr() for nm in ("a_lo", "a_hi", "alpha_lo",
                                             "alpha_hi", "xsum_lo",
                                             "xsum_hi")),
            *(planes[nm].data_ptr() for nm in ("qs", "s_lo", "s_hi", "m_lo",
                                               "m_hi")),
            y.data_ptr(), work.data_ptr(), k, n, vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, NAME)
    launches += 2 if pairs > 1 else 1
    return y
