"""W4A8 int8 decode matmul (T = 1): the wrapper of `csrc/w4a8_decode.cu`
and its plain PyTorch twin.

Replaces ntransformer_tpu/ops/pallas/w4a8.py::_w4a8_decode_impl (with
_blockdiag_i8 and _idot; entry w4a8_decode_pallas) and the activation
quantization the JAX package leaves to XLA in front of it. x [1, K] is
quantized per 256-group to int8 codes with scales alpha = max(amax / 127,
1e-30) and group sums xsum; each group's dot with the 4-bit codes is exact
in int32, and the scale/min fixup runs in f32 once per (group, column):
  y = sum over group pairs of (alpha_lo (P_lo s_lo) - xsum_lo m_lo)
                            + (alpha_hi (P_hi s_hi) - xsum_hi m_hi)
The kernel quantizes x itself, so a call is one launch (two where the pairs
are split over blocks) and no PyTorch op. The twin takes the same steps in
PyTorch: alpha by an IEEE division (a tensor divisor: PyTorch on the card
multiplies by the reciprocal of a Python scalar divisor), xsum in the
kernel's fixed tree (`tree_sum`), the group dots in float64 (exact), the
pairs summed in order. So kernel and twin are bit-equal, and codes and
alpha equal core/w4a8.quantize_activations' (numpy) on the same x; both
stay within 2e-5 of core/w4a8.w4a8_matmul_golden, which rounds each product
before summing.

On the H100 it is bound by bytes (0.53125 a weight over 3.35 TB/s). The
kernel gives each block a strip of 64 columns and a run of group pairs (one
warp a pair), reads the codes in 16-byte rows, and sums the pairs in order
in the block; a K of more than 8 pairs is split into runs summed by a
second, fixed-order pass (`pair_plan`); see the source. T > 1 (prefill,
verify, batched steps) is the exact-dequant `w4a8_matmul` entry of
ops/cuda/nibble_matmul.py. With `sel` (a device int32 index into stacked
planes: a routed expert) the decode kernel reads the index on the card and
offsets its five planes by it (ops/cuda/select.py); the pair-sum pass reads
no plane.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.dtypes import DType
from ...core.layout import LAYOUTS
from ...core.w4a8 import GRP, UNIT
from . import build, select

NAME = "w4a8_decode"
REPLACES = "ntransformer_tpu/ops/pallas/w4a8.py:69 _w4a8_decode_impl"
_SIGNATURES = {NAME: [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
               + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
               + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_void_p]}
_MAX_PAIRS = 8  # warps a block (one group pair each)
_ROWS_DIV = {s.name: s.rows_div for s in LAYOUTS[DType.W4A8]}
# plane -> (rows_div, dtype), in the C entry's order
_PLANES = {nm: (_ROWS_DIV[nm], torch.uint8 if nm == "qs" else torch.float32)
           for nm in ("qs", "s_lo", "s_hi", "m_lo", "m_hi")}

# kernel launches since the last reset (chip_smoke.py reads and resets it):
# a product whose pairs are split over blocks is two, the decode kernel and
# its pair-sum pass
launches = 0


def check_shapes(x: torch.Tensor, planes: dict, lead: int = 0):
    """(T, K, N) of a W4A8 decode product, or ValueError: x [1, K], qs
    [K/2, N] and the four f32 planes [K/512, N], after `lead` stacked axes
    (1 for a select's stack)."""
    if x.dim() != 2:
        raise ValueError(f"w4a8 decode wants x [1,K]; got {tuple(x.shape)}")
    t, k = x.shape
    if t != 1:
        raise ValueError(f"w4a8 decode is the T = 1 product; got T={t} (T > 1"
                         " is the w4a8_matmul entry of nibble_matmul)")
    if k % UNIT:
        raise ValueError(f"K={k} is not a multiple of {UNIT} (the W4A8 unit)")
    if planes.keys() != _PLANES.keys():
        raise ValueError(f"w4a8 planes {sorted(planes)}; want "
                         f"{sorted(_PLANES)}")
    n = planes["qs"].shape[-1]
    for nm, (rows_div, dtype) in _PLANES.items():
        a = planes[nm]
        if a.dim() != 2 + lead or a.shape[lead:] != (k // rows_div, n):
            raise ValueError(f"w4a8 plane {nm} {tuple(a.shape)} does not "
                             f"match x {tuple(x.shape)}")
        if a.dtype != dtype:
            raise ValueError(f"w4a8 plane {nm} is {a.dtype}; want {dtype}")
    return t, k, n


def tree_sum(xg: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis (a power of two) in the kernel's fixed
    tree: halve it, v[i] + v[i + h], until one value is left."""
    while xg.shape[-1] > 1:
        h = xg.shape[-1] // 2
        xg = xg[..., :h] + xg[..., h:]
    return xg[..., 0]


def _activations(x: torch.Tensor) -> dict:
    """The kernel's quantization of x [1, K]: int8 codes a_lo / a_hi [K/2],
    alpha_lo / alpha_hi and xsum_lo / xsum_hi [K/512], pair c's lo half
    being group 2c and its hi half group 2c + 1."""
    xg = x.to(torch.float32).reshape(-1, GRP)
    amax = xg.abs().amax(dim=1)
    alpha = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-30)
    codes = torch.round(xg / alpha[:, None]).to(torch.int8)
    xsum = tree_sum(xg)
    out = {}
    for half, sl in (("lo", slice(0, None, 2)), ("hi", slice(1, None, 2))):
        out[f"a_{half}"] = codes[sl].reshape(-1)
        out[f"alpha_{half}"] = alpha[sl]
        out[f"xsum_{half}"] = xsum[sl]
    return out


def w4a8_decode_plain(x: torch.Tensor, planes: dict,
                      sel: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: its quantization, exact
    group dots (float64), the per-(pair, column) f32 fixup, the pairs
    summed in order. sel: the matrix of stacked planes, gathered on the
    planes' device."""
    if sel is not None:
        planes = select.select_plain(planes, sel)
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


def pair_plan(k: int) -> int:
    """Group pairs per block: all of K when it has at most 8 (one warp a
    pair, one pass), else the fewest runs of at most 8, summed by a second
    pass."""
    pairs = k // UNIT
    nsplit = -(-pairs // _MAX_PAIRS)
    return -(-pairs // nsplit)


def w4a8_decode_cuda(x: torch.Tensor, planes: dict,
                     sel: torch.Tensor | None = None) -> torch.Tensor:
    """y[1,N] f32 = the W4A8 decode product of x[1,K] with the planes of
    core/layout.py. sel: an int32 index (one element) into stacked planes
    [M, rows, N], read on the card. On a CPU tensor this is the plain twin;
    on a CUDA tensor it launches the kernel (which quantizes x: bf16 or f32
    as given, any stride) or raises."""
    global launches
    if x.device.type == "cpu":
        return w4a8_decode_plain(x, planes, sel)
    if sel is not None:
        select.check(x, sel, planes, NAME)
    _, k, n = check_shapes(x, planes, int(sel is not None))
    dev = x.get_device()
    ptrs = [planes[nm].data_ptr() for nm in _PLANES]
    qs_stride, f_stride = (select.strides(planes, ("qs", "s_lo"))
                           if sel is not None else (0, 0))
    if sel is not None and any(
            select.strides(planes, (nm,))[0] != f_stride
            for nm in ("s_hi", "m_lo", "m_hi")):
        raise ValueError("w4a8 decode: the four f32 planes of a stack "
                         "must share one stride")
    if not x.is_cuda or any(a.get_device() != dev for a in planes.values()):
        raise ValueError(f"w4a8 decode: tensors on "
                         f"{[str(a.device) for a in planes.values()]} and "
                         f"{x.device}; want one CUDA device")
    if not all(a.is_contiguous() for a in planes.values()):
        raise ValueError("w4a8 decode wants contiguous planes")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w4a8 decode takes bf16 or f32 x; got {x.dtype}")
    lib = build.load(NAME, _SIGNATURES)
    pairs = k // UNIT
    pps = pair_plan(k)
    vec = int(n % 16 == 0 and all(p % 16 == 0 for p in ptrs)
              and qs_stride % 16 == 0)
    split = pps < pairs
    # one allocation: y, then the pairs' parts when they are split
    y = torch.empty(pairs + 1 if split else 1, n, dtype=torch.float32,
                    device=x.device)
    out = y.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.w4a8_decode(
            x.data_ptr(), int(x.dtype == torch.float32), x.stride(1), *ptrs,
            out, out + 4 * n if split else 0, k, n, pps, vec,
            None if sel is None else sel.data_ptr(), qs_stride, f_stride,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, NAME)
    launches += 2 if split else 1
    return y[:1] if split else y
