"""Fused dequant-matmul of the GGUF nibble formats (Q4_0, Q4_K, Q5_K,
Q6_K) and of W4A8 at T > 1: the wrapper of `csrc/kquant_matmul.cu` (Q4_0
and the K-quants Q4_K, Q5_K, Q6_K) and `csrc/nibble_matmul.cu` (W4A8) and
their plain PyTorch twin.

Replaces ntransformer_tpu/ops/pallas/matmul.py::_quant_matmul_impl with its
_q4_0_tile, _q4_k_tile, _q5_k_tile, _q6_k_tile and _w4a8_tile bodies (entry
quant_matmul_pallas). y[T,N] f32 = bf16(x)[T,K] @ W with W the bf16 of the
weight as the plain dequant (ops/dequant_torch.py) computes it in f32, and
f32 accumulation: kernel and twin differ only in the order of the sums. The
TPU kernel's group-sum correction dot for the min term is not carried over
(it rounds differently: bf16(q·s) and bf16(Σx)·bf16(m)). W4A8 takes this
path only at T > 1, as on the TPU, and raises at T = 1: its decode product
quantizes the activations (ops/cuda/w4a8.py).

On the H100 it is bound by bytes at small T (0.5625 to 0.8203125 bytes
per weight over 3.35 TB/s), with the per-weight dequant close behind on
the CUDA cores, and by operations at prefill T. The kernels read x at the
two element positions of each plane row's nibbles (no activation reorder
on the card).

Q4_0 and the K-quants Q4_K, Q5_K and Q6_K run the shapes of the Q8_0
kernel: up to `plans.SKINNY_ROWS` tokens a skinny mma.sync kernel that
streams the planes once with the weight as the M side, its K splits (whole
superblocks for the K-quants, whole 64-element steps for Q4_0) one cluster
summed in rank order, one launch; past it the warp-specialized wgmma tile
of `csrc/hopper_tile.cuh`, its producer dequantizing each 32-plane-row
stage once for 256 or 128 rows of x (`plans.tile_plan`). W4A8 runs a
warp-specialized wgmma tile of its own (256 x 128, 128 x 256 or 128 x 128,
`w4a8_tile`) whose producer warpgroup dequantizes each stage once for all
the tile's rows of x while the consumers' wgmma runs; see the sources.

One C entry, one launch counter and one launch per product for each format
(`KERNELS`). With `sel` (a device int32 index into stacked [M, rows, N]
planes: a routed expert, models/llama.moe_ffn) the skinny kernel of
csrc/kquant_matmul.cu reads the index on the card and offsets every plane
by it (ops/cuda/select.py), up to 8 tokens; the tiles take no select.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ...core.dtypes import DType
from ...core.layout import LAYOUTS
from ..dequant_torch import dequant_planes_torch
from . import build, plans, select

NAME = "nibble_matmul"      # csrc/nibble_matmul.cu: W4A8 at T > 1
KQ_NAME = "kquant_matmul"  # csrc/kquant_matmul.cu: Q4_0, Q4_K, Q5_K, Q6_K
_TPU = "ntransformer_tpu/ops/pallas/matmul.py:344 _quant_matmul_impl"
# the eight plane slots of the GGUF formats' C entries, in order; a
# format's "qs"/"ql" plane goes to "q", and a slot a format lacks gets a
# null pointer (W4A8 has an entry of its own)
SLOTS = ("q", "qh", "sc_lo", "sc_hi", "mn_lo", "mn_hi", "d", "dmin")
_SLOT_OF = {"qs": "q", "ql": "q"}
_TORCH_DTYPE = {"uint8": torch.uint8, "int8": torch.int8,
                "uint16": torch.int16, "float32": torch.float32}


@dataclass
class Kernel:
    """One format's C entry point and its launch count since the last reset
    (chip_smoke.py reads and resets it)."""

    name: str
    replaces: str
    source: str = f"csrc/{KQ_NAME}.cu"
    launches: int = 0


KERNELS = {
    DType.Q4_0: Kernel("q4_0_matmul", f"{_TPU} + _q4_0_tile :91"),
    DType.Q4_K: Kernel("q4_k_matmul",
                       f"{_TPU} + _q4_k_tile :134 (+ _group_sums :111)"),
    DType.Q5_K: Kernel("q5_k_matmul", f"{_TPU} + _q5_k_tile :172"),
    DType.Q6_K: Kernel("q6_k_matmul", f"{_TPU} + _q6_k_tile :211"),
    # T > 1 only
    DType.W4A8: Kernel("w4a8_matmul", f"{_TPU} + _w4a8_tile :248",
                       f"csrc/{NAME}.cu"),
}
KQUANT = (DType.Q4_K, DType.Q5_K, DType.Q6_K)
# the formats of csrc/kquant_matmul.cu: the skinny kernel and the wgmma
# tile, one launch a product
KQ_FORMATS = (DType.Q4_0,) + KQUANT
# the block along K of each format: 32 elements for Q4_0, 512 (two 256
# groups) for W4A8, a 256-element superblock for the K-quants
_K_UNIT = {DType.Q4_0: 32, DType.W4A8: 512}
_SIGNATURES = {"w4a8_matmul": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
               + [ctypes.c_void_p]}
_KQ_SIGNATURES = {KERNELS[dt].name: [ctypes.c_void_p] * 10
                  + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3
                  for dt in KQ_FORMATS}
_MAGIC = 0x4B000000  # the f32 2^23 the K-quant kernels build codes on


def check_shapes(x: torch.Tensor, planes: dict, dtype: DType,
                 lead: int = 0):
    """(T, K, N) of a product in format `dtype`, or ValueError: x [T, K],
    every plane [K // rows_div, N] of core/layout.py's dtype, after `lead`
    stacked axes (1 for a select's [M, rows, N] stack)."""
    if dtype not in KERNELS:
        raise ValueError(f"{dtype.value} is not a nibble format")
    if x.dim() != 2:
        raise ValueError(f"{dtype.value} matmul wants x [T,K]; got "
                         f"{tuple(x.shape)}")
    t, k = x.shape
    unit = _K_UNIT.get(dtype, 256)
    if k % unit:
        raise ValueError(f"K={k} is not a multiple of {unit} (the "
                         f"{dtype.value} block)")
    specs = LAYOUTS[dtype]
    if set(planes) != {s.name for s in specs}:
        raise ValueError(f"{dtype.value} planes {sorted(planes)}; want "
                         f"{sorted(s.name for s in specs)}")
    n = planes[specs[0].name].shape[-1]
    for s in specs:
        a = planes[s.name]
        if a.dim() != 2 + lead or tuple(a.shape[lead:]) != (k // s.rows_div,
                                                             n):
            raise ValueError(f"{dtype.value} plane {s.name} "
                             f"{tuple(a.shape)} does not match x "
                             f"{tuple(x.shape)} (want "
                             f"{(k // s.rows_div, n)})")
        if a.dtype != _TORCH_DTYPE[s.np_dtype]:
            raise ValueError(f"{dtype.value} plane {s.name} is {a.dtype}; "
                             f"want {_TORCH_DTYPE[s.np_dtype]}")
    return t, k, n


def nibble_matmul_plain(x: torch.Tensor, planes: dict, dtype: DType,
                        sel: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: bf16 dequant, bf16 x, f32
    products and sums. sel: the matrix of stacked planes, gathered on the
    planes' device."""
    if sel is not None:
        planes = select.select_plain(planes, sel)
    _, k, n = check_shapes(x, planes, dtype)
    w = dequant_planes_torch(planes, dtype, k, n, out_dtype=torch.bfloat16)
    return x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)


def w4a8_tile(device: torch.device, t: int, n: int) -> tuple[int, int]:
    """(rows, columns) of the W4A8 tile, the first that gives at least half
    the SMs a block: 256 x 128 when T > 128 (each dequantized weight feeds
    256 rows), 128 x 256, then 128 x 128 (the 8B wo and down at T = 512)."""
    sms = plans.sm_count(device)
    for bm, bn in (((256, 128),) if t > 128 else ()) + ((128, 256),):
        if 2 * -(-t // bm) * -(-n // bn) >= sms:
            return bm, bn
    return 128, 128


def nibble_matmul_cuda(x: torch.Tensor, planes: dict, dtype: DType,
                       sel: torch.Tensor | None = None) -> torch.Tensor:
    """y[T,N] f32 = x[T,K] @ W for a Q4_0 / Q4_K / Q5_K / Q6_K matrix, or a
    W4A8 matrix at T > 1, given as its planes (core/layout.py; f16 planes as
    int16 bits). sel: an int32 index (one element) into stacked planes
    [M, rows, N], read on the card (Q4_0 and the K-quants, T <= 8). On a
    CPU tensor this is the plain twin; on a CUDA tensor it launches the
    kernel or raises."""
    t, k, n = check_shapes(x, planes, dtype, int(sel is not None))
    if dtype == DType.W4A8 and t == 1:
        raise ValueError("w4a8_matmul is the T > 1 product; at T = 1 the "
                         "W4A8 product is the w4a8_decode kernel "
                         "(ops/cuda/w4a8.py)")
    if x.device.type == "cpu":
        return nibble_matmul_plain(x, planes, dtype, sel)
    if sel is not None:
        if dtype not in KQ_FORMATS:
            raise ValueError(f"{dtype.value} matmul takes no select (the "
                             "W4A8 tile runs at T > 1, where the experts "
                             "are indexed by host ints)")
        select.check(x, sel, planes, KERNELS[dtype].name)
    if not x.is_cuda or any(a.device != x.device for a in planes.values()):
        raise ValueError(f"{dtype.value} matmul: tensors on "
                         f"{[str(a.device) for a in planes.values()]} and "
                         f"{x.device}; want one CUDA device")
    if not all(a.is_contiguous() for a in planes.values()):
        raise ValueError(f"{dtype.value} matmul wants contiguous planes")
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    kern = KERNELS[dtype]
    by_slot = {_SLOT_OF.get(nm, nm): a for nm, a in planes.items()}
    strides = (select.strides(by_slot, SLOTS) if sel is not None
               else [0] * len(SLOTS))
    vec = int(n % 16 == 0 and all(a.data_ptr() % 16 == 0
                                  for a in planes.values())
              and all(st % 16 == 0 for st in strides))
    if dtype in KQ_FORMATS:
        ptrs = [by_slot[s].data_ptr() if s in by_slot else None
                for s in SLOTS]
        lib = build.load(KQ_NAME, _KQ_SIGNATURES)
        sms = plans.sm_count(x.device)
        if t <= plans.SKINNY_ROWS:
            path, bm = 0, 0
            nsplit, split_k = plans.skinny_plan(
                sms, t, k, n, plans.Q4_0_UNIT if dtype == DType.Q4_0
                else plans.KQUANT_UNIT)
        else:
            path = 1
            bm, nsplit, split_k = plans.tile_plan(sms, t, k, n, 64)
        y = torch.empty(t, n, dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            rc = getattr(lib, kern.name)(
                x.data_ptr(), *ptrs, y.data_ptr(), t, k, n, path, nsplit,
                split_k, bm, vec, _MAGIC,
                None if sel is None else sel.data_ptr(),
                None if sel is None else (ctypes.c_longlong * 8)(*strides),
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, rc, kern.name)
        kern.launches += 1
        return y
    lib = build.load(NAME, _SIGNATURES)
    y = torch.empty(t, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.w4a8_matmul(
            x.data_ptr(), *(planes[nm].data_ptr() for nm in
                            ("qs", "s_lo", "s_hi", "m_lo", "m_hi")),
            y.data_ptr(), t, k, n, *w4a8_tile(x.device, t, n), vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, kern.name)
    kern.launches += 1
    return y
