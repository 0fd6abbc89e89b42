"""Quantized linear layers: QLinear and the matmul dispatch.

Port of ntransformer_tpu/ops/linear.py. A QLinear holds the transposed
planes of one weight matrix (core/layout.py) as torch tensors, with the JAX
package's plane names; f16-bit scale planes are held as int16 with the same
bits. `qmatmul` launches the hand-written kernel of the matrix's format
(Q8_0: ops/cuda/matmul.py; Q4_0, Q4_K, Q5_K, Q6_K and W4A8 at T > 1:
ops/cuda/nibble_matmul.py; W4A8 at T = 1: ops/cuda/w4a8.py; W8A8:
ops/cuda/w8a8.py) when kernels are on for the activations' device, and
otherwise its plain twin, which computes what the JAX CPU path computes:
bf16 dequant, bf16 activations and f32 accumulation for the GGUF formats,
the quantized-activation products of core/w4a8.py and core/w8a8.py for the
engine-native formats.

`convert_qlinear_w4a8` / `convert_qlinear_w8a8` requantize a QLinear of any
format to an engine-native one (the --w4a8 / --w8a8 load path).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import DType
from ..core.layout import LAYOUTS, SPLIT_UNIT, dequant_planes
from ..core.w4a8 import requant_w4a8
from ..core.w8a8 import requant_w8a8
from .dequant_torch import (FLOAT_KINDS, dequant_planes_torch, not_ported,
                            requant_w4a8_torch, requant_w8a8_torch)

# "auto": the CUDA kernels iff the tensors are on CUDA. "off": plain PyTorch
# on every device (chip_smoke.py runs the plain path on the card with it to
# compare). No environment variable sets it.
KERNEL_MODE = "auto"


def kernels_enabled(t: torch.Tensor) -> bool:
    return KERNEL_MODE == "auto" and t.is_cuda


@dataclass
class QLinear:
    """One weight matrix as transposed planes: x [T, K] → y [T, N], planes
    stored [K-ish, N], or [L, K-ish, N] for a stacked layer set."""

    dtype: DType
    k: int
    n: int
    planes: dict

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.planes.values())

    def layer(self, index: int) -> "QLinear":
        """Layer `index` of a stacked QLinear: free views, no copies."""
        return QLinear(self.dtype, self.k, self.n,
                       {nm: v[index] for nm, v in self.planes.items()})


def split_x(x: torch.Tensor, dtype: DType):
    """(x_lo, x_hi), each [..., K/2]: the activations reordered to a nibble
    format's split layout (a reshape and two slices). Plane row r's low and
    high nibbles multiply x_lo[..., r] and x_hi[..., r]; the CUDA kernels
    read x at those positions instead of copying it."""
    u = SPLIT_UNIT[dtype]
    k = x.shape[-1]
    lead = x.shape[:-1]
    xs = x.reshape(*lead, k // u, u)
    return (xs[..., : u // 2].reshape(*lead, k // 2),
            xs[..., u // 2:].reshape(*lead, k // 2))


def plane_dims(planes: dict, dtype: DType) -> tuple[int, int]:
    """(k, n) read off the plane tensors themselves."""
    if dtype in FLOAT_KINDS:
        w = planes["w"]
        return w.shape[-2], w.shape[-1]
    first = LAYOUTS[dtype][0]
    arr = planes[first.name]
    return arr.shape[-2] * first.rows_div, arr.shape[-1]


def pad_qlinear_lanes(ql: QLinear, multiple: int) -> QLinear:
    """Zero-pad every plane's lane (N) axis to the next `multiple`; padded
    columns dequantize to exactly 0 and callers slice the output back."""
    if ql.n % multiple == 0:
        return ql
    pad = multiple - ql.n % multiple
    return QLinear(ql.dtype, ql.k, ql.n + pad,
                   {nm: F.pad(a, (0, pad)) for nm, a in ql.planes.items()})


def qmatmul(x: torch.Tensor, ql: QLinear, *, layer: int | None = None,
            sel: torch.Tensor | None = None) -> torch.Tensor:
    """y[T, N] f32 = x[T, K] @ W^T in file terms. layer: a host index into
    stacked [L, ...] planes (a free view). sel: an int32 tensor holding one
    index into stacked [M, ...] planes that stays on the device (a routed
    expert of the flattened [L·E, ...] expert planes, models/llama.moe_ffn):
    the T = 1 kernels read it on the card and the plain twins gather with
    it, so no path reads it to the host (T <= 8; a float matrix, which has
    no kernel, gathers its matrix as the plain twins do). The W4A8 and W8A8
    products split by rows as the JAX `qmatmul` does: W4A8 at T = 1 is the
    quantized-activation decode product and at T > 1 the exact-dequant
    tile; W8A8 is one int8 product up to MAX_ROWS rows."""
    if layer is not None:
        if sel is not None:
            raise ValueError("qmatmul takes a host layer or a device sel, "
                             "not both")
        ql = ql.layer(layer)
    if ql.dtype in FLOAT_KINDS:
        w = ql.planes["w"]
        if sel is not None:
            from .cuda.select import select_plain
            w = select_plain({"w": w}, sel)["w"]
        return x.to(w.dtype).to(torch.float32) @ w.to(torch.float32)
    if ql.dtype == DType.Q8_0:
        from .cuda.matmul import quant_matmul_cuda, quant_matmul_plain
        fn = quant_matmul_cuda if kernels_enabled(x) else quant_matmul_plain
        return fn(x, ql.planes["qs"], ql.planes["d"], sel)
    if ql.dtype == DType.W4A8 and x.shape[0] == 1:
        from .cuda import w4a8 as cw4
        fn = cw4.w4a8_decode_cuda if kernels_enabled(x) else \
            cw4.w4a8_decode_plain
        return fn(x, ql.planes, sel)
    if ql.dtype == DType.W8A8:
        from .cuda import w8a8 as cw8
        if x.shape[0] <= cw8.MAX_ROWS:
            fn = cw8.w8a8_matmul_cuda if kernels_enabled(x) else \
                cw8.w8a8_matmul_plain
            return fn(x, ql.planes["q"], ql.planes["s"], sel)
        if x.is_cuda:
            # no path of the port reaches it: prefill and admission chunks
            # are 512 rows (ROADMAP queue 3)
            raise ValueError(f"W8A8 product of {x.shape[0]} rows: the card "
                             f"takes at most {cw8.MAX_ROWS}")
        # the JAX package's dequant tail above MAX_ROWS
        if sel is not None:
            raise ValueError("a select takes at most 8 rows")
        k, n = plane_dims(ql.planes, ql.dtype)
        w = dequant_planes_torch(ql.planes, ql.dtype, k, n,
                                 out_dtype=torch.bfloat16)
        return x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32)
    from .cuda import nibble_matmul as nm
    if ql.dtype not in nm.KERNELS:
        raise not_ported(ql.dtype)
    fn = nm.nibble_matmul_cuda if kernels_enabled(x) else \
        nm.nibble_matmul_plain
    return fn(x, ql.planes, ql.dtype, sel)


def convert_qlinear_w4a8(ql: QLinear) -> QLinear:
    """Requantize any QLinear to the engine-native W4A8 format
    (core/w4a8.py): dequantize each [rows, N] plane set to f32 W^T and
    requantize per (256-group, column), over any stacked leading dims. numpy
    planes stay numpy (the host load path), torch planes stay on their
    device (the synthetic path). Changes numerics: callers gate it with
    --w4a8."""
    return _convert_qlinear(ql, DType.W4A8)


def convert_qlinear_w8a8(ql: QLinear) -> QLinear:
    """Requantize any QLinear to W8A8 (core/w8a8.py: per-column symmetric
    int8 and [1, N] scales), as convert_qlinear_w4a8. Changes numerics:
    callers gate it with --w8a8."""
    return _convert_qlinear(ql, DType.W8A8)


def _float_source(w, dtype: DType):
    """A float matrix's f32 values as the JAX package requantizes them. Its
    loader holds a BF16 matrix as bf16 before conversion; the port's host
    plane is f32 until placement, so it is rounded to bf16 here first, or
    the planes would differ."""
    host = isinstance(w, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(w)) if host else w
    t = t.to(torch.bfloat16 if dtype == DType.BF16 else t.dtype)
    t = t.to(torch.float32)
    return t.numpy() if host else t


def _convert_qlinear(ql: QLinear, target: DType) -> QLinear:
    if ql.dtype == target:
        return ql
    first = next(iter(ql.planes.values()))
    host = isinstance(first, np.ndarray)
    if host:
        requant = requant_w4a8 if target == DType.W4A8 else requant_w8a8
    else:
        requant = (requant_w4a8_torch if target == DType.W4A8
                   else requant_w8a8_torch)
    lead = tuple(first.shape[:-2])
    flat = {nm: v.reshape((-1,) + tuple(v.shape[len(lead):]))
            for nm, v in ql.planes.items()}
    outs = []
    for i in range(next(iter(flat.values())).shape[0]):
        sl = {nm: v[i] for nm, v in flat.items()}
        if ql.dtype in FLOAT_KINDS:
            w = _float_source(sl["w"], ql.dtype)
        else:
            k, n = plane_dims(sl, ql.dtype)
            w = (dequant_planes(sl, ql.dtype, k, n) if host
                 else dequant_planes_torch(sl, ql.dtype, k, n))
        outs.append(requant(w))
    stack = np.stack if host else torch.stack
    planes = {nm: stack([o[nm] for o in outs]) for nm in outs[0]}
    planes = {nm: v.reshape(lead + tuple(v.shape[1:]))
              for nm, v in planes.items()}
    return QLinear(target, ql.k, ql.n, planes)


def gather_columns(ql: QLinear, ids: torch.Tensor) -> QLinear:
    """Select output columns (lane dim) of a QLinear — the token columns of
    a transposed [K, V] embedding table."""
    return QLinear(ql.dtype, ql.k, int(ids.shape[0]),
                   {nm: v.index_select(-1, ids) for nm, v in ql.planes.items()})


def embed_lookup(table: QLinear, token_ids: torch.Tensor,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantized embedding rows [T, K] gathered from the transposed
    [K, V] table (shared with the LM head when embeddings are tied)."""
    ids = token_ids.to(device=next(iter(table.planes.values())).device,
                       dtype=torch.long).reshape(-1)
    sub = gather_columns(table, ids)
    k, n = plane_dims(sub.planes, sub.dtype)
    w = dequant_planes_torch(sub.planes, sub.dtype, k, n, out_dtype=out_dtype)
    return w.T
