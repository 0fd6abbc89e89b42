"""Quantized linear layers: QLinear and the matmul dispatch.

Port of ntransformer_tpu/ops/linear.py. A QLinear holds the transposed
planes of one weight matrix (core/layout.py) as torch tensors, with the JAX
package's plane names; f16-bit scale planes are held as int16 with the same
bits. `qmatmul` launches the hand-written kernel of the matrix's format
(Q8_0: ops/cuda/matmul.py; Q4_0, Q4_K, Q5_K, Q6_K: ops/cuda/
nibble_matmul.py) when kernels are on for the activations' device, and
otherwise computes what the JAX CPU path computes: bf16 dequant, bf16
activations, f32 accumulation.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..core.dtypes import DType
from ..core.layout import LAYOUTS, SPLIT_UNIT
from .dequant_torch import FLOAT_KINDS, dequant_planes_torch, not_ported

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


def qmatmul(x: torch.Tensor, ql: QLinear, *,
            layer: int | None = None) -> torch.Tensor:
    """y[T, N] f32 = x[T, K] @ W^T in file terms. layer: index into stacked
    [L, ...] planes (a free view)."""
    if layer is not None:
        ql = ql.layer(layer)
    if ql.dtype in FLOAT_KINDS:
        w = ql.planes["w"]
        return x.to(w.dtype).to(torch.float32) @ w.to(torch.float32)
    if ql.dtype == DType.Q8_0:
        from .cuda.matmul import quant_matmul_cuda, quant_matmul_plain
        fn = quant_matmul_cuda if kernels_enabled(x) else quant_matmul_plain
        return fn(x, ql.planes["qs"], ql.planes["d"])
    from .cuda import nibble_matmul as nm
    if ql.dtype not in nm.KERNELS:
        raise not_ported(ql.dtype)
    fn = nm.nibble_matmul_cuda if kernels_enabled(x) else \
        nm.nibble_matmul_plain
    return fn(x, ql.planes, ql.dtype)


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
