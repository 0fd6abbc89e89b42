"""Torch mirror of `dequant_planes_jnp` — the oracle for the matmul kernel.

Reconstructs W^T [k, n] from a QLinear's planes on whatever device they
live. Only the dtypes the port computes are here: Q8_0 and the float kinds.
The other quantized layouts arrive with their kernels (ROADMAP queue 2
row 1b); until then they raise instead of taking a plain dequant path.
"""
from __future__ import annotations

import torch

from ..core.dtypes import DType
from .f16bits import f16_bits_to_f32

FLOAT_KINDS = (DType.F16, DType.BF16, DType.F32)


def not_ported(dtype: DType, what: str = "") -> NotImplementedError:
    """The error for a quantized dtype whose kernel the port lacks."""
    return NotImplementedError(
        f"{what}{dtype.value} is not ported yet: the port computes Q8_0 and "
        "float matrices only (ROADMAP queue 2 row 1b: the Q4_0/Q4_K/Q5_K/"
        "Q6_K dequant-matmul tiles)")


def dequant_planes_torch(planes: dict, dtype: DType, k: int, n: int,
                         out_dtype=torch.float32) -> torch.Tensor:
    """W^T [k, n] in original element order: for Q8_0, q·d in f32, then cast
    to out_dtype (bf16 for the matmul: the same rounding as the TPU kernel's
    default-precision dot)."""
    if dtype in FLOAT_KINDS:
        return planes["w"].to(out_dtype)
    if dtype == DType.Q8_0:
        d = f16_bits_to_f32(planes["d"])
        qs = planes["qs"].to(torch.float32)
        return (qs * torch.repeat_interleave(d, 32, dim=-2)).to(out_dtype)
    raise not_ported(dtype)
