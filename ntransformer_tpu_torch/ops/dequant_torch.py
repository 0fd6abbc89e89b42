"""Torch mirror of `dequant_planes_jnp` — the oracle for the matmul kernels.

Reconstructs W^T [k, n] from a QLinear's planes on whatever device they
live, on any leading [L, ...] dims: the plain twins' dequant, the
embedding lookup's dequant (a gather of token columns, plain PyTorch on
the card as the JAX package leaves it to XLA) and the CPU oracle. Every
GGUF layout the port loads is here; the engine-native W4A8/W8A8 formats
arrive with their kernels (ROADMAP queue 1 item 10) and raise until then.
"""
from __future__ import annotations

import torch

from ..core.dtypes import DType
from .f16bits import f16_bits_to_f32

FLOAT_KINDS = (DType.F16, DType.BF16, DType.F32)


def not_ported(dtype: DType, what: str = "") -> NotImplementedError:
    """The error for a quantized dtype whose kernel the port lacks."""
    return NotImplementedError(
        f"{what}{dtype.value} is not ported yet: the port computes the GGUF "
        "formats Q8_0, Q4_0, Q4_K, Q5_K, Q6_K and float matrices (ROADMAP "
        "queue 1 item 10: the engine-native W4A8/W8A8 formats)")


def _rep(a: torch.Tensor, n: int) -> torch.Tensor:
    """Repeat each plane row n times (the rows axis is -2)."""
    return torch.repeat_interleave(a, n, dim=-2)


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32)


def dequant_planes_torch(planes: dict, dtype: DType, k: int, n: int,
                         out_dtype=torch.float32) -> torch.Tensor:
    """W^T [..., k, n] in original element order, computed in f32 exactly as
    `dequant_planes_jnp` does it, then cast to out_dtype (bf16 for the
    matmul: the same rounding as the TPU kernel's default-precision dot)."""
    if dtype in FLOAT_KINDS:
        return planes["w"].to(out_dtype)
    lead = tuple(next(iter(planes.values())).shape[:-2])
    if dtype == DType.Q8_0:
        d = f16_bits_to_f32(planes["d"])
        return (_f32(planes["qs"]) * _rep(d, 32)).to(out_dtype)

    if dtype == DType.Q4_0:
        d = _rep(f16_bits_to_f32(planes["d"]), 16)
        qs = planes["qs"]
        w_lo = ((_f32(qs & 0x0F) - 8.0) * d).reshape(*lead, k // 32, 16, n)
        w_hi = ((_f32(qs >> 4) - 8.0) * d).reshape(*lead, k // 32, 16, n)
        return torch.cat([w_lo, w_hi], dim=-2).reshape(*lead, k, n) \
            .to(out_dtype)

    if dtype in (DType.Q4_K, DType.Q5_K):
        qs = planes["qs"]
        lo, hi = _f32(qs & 0x0F), _f32(qs >> 4)
        if dtype == DType.Q5_K:
            # qh [K/8, N] as [K/256, 32, N]: bit 2c covers lo rows
            # [32c, 32c+32) of the superblock, bit 2c+1 the hi rows
            qh = planes["qh"].to(torch.int32).reshape(*lead, k // 256, 32, n)
            lo_b = torch.cat([(qh >> (2 * c)) & 1 for c in range(4)], dim=-2)
            hi_b = torch.cat([(qh >> (2 * c + 1)) & 1 for c in range(4)],
                             dim=-2)
            lo = lo + 16.0 * _f32(lo_b.reshape(*lead, k // 2, n))
            hi = hi + 16.0 * _f32(hi_b.reshape(*lead, k // 2, n))
        d = _rep(f16_bits_to_f32(planes["d"]), 128)
        dmin = _rep(f16_bits_to_f32(planes["dmin"]), 128)
        w_lo = lo * (d * _rep(_f32(planes["sc_lo"]), 32)) \
            - dmin * _rep(_f32(planes["mn_lo"]), 32)
        w_hi = hi * (d * _rep(_f32(planes["sc_hi"]), 32)) \
            - dmin * _rep(_f32(planes["mn_hi"]), 32)
        # interleave lo/hi back at unit 64: lo row 32c+j → elem 64c+j
        w = torch.stack([w_lo.reshape(*lead, k // 64, 32, n),
                         w_hi.reshape(*lead, k // 64, 32, n)], dim=-3)
        return w.reshape(*lead, k, n).to(out_dtype)

    if dtype == DType.Q6_K:
        ql = planes["ql"]
        # qh [K/4, N] as [K/128, 32, N]: bit pairs 0/1 cover the lo rows
        # [64H, 64H+32) / [64H+32, 64H+64), pairs 2/3 the hi rows
        qh = planes["qh"].to(torch.int32).reshape(*lead, k // 128, 32, n)
        hb_lo = torch.cat([qh & 3, (qh >> 2) & 3], dim=-2) \
            .reshape(*lead, k // 2, n)
        hb_hi = torch.cat([(qh >> 4) & 3, (qh >> 6) & 3], dim=-2) \
            .reshape(*lead, k // 2, n)
        lo = ((ql & 0x0F).to(torch.int32) | (hb_lo << 4)) - 32
        hi = ((ql >> 4).to(torch.int32) | (hb_hi << 4)) - 32
        d = _rep(f16_bits_to_f32(planes["d"]), 128)
        w_lo = _f32(lo) * (d * _rep(_f32(planes["sc_lo"]), 16))
        w_hi = _f32(hi) * (d * _rep(_f32(planes["sc_hi"]), 16))
        w = torch.stack([w_lo.reshape(*lead, k // 128, 64, n),
                         w_hi.reshape(*lead, k // 128, 64, n)], dim=-3)
        return w.reshape(*lead, k, n).to(out_dtype)
    raise not_ported(dtype)
