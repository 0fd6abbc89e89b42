"""Torch mirror of `dequant_planes_jnp` — the oracle for the matmul kernels.

Reconstructs W^T [k, n] from a QLinear's planes on whatever device they
live, on any leading [L, ...] dims: the plain twins' dequant, the
embedding lookup's dequant (a gather of token columns, plain PyTorch on
the card as the JAX package leaves it to XLA) and the CPU oracle. Every
GGUF layout the port loads is here, and the engine-native W4A8 and W8A8
formats.

Also the torch twins of the numpy functions of core/w4a8.py and
core/w8a8.py that run on tensors: the requant of planes that live on the
card (`synth_model`'s, converted there) and the run-time activation
quantization of the W4A8 and W8A8 products: the plain paths' (the CPU's,
and the card's with the kernels off), since the W4A8 decode and W8A8
kernels quantize x themselves and are held to these. Each repeats its numpy twin's operations one for one (IEEE
division, round half to even, the same clamps), so codes and scales come
out bit for bit the same on the card and on the CPU. A divisor is always a
tensor: PyTorch on CUDA divides by a Python scalar through its reciprocal,
which moves ~5% of the quotients one ulp from the IEEE division.
"""
from __future__ import annotations

import torch

from ..core.dtypes import DType
from ..core.w4a8 import GRP, UNIT
from .f16bits import f16_bits_to_f32

FLOAT_KINDS = (DType.F16, DType.BF16, DType.F32)


def not_ported(dtype: DType, what: str = "") -> NotImplementedError:
    """The error for a quantized dtype whose kernel the port lacks."""
    return NotImplementedError(
        f"{what}{dtype.value} is not ported yet: the port computes the GGUF "
        "formats Q8_0, Q4_0, Q4_K, Q5_K, Q6_K, the engine-native W4A8 and "
        "W8A8 formats and float matrices (see ROADMAP.md, queue 2)")


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

    if dtype == DType.W4A8:
        return dequant_w4a8_torch(planes, k, n).to(out_dtype)
    if dtype == DType.W8A8:
        return (_f32(planes["q"]) * _f32(planes["s"])).to(out_dtype)
    raise not_ported(dtype)


# ------------------------------------------------- W4A8 / W8A8 (core twins)
def dequant_w4a8_torch(planes: dict, k: int, n: int) -> torch.Tensor:
    """W^T [..., k, n] f32 of W4A8 planes: c * s - m per element, the two
    roundings in core/w4a8.dequant_w4a8's order."""
    qs = planes["qs"]
    lead = tuple(qs.shape[:-2])
    g2 = k // UNIT

    def half(codes, s, m):
        c3 = codes.reshape(*lead, g2, GRP, n)
        return c3 * s.unsqueeze(-2) - m.unsqueeze(-2)

    w_lo = half(_f32(qs & 0x0F), planes["s_lo"], planes["m_lo"])
    w_hi = half(_f32(qs >> 4), planes["s_hi"], planes["m_hi"])
    return torch.stack([w_lo, w_hi], dim=-3).reshape(*lead, k, n)


def requant_w8a8_torch(w_t: torch.Tensor) -> dict:
    """Torch twin of core/w8a8.requant_w8a8: [K, N] W^T -> planes."""
    w = w_t.to(torch.float32)
    amax = w.abs().amax(dim=0, keepdim=True)
    s = amax / torch.full_like(amax, 127.0)
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def requant_w4a8_torch(w_t: torch.Tensor) -> dict:
    """Torch twin of core/w4a8.requant_w4a8: [K, N] W^T -> planes."""
    k, n = w_t.shape
    if k % UNIT:
        raise ValueError(f"w4a8 needs K % {UNIT} == 0, got K={k}")
    g_all = k // GRP
    wg = w_t.to(torch.float32).reshape(g_all, GRP, n)
    mx = wg.amax(dim=1)
    mn = wg.amin(dim=1)
    span = mx - mn
    scale = span / torch.full_like(span, 15.0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round((wg - mn[:, None, :]) / scale[:, None, :]),
                    0, 15).to(torch.uint8).reshape(g_all // 2, 2, GRP, n)
    qs = q[:, 0].reshape(k // 2, n) | (q[:, 1].reshape(k // 2, n) << 4)
    s2 = scale.reshape(g_all // 2, 2, n)
    m2 = (-mn).reshape(g_all // 2, 2, n)
    return {"qs": qs, "s_lo": s2[:, 0].contiguous(),
            "s_hi": s2[:, 1].contiguous(), "m_lo": m2[:, 0].contiguous(),
            "m_hi": m2[:, 1].contiguous()}


def quantize_rows_torch(x: torch.Tensor):
    """Torch twin of core/w8a8.quantize_rows: x [T, K] f32 -> (codes int8
    [T, K], scale f32 [T, 1]); a zero row keeps scale 1."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    am = amax / torch.full_like(amax, 127.0)
    am = torch.where(am > 0, am, torch.ones_like(am))
    codes = torch.clamp(torch.round(x / am), -127, 127).to(torch.int8)
    return codes, am


def quantize_activations_torch(x: torch.Tensor) -> dict:
    """Torch twin of core/w4a8.quantize_activations: x [T, K] -> int32
    codes a_lo / a_hi [T, K/2], alpha_lo / alpha_hi = max(amax/127, 1e-30)
    and the exact group sums xsum_lo / xsum_hi [T, K/512] (their
    summation order is the device's)."""
    t, k = x.shape
    g_all = k // GRP
    xg = x.to(torch.float32).reshape(t, g_all, GRP)
    amax = xg.abs().amax(dim=2)
    alpha = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-30)
    ahat = torch.round(xg / alpha[:, :, None]).to(torch.int32)
    xsum = xg.sum(dim=2)
    a2 = ahat.reshape(t, g_all // 2, 2, GRP)
    alpha2 = alpha.reshape(t, g_all // 2, 2)
    xsum2 = xsum.reshape(t, g_all // 2, 2)
    return dict(a_lo=a2[:, :, 0].reshape(t, k // 2),
                a_hi=a2[:, :, 1].reshape(t, k // 2),
                alpha_lo=alpha2[:, :, 0], alpha_hi=alpha2[:, :, 1],
                xsum_lo=xsum2[:, :, 0], xsum_hi=xsum2[:, :, 1])
