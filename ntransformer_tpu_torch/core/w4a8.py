"""W4A8: the engine-native decode format (numpy).

The port's own copy of ntransformer_tpu/core/w4a8.py, numpy only: the
load-time requant of host planes, the golden dequant and the golden
semantics of the decode matmul. The torch twins (on-card requant of
synthetic planes, the runtime activation quantization) are in
ops/dequant_torch.py; the kernels are csrc/w4a8_decode.cu (T = 1) and the
w4a8_matmul entry of csrc/nibble_matmul.cu (T > 1).

Weights are requantized once at load to 4-bit affine codes with
per-(256-element group, output column) f32 scale and min planes;
activations are quantized per 256-group to int8 at run time, and the
decode product is an exact int32 dot per group with the scale fixup
applied at group granularity. This changes numerics against the source
dtype; it is opt-in (--w4a8).

Format (split unit 512; lo half = EVEN 256-groups, hi half = ODD):
  qs    uint8 [K/2, N]  row 256c+j packs (elem 512c+j) | (elem 512c+256+j)<<4
  s_lo  f32 [K/512, N]  scale of group 2c   (w = s*q - m, q in [0,15])
  s_hi  f32 [K/512, N]  scale of group 2c+1
  m_lo  f32 [K/512, N]  -min of group 2c
  m_hi  f32 [K/512, N]  -min of group 2c+1

4.25 bits/weight: codes 4.0 + four f32 planes/512. K must be a multiple
of 512.
"""
from __future__ import annotations

import numpy as np

GRP = 256     # quant group along K
UNIT = 512    # lo/hi split unit (2 groups)


def requant_w4a8(w_t: np.ndarray) -> dict:
    """[K, N] f32 dequantized W^T -> w4a8 planes dict.

    Per (256-group, column) affine: scale = (max-min)/15, q = round((w-min)/
    scale) in [0,15], so dequant is s*q - m with m = -min. Degenerate groups
    (max == min) store q = 0, s = 1, m = -min.
    """
    k, n = w_t.shape
    if k % UNIT:
        raise ValueError(f"w4a8 needs K % {UNIT} == 0, got K={k}")
    g_all = k // GRP
    wg = w_t.reshape(g_all, GRP, n).astype(np.float32)
    mx = wg.max(axis=1)
    mn = wg.min(axis=1)
    scale = (mx - mn) / 15.0
    scale = np.where(scale > 0, scale, np.ones_like(scale))
    q = np.clip(np.round((wg - mn[:, None, :]) / scale[:, None, :]),
                0, 15).astype(np.uint8)
    lo = q.reshape(g_all // 2, 2, GRP, n)[:, 0].reshape(k // 2, n)
    hi = q.reshape(g_all // 2, 2, GRP, n)[:, 1].reshape(k // 2, n)
    qs = (lo | (hi << 4)).astype(np.uint8)
    s2 = scale.reshape(g_all // 2, 2, n)
    m2 = (-mn).reshape(g_all // 2, 2, n)
    return {
        "qs": qs,
        "s_lo": s2[:, 0].astype(np.float32),
        "s_hi": s2[:, 1].astype(np.float32),
        "m_lo": m2[:, 0].astype(np.float32),
        "m_hi": m2[:, 1].astype(np.float32),
    }


def dequant_w4a8(planes: dict, k: int, n: int) -> np.ndarray:
    """Planes -> [K, N] f32 W^T in original element order: c * s - m."""
    qs = planes["qs"].astype(np.int32)
    lo = (qs & 0x0F).astype(np.float32)           # [K/2, N] even groups
    hi = (qs >> 4).astype(np.float32)             # odd groups
    g2 = k // UNIT

    def half(codes, s, m):
        c3 = codes.reshape(g2, GRP, n)
        return c3 * s[:, None, :] - m[:, None, :]

    wlo = half(lo, planes["s_lo"], planes["m_lo"])   # [g2, GRP, n]
    whi = half(hi, planes["s_hi"], planes["m_hi"])
    return np.stack([wlo, whi], axis=1).reshape(k, n)


def quantize_activations(x: np.ndarray) -> dict:
    """x [T, K] float -> the decode kernel's activation inputs: int32 codes
    split lo/hi [T, K/2], per-group alpha = max(amax/127, 1e-30) and exact
    group sums of x (the min term pays no activation-quant error), each
    split [T, K/512]."""
    t, k = x.shape
    g_all = k // GRP
    xg = x.astype(np.float32).reshape(t, g_all, GRP)
    alpha = np.abs(xg).max(axis=2) / 127.0
    alpha = np.maximum(alpha, 1e-30)
    ahat = np.round(xg / alpha[:, :, None]).astype(np.int32)
    xsum = xg.sum(axis=2)
    a2 = ahat.reshape(t, g_all // 2, 2, GRP)

    def ev(v):
        return v.reshape(t, g_all // 2, 2)[:, :, 0]

    def od(v):
        return v.reshape(t, g_all // 2, 2)[:, :, 1]

    return dict(
        a_lo=a2[:, :, 0].reshape(t, k // 2),
        a_hi=a2[:, :, 1].reshape(t, k // 2),
        alpha_lo=ev(alpha), alpha_hi=od(alpha),
        xsum_lo=ev(xsum), xsum_hi=od(xsum),
    )


def w4a8_matmul_golden(x: np.ndarray, planes: dict, k: int,
                       n: int) -> np.ndarray:
    """The decode path's intended math in f32 (exact given the quantized
    inputs): y = sum_g alpha_g * (ahat_g . s_g q_g) - sum_g xsum_g m_g."""
    acts = quantize_activations(x)
    qs = planes["qs"].astype(np.int32)
    t = x.shape[0]
    g2 = k // UNIT

    def half(codes, s, m, a, alpha, xsum):
        w = (codes.reshape(g2, GRP, n).astype(np.float32)
             * s[:, None, :]).reshape(k // 2, n)
        af = (a.reshape(t, g2, GRP).astype(np.float32)
              * alpha[:, :, None]).reshape(t, k // 2)
        return af @ w - xsum @ m

    return (half(qs & 0x0F, planes["s_lo"], planes["m_lo"],
                 acts["a_lo"], acts["alpha_lo"], acts["xsum_lo"])
            + half(qs >> 4, planes["s_hi"], planes["m_hi"],
                   acts["a_hi"], acts["alpha_hi"], acts["xsum_hi"]))
