"""Vectorized numpy quantizers (f32 → GGML packed blocks).

A copy of the JAX package's core/quant.py (the port imports nothing from
that package), unchanged in behaviour: tests/test_torch_dequant.py holds
its bytes equal to the original's for every format. The port uses it to
requantize a model on a machine without JAX (chip_smoke.py writes
requantized repolm512 files with it and core/gguf.py's GGUFWriter).

Quantization here is round-to-nearest with simple absmax/minmax scale search —
adequate for round-trip-error tests and synthetic models. Decoding of files
produced by any GGML-compliant quantizer remains bit-exact via core/dequant.py.
"""
from __future__ import annotations

import numpy as np

from .dequant import QK, QK_K, pack_kquant_scales
from .dtypes import DType


def _f16_bytes(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).view(np.uint8)


def quantize_q8_0(x: np.ndarray) -> bytes:
    b = x.reshape(-1, QK).astype(np.float32)
    amax = np.abs(b).max(axis=1)
    d = (amax / 127.0).astype(np.float16).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = np.clip(np.rint(b * inv[:, None]), -128, 127).astype(np.int8)
    out = np.empty((b.shape[0], 34), dtype=np.uint8)
    out[:, :2] = _f16_bytes(d).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def quantize_q4_0(x: np.ndarray) -> bytes:
    b = x.reshape(-1, QK).astype(np.float32)
    # GGML picks the signed max-|x| element and maps it to -8
    idx = np.abs(b).argmax(axis=1)
    vmax = b[np.arange(b.shape[0]), idx]
    d = (vmax / -8.0).astype(np.float16).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.rint(b * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    out = np.empty((b.shape[0], 18), dtype=np.uint8)
    out[:, :2] = _f16_bytes(d).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


def _kquant_affine(x: np.ndarray, qmax: int):
    """Per-32-group affine quantization used by Q4_K/Q5_K.

    x: [nb, 8, 32] → returns (q uint8 [nb,8,32], sc6, m6 uint8 [nb,8],
    d f32 [nb], dmin f32 [nb]) such that x ≈ d*sc6*q - dmin*m6.
    """
    gmin = np.minimum(x.min(axis=2), 0.0)          # [nb, 8] (mins stored positive)
    gmax = np.maximum(x.max(axis=2), 0.0)
    scale = (gmax - gmin) / qmax                    # per-group scale ≥ 0
    mpos = -gmin                                    # per-group positive min
    d = (scale.max(axis=1) / 63.0).astype(np.float16).astype(np.float32)
    dmin = (mpos.max(axis=1) / 63.0).astype(np.float16).astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin > 0, dmin, 1.0), 0.0)
    sc6 = np.clip(np.rint(scale * inv_d[:, None]), 0, 63).astype(np.uint8)
    m6 = np.clip(np.rint(mpos * inv_m[:, None]), 0, 63).astype(np.uint8)
    eff_scale = d[:, None] * sc6.astype(np.float32)
    eff_min = dmin[:, None] * m6.astype(np.float32)
    inv_s = np.where(eff_scale > 0, 1.0 / np.where(eff_scale > 0, eff_scale, 1.0), 0.0)
    q = np.clip(np.rint((x + eff_min[:, :, None]) * inv_s[:, :, None]), 0, qmax)
    return q.astype(np.uint8), sc6, m6, d, dmin


def quantize_q4_k(x: np.ndarray) -> bytes:
    b = x.reshape(-1, 8, 32).astype(np.float32)
    nb = b.shape[0]
    assert b.size % QK_K == 0
    q, sc6, m6, d, dmin = _kquant_affine(b, 15)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _f16_bytes(dmin).reshape(-1, 2)
    out[:, 4:16] = pack_kquant_scales(sc6, m6)
    qq = q.reshape(nb, 4, 2, 32)  # [nb, chunk, half, 32]
    out[:, 16:144] = (qq[:, :, 0] | (qq[:, :, 1] << 4)).reshape(nb, 128)
    return out.tobytes()


def quantize_q5_k(x: np.ndarray) -> bytes:
    b = x.reshape(-1, 8, 32).astype(np.float32)
    nb = b.shape[0]
    q, sc6, m6, d, dmin = _kquant_affine(b, 31)
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = _f16_bytes(d).reshape(-1, 2)
    out[:, 2:4] = _f16_bytes(dmin).reshape(-1, 2)
    out[:, 4:16] = pack_kquant_scales(sc6, m6)
    qq = q.reshape(nb, 4, 2, 32)
    lo = qq & 0x0F
    hb = (qq >> 4) & 1  # [nb, chunk, half, 32]
    out[:, 16:48] = 0
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for chunk in range(4):
        qh |= (hb[:, chunk, 0] << (2 * chunk)) | (hb[:, chunk, 1] << (2 * chunk + 1))
    out[:, 16:48] = qh
    out[:, 48:176] = (lo[:, :, 0] | (lo[:, :, 1] << 4)).reshape(nb, 128)
    return out.tobytes()


def quantize_q6_k(x: np.ndarray) -> bytes:
    b = x.reshape(-1, 16, 16).astype(np.float32)  # 16 groups of 16
    nb = b.shape[0]
    gamax = np.abs(b).max(axis=2)                  # [nb, 16]
    gscale = gamax / 31.0
    d = (gscale.max(axis=1) / 127.0).astype(np.float16).astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    sc = np.clip(np.rint(gscale * inv_d[:, None]), -128, 127).astype(np.int8)
    eff = d[:, None] * sc.astype(np.float32)
    inv_s = np.where(eff != 0, 1.0 / np.where(eff != 0, eff, 1.0), 0.0)
    q = np.clip(np.rint(b * inv_s[:, :, None]), -32, 31).astype(np.int32) + 32
    q = q.reshape(nb, 2, 128)  # two halves
    # Inverse of the q1..q4 interleave (see dequant_q6_k): within a half,
    # element l+0 → q1, l+32 → q2, l+64 → q3, l+96 → q4 (l in 0..31)
    g = q.reshape(nb, 2, 4, 32)
    ql = np.empty((nb, 2, 64), dtype=np.uint8)
    ql[:, :, :32] = (g[:, :, 0] & 0x0F) | ((g[:, :, 2] & 0x0F) << 4)
    ql[:, :, 32:] = (g[:, :, 1] & 0x0F) | ((g[:, :, 3] & 0x0F) << 4)
    qh = ((g[:, :, 0] >> 4) | ((g[:, :, 1] >> 4) << 2)
          | ((g[:, :, 2] >> 4) << 4) | ((g[:, :, 3] >> 4) << 6)).astype(np.uint8)
    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, 0:128] = ql.reshape(nb, 128)
    out[:, 128:192] = qh.reshape(nb, 64)
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = _f16_bytes(d).reshape(-1, 2)
    return out.tobytes()


def quantize_f16(x: np.ndarray) -> bytes:
    return x.astype(np.float16).tobytes()


def quantize_f32(x: np.ndarray) -> bytes:
    return x.astype(np.float32).tobytes()


QUANT_FN = {
    DType.F32: quantize_f32,
    DType.F16: quantize_f16,
    DType.Q8_0: quantize_q8_0,
    DType.Q4_0: quantize_q4_0,
    DType.Q4_K: quantize_q4_k,
    DType.Q5_K: quantize_q5_k,
    DType.Q6_K: quantize_q6_k,
}


def quantize(x: np.ndarray, dtype: DType) -> bytes:
    """Quantize f32 array to packed bytes of `dtype`."""
    return QUANT_FN[dtype](x)
