"""Vectorized numpy dequantizers — the bit-exact golden reference path.

These decode the public GGML block formats (semantics as implemented by the
reference engine: src/cuda/gemm.cu dequant math and
tools/decompose_gguf.py:219-382) into f32. Every Pallas kernel and every
load-time re-layout (core/layout.py) is parity-tested against this module.

All functions take the packed bytes of a whole tensor and its logical
(rows, cols) shape; quantization blocks never straddle rows.
"""
from __future__ import annotations

import numpy as np

from .dtypes import DType

QK = 32      # Q4_0 / Q8_0 block elements
QK_K = 256   # K-quant superblock elements


def _f16(b: np.ndarray) -> np.ndarray:
    """View little-endian f16 pairs of bytes as f32."""
    return np.ascontiguousarray(b).view(np.float16).astype(np.float32)


def dequant_q8_0(raw: np.ndarray | bytes, rows: int, cols: int) -> np.ndarray:
    nb = rows * cols // QK
    data = np.frombuffer(raw, dtype=np.uint8).reshape(nb, 34)
    d = _f16(data[:, :2]).reshape(nb)
    qs = data[:, 2:].view(np.int8).astype(np.float32)
    return (qs * d[:, None]).reshape(rows, cols)


def dequant_q4_0(raw: np.ndarray | bytes, rows: int, cols: int) -> np.ndarray:
    nb = rows * cols // QK
    data = np.frombuffer(raw, dtype=np.uint8).reshape(nb, 18)
    d = _f16(data[:, :2]).reshape(nb)
    qs = data[:, 2:]
    lo = (qs & 0x0F).astype(np.int32) - 8   # elements 0..15
    hi = (qs >> 4).astype(np.int32) - 8     # elements 16..31
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d[:, None]).reshape(rows, cols)


def unpack_kquant_scales(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min packing shared by Q4_K and Q5_K.

    Returns (sc, m), each [B, 8] uint8 in 0..63.
    Packing scheme per GGML: sub-blocks 0-3 use low 6 bits of bytes 0-3
    (scales) and 4-7 (mins); sub-blocks 4-7 pack their low nibbles in bytes
    8-11 and their high 2 bits in the top bits of bytes 0-7.
    """
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), dtype=np.uint8)
    m = np.empty_like(sc)
    sc[..., :4] = s[..., 0:4] & 0x3F
    m[..., :4] = s[..., 4:8] & 0x3F
    sc[..., 4:] = (s[..., 8:12] & 0x0F) | ((s[..., 0:4] >> 6) << 4)
    m[..., 4:] = (s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)
    return sc, m


def pack_kquant_scales(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Inverse of unpack_kquant_scales; sc/m [B, 8] uint8 in 0..63 → [B, 12]."""
    sc = sc.astype(np.uint8)
    m = m.astype(np.uint8)
    out = np.zeros(sc.shape[:-1] + (12,), dtype=np.uint8)
    out[..., 0:4] = (sc[..., :4] & 0x3F) | ((sc[..., 4:] >> 4) << 6)
    out[..., 4:8] = (m[..., :4] & 0x3F) | ((m[..., 4:] >> 4) << 6)
    out[..., 8:12] = (sc[..., 4:] & 0x0F) | ((m[..., 4:] & 0x0F) << 4)
    return out


def dequant_q4_k(raw: np.ndarray | bytes, rows: int, cols: int) -> np.ndarray:
    nb = rows * cols // QK_K
    data = np.frombuffer(raw, dtype=np.uint8).reshape(nb, 144)
    d = _f16(data[:, 0:2]).reshape(nb, 1)
    dmin = _f16(data[:, 2:4]).reshape(nb, 1)
    sc, m = unpack_kquant_scales(data[:, 4:16])
    qs = data[:, 16:144].reshape(nb, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32)  # sub-block = chunk*2 + half
    scale = d * sc.astype(np.float32)   # [nb, 8]
    minv = dmin * m.astype(np.float32)  # [nb, 8]
    y = q * scale[:, :, None] - minv[:, :, None]
    return y.reshape(rows, cols)


def dequant_q5_k(raw: np.ndarray | bytes, rows: int, cols: int) -> np.ndarray:
    nb = rows * cols // QK_K
    data = np.frombuffer(raw, dtype=np.uint8).reshape(nb, 176)
    d = _f16(data[:, 0:2]).reshape(nb, 1)
    dmin = _f16(data[:, 2:4]).reshape(nb, 1)
    sc, m = unpack_kquant_scales(data[:, 4:16])
    qh = data[:, 16:48]                      # [nb, 32]
    ql = data[:, 48:176].reshape(nb, 4, 32)  # per 64-chunk
    lo = (ql & 0x0F).astype(np.int32)
    hi = (ql >> 4).astype(np.int32)
    # bit 2j of qh → +16 for first half of chunk j; bit 2j+1 → second half
    shifts = np.arange(4, dtype=np.uint8) * 2
    hlo = ((qh[:, None, :] >> shifts[None, :, None]) & 1).astype(np.int32)
    hhi = ((qh[:, None, :] >> (shifts + 1)[None, :, None]) & 1).astype(np.int32)
    qlo = (lo + 16 * hlo).astype(np.float32)
    qhi = (hi + 16 * hhi).astype(np.float32)
    q = np.stack([qlo, qhi], axis=2).reshape(nb, 8, 32)
    scale = d * sc.astype(np.float32)
    minv = dmin * m.astype(np.float32)
    y = q * scale[:, :, None] - minv[:, :, None]
    return y.reshape(rows, cols)


def dequant_q6_k(raw: np.ndarray | bytes, rows: int, cols: int) -> np.ndarray:
    nb = rows * cols // QK_K
    data = np.frombuffer(raw, dtype=np.uint8).reshape(nb, 210)
    ql = data[:, 0:128].reshape(nb, 2, 64)
    qh = data[:, 128:192].reshape(nb, 2, 32)
    scales = data[:, 192:208].view(np.int8).reshape(nb, 2, 8).astype(np.float32)
    d = _f16(data[:, 208:210]).reshape(nb, 1, 1, 1)
    lo_a = (ql[:, :, :32] & 0x0F).astype(np.int32)
    lo_b = (ql[:, :, 32:] & 0x0F).astype(np.int32)
    hi_a = (ql[:, :, :32] >> 4).astype(np.int32)
    hi_b = (ql[:, :, 32:] >> 4).astype(np.int32)
    qhi = qh.astype(np.int32)
    q1 = (lo_a | ((qhi & 3) << 4)) - 32          # elements l+0,  scale l//16
    q2 = (lo_b | (((qhi >> 2) & 3) << 4)) - 32   # elements l+32, scale l//16+2
    q3 = (hi_a | (((qhi >> 4) & 3) << 4)) - 32   # elements l+64, scale l//16+4
    q4 = (hi_b | (((qhi >> 6) & 3) << 4)) - 32   # elements l+96, scale l//16+6
    q = np.stack([q1, q2, q3, q4], axis=2).astype(np.float32)  # [nb, 2, 4, 32]
    # scale index for group g, lane l: g*2 + l//16
    sidx = (np.arange(4)[:, None] * 2 + np.arange(32)[None, :] // 16)  # [4, 32]
    sc_sel = np.take_along_axis(
        scales[:, :, None, :].repeat(4, axis=2),
        np.broadcast_to(sidx, (nb, 2, 4, 32)),
        axis=3,
    )
    y = d * sc_sel * q  # [nb, 2, 4, 32] — ordering half*128 + g*32 + l
    return y.reshape(rows, cols)


def dequant_f16(raw, rows: int, cols: int) -> np.ndarray:
    return np.frombuffer(raw, dtype="<f2").astype(np.float32).reshape(rows, cols)


def dequant_bf16(raw, rows: int, cols: int) -> np.ndarray:
    u = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
    return u.view(np.float32).reshape(rows, cols)


def dequant_f32(raw, rows: int, cols: int) -> np.ndarray:
    return np.frombuffer(raw, dtype="<f4").reshape(rows, cols).copy()


DEQUANT_FN = {
    DType.F32: dequant_f32,
    DType.F16: dequant_f16,
    DType.BF16: dequant_bf16,
    DType.Q8_0: dequant_q8_0,
    DType.Q4_0: dequant_q4_0,
    DType.Q4_K: dequant_q4_k,
    DType.Q5_K: dequant_q5_k,
    DType.Q6_K: dequant_q6_k,
}


def dequantize(raw, dtype: DType, rows: int, cols: int) -> np.ndarray:
    """Dequantize a packed tensor to f32 [rows, cols]."""
    return DEQUANT_FN[dtype](raw, rows, cols)
