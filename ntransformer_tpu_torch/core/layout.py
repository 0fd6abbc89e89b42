"""Load-time re-layout of GGML quant blocks into TPU-native planar arrays.

The reference keeps GGUF blocks packed in GPU buffers and bit-twiddles per
warp (src/cuda/gemm.cu). A literal port would make the TPU's VPU do byte
gathers it hates. Instead, each tensor is de-interleaved ONCE at load into a
set of planar arrays ("planes") chosen so that:

  * weights live TRANSPOSED as [K, N] (contraction dim on sublanes, output
    dim on lanes) — the natural layout for `x @ W` on the MXU;
  * every nibble/bit unpack in the kernel yields tiles covering CONTIGUOUS
    ranges of a once-per-call reordered activation vector, so dequant is
    pure vectorized and/shift/multiply with zero lane shuffles;
  * K-quant 6-bit scales/mins are unpacked to byte planes and the f16
    superblock scales kept as their own planes, so in-kernel dequant is
    exact (bit-identical to the golden path) with only cheap sublane
    broadcasts (granularities 16/32 and 128).

The activation reorder is a reshape-only permutation (`split_x`): for a
format whose file blocks interleave elements at unit u, x is viewed as
[..., K/u, u] and split into the first/second u/2 columns. The file's nibble
pairs then land exactly on (x_lo[j], x_hi[j]) — i.e. the raw qs bytes,
transposed, ARE the plane. Dot products are invariant to this consistent
permutation of (x, W) pairs.

Layouts (K = in_features, N = out_features):
  q8_0: qs   int8 [K,   N]; d  u16(f16 bits) [K/32, N]          (no reorder)
  q4_0: qs  uint8 [K/2, N]; d  u16(f16 bits) [K/32, N]          (unit 32)
  q4_k: qs  uint8 [K/2, N]; sc_lo/sc_hi/mn_lo/mn_hi uint8 [K/64, N];
        d/dmin u16(f16 bits) [K/256, N]                                    (unit 64)
  q5_k: q4_k planes + qh uint8 [K/8, N]                          (unit 64)
  q6_k: ql  uint8 [K/2, N]; qh uint8 [K/4, N];
        sc_lo/sc_hi int8 [K/32, N]; d u16 [K/256, N]             (unit 128)
  f16/bf16/f32: w bf16 [K, N]

Bits/weight match the file format exactly (Q4_K 4.625, Q5_K 5.625, Q6_K
6.5625) — de-interleaving adds zero memory or bandwidth overhead.

Row layout (for embedding gather) keeps tensors un-transposed with the same
plane fields at [V, ...] — see `relayout_rows` / dequant in ops/embed.py.

All planes are parity-tested against core/dequant.py (the bit-exact golden
path) in tests/test_layout.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .dequant import unpack_kquant_scales
from .dtypes import DType

# Activation reorder unit per dtype (file block interleave granularity)
SPLIT_UNIT = {
    DType.Q4_0: 32,
    DType.Q4_K: 64,
    DType.Q5_K: 64,
    DType.Q6_K: 128,
    DType.W4A8: 512,  # lo half = even 256-groups, hi = odd (core/w4a8.py)
}


@dataclass(frozen=True)
class PlaneSpec:
    """Static description of one plane of a quant layout."""

    name: str
    np_dtype: str
    rows_div: int  # plane rows = K // rows_div


LAYOUTS: dict[DType, tuple[PlaneSpec, ...]] = {
    DType.Q8_0: (
        PlaneSpec("qs", "int8", 1),
        PlaneSpec("d", "uint16", 32),
    ),
    DType.Q4_0: (
        PlaneSpec("qs", "uint8", 2),
        PlaneSpec("d", "uint16", 32),
    ),
    DType.Q4_K: (
        PlaneSpec("qs", "uint8", 2),
        PlaneSpec("sc_lo", "uint8", 64),
        PlaneSpec("sc_hi", "uint8", 64),
        PlaneSpec("mn_lo", "uint8", 64),
        PlaneSpec("mn_hi", "uint8", 64),
        PlaneSpec("d", "uint16", 256),
        PlaneSpec("dmin", "uint16", 256),
    ),
    DType.Q5_K: (
        PlaneSpec("qs", "uint8", 2),
        PlaneSpec("qh", "uint8", 8),
        PlaneSpec("sc_lo", "uint8", 64),
        PlaneSpec("sc_hi", "uint8", 64),
        PlaneSpec("mn_lo", "uint8", 64),
        PlaneSpec("mn_hi", "uint8", 64),
        PlaneSpec("d", "uint16", 256),
        PlaneSpec("dmin", "uint16", 256),
    ),
    DType.Q6_K: (
        PlaneSpec("ql", "uint8", 2),
        PlaneSpec("qh", "uint8", 4),
        PlaneSpec("sc_lo", "int8", 32),
        PlaneSpec("sc_hi", "int8", 32),
        PlaneSpec("d", "uint16", 256),
    ),
    # Engine-native w4a8 (core/w4a8.py) — produced by load-time requant,
    # never by relayout() of file bytes.
    DType.W4A8: (
        PlaneSpec("qs", "uint8", 2),
        PlaneSpec("s_lo", "float32", 512),
        PlaneSpec("s_hi", "float32", 512),
        PlaneSpec("m_lo", "float32", 512),
        PlaneSpec("m_hi", "float32", 512),
    ),
    # Engine-native w8a8 (core/w8a8.py) — load-time requant only.
    # rows_div=0 is the "fixed 1 row" sentinel: the column-scale plane is
    # [1, N] regardless of K (per-column, K-independent).
    DType.W8A8: (
        PlaneSpec("q", "int8", 1),
        PlaneSpec("s", "float32", 0),
    ),
}




# Square tile of the transposing copy: 256 x 256 one-byte elements (64 KiB)
# stay in cache while they are read by rows and written by columns.
_TILE = 256


def transposed(a: np.ndarray) -> np.ndarray:
    """a.T of a 2-D array as a C-contiguous copy. numpy's own transposing
    copy reads the source a column at a time, which for the 1-byte planes of
    a vocabulary-sized matrix is an order of magnitude slower than copying
    square tiles; the bytes are the same."""
    n, m = a.shape
    if n * m <= _TILE * _TILE:
        return np.ascontiguousarray(a.T)
    out = np.empty((m, n), a.dtype)
    for i in range(0, n, _TILE):
        for j in range(0, m, _TILE):
            out[j:j + _TILE, i:i + _TILE] = a[i:i + _TILE, j:j + _TILE].T
    return out


def relayout(raw, dtype: DType, n: int, k: int) -> dict[str, np.ndarray]:
    """Re-layout packed GGUF bytes of a [n, k] tensor into transposed planes.

    `n` = out_features (file rows), `k` = in_features (file cols; the
    contraction dim along which blocks run).
    """
    raw = np.frombuffer(raw, dtype=np.uint8) if not isinstance(raw, np.ndarray) else raw

    if dtype == DType.Q8_0:
        nb = n * k // 32
        data = raw.reshape(nb, 34)
        d = data[:, :2].copy().view(np.uint16).reshape(n, k // 32)
        qs = data[:, 2:].view(np.int8).reshape(n, k)
        return {"qs": transposed(qs),
                "d": transposed(d)}

    if dtype == DType.Q4_0:
        nb = n * k // 32
        data = raw.reshape(nb, 18)
        d = data[:, :2].copy().view(np.uint16).reshape(n, k // 32)
        # File byte j of block b packs (elem 32b+j, elem 32b+16+j) — exactly
        # the (lo, hi) pair for split unit 32, so the raw bytes are the plane.
        qs = data[:, 2:].reshape(n, k // 2)
        return {"qs": transposed(qs),
                "d": transposed(d)}

    if dtype in (DType.Q4_K, DType.Q5_K):
        nb = n * k // 256
        bb = 144 if dtype == DType.Q4_K else 176
        data = raw.reshape(nb, bb)
        d = data[:, 0:2].copy().view(np.uint16).reshape(n, k // 256)
        dmin = data[:, 2:4].copy().view(np.uint16).reshape(n, k // 256)
        sc6, m6 = unpack_kquant_scales(data[:, 4:16])  # [nb, 8] uint8
        # Groups alternate lo/hi per 64-element chunk (sub-block 2c / 2c+1)
        sc = sc6.reshape(n, k // 256, 4, 2)
        mn = m6.reshape(n, k // 256, 4, 2)
        planes = {
            "sc_lo": transposed(sc[..., 0].reshape(n, k // 64)),
            "sc_hi": transposed(sc[..., 1].reshape(n, k // 64)),
            "mn_lo": transposed(mn[..., 0].reshape(n, k // 64)),
            "mn_hi": transposed(mn[..., 1].reshape(n, k // 64)),
            "d": transposed(d),
            "dmin": transposed(dmin),
        }
        if dtype == DType.Q4_K:
            qs = data[:, 16:144]
        else:
            qs = data[:, 48:176]
            planes["qh"] = transposed(
                data[:, 16:48].reshape(n, k // 8))
        # File qs byte j of chunk c packs (elem 64c+j, elem 64c+32+j) — the
        # (lo, hi) pair for split unit 64; raw bytes are the plane.
        planes["qs"] = transposed(qs.reshape(n, k // 2))
        return planes

    if dtype == DType.Q6_K:
        nb = n * k // 256
        data = raw.reshape(nb, 210)
        # File ql byte (64h+j) packs (elem 128h+j, elem 128h+64+j): unit 128.
        ql = data[:, 0:128].reshape(n, k // 2)
        qh = data[:, 128:192].reshape(n, k // 4)
        scales = data[:, 192:208].view(np.int8).reshape(n, k // 256, 2, 8)
        d = data[:, 208:210].copy().view(np.uint16).reshape(n, k // 256)
        # group index within sb = 8h + 2g + l//16; lo (j∈[0,64), g=j//32)
        # covers groups 8h..8h+3, hi covers 8h+4..8h+7 — contiguous per half.
        sc_lo = scales[..., 0:4].reshape(n, k // 32)
        sc_hi = scales[..., 4:8].reshape(n, k // 32)
        return {
            "ql": transposed(ql),
            "qh": transposed(qh),
            "sc_lo": transposed(sc_lo),
            "sc_hi": transposed(sc_hi),
            "d": transposed(d),
        }

    raise ValueError(f"no planar layout for {dtype}")


def split_x(x: np.ndarray, dtype: DType) -> tuple[np.ndarray, np.ndarray]:
    """Reorder activations to match a split layout: returns (x_lo, x_hi),
    each [..., K/2]. Pure reshape/slice; numpy version (jnp twin in ops)."""
    u = SPLIT_UNIT[dtype]
    k = x.shape[-1]
    xs = x.reshape(*x.shape[:-1], k // u, u)
    return (xs[..., : u // 2].reshape(*x.shape[:-1], k // 2),
            xs[..., u // 2:].reshape(*x.shape[:-1], k // 2))


# ---------------------------------------------------------------------------
# Reference dequant FROM planes (numpy) — used to parity-test the planes and
# the Pallas kernels' unpack logic.
# ---------------------------------------------------------------------------

def dequant_planes(planes: dict[str, np.ndarray], dtype: DType,
                   k: int, n: int) -> np.ndarray:
    """Reconstruct W^T [K, N] f32 in ORIGINAL element order from planes."""
    if dtype == DType.W4A8:
        from .w4a8 import dequant_w4a8
        return dequant_w4a8(planes, k, n)
    if dtype == DType.W8A8:
        from .w8a8 import dequant_w8a8
        return dequant_w8a8(planes, k, n)

    if dtype == DType.Q8_0:
        d = planes["d"].view(np.float16).astype(np.float32)
        qs = planes["qs"].astype(np.float32)
        return qs * np.repeat(d, 32, axis=0)

    if dtype == DType.Q4_0:
        d = np.repeat(planes["d"].view(np.float16).astype(np.float32), 16, axis=0)
        qs = planes["qs"]
        lo = (qs & 0x0F).astype(np.float32) - 8.0
        hi = (qs >> 4).astype(np.float32) - 8.0
        w = np.zeros((k, n), np.float32)
        lo_idx, hi_idx = _split_index(k, 32)
        w[lo_idx] = lo * d
        w[hi_idx] = hi * d
        return w

    if dtype in (DType.Q4_K, DType.Q5_K):
        qs = planes["qs"]
        lo = (qs & 0x0F).astype(np.float32)
        hi = (qs >> 4).astype(np.float32)
        if dtype == DType.Q5_K:
            qh = planes["qh"]  # [K/8, N]; row 32s+j, bit 2c(+1)
            # lo position p = 128s + 32c + j → qh row 32s + j, bit 2c
            hb = _q5k_bits(qh, k, n)
            lo = lo + 16.0 * hb[0]
            hi = hi + 16.0 * hb[1]
        d = np.repeat(planes["d"].view(np.float16).astype(np.float32), 128, axis=0)
        dmin = np.repeat(planes["dmin"].view(np.float16).astype(np.float32), 128, axis=0)
        sc_lo = d * np.repeat(planes["sc_lo"].astype(np.float32), 32, axis=0)
        sc_hi = d * np.repeat(planes["sc_hi"].astype(np.float32), 32, axis=0)
        mn_lo = dmin * np.repeat(planes["mn_lo"].astype(np.float32), 32, axis=0)
        mn_hi = dmin * np.repeat(planes["mn_hi"].astype(np.float32), 32, axis=0)
        w = np.zeros((k, n), np.float32)
        lo_idx, hi_idx = _split_index(k, 64)
        w[lo_idx] = lo * sc_lo - mn_lo
        w[hi_idx] = hi * sc_hi - mn_hi
        return w

    if dtype == DType.Q6_K:
        ql = planes["ql"]
        qh = planes["qh"]  # [K/4, N]: row 32h+l? no: row (64h+j)//? see below
        # qh plane row (32h + l), l∈[0,32): bitpairs for elems 128h + {l,
        # 32+l, 64+l, 96+l}. lo j = 32*(j//32)… lo position p = 64h + j:
        #   j<32 → bitpair0 row 32h+j ; j≥32 → bitpair1 row 32h+j-32
        qh_i = qh.astype(np.int32).reshape(k // 128, 32, n)
        b0 = (qh_i >> 0) & 3
        b1 = (qh_i >> 2) & 3
        b2 = (qh_i >> 4) & 3
        b3 = (qh_i >> 6) & 3
        hb_lo = np.concatenate([b0, b1], axis=1).reshape(k // 2, n)
        hb_hi = np.concatenate([b2, b3], axis=1).reshape(k // 2, n)
        lo = ((ql & 0x0F).astype(np.int32) | (hb_lo << 4)) - 32
        hi = ((ql >> 4).astype(np.int32) | (hb_hi << 4)) - 32
        d = np.repeat(planes["d"].view(np.float16).astype(np.float32), 128, axis=0)
        sc_lo = d * np.repeat(planes["sc_lo"].astype(np.float32), 16, axis=0)
        sc_hi = d * np.repeat(planes["sc_hi"].astype(np.float32), 16, axis=0)
        w = np.zeros((k, n), np.float32)
        lo_idx, hi_idx = _split_index(k, 128)
        w[lo_idx] = lo.astype(np.float32) * sc_lo
        w[hi_idx] = hi.astype(np.float32) * sc_hi
        return w

    raise ValueError(f"no plane dequant for {dtype}")


def _split_index(k: int, unit: int):
    """Element indices covered by the lo/hi planes for a given split unit."""
    idx = np.arange(k).reshape(k // unit, unit)
    return idx[:, : unit // 2].ravel(), idx[:, unit // 2:].ravel()


def _q5k_bits(qh: np.ndarray, k: int, n: int):
    """Q5_K high bits for (lo, hi) plane positions, each [K/2, N] f32."""
    qh_i = qh.astype(np.int32).reshape(k // 256, 32, n)
    lo_bits = [(qh_i >> (2 * c)) & 1 for c in range(4)]
    hi_bits = [(qh_i >> (2 * c + 1)) & 1 for c in range(4)]
    lo = np.concatenate(lo_bits, axis=1).reshape(k // 2, n)
    hi = np.concatenate(hi_bits, axis=1).reshape(k // 2, n)
    return lo.astype(np.float32), hi.astype(np.float32)
