"""Quantized dtype tables and GGUF/GGML enum mappings.

TPU-native re-design of the reference's type system
(ref: src/core/types.h:24-215). The packed GGML block layouts are a public,
fixed file format; block sizes and byte layouts here must match the GGUF
spec bit-for-bit (verified by golden-block tests in tests/test_dequant.py).

Unlike the reference (which keeps blocks packed in GPU buffers and
bit-twiddles in CUDA), the TPU build de-interleaves blocks at load time into
planar arrays the VPU can process with wide vector and/shift ops
(see core/layout.py).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class DType(enum.Enum):
    """Weight storage dtypes supported by the engine (ref: types.h:24-35)."""

    F32 = "f32"
    F16 = "f16"
    BF16 = "bf16"
    Q8_0 = "q8_0"
    Q4_0 = "q4_0"
    Q4_K = "q4_k"  # Q4_K_M files mix Q4_K + Q5_K + Q6_K tensors
    Q5_K = "q5_k"
    Q6_K = "q6_k"
    Q2_K = "q2_k"  # layout defined; no kernel yet (matches reference)
    I32 = "i32"
    # Engine-native runtime format (NOT a GGUF storage type): 4-bit affine
    # codes + per-256-group f32 scale/min planes, consumed by the int8-MXU
    # quantized-activation decode kernel (core/w4a8.py). Produced by
    # load-time requant from any source dtype; opt-in via --w4a8.
    W4A8 = "w4a8"
    # Engine-native SERVING format (r5): per-column symmetric int8 weight
    # codes + [1, N] f32 column scales, dotted against per-row int8
    # activations in ONE full-rate int8 MXU dot (any row count — batched
    # decode, verify windows, prefill). Produced by load-time requant;
    # opt-in via --w8a8 (core/w8a8.py).
    W8A8 = "w8a8"


@dataclass(frozen=True)
class BlockInfo:
    """Block geometry: elements per block and packed bytes per block."""

    block_elems: int
    block_bytes: int


# ref: types.h:37-66 (dtype_size / dtype_block_size)
_BLOCK_INFO = {
    DType.F32: BlockInfo(1, 4),
    DType.F16: BlockInfo(1, 2),
    DType.BF16: BlockInfo(1, 2),
    DType.I32: BlockInfo(1, 4),
    DType.Q8_0: BlockInfo(32, 34),   # f16 d + 32 x int8
    DType.Q4_0: BlockInfo(32, 18),   # f16 d + 16 bytes of nibbles
    DType.Q4_K: BlockInfo(256, 144),  # f16 d, f16 dmin, 12B 6-bit scales, 128B nibbles
    DType.Q5_K: BlockInfo(256, 176),  # + 32B high-bit plane
    DType.Q6_K: BlockInfo(256, 210),  # 128B ql + 64B qh + 16B int8 scales + f16 d
    DType.Q2_K: BlockInfo(256, 84),
    # w4a8: per 512 elems, 256 code bytes + 4 f32 plane entries = 4.25 bpw
    DType.W4A8: BlockInfo(512, 272),
    # w8a8: int8 codes; the [1, N] column-scale plane amortizes to ~0
    DType.W8A8: BlockInfo(1, 1),
}


def block_info(dt: DType) -> BlockInfo:
    return _BLOCK_INFO[dt]


def row_nbytes(dt: DType, n_elems: int) -> int:
    """Packed bytes for n_elems elements (must be block-aligned).

    ref: types.h:83-87 (dtype_row_size).
    """
    info = _BLOCK_INFO[dt]
    if n_elems % info.block_elems != 0:
        raise ValueError(f"{n_elems} not a multiple of {dt} block size {info.block_elems}")
    return (n_elems // info.block_elems) * info.block_bytes


def bits_per_weight(dt: DType) -> float:
    info = _BLOCK_INFO[dt]
    return info.block_bytes * 8.0 / info.block_elems


class GGMLType(enum.IntEnum):
    """GGML tensor type ids as stored in GGUF files (ref: types.h:171-200)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30


_GGML_TO_DTYPE = {
    GGMLType.F32: DType.F32,
    GGMLType.F16: DType.F16,
    GGMLType.BF16: DType.BF16,
    GGMLType.Q8_0: DType.Q8_0,
    GGMLType.Q4_0: DType.Q4_0,
    GGMLType.Q4_K: DType.Q4_K,
    GGMLType.Q5_K: DType.Q5_K,
    GGMLType.Q6_K: DType.Q6_K,
    GGMLType.Q2_K: DType.Q2_K,
    GGMLType.I32: DType.I32,
}

_DTYPE_TO_GGML = {v: k for k, v in _GGML_TO_DTYPE.items()}


def ggml_to_dtype(t: int) -> DType:
    """Map a GGML type id to an engine DType (ref: types.h:202-215)."""
    try:
        return _GGML_TO_DTYPE[GGMLType(t)]
    except (ValueError, KeyError):
        raise ValueError(f"unsupported GGML tensor type {t}") from None


def dtype_to_ggml(dt: DType) -> GGMLType:
    return _DTYPE_TO_GGML[dt]


# GGUF container constants (ref: types.h:151-168)
GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12
