"""W8A8: the engine-native int8 serving format (numpy).

The port's own copy of ntransformer_tpu/core/w8a8.py, numpy only: the
load-time requant of host planes and the golden semantics of the serving
matmul. The torch twins (on-card requant of synthetic planes, the runtime
row quantization) are in ops/dequant_torch.py; the kernel is
csrc/w8a8_matmul.cu (ops/cuda/w8a8.py).

Weights are requantized once at load to per-column symmetric int8 codes,
activations quantized per row to int8 at run time, and every product is
one int8 dot with a rank-1 fixup outside the contraction:
  y[t, n] = (a_i8[t, :] . q[:, n]) * (amax[t]/127) * s[n]
This changes numerics against the source dtype; it is opt-in (--w8a8).

Format:
  q  int8 [K, N]   w = q * s  (symmetric, q in [-127, 127])
  s  f32  [1, N]   per-column scale = absmax(col)/127
"""
from __future__ import annotations

import numpy as np


def requant_w8a8(w_t: np.ndarray) -> dict:
    """[K, N] f32 dequantized W^T -> w8a8 planes dict."""
    w = w_t.astype(np.float32)
    s = np.max(np.abs(w), axis=0, keepdims=True) / 127.0  # [1, N]
    s = np.where(s > 0, s, np.ones_like(s))
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return {"q": q, "s": s.astype(np.float32)}


def dequant_w8a8(planes: dict, k: int, n: int) -> np.ndarray:
    """Planes -> W^T [K, N] f32."""
    return planes["q"].astype(np.float32) * planes["s"].astype(np.float32)


def quantize_rows(x: np.ndarray):
    """Per-row symmetric int8 activation quant: (codes int8 [T, K],
    scale f32 [T, 1]) with x ~= codes * scale. A zero row keeps scale 1."""
    am = np.max(np.abs(x), axis=-1, keepdims=True) / 127.0  # [T, 1]
    am = np.where(am > 0, am, np.ones_like(am))
    codes = np.clip(np.round(x / am), -127, 127).astype(np.int8)
    return codes, am.astype(np.float32)


def w8a8_matmul_golden(x: np.ndarray, planes: dict, k: int,
                       n: int) -> np.ndarray:
    """Reference semantics of the kernel: quantize rows, exact int32 dot,
    then the fixup in the order (p * am) * s."""
    a, am = quantize_rows(x.astype(np.float32))
    p = (a.astype(np.int32) @ planes["q"].astype(np.int32)).astype(np.float32)
    return p * am * planes["s"].astype(np.float32)
