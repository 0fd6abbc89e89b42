"""f16-bits → f32 decode for the scale planes.

GGUF block scales are f16. The planes keep their raw bits; the JAX package
stores them as uint16, which PyTorch barely supports, so the port holds the
same bits as int16 and decodes them by reinterpreting them as float16 (the
CUDA kernels use `__half2float` on the same 16 bits). The decode is exact,
signed zeros and subnormals included. Unlike the JAX version, which builds
the float from integer ops and so turns NaN/Inf patterns into finite values,
NaN and Inf bits decode to NaN and Inf here; valid files carry neither.
"""
from __future__ import annotations

import numpy as np
import torch


def f16_bits_to_f32(u) -> torch.Tensor:
    """Decode f16 bit patterns (int16/uint16/int32 tensor or numpy array) to
    an f32 tensor, exactly."""
    if isinstance(u, np.ndarray):
        u = torch.from_numpy(np.ascontiguousarray(u).astype(np.uint16)
                             .view(np.int16))
    if u.dtype != torch.int16:
        u = (u.to(torch.int32) & 0xFFFF).to(torch.int16)
    return u.view(torch.float16).to(torch.float32)
