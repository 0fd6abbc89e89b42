"""The device-side select of the T = 1 matmul kernels: one matrix of a
stacked [M, rows, N] plane set picked by an index that stays on the card.

Replaces the scalar prefetch of the TPU kernels (ntransformer_tpu/ops/
pallas/matmul.py, w8a8.py and w4a8.py take the layer or expert index as a
prefetched scalar). A routed expert's index is the router's top-k output:
reading it to the host would synchronize once a layer, so the skinny
kernels of csrc/q8_0_matmul.cu, csrc/kquant_matmul.cu, csrc/w8a8_matmul.cu
and csrc/w4a8_decode.cu take a device pointer to an int32 and each block
offsets its plane pointers by the index times the planes' strides in bytes
(`strides`) before its first copy. The plain twins take the same tensor
through `index_select` (`select_plain`): no `.item()`, no host read.
"""
from __future__ import annotations

import torch

MAX_ROWS = 8  # the select runs the skinny kernel's first token width


def select_plain(planes: dict, sel: torch.Tensor) -> dict:
    """The planes of matrix sel[0] (a copy, gathered on the planes' device
    without reading the index to the host)."""
    idx = sel.reshape(1).to(device=next(iter(planes.values())).device)
    return {nm: a.index_select(0, idx)[0] for nm, a in planes.items()}


def check(x: torch.Tensor, sel: torch.Tensor, planes: dict,
          what: str) -> None:
    """ValueError unless sel is one int32 on x's card, x has at most
    MAX_ROWS rows and the planes are contiguous stacks [M, rows, N] of one
    M (the wrappers' check_shapes hold the rest)."""
    if sel.dtype != torch.int32 or sel.numel() != 1:
        raise ValueError(f"{what}: sel must be one int32 index; got "
                         f"{sel.dtype} of shape {tuple(sel.shape)}")
    if sel.device != x.device:
        raise ValueError(f"{what}: sel on {sel.device}, x on {x.device}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"{what}: the select takes at most {MAX_ROWS} "
                         f"rows (the skinny kernel's T <= 8 width); got "
                         f"{x.shape[0]}")
    if len({a.shape[0] for a in planes.values()}) != 1 or not all(
            a.is_contiguous() for a in planes.values()):
        raise ValueError(f"{what}: planes "
                         f"{[tuple(a.shape) for a in planes.values()]} are "
                         "not contiguous [M, rows, N] stacks of one M")


def strides(planes: dict, names) -> list[int]:
    """Bytes from one matrix to the next of each named plane (0 for a name
    the planes lack)."""
    return [planes[nm].stride(0) * planes[nm].element_size()
            if nm in planes else 0 for nm in names]
