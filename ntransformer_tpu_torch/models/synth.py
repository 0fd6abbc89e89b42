"""Synthetic in-memory model builder (constant weights, valid Q8_0 layout).

Port of ntransformer_tpu/models/synth.py: full-size models built directly
as planes on the device — no multi-GB GGUF on disk. qs planes are zeros and
scale planes the same small f16 constant as the JAX package (~2^-8), so a
caller that wants non-trivial logits fills qs itself (chip_smoke.py does,
from a seeded generator). Layer planes are allocated pre-stacked
([L, rows, n]).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import DType
from ..core.layout import LAYOUTS
from ..ops.dequant_torch import not_ported
from ..ops.layers import rope_table
from ..ops.linear import QLinear
from .config import ModelConfig
from .llama import Arch, LayerWeights, ModelWeights, fuse_layer_weights
from .loader import resolve_device
from .presets import PRESETS

_F16_SMALL = int(np.float32(0.004).astype(np.float16).view(np.int16))


def synth_qlinear(n: int, k: int, dtype: DType, lead: int | None = None,
                  device="cuda") -> QLinear:
    """Planes for one matrix ([rows, n]) or a stacked set ([lead, rows, n]),
    created on `device`."""
    if dtype != DType.Q8_0:
        raise not_ported(dtype, "synthetic ")
    planes = {}
    for spec in LAYOUTS[dtype]:
        rows = k // spec.rows_div
        shape = (rows, n) if lead is None else (lead, rows, n)
        if spec.np_dtype == "uint16":
            planes[spec.name] = torch.full(shape, _F16_SMALL,
                                           dtype=torch.int16, device=device)
        else:
            planes[spec.name] = torch.zeros(shape, dtype=torch.int8,
                                            device=device)
    return QLinear(dtype, k, n, planes)


def synth_model(preset: str, dtype: str, max_seq_len: int = 4096,
                fuse: bool = False, device="cuda"):
    """(config, arch, weights) for a preset, built on `device` (the card by
    default; raises without CUDA unless device="cpu")."""
    dev = resolve_device(device)
    p = PRESETS[preset]
    head_dim = p["hidden"] // p["heads"]
    kv_dim = p["kv_heads"] * head_dim
    cfg = ModelConfig(
        model_name=f"synth-{preset}-{dtype}",
        vocab_size=p["vocab"], hidden_size=p["hidden"],
        intermediate_size=p["inter"], n_layers=p["layers"],
        n_heads=p["heads"], n_kv_heads=p["kv_heads"], head_dim=head_dim,
        rope_theta=p["rope_theta"],
        max_seq_len=min(p["ctx"], max_seq_len),
    )
    arch = Arch.from_config(cfg)
    dt = DType(dtype)
    h, it, v, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.n_layers)

    def mat(n, k, lead=L):
        return synth_qlinear(n, k, dt, lead, dev)

    stacked = LayerWeights(
        attn_norm=torch.ones(L, h, device=dev),
        wq=mat(h, h), wk=mat(kv_dim, h), wv=mat(kv_dim, h), wo=mat(h, h),
        ffn_norm=torch.ones(L, h, device=dev),
        w_gate=mat(it, h), w_up=mat(it, h), w_down=mat(h, it),
    )
    if fuse:
        stacked = fuse_layer_weights(stacked)
    cos, sin = rope_table(cfg.max_seq_len, head_dim, cfg.rope_theta,
                          device=dev)
    weights = ModelWeights(embed=mat(v, h, None), layers=stacked,
                           output_norm=torch.ones(h, device=dev),
                           lm_head=mat(v, h, None), rope_cos=cos,
                           rope_sin=sin)
    return cfg, arch, weights


def model_nbytes(weights: ModelWeights) -> int:
    """Bytes of every tensor of the weights (a tied head counted once)."""
    seen, total = set(), 0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()

    for part in (weights.embed, weights.lm_head):
        for t in part.planes.values():
            add(t)
    for f in weights.layers.__dataclass_fields__:
        v = getattr(weights.layers, f)
        for t in (v.planes.values() if isinstance(v, QLinear) else [v]):
            add(t)
    for t in (weights.output_norm, weights.rope_cos, weights.rope_sin):
        add(t)
    return total
