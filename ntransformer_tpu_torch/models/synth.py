"""Synthetic in-memory model builder (constant weights, valid GGUF layouts).

Port of ntransformer_tpu/models/synth.py: full-size models built directly
as planes on the device — no multi-GB GGUF on disk. The planes are filled
as the JAX package fills them: code planes (qs, ql, qh, q) zero, f16 scale
planes (d, dmin) the same small constant (~2^-8), 6-bit scale and min
planes (sc_*, mn_*) 8, the f32 planes of W4A8 and W8A8 (s_*, m_*, s) 0.004;
a caller that wants non-trivial logits fills the codes itself
(chip_smoke.py does, from a seeded generator). dtype "q4_k_m"
takes the per-tensor policy of `presets.q4_k_m_policy` (ffn_down and the
head Q6_K, the rest Q4_K). A K-quant LM head is not lane-padded (see
models/loader.py). Layer planes are allocated pre-stacked ([L, rows, n]).

The shape is a preset name or a dict with the presets' keys, which may add
`experts` and `experts_used` (a mixture-of-experts model, mixtral-shaped:
`inter` is then the per-expert width) and `norm_eps`. Expert matrices are
stacked [L, E, rows, n] and take the same policy by their llama.cpp names
(ffn_down_exps Q6_K, gate/up Q4_K under q4_k_m); the router ffn_gate_inp
is a float [H, E] matrix (llama.cpp keeps it f32), bf16 on the device.
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
from .loader import PORTED_QUANT, resolve_device
from .presets import PRESETS, q4_k_m_policy

_F16_SMALL = int(np.float32(0.004).astype(np.float16).view(np.int16))


def synth_qlinear(n: int, k: int, dtype: DType, lead: int | None = None,
                  device="cuda") -> QLinear:
    """Planes for one matrix ([rows, n]) or a stacked set ([lead, rows, n]),
    created on `device`."""
    if dtype not in PORTED_QUANT:
        raise not_ported(dtype, "synthetic ")
    planes = {}
    for spec in LAYOUTS[dtype]:
        # rows_div 0: a fixed one-row plane (W8A8's column scales)
        rows = 1 if spec.rows_div == 0 else k // spec.rows_div
        shape = (rows, n) if lead is None else (lead, rows, n)
        if spec.np_dtype == "uint16":
            planes[spec.name] = torch.full(shape, _F16_SMALL,
                                           dtype=torch.int16, device=device)
        elif spec.np_dtype == "float32":
            planes[spec.name] = torch.full(shape, 0.004, dtype=torch.float32,
                                           device=device)
        else:
            fill = 8 if spec.name.startswith(("sc", "mn")) else 0
            planes[spec.name] = torch.full(shape, fill,
                                           dtype=getattr(torch, spec.np_dtype),
                                           device=device)
    return QLinear(dtype, k, n, planes)


def synth_model(preset: str | dict, dtype: str, max_seq_len: int = 4096,
                fuse: bool = False, device="cuda"):
    """(config, arch, weights) for a preset name or shape dict (see the
    module docstring), built on `device` (the card by default; raises
    without CUDA unless device="cpu")."""
    dev = resolve_device(device)
    p = PRESETS[preset] if isinstance(preset, str) else preset
    name = preset if isinstance(preset, str) else p.get("name", "custom")
    head_dim = p["hidden"] // p["heads"]
    kv_dim = p["kv_heads"] * head_dim
    n_exp = p.get("experts", 0)
    cfg = ModelConfig(
        model_name=f"synth-{name}-{dtype}",
        vocab_size=p["vocab"], hidden_size=p["hidden"],
        intermediate_size=p["inter"], n_layers=p["layers"],
        n_heads=p["heads"], n_kv_heads=p["kv_heads"], head_dim=head_dim,
        rope_theta=p["rope_theta"], norm_eps=p.get("norm_eps", 1e-5),
        max_seq_len=min(p["ctx"], max_seq_len),
        n_experts=n_exp,
        n_experts_used=p.get("experts_used", 2) if n_exp else 0,
        moe_inter=p["inter"] if n_exp else 0,
    )
    arch = Arch.from_config(cfg)
    if dtype == "q4_k_m":
        policy = q4_k_m_policy
    else:
        fixed = DType(dtype)

        def policy(_name, _dt=fixed):
            return _dt
    h, it, v, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.n_layers)

    def mat(name, n, k, lead=L):
        return synth_qlinear(n, k, policy(name), lead, dev)

    def experts(name, n, k):
        ql = synth_qlinear(n, k, policy(name), L * n_exp, dev)
        return QLinear(ql.dtype, k, n,
                       {nm: a.reshape((L, n_exp) + tuple(a.shape[1:]))
                        for nm, a in ql.planes.items()})

    ffn = (dict(ffn_gate_inp=QLinear(DType.BF16, h, n_exp, {
                    "w": torch.full((L, h, n_exp), 0.004,
                                    dtype=torch.bfloat16, device=dev)}),
                w_gate_exps=experts("ffn_gate_exps", it, h),
                w_up_exps=experts("ffn_up_exps", it, h),
                w_down_exps=experts("ffn_down_exps", h, it),
                w_gate=None, w_up=None, w_down=None)
           if n_exp else
           dict(w_gate=mat("ffn_gate", it, h), w_up=mat("ffn_up", it, h),
                w_down=mat("ffn_down", h, it)))
    stacked = LayerWeights(
        attn_norm=torch.ones(L, h, device=dev),
        wq=mat("attn_q", h, h), wk=mat("attn_k", kv_dim, h),
        wv=mat("attn_v", kv_dim, h), wo=mat("attn_output", h, h),
        ffn_norm=torch.ones(L, h, device=dev), **ffn)
    if fuse:
        stacked = fuse_layer_weights(stacked)
    cos, sin = rope_table(cfg.max_seq_len, head_dim, cfg.rope_theta,
                          device=dev)
    weights = ModelWeights(embed=mat("token_embd", v, h, None),
                           layers=stacked,
                           output_norm=torch.ones(h, device=dev),
                           lm_head=mat("output.", v, h, None), rope_cos=cos,
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
