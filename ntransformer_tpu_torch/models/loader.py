"""GGUF → device weights loader (PyTorch).

Port of ntransformer_tpu/models/loader.py, resident path: parse the GGUF,
build the config from its metadata, re-layout every matrix into the
transposed planes of core/layout.py on the host (numpy), and place the
stacked planes on `device` as torch tensors. Tied embeddings fall back to
token_embd for the LM head.

The port computes the GGUF formats Q8_0, Q4_0, Q4_K, Q5_K and Q6_K (so
Q4_K_M files, which mix Q4_K, Q5_K and Q6_K, load) and float matrices; a
file with another quantized matrix is refused here, at load, with the
ROADMAP item that ports its kernel, rather than run through a plain dequant
on the card.

No lane padding of K-quant LM heads. The JAX package pads a K-quant head's
N to a multiple of 2048 (and slices the logits back) because its Pallas
tile of 256 lanes left 501 grid steps on the 128256-token vocab, a Mosaic
reason. The CUDA kernels take any N (a ragged last column strip is masked),
so the head keeps its file width here; `head_logits` still slices a padded
head, so padded planes give the same logits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.dequant import dequantize
from ..core.dtypes import DType
from ..core.gguf import GGUFReader
from ..core.layout import LAYOUTS, relayout
from ..inference.tokenizer import Tokenizer
from ..ops.dequant_torch import not_ported
from ..ops.layers import rope_table
from ..ops.linear import QLinear
from .config import ModelConfig
from .llama import Arch, LayerWeights, ModelWeights, fuse_layer_weights, \
    stack_layers

PORTED_QUANT = (DType.Q8_0, DType.Q4_0, DType.Q4_K, DType.Q5_K,
                DType.Q6_K)


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU;
    asking for CUDA on a machine without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "GPU by default; pass device='cpu' to run its "
                           "plain PyTorch path on the CPU")
    return dev


def load_qlinear_host(reader: GGUFReader, name: str) -> QLinear:
    """One weight matrix as host planes (numpy): the planes of a ported
    quantized format, or an f32 [K, N] 'w' plane for float matrices (bf16
    once placed)."""
    info = reader.info(name)
    n, k = info.shape  # file rows = out_features
    raw = reader.raw_bytes(name)
    if info.dtype not in LAYOUTS:
        w = dequantize(raw, info.dtype, n, k)  # [N, K] f32
        return QLinear(DType.BF16, k, n, {"w": np.ascontiguousarray(w.T)})
    if info.dtype not in PORTED_QUANT:
        raise not_ported(info.dtype, f"{name}: ")
    return QLinear(info.dtype, k, n, relayout(raw, info.dtype, n, k))


def plane_to_torch(a: np.ndarray, name: str, device) -> torch.Tensor:
    """One host plane as a tensor: f16-bit planes (uint16) keep their bits
    as int16, float 'w' planes become bf16."""
    if a.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    if name == "w":
        t = t.to(torch.bfloat16)
    return t.to(device)


def qlinear_to_device(ql: QLinear, device) -> QLinear:
    return QLinear(ql.dtype, ql.k, ql.n,
                   {nm: plane_to_torch(v, nm, device)
                    for nm, v in ql.planes.items()})


def load_norm(reader: GGUFReader, name: str) -> np.ndarray:
    info = reader.info(name)
    n_elems = int(np.prod(info.shape))
    return dequantize(reader.raw_bytes(name), info.dtype, 1,
                      n_elems).reshape(-1)


def rope_freq_factors(reader: GGUFReader) -> np.ndarray | None:
    """Per-frequency rope divisors (`rope_freqs.weight`, Llama-3.1 style)
    when the file carries them."""
    if "rope_freqs.weight" not in reader:
        return None
    info = reader.info("rope_freqs.weight")
    n = int(np.prod(info.shape))
    return dequantize(reader.raw_bytes("rope_freqs.weight"),
                      info.dtype, 1, n).reshape(-1)


def load_layer_host(reader: GGUFReader, i: int) -> LayerWeights:
    """One layer's weights on the host (numpy planes and vectors)."""
    pre = f"blk.{i}."
    if pre + "ffn_gate_inp.weight" in reader:
        raise NotImplementedError(
            "mixture-of-experts models are not ported yet (ROADMAP queue 1 "
            "item 4: moe_ffn)")

    def opt(name):
        full = pre + name
        return load_norm(reader, full) if full in reader else None

    return LayerWeights(
        attn_norm=load_norm(reader, pre + "attn_norm.weight"),
        wq=load_qlinear_host(reader, pre + "attn_q.weight"),
        wk=load_qlinear_host(reader, pre + "attn_k.weight"),
        wv=load_qlinear_host(reader, pre + "attn_v.weight"),
        wo=load_qlinear_host(reader, pre + "attn_output.weight"),
        ffn_norm=load_norm(reader, pre + "ffn_norm.weight"),
        w_gate=load_qlinear_host(reader, pre + "ffn_gate.weight"),
        w_up=load_qlinear_host(reader, pre + "ffn_up.weight"),
        w_down=load_qlinear_host(reader, pre + "ffn_down.weight"),
        bq=opt("attn_q.bias"), bk=opt("attn_k.bias"), bv=opt("attn_v.bias"),
        attn_post_norm=opt("post_attention_norm.weight"),
        ffn_post_norm=opt("post_ffw_norm.weight"),
        q_norm=opt("attn_q_norm.weight"), k_norm=opt("attn_k_norm.weight"),
    )


def layer_to_device(lw: LayerWeights, device) -> LayerWeights:
    def put(v):
        if v is None:
            return None
        if isinstance(v, QLinear):
            return qlinear_to_device(v, device)
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return LayerWeights(**{f: put(getattr(lw, f))
                           for f in lw.__dataclass_fields__})


@dataclass
class LoadedModel:
    config: ModelConfig
    arch: Arch
    weights: ModelWeights
    tokenizer: Tokenizer | None
    reader: GGUFReader | None
    device: torch.device


def load_model(path: str, *, max_seq_len: int | None = None,
               fuse: bool = False, device="cuda") -> LoadedModel:
    """Load a GGUF model fully resident on `device` (the card by default;
    raises without CUDA unless device="cpu"). fuse=True builds the fused
    wqkv / w_gate_up matrices of the single-device resident path."""
    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata, max_seq_len)
    arch = Arch.from_config(cfg)

    embed = qlinear_to_device(load_qlinear_host(reader, "token_embd.weight"),
                              dev)
    stacked = stack_layers([layer_to_device(load_layer_host(reader, i), dev)
                            for i in range(cfg.n_layers)])
    if fuse:
        stacked = fuse_layer_weights(stacked)
    output_norm = torch.from_numpy(
        load_norm(reader, "output_norm.weight")).to(dev)
    if "output.weight" in reader:
        lm_head = qlinear_to_device(load_qlinear_host(reader, "output.weight"),
                                    dev)
    else:
        lm_head = embed  # tied embeddings
    cos, sin = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                          rope_freq_factors(reader), device=dev)
    if cfg.rope_local_theta:
        # gemma3: the local layers rotate with their own base
        lcos, lsin = rope_table(cfg.max_seq_len, cfg.head_dim,
                                cfg.rope_local_theta, device=dev)
        cos, sin = torch.stack([cos, lcos]), torch.stack([sin, lsin])
    weights = ModelWeights(embed=embed, layers=stacked,
                           output_norm=output_norm, lm_head=lm_head,
                           rope_cos=cos, rope_sin=sin)
    return LoadedModel(cfg, arch, weights,
                       Tokenizer.from_gguf_metadata(reader.metadata), reader,
                       dev)
