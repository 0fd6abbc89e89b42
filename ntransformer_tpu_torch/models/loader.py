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
on the card. `w4a8=True` / `w8a8=True` requantize every eligible matrix to
an engine-native format on the host before placement, with the JAX
package's eligibility and tied-head rules.

No lane padding of K-quant LM heads. The JAX package pads a K-quant head's
N to a multiple of 2048 (and slices the logits back) because its Pallas
tile of 256 lanes left 501 grid steps on the 128256-token vocab, a Mosaic
reason. The CUDA kernels take any N (a ragged last column strip is masked),
so the head keeps its file width here; `head_logits` still slices a padded
head, so padded planes give the same logits.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.dequant import dequantize
from ..core.dtypes import DType
from ..core.gguf import GGUFReader
from ..core.layout import LAYOUTS, relayout
from ..inference.tokenizer import Tokenizer
from ..ops.dequant_torch import not_ported
from ..ops.layers import rope_table
from ..ops.linear import QLinear, convert_qlinear_w4a8, convert_qlinear_w8a8
from .config import ModelConfig
from .llama import Arch, LayerWeights, ModelWeights, fuse_layer_weights, \
    stack_layers

PORTED_QUANT = (DType.Q8_0, DType.Q4_0, DType.Q4_K, DType.Q5_K,
                DType.Q6_K, DType.W4A8, DType.W8A8)


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU;
    asking for CUDA on a machine without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "GPU by default; pass device='cpu' to run its "
                           "plain PyTorch path on the CPU")
    return dev


def load_qlinear_host(reader: GGUFReader, name: str,
                      compute: str = "quant") -> QLinear:
    """One weight matrix as host planes (numpy): the planes of a ported
    quantized format, or an f32 [K, N] 'w' plane for float matrices (bf16
    once placed). compute="bf16" dequantizes every matrix to such a
    plane."""
    info = reader.info(name)
    n, k = info.shape  # file rows = out_features
    raw = reader.raw_bytes(name)
    if compute == "bf16" or info.dtype not in LAYOUTS:
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


def load_qlinear_experts(reader: GGUFReader, name: str,
                         compute: str = "quant") -> QLinear:
    """A stacked expert matrix ([E, N, K] in the file: llama.cpp's
    ffn_*_exps) as host planes with a leading expert axis [E, rows, N]:
    each expert relayouts as a 2-D matrix does, and moe_ffn indexes the
    flattened axis."""
    info = reader.info(name)
    e, n, k = info.shape
    raw = np.frombuffer(reader.raw_bytes(name), np.uint8)
    per = raw.size // e
    if compute == "bf16" or info.dtype not in LAYOUTS:
        w = np.stack([np.ascontiguousarray(
            dequantize(raw[i * per:(i + 1) * per], info.dtype, n, k).T)
            for i in range(e)])
        return QLinear(DType.BF16, k, n, {"w": w})
    if info.dtype not in PORTED_QUANT:
        raise not_ported(info.dtype, f"{name}: ")
    parts = [relayout(raw[i * per:(i + 1) * per], info.dtype, n, k)
             for i in range(e)]
    return QLinear(info.dtype, k, n,
                   {nm: np.stack([p[nm] for p in parts]) for nm in parts[0]})


def load_layer_host(reader: GGUFReader, i: int,
                    compute: str = "quant") -> LayerWeights:
    """One layer's weights on the host (numpy planes and vectors). A
    mixture-of-experts layer carries its f32 router (a float matrix, bf16
    once placed) and the stacked expert matrices, and no dense FFN.
    compute: as load_qlinear_host."""
    pre = f"blk.{i}."
    moe = pre + "ffn_gate_inp.weight" in reader

    def opt(name):
        full = pre + name
        return load_norm(reader, full) if full in reader else None

    def mat(name):
        return load_qlinear_host(reader, pre + name, compute)

    def dense(name):
        return mat(name) if pre + name in reader else None

    def experts(name):
        return (load_qlinear_experts(reader, pre + name, compute) if moe
                else None)

    return LayerWeights(
        attn_norm=load_norm(reader, pre + "attn_norm.weight"),
        wq=mat("attn_q.weight"), wk=mat("attn_k.weight"),
        wv=mat("attn_v.weight"), wo=mat("attn_output.weight"),
        ffn_norm=load_norm(reader, pre + "ffn_norm.weight"),
        w_gate=dense("ffn_gate.weight"),
        w_up=dense("ffn_up.weight"),
        w_down=dense("ffn_down.weight"),
        bq=opt("attn_q.bias"), bk=opt("attn_k.bias"), bv=opt("attn_v.bias"),
        attn_post_norm=opt("post_attention_norm.weight"),
        ffn_post_norm=opt("post_ffw_norm.weight"),
        q_norm=opt("attn_q_norm.weight"), k_norm=opt("attn_k_norm.weight"),
        ffn_gate_inp=dense("ffn_gate_inp.weight"),
        w_gate_exps=experts("ffn_gate_exps.weight"),
        w_up_exps=experts("ffn_up_exps.weight"),
        w_down_exps=experts("ffn_down_exps.weight"),
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


def _w4a8_eligible(ql: QLinear) -> bool:
    return ql.k % 512 == 0 and ql.n % 128 == 0


def _w8a8_eligible(ql: QLinear) -> bool:
    return ql.n % 128 == 0


# format -> (eligible, convert)
_ENGINE_FORMATS = {
    DType.W4A8: (_w4a8_eligible, convert_qlinear_w4a8),
    DType.W8A8: (_w8a8_eligible, convert_qlinear_w8a8),
}


def _convert_layer(lw: LayerWeights, target: DType) -> LayerWeights:
    eligible, convert = _ENGINE_FORMATS[target]

    def conv(v):
        if v.dtype == target or not eligible(v):
            return v
        return convert(v)

    return replace(lw, **{
        f: conv(getattr(lw, f)) for f in lw.__dataclass_fields__
        if isinstance(getattr(lw, f), QLinear)})


def _convert_weights(weights: ModelWeights, target: DType) -> ModelWeights:
    eligible, convert = _ENGINE_FORMATS[target]
    lm_head = weights.lm_head
    if lm_head.dtype != target and eligible(lm_head):
        lm_head = convert(lm_head)
    return replace(weights, layers=_convert_layer(weights.layers, target),
                   lm_head=lm_head)


def convert_layer_w4a8(lw: LayerWeights) -> LayerWeights:
    """Requantize every eligible matrix of one layer to W4A8 (K % 512 and
    N % 128; changes numerics). A matrix whose shape does not fit keeps its
    source format: qmatmul dispatches per QLinear."""
    return _convert_layer(lw, DType.W4A8)


def convert_layer_w8a8(lw: LayerWeights) -> LayerWeights:
    """Requantize every eligible matrix of one layer to W8A8 (N % 128;
    changes numerics), as convert_layer_w4a8."""
    return _convert_layer(lw, DType.W8A8)


def convert_weights_w4a8(weights: ModelWeights) -> ModelWeights:
    """W4A8-convert a built ModelWeights (the synthetic path; the GGUF load
    converts each layer on the host before placement). The embedding table
    keeps its format (a gather, not a product); a tied head gets its own
    converted copy."""
    return _convert_weights(weights, DType.W4A8)


def convert_weights_w8a8(weights: ModelWeights) -> ModelWeights:
    """W8A8-convert a built ModelWeights, as convert_weights_w4a8."""
    return _convert_weights(weights, DType.W8A8)


@dataclass
class LoadedModel:
    config: ModelConfig
    arch: Arch
    weights: ModelWeights
    tokenizer: Tokenizer | None
    reader: GGUFReader | None
    device: torch.device


def load_model(path: str, *, max_seq_len: int | None = None,
               compute: str = "quant", n_layers: int | None = None,
               with_tokenizer: bool = True, fuse: bool = False,
               device="cuda", w4a8: bool = False,
               w8a8: bool = False) -> LoadedModel:
    """Load a GGUF model fully resident on `device` (the card by default;
    raises without CUDA unless device="cpu"). compute="quant" keeps the
    quantized planes (the kernels dequantize on the fly); "bf16"
    dequantizes every matrix at load to a bf16 float matrix (a plain
    product, the quality tools' reference compute). n_layers limits the
    stack. fuse=True builds the fused wqkv / w_gate_up matrices of the
    single-device resident path. w4a8=True / w8a8=True (mutually exclusive)
    requantize every eligible matrix to that engine-native format on the
    host before placement; the gather table keeps its format, a tied head
    gets a converted copy. Changes numerics."""
    if w4a8 and w8a8:
        raise ValueError("w4a8 and w8a8 are mutually exclusive")
    if compute not in ("quant", "bf16"):
        raise ValueError(f"compute must be 'quant' or 'bf16', got "
                         f"{compute!r}")
    target = DType.W4A8 if w4a8 else DType.W8A8 if w8a8 else None
    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = ModelConfig.from_gguf_metadata(reader.metadata, max_seq_len)
    if n_layers is not None:
        cfg.n_layers = n_layers
    arch = Arch.from_config(cfg)

    def host_layer(i):
        lw = load_layer_host(reader, i, compute)
        return lw if target is None else _convert_layer(lw, target)

    embed_host = load_qlinear_host(reader, "token_embd.weight", compute)
    embed = qlinear_to_device(embed_host, dev)
    stacked = stack_layers([layer_to_device(host_layer(i), dev)
                            for i in range(cfg.n_layers)])
    if fuse:
        stacked = fuse_layer_weights(stacked)
    output_norm = torch.from_numpy(
        load_norm(reader, "output_norm.weight")).to(dev)
    tied = "output.weight" not in reader
    head_host = (embed_host if tied
                 else load_qlinear_host(reader, "output.weight", compute))
    if target is not None and _ENGINE_FORMATS[target][0](head_host):
        lm_head = qlinear_to_device(_ENGINE_FORMATS[target][1](head_host),
                                    dev)
    elif tied:
        lm_head = embed  # tied embeddings
    else:
        lm_head = qlinear_to_device(head_host, dev)
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
    tok = (Tokenizer.from_gguf_metadata(reader.metadata) if with_tokenizer
           else None)
    return LoadedModel(cfg, arch, weights, tok, reader, dev)
