"""Model configuration parsed from GGUF metadata (ref: src/model/config.h/.cpp).

The engine has no hardcoded model zoo: like the reference, the architecture
(Llama family: RMSNorm + RoPE + GQA + SwiGLU) is parameterized entirely by
the GGUF file's metadata keys (config.cpp:18-50).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    architecture: str = "llama"
    model_name: str = "unknown"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    head_dim: int = 128
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # True = ADJACENT pairs (2i, 2i+1) — ggml ROPE_TYPE_NORM, the order
    # llama.cpp's converter PERMUTES llama q/k rows into. False =
    # HALF-SPLIT pairs (i, i+D/2) — HF rotate_half / ggml NEOX, used by
    # unpermuted arches (qwen2, gpt-neox) and this repo's own writers.
    # See from_gguf_metadata for the per-arch default and the
    # ntransformer.rope_style override. NOTE: the reference applies
    # half-split to EVERY file (rotary.cu:25-60; config.h:36 default is
    # never overridden), which mismatches llama.cpp-converted llama
    # GGUFs — a real-weights correctness defect this repo fixes.
    rope_interleaved: bool = False
    max_seq_len: int = 4096
    bos_token_id: int = 1
    eos_token_id: int = 2
    # family switches (see models/llama.py Arch): gemma gates with
    # gelu-tanh, norms scale by (1 + w), embeddings scale by sqrt(hidden)
    act: str = "silu"
    norm_bias: float = 0.0
    embed_scale: float = 1.0
    # gemma2-family switches. post_norms: every block additionally
    # RMSNorms its attention and FFN outputs before the residual add.
    # attn_softcap/final_softcap: cap*tanh(x/cap) on attention scores /
    # final logits (0 = off). swa_pattern n: layers with l % n < n-1 use
    # sliding-window attention of `sliding_window` keys (gemma2: n=2,
    # even layers local / odd global). query_scale 0 = default
    # 1/sqrt(head_dim) (gemma2-27b overrides to 1/sqrt(hidden/n_heads)).
    post_norms: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0
    swa_pattern: int = 0
    query_scale: float = 0.0
    # qwen3/gemma3: per-head RMSNorm on q/k before RoPE; gemma3's SWA
    # layers additionally rotate with their own rope base (local theta)
    qk_norm: bool = False
    rope_local_theta: float = 0.0
    # mixture-of-experts (mixtral: llama arch + expert_count; qwen3moe):
    # n_experts total, n_experts_used routed per token (softmax over all
    # router logits, top-k, renormalize — mixtral's softmax-after-top-k
    # is mathematically identical), per-expert FFN width moe_inter
    n_experts: int = 0
    n_experts_used: int = 0
    moe_inter: int = 0
    metadata: dict = field(default_factory=dict)

    @property
    def group_size(self) -> int:
        """Query heads per KV head (GQA group), ref config.h:49."""
        return self.n_heads // self.n_kv_heads

    @property
    def is_gqa(self) -> bool:
        return self.n_kv_heads < self.n_heads

    @classmethod
    def from_gguf_metadata(cls, md: dict, max_seq_len: int | None = None) -> "ModelConfig":
        arch = str(md.get("general.architecture", "llama"))
        p = arch + "."

        def get(key, default):
            v = md.get(key, default)
            return type(default)(v) if v is not None else default

        cfg = cls(
            architecture=arch,
            model_name=str(md.get("general.name", "unknown")),
            vocab_size=get(p + "vocab_size", 0),
            hidden_size=get(p + "embedding_length", 4096),
            intermediate_size=get(p + "feed_forward_length", 11008),
            n_layers=get(p + "block_count", 32),
            n_heads=get(p + "attention.head_count", 32),
            norm_eps=get(p + "attention.layer_norm_rms_epsilon", 1e-5),
            rope_theta=get(p + "rope.freq_base", 10000.0),
            max_seq_len=get(p + "context_length", 4096),
            bos_token_id=get("tokenizer.ggml.bos_token_id", 1),
            eos_token_id=get("tokenizer.ggml.eos_token_id", 2),
            metadata=md,
        )
        cfg.n_kv_heads = get(p + "attention.head_count_kv", cfg.n_heads)
        cfg.head_dim = get(p + "attention.key_length",
                           cfg.hidden_size // cfg.n_heads)
        # RoPE pairing. Explicit key wins (this repo's writers stamp
        # "half" — they emit q/k rows unpermuted in HF order); otherwise
        # the llama.cpp-ecosystem default per architecture: the llama
        # converter permutes q/k into ADJACENT-pair order (ggml NORM),
        # qwen2/neox-family files stay HALF-SPLIT (ggml NEOX).
        if arch == "gemma":
            # gemma-1 family deltas (llama.cpp build_gemma graph): gelu
            # gating, RMSNorm weight offset +1, sqrt(hidden) embed scale,
            # tied LM head (no output.weight in the file — the loader's
            # tied fallback covers it)
            cfg.act = "gelu_tanh"
            cfg.norm_bias = 1.0
            cfg.embed_scale = float(cfg.hidden_size) ** 0.5
        elif arch == "gemma2":
            # gemma-2 deltas on top of the gemma-1 set (llama.cpp
            # build_gemma2 graph): post-attention/post-FFN block norms,
            # attention-score and final-logit softcapping, and alternating
            # sliding-window attention (even layers local, odd global —
            # HF Gemma2 `not bool(layer_idx % 2)`)
            cfg.act = "gelu_tanh"
            cfg.norm_bias = 1.0
            cfg.embed_scale = float(cfg.hidden_size) ** 0.5
            cfg.post_norms = True
            cfg.sliding_window = get(p + "attention.sliding_window", 4096)
            cfg.swa_pattern = 2
            cfg.attn_softcap = get(p + "attn_logit_softcapping", 50.0)
            cfg.final_softcap = get(p + "final_logit_softcapping", 30.0)
            if cfg.n_layers == 46:
                # gemma-2-27b: query_pre_attn_scalar = hidden/n_heads
                # (144), not head_dim (128) — llama.cpp keys the same
                # override on the 27B layer count
                cfg.query_scale = (cfg.hidden_size / cfg.n_heads) ** -0.5
        elif arch in ("qwen3", "qwen3moe"):
            # qwen3 = qwen2 graph minus QKV biases plus per-head q/k
            # RMSNorms before RoPE (llama.cpp build_qwen3); qwen3moe
            # additionally routes the FFN (expert keys parsed below)
            cfg.qk_norm = True
        elif arch == "gemma3":
            # gemma-3 (llama.cpp build_gemma3): gemma-2's post norms and
            # embed scaling, q/k norms instead of softcaps, 5-local:1-global
            # SWA, and a separate rope base for the local layers
            cfg.act = "gelu_tanh"
            cfg.norm_bias = 1.0
            cfg.embed_scale = float(cfg.hidden_size) ** 0.5
            cfg.post_norms = True
            cfg.qk_norm = True
            cfg.sliding_window = get(p + "attention.sliding_window", 1024)
            cfg.swa_pattern = 6
            # global layers read rope.freq_base (1M); local layers are
            # fixed at 10k unless the file overrides
            cfg.rope_local_theta = get(p + "rope.local_freq_base", 10000.0)
        # mixture-of-experts keys (any arch — mixtral is plain 'llama'
        # with expert_count > 0; qwen3moe uses its own prefix)
        cfg.n_experts = get(p + "expert_count", 0)
        if cfg.n_experts:
            cfg.n_experts_used = get(p + "expert_used_count", 2)
            cfg.moe_inter = get(p + "expert_feed_forward_length",
                                cfg.intermediate_size)
        style = md.get("ntransformer.rope_style")
        if style is not None:
            style = str(style)
            if style not in ("adjacent", "half"):
                raise ValueError(f"ntransformer.rope_style={style!r} "
                                 "(want 'adjacent' or 'half')")
            cfg.rope_interleaved = style == "adjacent"
        else:
            cfg.rope_interleaved = arch in ("llama", "mistral")
        if cfg.vocab_size == 0:
            toks = md.get("tokenizer.ggml.tokens")
            cfg.vocab_size = len(toks) if toks is not None else 32000
        if max_seq_len is not None:
            # cap like --ctx-size (transformer.cpp:70-74)
            cfg.max_seq_len = min(cfg.max_seq_len, max_seq_len)
        return cfg

    def describe(self) -> str:
        return (
            f"=== Model Config ===\n"
            f"Architecture: {self.architecture}  Name: {self.model_name}\n"
            f"Vocab: {self.vocab_size}, Hidden: {self.hidden_size}, "
            f"Intermediate: {self.intermediate_size}\n"
            f"Layers: {self.n_layers}, Heads: {self.n_heads}, "
            f"KV Heads: {self.n_kv_heads}, Head dim: {self.head_dim}\n"
            f"Max seq: {self.max_seq_len}, Norm eps: {self.norm_eps:g}\n"
            f"RoPE theta: {self.rope_theta:.1f}, "
            f"GQA: {'yes' if self.is_gqa else 'no'} (group={self.group_size})\n"
            f"BOS: {self.bos_token_id}, EOS: {self.eos_token_id}"
        )
