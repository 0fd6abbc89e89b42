"""Model shape presets + the Q4_K_M per-tensor dtype policy.

Lives inside the package (synth.py and the test-GGUF tool both need it;
the package must not import from the repo-root tools/ directory).
"""
from ..core.dtypes import DType

PRESETS = {
    # (vocab, hidden, inter, layers, heads, kv_heads, ctx)
    "tiny": dict(vocab=512, hidden=256, inter=512, layers=4, heads=4,
                 kv_heads=2, ctx=512, rope_theta=10000.0),
    "micro": dict(vocab=256, hidden=128, inter=256, layers=2, heads=2,
                  kv_heads=1, ctx=256, rope_theta=10000.0),
    # 7 layers so a 5:1 SWA pattern (gemma3) includes one GLOBAL layer
    # (il % 6 == 5) — a 4-layer model would test only the local path
    "deep": dict(vocab=512, hidden=128, inter=256, layers=7, heads=4,
                 kv_heads=2, ctx=512, rope_theta=10000.0),
    # smallest shape the W4A8 format accepts (K % 512 == 0 everywhere)
    "tiny512": dict(vocab=512, hidden=512, inter=1024, layers=2, heads=8,
                    kv_heads=4, ctx=512, rope_theta=10000.0),
    # mixture-of-experts (mixtral-shaped: llama arch + expert tensors);
    # inter is the PER-EXPERT FFN width
    "moe": dict(vocab=512, hidden=128, inter=192, layers=3, heads=4,
                kv_heads=2, ctx=512, rope_theta=10000.0,
                experts=4, experts_used=2),
    "1b": dict(vocab=128256, hidden=2048, inter=8192, layers=16, heads=32,
               kv_heads=8, ctx=4096, rope_theta=500000.0),
    "3b": dict(vocab=128256, hidden=3072, inter=8192, layers=28, heads=24,
               kv_heads=8, ctx=4096, rope_theta=500000.0),
    "8b": dict(vocab=128256, hidden=4096, inter=14336, layers=32, heads=32,
               kv_heads=8, ctx=4096, rope_theta=500000.0),
    "70b": dict(vocab=128256, hidden=8192, inter=28672, layers=80, heads=64,
                kv_heads=8, ctx=4096, rope_theta=500000.0),
}


def q4_k_m_policy(tensor_name: str) -> DType:
    """Q4_K_M per-tensor dtype policy (mirrors llama.cpp: most tensors
    Q4_K; ffn_down and embeddings Q6_K — the reference notes files mix
    Q4_K/Q5_K/Q6_K, README.md:207-215)."""
    if ("ffn_down" in tensor_name or "token_embd" in tensor_name
            or "output." in tensor_name):
        return DType.Q6_K
    return DType.Q4_K
