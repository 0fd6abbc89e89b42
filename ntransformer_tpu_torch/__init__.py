"""ntransformer_tpu_torch — the PyTorch + CUDA port of ntransformer_tpu.

The port runs llama-family GGUF models in Q8_0, Q4_0, Q4_K, Q5_K and Q6_K
(so Q4_K_M files) on one NVIDIA H100: resident single-stream generation and
continuous-batching serving. It mirrors the layout of the JAX package
(`ntransformer_tpu/`, which stays the reference) module for module, imports
nothing from it, and replaces each Pallas kernel on its path with a kernel
written by hand in CUDA C++ for sm_90a (`csrc/`):

  * ops/cuda/matmul.py            — the fused Q8_0 dequant-matmul
  * ops/cuda/nibble_matmul.py     — the fused Q4_0/Q4_K/Q5_K/Q6_K
                                    dequant-matmul
  * ops/cuda/attention.py         — prefill flash attention
  * ops/cuda/batched_attention.py — batched flash decode / verify
  * ops/cuda/kv_update.py         — the in-place KV append

Entry points run on the card unless the caller passes device="cpu"; on a
CPU tensor every kernel wrapper computes its plain PyTorch twin instead.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy conveniences: importing the package never builds a kernel
    if name in ("Engine", "GenerateConfig", "ChatSession"):
        from .inference import engine as _e
        return getattr(_e, name)
    if name == "load_model":
        from .models.loader import load_model
        return load_model
    raise AttributeError(name)
