"""ntransformer_tpu_torch — the PyTorch + CUDA port of ntransformer_tpu.

The port runs the resident, single-stream generate path for Q8_0
llama-family GGUF models on one NVIDIA H100. It mirrors the layout of the
JAX package (`ntransformer_tpu/`, which stays the reference) module for
module, imports nothing from it, and replaces each Pallas kernel on its
path with a kernel written by hand in CUDA C++ for sm_90a (`csrc/`):

  * ops/cuda/matmul.py    — the fused Q8_0 dequant-matmul
  * ops/cuda/attention.py — prefill flash attention

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
