"""Logit spread between the JAX package's kernel path and its CPU path.

On the CPU, runs models/repolm512_q8.gguf through the JAX Engine twice with
chip_smoke.py's prompt: once on the plain jnp path (KERNEL_MODE="off") and
once through the Pallas kernels in interpret mode (KERNEL_MODE="on"; the
flash kernel rounds p to bf16 there, as on the TPU). Each run is the
bucketed prefill and then 32 decode steps teacher-forced on the plain run's
greedy tokens. Prints one JSON line: max|dlogit| / max|logit| per step
(step 0 is the prefill). It is the yardstick for the port's card-vs-CPU
logit tolerances in chip_smoke.py and tests/test_torch_model.py.

Usage: JAX_PLATFORMS=cpu python experiments/logit_spread.py
"""
import json
import os
import sys

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import PROMPT  # noqa: E402
from ntransformer_tpu.inference.engine import Engine  # noqa: E402
from ntransformer_tpu.models.llama import KVCache  # noqa: E402
from ntransformer_tpu.ops import linear  # noqa: E402

STEPS = 32


def run(engine, ids, forced=None):
    kv = KVCache.create(engine.arch)
    logits, kv, _ = engine._prefill(kv, ids)
    out, toks = [np.asarray(logits[0])], []
    for i in range(STEPS):
        tok = int(np.argmax(out[-1])) if forced is None else forced[i]
        toks.append(tok)
        logits, kv, _ = engine._decode_step(kv, tok, len(ids) + i)
        out.append(np.asarray(logits[0]))
    return toks, out


def main():
    engine = Engine.load(os.path.join(ROOT, "models", "repolm512_q8.gguf"),
                         fuse=True)
    ids = engine._encode(PROMPT)
    linear.KERNEL_MODE = "off"
    jax.clear_caches()  # the mode is read at trace time
    toks, plain = run(engine, ids)
    linear.KERNEL_MODE = "on"
    jax.clear_caches()
    kernel_toks, _ = run(engine, ids)
    _, kernel = run(engine, ids, forced=toks)
    rel = [float(np.abs(a - b).max() / np.abs(b).max())
           for a, b in zip(kernel, plain)]
    print(json.dumps({"prompt_tokens": len(ids),
                      "greedy_agree": sum(a == b for a, b in
                                          zip(kernel_toks, toks)),
                      "steps": STEPS, "prefill_rel": rel[0],
                      "max_rel": max(rel), "rel": rel}))


if __name__ == "__main__":
    main()
