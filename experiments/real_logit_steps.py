"""Where the port's card-vs-CPU logit spread on repolm512 comes from.

On a CUDA card, runs models/repolm512_q8.gguf through the port's Engine
with chip_smoke.py's prompt: one greedy pass on the CPU (the reference),
then passes on the card teacher-forced on the CPU's tokens, each with a
different set of hand-written kernels switched on:

  kernels        both kernels in prefill and decode (the main path)
  plain          no kernel (plain PyTorch on the card)
  matmul         the Q8_0 matmul kernel only
  flash          the flash-attention kernel only (prefill, q_len >= 64)
  prefill        both kernels in the prefill, plain decode steps
  decode         plain prefill, the matmul kernel in the decode steps

For each pass it prints max|dlogit| / max|logit| per step (step 0 is the
prefill) against the CPU and against the card's plain pass, and for the
worst step of the main path the same measure of every layer's output
hidden state, kernels against plain.

Usage (on the card): python3 experiments/real_logit_steps.py
"""
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import PROMPT  # noqa: E402
from ntransformer_tpu_torch.core.dtypes import DType  # noqa: E402
from ntransformer_tpu_torch.inference.engine import Engine  # noqa: E402
from ntransformer_tpu_torch.models import llama  # noqa: E402
from ntransformer_tpu_torch.ops import layers, linear  # noqa: E402
from ntransformer_tpu_torch.ops.cuda import attention as ca  # noqa: E402
from ntransformer_tpu_torch.ops.cuda import matmul as cm  # noqa: E402

STEPS = 32
CONFIGS = {  # name: ({prefill kernels}, {decode kernels})
    "kernels": ({"mm", "fa"}, {"mm", "fa"}),
    "plain": (set(), set()),
    "matmul": ({"mm"}, {"mm"}),
    "flash": ({"fa"}, {"fa"}),
    "prefill": ({"mm", "fa"}, set()),
    "decode": (set(), {"mm"}),
}
ON: set = set()           # kernels switched on right now
RECORD: list | None = None  # layer outputs of the step being recorded


def qmatmul(x, ql, *, layer=None):
    if ql.dtype != DType.Q8_0:
        return linear.qmatmul(x, ql, layer=layer)
    if layer is not None:
        ql = ql.layer(layer)
    fn = cm.quant_matmul_cuda if "mm" in ON and x.is_cuda else \
        cm.quant_matmul_plain
    return fn(x, ql.planes["qs"], ql.planes["d"])


def attention(q, k, v, pos, q_len, scale, window=None, softcap=0.0):
    if "fa" in ON and q.is_cuda and q_len >= layers.FLASH_MIN_Q:
        return ca.flash_attention_cuda(q, k, v, pos, q_len, scale,
                                       window=window, softcap=softcap)
    return layers.attention_torch(q, k, v, pos, q_len, scale, window=window,
                                  softcap=softcap)


_layer_step = llama.layer_step


def layer_step(*args, **kw):
    y = _layer_step(*args, **kw)
    if RECORD is not None:
        RECORD.append(y[-1].float().cpu())
    return y


def run(engine, ids, cfg, forced=None, record_step=None):
    """Prefill, then STEPS decode steps (greedy or fed `forced`). Returns
    (tokens, per-step logits, layer outputs of record_step or None)."""
    global ON, RECORD
    pre, dec = cfg
    kv = engine._make_kv()
    ON, RECORD = pre, ([] if record_step == 0 else None)
    logits, kv, _ = engine._prefill(kv, ids)
    out, toks, rec = [logits[0].float().cpu()], [], RECORD
    for i in range(STEPS):
        tok = int(torch.argmax(out[-1])) if forced is None else forced[i]
        toks.append(tok)
        ON, RECORD = dec, ([] if record_step == i + 1 else None)
        logits, kv, _ = engine._decode_step(kv, tok, len(ids) + i)
        rec = RECORD if RECORD is not None else rec
        out.append(logits[0].float().cpu())
    ON, RECORD = set(), None
    return toks, out, rec


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    llama.qmatmul, llama.attention, llama.layer_step = \
        qmatmul, attention, layer_step
    gguf = os.path.join(ROOT, "models", "repolm512_q8.gguf")
    cpu = Engine.load(gguf, device="cpu", fuse=True)
    gpu = Engine.load(gguf, device="cuda", fuse=True)
    ids = cpu._encode(PROMPT)
    toks, ref, _ = run(cpu, ids, CONFIGS["plain"])
    passes = {name: run(gpu, ids, cfg, forced=toks)[1]
              for name, cfg in CONFIGS.items()}
    result = {"prompt_tokens": len(ids), "steps": STEPS}
    for name, logits in passes.items():
        result[name] = {
            "vs_cpu": [rel(a, b) for a, b in zip(logits, ref)],
            "vs_plain": [rel(a, b) for a, b in zip(logits, passes["plain"])]}
    worst = max(range(STEPS + 1), key=lambda i: result["kernels"]["vs_cpu"][i])
    _, _, hk = run(gpu, ids, CONFIGS["kernels"], forced=toks,
                   record_step=worst)
    _, _, hp = run(gpu, ids, CONFIGS["plain"], forced=toks, record_step=worst)
    _, _, hc = run(cpu, ids, CONFIGS["plain"], forced=toks, record_step=worst)
    result["worst_step"] = worst
    result["worst_step_layers"] = {
        "kernels_vs_plain": [rel(a, b) for a, b in zip(hk, hp)],
        "plain_vs_cpu": [rel(a, b) for a, b in zip(hp, hc)],
        "kernels_vs_cpu": [rel(a, b) for a, b in zip(hk, hc)]}
    for name in CONFIGS:
        r = result[name]
        print(f"{name:8s} vs cpu: max {max(r['vs_cpu']):.4f} at step "
              f"{r['vs_cpu'].index(max(r['vs_cpu']))}, step {worst} "
              f"{r['vs_cpu'][worst]:.4f}; vs plain: max "
              f"{max(r['vs_plain']):.4f}, step {worst} "
              f"{r['vs_plain'][worst]:.4f}", flush=True)
    print(json.dumps(result), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "real_logit_steps.json"),
              "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
