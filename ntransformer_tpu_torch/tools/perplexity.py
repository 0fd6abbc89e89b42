"""Perplexity evaluation: the per-bit-width quality check.

Port of tools/perplexity.py: the PPL of a GGUF model over a text corpus in
non-overlapping teacher-forced windows, comparable across quantizations of
the same model. Each window's summed NLL is computed on the model's device
(log-softmax and the target gather included) and one scalar is read to the
host per window. On a CUDA device a run holds one cache and replays its
forwards as CUDA graphs (models/graphs.ForwardGraphs, the JAX package's
jitted forward): each window's all-logits forward at pos 0 (one graph a
window length), or in decode mode the T = 1 step; the NLL reduction runs
outside the graphs.

Usage: python -m ntransformer_tpu_torch.tools.perplexity -m model.gguf
       -f corpus.txt [--ctx 512] [--mode prefill|decode] [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import sys

import torch

from ..models.graphs import ForwardGraphs
from ..models.llama import KVCache, forward
from ..models.loader import load_model


def _graphed(device) -> bool:
    """Whether a run on `device` replays captured forwards: iff the device
    is CUDA."""
    return torch.device(device).type == "cuda"


class _Run:
    """The cache one run holds, zeroed for each window, and on a CUDA
    device the ForwardGraphs bound to it (None on the CPU, which calls the
    forward directly)."""

    def __init__(self, model):
        self.kv = KVCache.create(model.arch, device=model.device)
        self.graphs = (ForwardGraphs(model.arch, model.weights, self.kv)
                       if _graphed(model.device) else None)

    def start(self) -> KVCache:
        for t in (self.kv.k, self.kv.v):
            t.zero_()
        return self.kv


@torch.inference_mode()
def window_nll(model, ids: torch.Tensor, run: _Run | None = None
               ) -> torch.Tensor:
    """Summed NLL of one window through one all-logits forward at pos 0
    (the T > 1 prefill path; a verify graph replayed on run's cache on a
    CUDA device), as a device scalar."""
    run = run or _Run(model)
    kv = run.start()
    if run.graphs is not None:
        logits = run.graphs.verify(kv, ids, 0)
    else:
        logits, _, _ = forward(model.arch, model.weights, kv, ids, 0,
                               all_logits=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp[:-1].gather(1, ids[1:, None]).sum()


@torch.inference_mode()
def window_nll_decode(model, ids: torch.Tensor, run: _Run | None = None
                      ) -> torch.Tensor:
    """Summed NLL of one window stepped one token at a time (T = 1) through
    the resident forward and its cache (the step graph replayed on run's
    cache on a CUDA device): the decode path, whose numerics the W4A8
    format changes (its T = 1 product quantizes the activations to int8,
    its T > 1 product dequantizes exactly). A device scalar."""
    run = run or _Run(model)
    kv = run.start()
    total = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(ids.shape[0] - 1):
        if run.graphs is not None:
            logits = run.graphs.step(kv, ids[i:i + 1], i)
        else:
            logits, kv, _ = forward(model.arch, model.weights, kv,
                                    ids[i:i + 1], i)
        total -= torch.log_softmax(logits[0].float(), dim=-1)[ids[i + 1]]
    return total


def perplexity(model, token_ids: list[int], ctx: int = 512,
               progress=None, mode: str = "prefill") -> dict:
    """PPL over non-overlapping windows of ctx tokens; window w predicts
    its tokens [1, len) from the teacher-forced positions [0, len - 1).
    mode="prefill": one all-logits forward a window; mode="decode": T = 1
    steps, to price decode-only numerics (W4A8's int8 activations)."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    ctx = min(ctx, model.arch.max_seq_len)
    fn = window_nll if mode == "prefill" else window_nll_decode
    run = _Run(model)
    total_nll, total_tok = 0.0, 0
    n_windows = max(1, len(token_ids) // ctx)
    for w in range(n_windows):
        ids = token_ids[w * ctx: (w + 1) * ctx]
        if len(ids) < 2:
            break
        t = torch.tensor(ids, dtype=torch.long, device=model.device)
        total_nll += float(fn(model, t, run))  # the window's one host read
        total_tok += len(ids) - 1
        if progress:
            progress(w + 1, n_windows, math.exp(total_nll / total_tok))
    return {"ppl": math.exp(total_nll / max(1, total_tok)),
            "nll_per_token": total_nll / max(1, total_tok),
            "tokens": total_tok, "windows": n_windows, "mode": mode}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", required=True, help="text corpus")
    ap.add_argument("--ctx", type=int, default=512)
    ap.add_argument("--compute", default="quant", choices=["quant", "bf16"])
    ap.add_argument("--mode", default="prefill",
                    choices=["prefill", "decode"],
                    help="decode = per-token T=1 stepping (prices decode-"
                         "only numerics like w4a8 int8 activations)")
    ap.add_argument("--w4a8", action="store_true",
                    help="requantize weights to W4A8 at load")
    ap.add_argument("--w8a8", action="store_true",
                    help="requantize weights to W8A8 at load")
    ap.add_argument("--windows", type=int, default=0,
                    help="cap the number of ctx windows (0 = all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    model = load_model(args.model, compute=args.compute, w4a8=args.w4a8,
                       w8a8=args.w8a8, device=args.device)
    with open(args.file, encoding="utf-8", errors="replace") as f:
        ids = model.tokenizer.encode(f.read(), add_bos=True)
    if args.windows:
        ids = ids[: args.windows * args.ctx]
    print(f"{len(ids)} tokens, ctx {args.ctx}", file=sys.stderr)

    def prog(w, n, ppl):
        print(f"window {w}/{n}: running ppl {ppl:.3f}", file=sys.stderr)

    r = perplexity(model, ids, args.ctx, prog, mode=args.mode)
    print(f"perplexity: {r['ppl']:.4f}  "
          f"(nll/token {r['nll_per_token']:.4f}, {r['tokens']} tokens)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
