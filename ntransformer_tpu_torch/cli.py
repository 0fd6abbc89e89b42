"""CLI of the port: the JAX package's parser, flag for flag, plus --device.

This slice runs resident generation and --benchmark on one device. Every
other mode exits with 2 and names the ROADMAP item that ports it.

Usage: python -m ntransformer_tpu_torch -m model.gguf -p "prompt" [-n 128]
"""
from __future__ import annotations

import argparse
import sys

# mode → why it is refused (the ROADMAP item that ports it)
_NOT_PORTED = {
    "--serve": "continuous batching is ROADMAP queue 1 items 7 and 9 "
               "(models/batched.py, inference/serve.py)",
    "--http": "the HTTP server is ROADMAP queue 1 item 9 "
              "(inference/http_server.py)",
    "--chat": "chat templates are ROADMAP queue 1 item 9 (inference/chat.py)",
    "--streaming": "tiered streaming is ROADMAP queue 1 item 12",
    "--max-hbm-layers/--max-ram-layers": "tiered streaming is ROADMAP "
                                         "queue 1 item 12",
    "--requant-q4k/--requant-ram": "requantizing for the tiered pack is "
                                   "ROADMAP queue 1 item 12",
    "--tp": "tensor parallelism is ROADMAP queue 1 item 14",
    "--cp": "context parallelism is ROADMAP queue 1 item 14",
    "--ep": "expert parallelism is ROADMAP queue 1 item 14",
    "--dp": "data-parallel serving is ROADMAP queue 1 item 14",
    "--self-spec": "speculative decoding is ROADMAP queue 1 item 13",
    "--draft-model": "speculative decoding is ROADMAP queue 1 item 13",
    "--spec-k": "speculative serving is ROADMAP queue 1 item 13",
    "--w4a8": "the W4A8 format and kernel are ROADMAP queue 1 item 10 and "
              "queue 2 row 7",
    "--w8a8": "the W8A8 format and kernel are ROADMAP queue 1 item 10 and "
              "queue 2 row 6",
    "--kv-int8": "the int8 KV cache is ROADMAP queue 1 item 4",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ntransformer_tpu_torch",
        description="Quantized GGUF inference engine (PyTorch + CUDA port)")
    p.add_argument("-m", "--model", required=True, help="GGUF model path")
    p.add_argument("-p", "--prompt", default="The capital of France is")
    p.add_argument("-n", "--max-tokens", type=int, default=128)
    p.add_argument("-t", "--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--repeat-penalty", type=float, default=1.1)
    p.add_argument("-c", "--ctx-size", type=int, default=4096)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs "
                        "the plain PyTorch path)")
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--draft-model", default=None)
    p.add_argument("--draft-k", type=int, default=4)
    p.add_argument("--self-spec", action="store_true")
    p.add_argument("--early-exit", type=float, default=0.0)
    p.add_argument("--skip-threshold", type=float, default=0.0,
                   help="layer-skip calibration threshold, e.g. 0.98")
    p.add_argument("--requant-q4k", action="store_true")
    p.add_argument("--requant-ram", action="store_true")
    p.add_argument("--delta-model", default=None,
                   help="(negative result — refused)")
    p.add_argument("--max-hbm-layers", type=int, default=None)
    p.add_argument("--max-ram-layers", type=int, default=None)
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--bench-tokens", type=int, default=64)
    p.add_argument("--chat", action="store_true")
    p.add_argument("--tp", type=int, default=None)
    p.add_argument("--cp", type=int, default=None)
    p.add_argument("--ep", type=int, default=None)
    p.add_argument("--kv-int8", action="store_true")
    p.add_argument("--spec-k", type=int, default=0)
    p.add_argument("--spec-draft-layers", type=int, default=None)
    p.add_argument("--serve", default=None, metavar="PROMPTS_FILE")
    p.add_argument("--http", type=int, default=None, metavar="PORT")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--prefix-cache", type=int, default=0)
    p.add_argument("--no-fuse", action="store_true",
                   help="disable fused wqkv / gate|up weights")
    p.add_argument("--w4a8", action="store_true")
    p.add_argument("--w8a8", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def refused_mode(args) -> str | None:
    """The first requested mode this slice does not run, or None."""
    asked = {
        "--serve": args.serve, "--http": args.http is not None,
        "--chat": args.chat, "--streaming": args.streaming,
        "--max-hbm-layers/--max-ram-layers": (args.max_hbm_layers is not None
                                              or args.max_ram_layers
                                              is not None),
        "--requant-q4k/--requant-ram": args.requant_q4k or args.requant_ram,
        "--tp": args.tp, "--cp": args.cp, "--ep": args.ep, "--dp": args.dp,
        "--self-spec": args.self_spec, "--draft-model": args.draft_model,
        "--spec-k": args.spec_k, "--w4a8": args.w4a8, "--w8a8": args.w8a8,
        "--kv-int8": args.kv_int8,
    }
    return next((mode for mode, on in asked.items() if on), None)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils import logging as log
    from .utils.timing import PROFILER

    if args.verbose:
        log.set_level("debug")
        PROFILER.enabled = True
    if args.delta_model:
        log.error("delta streaming is a measured negative result (output "
                  "garbage; weights across layers are uncorrelated). "
                  "Refusing.")
        return 2
    mode = refused_mode(args)
    if mode is not None:
        log.error(f"{mode} is not ported yet: {_NOT_PORTED[mode]}. This "
                  "slice runs resident generation and --benchmark.")
        return 2

    from .inference.engine import Engine, GenerateConfig
    cfg = GenerateConfig(
        max_tokens=args.max_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        repeat_penalty=args.repeat_penalty, seed=args.seed,
        skip_threshold=args.skip_threshold)
    log.info(f"loading {args.model} (resident, {args.device})")
    engine = Engine.load(args.model, max_seq_len=args.ctx_size,
                         fuse=not args.no_fuse, device=args.device)

    if args.benchmark:
        stats = engine.benchmark(args.prompt, n_tokens=args.bench_tokens)
        print(stats.report(), file=sys.stderr)
        return 0

    def emit(piece: str):
        print(piece, end="", flush=True)

    text, stats = engine.generate(args.prompt, cfg, emit)
    print()
    print(stats.report(), file=sys.stderr)
    if args.verbose:
        print(PROFILER.summary(), file=sys.stderr)
        from .utils.timing import device_memory_report
        print(device_memory_report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
