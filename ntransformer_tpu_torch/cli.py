"""CLI of the port: the JAX package's parser, flag for flag, plus --device.

It runs resident generation (bf16 or --kv-int8 cache), --benchmark and
--serve (continuous batching over a prompts file, with --batch-size,
--prefix-cache and --kv-int8) on one device, each in the file's formats or
requantized at load to W4A8 (--w4a8) or W8A8 (--w8a8); tiered streaming
(--streaming, --max-hbm-layers, --max-ram-layers, --requant-q4k,
--requant-ram; automatic when the file does not fit the card's free memory);
and context-parallel generation and --benchmark (--cp N: the cache split
along the sequence over N shards, one on each of the first N cards, or all
on the CPU with --device cpu). Every other mode exits with 2 and names the
ROADMAP item that ports it; so do the JAX CLI's refusals of --cp with
--serve, --draft-model, --w4a8/--w8a8, streaming and --kv-int8.

This module is the one place of the port that reads the JAX package's
environment switches of these modes, with their names, values and defaults,
and passes them on as keyword arguments:
  NT_ATTN_DOT          the batched flash cache-dot form of --serve ("f32")
  NT_ATTN_BUCKETS      the rungs of --serve's s_live ladder ("4"; "0": none)
  NT_H2D               "planes": one host -> device copy per plane ("blob")
  NT_DIRECT_IO         "0": streamed reads through the page cache ("1")
  NT_REQUANT_RAM       a dtype name (Q4_K): the tier-B requant, as
                       --requant-ram (unset, "" or "0": off)
  NT_MAX_HBM_LAYERS    caps, as --max-hbm-layers / --max-ram-layers
  NT_MAX_RAM_LAYERS

Usage: python -m ntransformer_tpu_torch -m model.gguf -p "prompt" [-n 128]
"""
from __future__ import annotations

import argparse
import os
import sys

# mode → why it is refused (the ROADMAP item that ports it)
_NOT_PORTED = {
    "--http": "the HTTP server is ROADMAP queue 1 item 9 "
              "(inference/http_server.py)",
    "--chat": "chat templates are ROADMAP queue 1 item 9 (inference/chat.py)",
    "--tp": "tensor parallelism (and so --cp with --tp) is ROADMAP queue "
            "1 item 14",
    "--ep": "expert parallelism is ROADMAP queue 1 item 14",
    "--dp": "data-parallel serving is ROADMAP queue 1 item 14",
    # the JAX package streams for --self-spec (the resident prefix drafts);
    # the port refuses it until speculation is ported
    "--self-spec": "speculative decoding (tiered self-speculation "
                   "included) is ROADMAP queue 1 item 13",
    "--draft-model": "speculative decoding is ROADMAP queue 1 item 13",
    "--spec-k": "speculative serving is ROADMAP queue 1 item 13",
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
    p.add_argument("--w4a8", action="store_true",
                   help="requantize weights to the W4A8 format at load "
                        "(int8 decode kernel); changes numerics")
    p.add_argument("--w8a8", action="store_true",
                   help="requantize weights to the W8A8 serving format at "
                        "load (one int8 product at any batch size); changes "
                        "numerics")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def refused_mode(args) -> str | None:
    """The first requested mode this slice does not run, or None."""
    asked = {
        "--http": args.http is not None,
        "--chat": args.chat,
        "--tp": args.tp, "--ep": args.ep, "--dp": args.dp,
        "--self-spec": args.self_spec, "--draft-model": args.draft_model,
        "--spec-k": args.spec_k,
    }
    return next((mode for mode, on in asked.items() if on), None)


def should_stream(path: str, args) -> bool:
    """Tiered or resident: the streaming flags force it; otherwise the
    file plus a margin against the card's free memory (a CPU run streams
    only when asked)."""
    if (args.streaming or args.requant_q4k or args.requant_ram
            or args.max_hbm_layers is not None
            or args.max_ram_layers is not None):
        return True
    import torch
    if torch.device(args.device).type != "cuda" \
            or not torch.cuda.is_available():
        return False
    from .memory.tiers import HBM_MARGIN_BYTES, hbm_free_bytes
    try:
        need = os.path.getsize(path)
    except OSError:
        return False
    return need + HBM_MARGIN_BYTES + (1 << 30) > hbm_free_bytes()


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


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
    if args.cp and args.serve:
        log.error("--serve shards slots over dp and weights over tp; "
                  "context parallelism (--cp) is a single-request "
                  "long-context mode and does not compose with the "
                  "batch server")
        return 2
    if args.cp and args.draft_model:
        log.error("--draft-model pairs with the single-chip resident or "
                  "tiered engine (reference main.cpp:121-132); it is not "
                  "supported under --tp/--cp/--ep")
        return 2
    mode = refused_mode(args)
    if mode is not None:
        log.error(f"{mode} is not ported yet: {_NOT_PORTED[mode]}. The "
                  "port runs resident, tiered and context-parallel "
                  "generation, --benchmark and --serve.")
        return 2
    if args.w4a8 and args.w8a8:
        log.error("--w4a8 and --w8a8 are mutually exclusive (pick the "
                  "decode-optimized or the serving format)")
        return 2
    if args.serve:
        if args.streaming:
            log.error("--serve is the resident continuous-batching loop; "
                      "--draft-model/--self-spec/--streaming are "
                      "single-request engine modes and do not compose "
                      "with it")
            return 2
        return serve(args)

    stream = should_stream(args.model, args)
    if (args.w4a8 or args.w8a8) and (stream or args.cp):
        log.error("--w4a8/--w8a8 are resident single-chip modes for now: "
                  "the tiered pack streams SOURCE-dtype planes, and the "
                  "parallel engines shard source planes (convert-then-"
                  "shard lands with a parity test before it is enabled). "
                  "Drop the parallel/streaming flags, or drop the "
                  "requant flag.")
        return 2
    if stream and args.cp:
        log.error("--cp is a resident long-context mode; it does not "
                  "compose with tiered streaming (drop --cp, or drop the "
                  "flags/model-size that force streaming — use --tp for "
                  "streamed-layer sharding)")
        return 2
    from .inference.engine import (CPEngine, Engine, GenerateConfig,
                                   TieredEngine)
    cfg = GenerateConfig(
        max_tokens=args.max_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        repeat_penalty=args.repeat_penalty, seed=args.seed,
        skip_threshold=args.skip_threshold,
        early_exit_threshold=args.early_exit)
    if stream:
        from .core.dtypes import DType
        log.info(f"loading {args.model} (tiered streaming, {args.device})")
        requant_ram = DType.Q4_K if args.requant_ram else None
        env_rq = os.environ.get("NT_REQUANT_RAM", "")
        if requant_ram is None and env_rq and env_rq != "0":
            requant_ram = DType[env_rq.upper()]
        engine = TieredEngine.load(
            args.model, max_seq_len=args.ctx_size, device=args.device,
            requant=DType.Q4_K if args.requant_q4k else None,
            requant_ram=requant_ram,
            max_hbm_layers=(args.max_hbm_layers
                            if args.max_hbm_layers is not None
                            else _env_int("NT_MAX_HBM_LAYERS")),
            max_ram_layers=(args.max_ram_layers
                            if args.max_ram_layers is not None
                            else _env_int("NT_MAX_RAM_LAYERS")),
            kv_quant=args.kv_int8,
            direct_io=os.environ.get("NT_DIRECT_IO", "1") != "0",
            h2d="planes" if os.environ.get("NT_H2D", "blob") == "planes"
            else "blob")
    elif args.cp:
        log.info(f"loading {args.model} (resident, {args.cp}-way context "
                 f"parallel, {args.device})")
        try:
            engine = CPEngine.load(args.model, cp=args.cp,
                                   max_seq_len=args.ctx_size,
                                   device=args.device,
                                   kv_quant=args.kv_int8)
        except NotImplementedError as e:
            log.error(str(e))
            return 2
    else:
        log.info(f"loading {args.model} (resident, {args.device})")
        engine = Engine.load(args.model, max_seq_len=args.ctx_size,
                             fuse=not args.no_fuse, device=args.device,
                             kv_quant=args.kv_int8, w4a8=args.w4a8,
                             w8a8=args.w8a8)

    try:
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
    finally:
        if stream:
            engine.tm.close()


def serve(args) -> int:
    """--serve: continuous batching over a prompts file (one prompt per
    line); prints each completion and the aggregate throughput."""
    from .inference.sampler import SamplerConfig
    from .inference.serve import BatchServer, Request
    from .models.loader import load_model
    from .utils import logging as log
    from .ops.cuda.batched_attention import DOT_IMPLS
    dot_impl = os.environ.get("NT_ATTN_DOT", "f32")
    if dot_impl not in DOT_IMPLS:
        log.error(f"NT_ATTN_DOT={dot_impl!r}: want one of "
                  f"{', '.join(DOT_IMPLS)}")
        return 2
    attn_buckets = int(os.environ.get("NT_ATTN_BUCKETS", "4"))
    log.info(f"loading {args.model} (resident, {args.device}) to serve "
             f"{args.batch_size} slots")
    model = load_model(args.model, max_seq_len=args.ctx_size,
                       fuse=not args.no_fuse, device=args.device,
                       w4a8=args.w4a8, w8a8=args.w8a8)
    srv = BatchServer(model, batch_size=args.batch_size,
                      prefix_cache=args.prefix_cache, kv_quant=args.kv_int8,
                      dot_impl=dot_impl, attn_buckets=attn_buckets,
                      sampler_cfg=SamplerConfig(
                          temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p,
                          repeat_penalty=args.repeat_penalty,
                          seed=args.seed))
    with open(args.serve) as f:
        prompts = [ln.rstrip("\n") for ln in f if ln.strip()]
    # the replay file is written by the operator (trusted): chat-template
    # control strings become real control ids, unlike untrusted prompts
    reqs = [Request(prompt=pr, max_tokens=args.max_tokens,
                    parse_special=True) for pr in prompts]
    stats = srv.run(reqs)
    for r in reqs:
        print(f"### {r.prompt!r}\n{r.text}\n")
    print(stats.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
