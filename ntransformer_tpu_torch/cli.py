"""CLI of the port: the JAX package's parser, flag for flag, plus --device.

It runs resident generation (bf16 or --kv-int8 cache), --benchmark, --chat
(the model's chat template and a session cache across turns, or the raw
loop without one), --serve (continuous batching over a prompts file, with
--batch-size, --prefix-cache, --kv-int8 and self-speculative serving
--spec-k K [--spec-draft-layers N]) and --http PORT [--host] (the same
server behind the HTTP front end, until interrupted), on one device or
sharded over a (dp, tp) mesh (--dp and --tp: the slots split over dp
groups, the weights over tp shards; one position on each card, or all on
one device with --device cuda:0 or --device cpu), each in the file's
formats or, on one device, requantized at load to W4A8 (--w4a8) or W8A8
(--w8a8); speculative decoding with a separate draft model (--draft-model,
--draft-k), resident or tiered; tiered streaming (--streaming,
--max-hbm-layers, --max-ram-layers, --requant-q4k, --requant-ram, and
--self-spec, which streams and drafts on the resident prefix; automatic
when the file does not fit the card's free memory); tensor-parallel
generation, --benchmark and --chat, resident or streamed (--tp N: the
weights and KV heads split over N shards, one on each of the first N
cards, or all on one device with --device cuda:0 or --device cpu; with
--streaming each shard streams its slice of every layer);
context-parallel generation and --benchmark (--cp N: the cache split along
the sequence over N shards, one on each of the first N cards, or all on
the CPU with --device cpu; with --tp M as well, the weights and KV heads
split over M shards too, on N * M positions, one a card or all on one
device with --device cuda:0 or --device cpu); and expert-parallel
generation, --benchmark and --chat of a mixture-of-experts model (--ep N:
the expert planes split over N shards, one on each of the first N cards,
or all on one device with --device cuda:0 or --device cpu). The JAX CLI's
refusals (--serve with --http, --cp with --serve/--http, --draft-model
with --cp/--tp/--ep, --ep with --tp/--cp or streaming, --serve/--http with
--draft-model/--self-spec/--streaming, --dp without a server, --w4a8/--w8a8
with streaming, --cp, --tp, --ep or a serving mesh, --tp beyond the cards,
--kv-int8 with --cp) exit with 2 and the JAX messages; so does --ep with
--serve/--http, which the JAX server ignores (the server shards over --dp
and --tp).

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


def should_stream(path: str, args) -> bool:
    """Tiered or resident: the streaming flags (--self-spec among them: the
    resident prefix drafts) force it; otherwise the file plus a margin
    against the card's free memory (a CPU run streams only when asked)."""
    if (args.streaming or args.self_spec or args.requant_q4k
            or args.requant_ram or args.max_hbm_layers is not None
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
    if args.serve and args.http is not None:
        log.error("--serve replays a prompts file to completion; --http is "
                  "the live network server — pick one")
        return 2
    server_mode = ("--serve" if args.serve
                   else "--http" if args.http is not None else None)
    if server_mode and args.cp:
        log.error(f"{server_mode} shards slots over dp and weights over tp; "
                  "context parallelism (--cp) is a single-request "
                  "long-context mode and does not compose with the "
                  "batch server")
        return 2
    if server_mode and (args.draft_model or args.self_spec
                        or args.streaming):
        log.error(f"{server_mode} is the resident continuous-batching loop; "
                  "--draft-model/--self-spec/--streaming are "
                  "single-request engine modes and do not compose "
                  "with it")
        return 2
    if args.draft_model and (args.cp or args.tp or args.ep):
        log.error("--draft-model pairs with the single-chip resident or "
                  "tiered engine (reference main.cpp:121-132); it is not "
                  "supported under --tp/--cp/--ep")
        return 2
    if args.ep and (args.cp or args.tp):
        log.error("--ep is its own mesh (expert axis); it does not "
                  "compose with --tp/--cp yet")
        return 2
    if server_mode and args.ep:
        log.error(f"{server_mode} shards slots over --dp and weights over "
                  "--tp; expert parallelism (--ep) is a single-request "
                  "engine mode and does not compose with the batch server")
        return 2
    if server_mode:
        return serve(args)
    if args.dp:
        log.error("--dp shards batch slots of the continuous-batching "
                  "server; it requires --serve or --http (use --tp for "
                  "single-request tensor parallelism)")
        return 2
    if args.w4a8 and args.w8a8:
        log.error("--w4a8 and --w8a8 are mutually exclusive (pick the "
                  "decode-optimized or the serving format)")
        return 2

    stream = should_stream(args.model, args)
    if (args.w4a8 or args.w8a8) and (stream or args.tp or args.cp
                                     or args.ep):
        log.error("--w4a8/--w8a8 are resident single-chip modes for now: "
                  "the tiered pack streams SOURCE-dtype planes, and the "
                  "parallel engines shard source planes (convert-then-"
                  "shard lands with a parity test before it is enabled). "
                  "Drop the parallel/streaming flags, or drop the "
                  "requant flag.")
        return 2
    if args.ep and stream:
        log.error("--ep is a resident mode; it does not compose with "
                  "tiered streaming")
        return 2
    if stream and args.cp:
        log.error("--cp is a resident long-context mode; it does not "
                  "compose with tiered streaming (drop --cp, or drop the "
                  "flags/model-size that force streaming — use --tp for "
                  "streamed-layer sharding)")
        return 2
    mesh = None
    if args.tp and not args.cp:
        from .parallel.tp import tp_mesh
        try:
            mesh = tp_mesh(args.tp, args.device)
        except ValueError:  # fewer cards than shards
            import torch
            log.error(f"--tp {args.tp}: only {torch.cuda.device_count()} "
                      "devices")
            return 2
    from .inference.engine import (CPEngine, Engine, EPEngine,
                                   GenerateConfig, TieredEngine, TPEngine)
    from .models.loader import load_model
    cfg = GenerateConfig(
        max_tokens=args.max_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        repeat_penalty=args.repeat_penalty, seed=args.seed,
        draft_k=args.draft_k, skip_threshold=args.skip_threshold,
        early_exit_threshold=args.early_exit)
    if stream:
        from .core.dtypes import DType
        if args.draft_model:
            # the draft loads first, resident; the tiered target sizes
            # itself on the memory left
            log.info(f"loading draft {args.draft_model} (resident, "
                     f"{args.device}) + target (tiered streaming)")
        else:
            ways = f", {args.tp}-way TP" if args.tp else ""
            log.info(f"loading {args.model} (tiered streaming, "
                     f"{args.device}{ways})")
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
            kv_quant=args.kv_int8, draft_path=args.draft_model,
            direct_io=os.environ.get("NT_DIRECT_IO", "1") != "0",
            h2d="planes" if os.environ.get("NT_H2D", "blob") == "planes"
            else "blob", mesh=mesh)
    elif args.ep:
        log.info(f"loading {args.model} (resident, {args.ep}-way expert "
                 f"parallel, {args.device})")
        try:
            engine = EPEngine.load(args.model, ep=args.ep,
                                   max_seq_len=args.ctx_size,
                                   device=args.device,
                                   fuse=not args.no_fuse,
                                   kv_quant=args.kv_int8)
        except ValueError as e:  # a dense model, E % ep, too few cards
            log.error(f"--ep {args.ep}: {e}")
            return 2
    elif args.cp:
        ways = (f"{args.cp}x{args.tp} context x tensor parallel"
                if args.tp else f"{args.cp}-way context parallel")
        log.info(f"loading {args.model} (resident, {ways}, {args.device})")
        try:
            engine = CPEngine.load(args.model, cp=args.cp, tp=args.tp,
                                   max_seq_len=args.ctx_size,
                                   device=args.device,
                                   kv_quant=args.kv_int8)
        except NotImplementedError as e:
            log.error(str(e))
            return 2
    elif args.tp:
        log.info(f"loading {args.model} (resident, {args.tp}-way TP, "
                 f"{args.device})")
        engine = TPEngine(load_model(args.model, max_seq_len=args.ctx_size,
                                     device="cpu"), mesh,
                          fuse=not args.no_fuse, kv_quant=args.kv_int8)
    else:
        log.info(f"loading {args.model} (resident, {args.device})")
        # the draft loads first (Engine.load)
        engine = Engine.load(args.model, draft_path=args.draft_model,
                             max_seq_len=args.ctx_size,
                             fuse=not args.no_fuse, device=args.device,
                             kv_quant=args.kv_int8, w4a8=args.w4a8,
                             w8a8=args.w8a8)

    try:
        if args.chat:
            engine.chat(cfg)
            return 0
        if args.benchmark:
            stats = engine.benchmark(args.prompt, n_tokens=args.bench_tokens)
            print(stats.report(), file=sys.stderr)
            return 0

        def emit(piece: str):
            print(piece, end="", flush=True)

        if args.self_spec:
            text, stats = engine.generate_self_speculative(args.prompt, cfg,
                                                           emit)
        elif args.draft_model:
            text, stats = engine.generate_speculative(args.prompt, cfg, emit)
        else:
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


def serving_mesh(args):
    """The (dp, tp) mesh of --serve/--http over --dp/--tp, built from
    --device as --tp builds its shards: "cuda" spreads the positions over
    the cards (an axis not given covers them all), a device with an index
    or "cpu" puts every position on it. None (logged) if the cards are too
    few."""
    import torch
    from .models.loader import resolve_device
    from .parallel.multihost import make_mesh
    from .utils import logging as log
    dev = resolve_device(args.device)
    tp = args.tp or 1
    devices = None
    if dev.type == "cpu" or dev.index is not None:
        devices = [dev] * (tp * (args.dp or 1))
    try:
        return make_mesh(tp=tp, dp=args.dp, devices=devices)
    except ValueError as e:
        log.error(f"--dp {args.dp} --tp {args.tp}: {e} "
                  f"({torch.cuda.device_count()} cards)")
        return None


def serve(args) -> int:
    """--serve: continuous batching over a prompts file (one prompt per
    line); prints each completion and the aggregate throughput. --http:
    the same server behind the HTTP front end until interrupted (SIGINT
    drains the in-flight requests and exits 0)."""
    from .inference.sampler import SamplerConfig
    from .inference.serve import BatchServer, Request
    from .models.loader import load_model
    from .utils import logging as log
    from .ops.cuda.batched_attention import DOT_IMPLS
    if args.w4a8 and args.w8a8:
        log.error("--w4a8 and --w8a8 are mutually exclusive (pick the "
                  "decode-optimized or the serving format)")
        return 2
    dot_impl = os.environ.get("NT_ATTN_DOT", "f32")
    if dot_impl not in DOT_IMPLS:
        log.error(f"NT_ATTN_DOT={dot_impl!r}: want one of "
                  f"{', '.join(DOT_IMPLS)}")
        return 2
    attn_buckets = int(os.environ.get("NT_ATTN_BUCKETS", "4"))
    mesh = None
    if args.tp or args.dp:
        if args.w4a8 or args.w8a8:
            log.error("--w4a8/--w8a8 do not compose with --tp/--dp "
                      "serving yet (convert-then-shard lands with a "
                      "parity test)")
            return 2
        mesh = serving_mesh(args)
        if mesh is None:
            return 2
        log.info(f"serving over mesh {mesh.shape}")
    # under a mesh the weights go host -> shards (BatchServer fuses each
    # shard's q|k|v and gate|up itself)
    log.info(f"loading {args.model} (resident, "
             f"{'cpu' if mesh is not None else args.device}) to serve "
             f"{args.batch_size} slots")
    model = load_model(args.model, max_seq_len=args.ctx_size,
                       fuse=mesh is None and not args.no_fuse,
                       device="cpu" if mesh is not None else args.device,
                       w4a8=args.w4a8, w8a8=args.w8a8)
    srv = BatchServer(model, batch_size=args.batch_size, mesh=mesh,
                      fuse=not args.no_fuse,
                      prefix_cache=args.prefix_cache, kv_quant=args.kv_int8,
                      spec_k=args.spec_k,
                      spec_draft_layers=args.spec_draft_layers,
                      dot_impl=dot_impl, attn_buckets=attn_buckets,
                      sampler_cfg=SamplerConfig(
                          temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p,
                          repeat_penalty=args.repeat_penalty,
                          seed=args.seed))
    if args.http is not None:
        from .inference.http_server import serve_http
        serve_http(srv, host=args.host, port=args.http)
        return 0
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
