#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (ntransformer_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught); the set-up always
runs, `python3 chip_smoke.py kernels,serve` (names comma-separated) runs a
subset of the rest, and `--cut-layers N` (8 by default: CUT_LAYERS)
sets the depth of the models that phase graphs (both formats), Mixtral's
replayed steps in phase moe and the mesh phases cp, tp, dp, pp, cptp and
ep run, at full width (32: full depth):

  set-up: the card's name and power limit, TF32 off, the eight kernel
     libraries built from csrc/ with nvcc (one process a translation unit,
     all in parallel, ops/cuda/build.py; the streamer's host library
     csrc/ntstage.cpp with g++ beside them) and nvcc's register report
     printed; beside the build and the phases, in worker processes, the
     selected phases' host set-up that needs no card (start_prep: the
     tiered 8B and Mixtral GGUFs with their packs, phase quality's requants
     and CPU perplexities), each waited for by the phase that takes it
     (Prep, which prints the wait);
  kernels: the Q8_0 matmul (T = 1, 8, 32, 70, 512: its skinny kernel and
     its wgmma tile; each row's profiler device time, one kernel a call,
     the counter and the profiler agreeing) and prefill flash attention
     against their plain PyTorch twins on the card at the full-width shapes
     (Llama-3.1-8B and repolm512), with times (CUDA events, L2 flushed
     before every launch, runs in turns), the least time the card could
     take, and one PyTorch library call as a yardstick;
  bkernels: the same for batched flash decode/verify and the in-place KV
     append at the serving shapes (8B, B = 1 to 32, bf16 and int8), each
     row with its profiler device time and kernels a call, the launch
     counter and the profiler agreeing (the split kernel of "f32" and
     "int8_s" one launch a call where its splits fit a cluster), and the
     s_live bucket's result bit-equal to the whole cache's; rows also at a
     (dp, tp) group's and a PP microbatch's and stage's shapes;
  qkernels: the same for the Q4_0, Q4_K, Q5_K and Q6_K dequant-matmul
     kernels at T = 1, 32 and 512 (8B shapes, the Q6_K and Q4_0 heads,
     repolm512's shapes, a ragged N, Q4_0's half step at K = 1056), and
     T = 8 and 64 at the 8B gate|up (Q4_0, Q4_K, Q5_K) and down (Q6_K);
     every row with its profiler device time and kernels a call, the
     counter and the profiler agreeing; each format one kernel a call (the
     skinny kernel or the wgmma tile of csrc/kquant_matmul.cu);
  real: models/repolm512_q8.gguf through the CLI on the card, Engine greedy
     generation on the card against the CPU, teacher-forced on the CPU's
     tokens with every step's logits compared, and each layer of the kernel
     path against the card's plain path on the same input;
  serve: repolm512 through the CLI's --serve on the card (bf16 and
     --kv-int8), the batched step teacher-forced on the CPU's tokens, and
     greedy serving on the card against the CPU;
  full: a synthetic Llama-3.1-8B Q8_0 (random int8 codes from a seeded
     generator) through Engine.benchmark with the launch counts read around
     it, a decode profile, and a 2-layer view with the kernels on and off;
  bfull: the same weights served by BatchServer at full width (this
     slice's main path: the launch counts in the kernels line are read
     around it), the batched step as the bench drives it (B = 1 bf16, B = 32
     int8, a T = 4 verify window) with profiles, and a 2-layer batched step
     with the kernels on and off; on the card the server replays captured
     steps, so its launch counts are read around its warmup (each step
     key's uncaptured warm-up call and capture) and its run;
  graphs: the batched steps as CUDA graphs (models/graphs.py; python3
     chip_smoke.py graphs runs it alone, building the 8B Q4_K_M itself when
     qfull does not run): for the synthetic 8B Q8_0 (after bfull) and Q4_K_M
     (inside qfull), each cut to its first 8 layers (CUT_LAYERS; `full`,
     `bfull` and `qfull` replay the whole 32), the decode step at B = 1 bf16
     and B = 32 int8 under the 768 rung, 64 chained steps replayed bit-equal
     to the uncaptured chain (logits, tokens, caches), the wall ms a step of
     both in turns, the kernels and device ms of a replay beside an
     uncaptured step's by the profiler (the port's kernels a replay equal to
     the uncaptured step's launch counters, which replays do not advance);
     on the Q4_K_M also a K = 3 speculative round at B = 8 through the draft
     and verify graphs bit-equal to the uncaptured round, and BatchServer(B
     = 8) over bfull's requests replaying its steps, its texts equal to the
     same server calling the steps directly; it prints its seconds. Phase
     moe replays the Mixtral B = 1 and B = 8 steps (8 layers) bit-equal to
     their uncaptured chains;
  qreal: repolm512 requantized on the host with the port's own quantizer
     and GGUF writer (Q4_K_M, Q4_K_M with a Q6_K attn_v, all-Q5_K,
     all-Q4_0), each through the CLI and Engine as in `real`, and the
     Q4_K_M file served as in `serve`;
  qfull: a synthetic Llama-3.1-8B Q4_K_M (seeded random codes, scales
     giving |w| ~ 0.02) through Engine.benchmark and BatchServer as in
     `full` and `bfull` (its launch counts are the Q4_K and Q6_K kernels'
     main path), then bench.py's B = 1 batched step for Q4_0 (the Q4_0
     kernel's main path) and Q6_K;
  wkernels: first the plain quantizers the card runs (W8A8 rows, W4A8
     groups, the int8 KV rows) against their numpy twins, bit for bit;
     then the W8A8 int8 matmul (it quantizes x itself; bit-equal to its
     twin; two launches a call, its quantize pass and the matmul), the
     W4A8 decode matmul (it quantizes x itself; bit-equal by construction,
     held to 2e-5; one launch a call, two where its pairs are split) - both
     with the counter and the profiler agreeing that the call launches
     nothing else - and the W4A8 T > 1 wgmma tile against their plain twins
     at the 8B shapes (W8A8 at T = 1, 8, 32, 512), a stacked layer view,
     repolm512's shapes, a ragged N and a column-major x, with
     torch._int_mm (cuBLASLt int8) as the W8A8 yardstick where it takes
     the shape, and each kernel's device time from the profiler beside its
     call time;
  wreal: repolm512 requantized at load with --w4a8 and with --w8a8, each
     as `real` (prefill layers held to the int8 limit: a flipped activation
     code moves a whole int8 step), the --w8a8 model also as `serve`;
  wfull: a synthetic Llama-3.1-8B in W4A8 through Engine.benchmark (the
     main path of the W4A8 tile and of the decode kernel) and bench.py's
     B = 1 step, then in W8A8 served by BatchServer (the W8A8 kernel's main
     path) with the bench-style steps (B = 1, B = 32 int8 also with the
     int8 cache dots, verify), each with profiles and a 2-layer on/off view;
  cp: the flash-attention partials kernel (the second entry of
     csrc/flash_attention.cu) at 8B widths, T = 512, in 4 shards of the
     path's own 9,216-key cache at pos 2,048, of a 32,768-key cache at pos
     20,000 (two shards visible, one straddling, one masked) and at pos
     16,350 (a shard boundary inside a query block), and at a TP shard's
     heads (Hq 16, Hkv 4) over the 9,216-key cache in 2 shards at pos 4,096
     (phase cptp's), each shard against its twin and the shards combined on
     the card against the unsplit flash kernel, all but the straddle case
     timed as above; then the synthetic 8B Q8_0 (the
     weights of `full`, its first CUT_LAYERS = 8 layers: phase graphs and
     the mesh phases cp, tp, dp, pp, cptp and ep cut the depth, never a
     width) through
     CPEngine with 4 shards on the one card, ctx
     9,216 and a 4,600-token prompt (Engine.benchmark's protocol, the
     partials kernel's main path: its launch count in the kernels line is
     read around it) beside the resident Engine, 32 steps teacher-forced on
     the resident's greedy tokens, and the CLI's --cp 1 on repolm512 (its
     text equal to the resident CLI's);
  cpcards: on a host with 4 cards or more (else it says so and passes),
     repolm512 and the synthetic 8B (all 32 layers, as in every phase over
     cards) through CPEngine with one shard per card, bit-equal to the 4
     shards on one card, and the CLI's --cp 4;
  tp: tensor parallelism (python3 chip_smoke.py tp runs it alone): the
     synthetic 8B Q8_0 of `full` (8 layers) through TPEngine with 2 shards on
     the one card (Engine.benchmark's protocol, prefill 512, ctx 4096; its
     launch counts are the kernels line's tp_launches) beside the resident
     Engine, decode profiles of both (kernels a token, busy share), 32 steps
     teacher-forced on the resident's greedy tokens with the bf16 and the int8
     cache (each step within the CP phase's rule), and repolm512 through the
     CLI's --tp 2 (both shards on cuda:0: resident, fused and --streaming at
     (2, 2, 2), texts equal to TPEngine's) and its refusals. With phase tiered
     also run, the tiered 8B's resident model as a 2-shard TPEngine and the
     GGUF streamed over that mesh at its tiers: 32 greedy tokens bit-identical,
     ms per token and the H2D bytes of each shard. The kernels and qkernels
     phases hold the Q8_0, Q4_K, Q6_K and flash kernels at the 8B's tp = 2 and
     4 shard shapes;
  tpcards: on a host with 4 cards or more (else it says so and passes),
     repolm512 and the synthetic 8B (32 layers) through TPEngine with one
     shard per card, bit-equal to the 4 shards on cuda:0, and the CLI's
     --tp 4;
  dp: data parallelism and the sharded batch server (python3 chip_smoke.py
     dp runs it alone): the synthetic 8B Q8_0 of `full` (8 layers) served by
     BatchServer(B = 8, bfull's eight requests) on one device and over the
     (2, 1) and (2, 2) meshes on cuda:0 (the kernels line's dp_launches are
     the two mesh servers'), served tok/s, ttft, ms and kernels a step side
     by side, the count of texts that differ from the one-device server's;
     8 steps teacher-forced on the one-device server's tokens that fail
     the run: at tp = 1 each dp group bit-equal to the unsharded step on
     its slots alone, at tp = 2 every step within max(2e-2, 2 r) of the
     largest logit (r: the one-device kernel path against its plain path);
     spec serving (K = 3) on the (2, 1) mesh; repolm512 through the CLI's
     --serve --dp 2, --serve --tp 2 --dp 2 and --http --dp 2 (--device
     cuda:0), texts equal to BatchServer.run's over the same mesh; two
     processes on cuda:0 joined over gloo (host-staged) serving repolm512
     at dp = 2, both printing the one-process server's texts;
  dpcards: on a host with 4 cards or more (else it says so and passes),
     the 8B (32 layers) over the (2, 2) mesh one position a card,
     teacher-forced
     bit-equal to the same mesh on cuda:0, and two processes over NCCL
     (one card each) at dp = 2 and at tp = 2;
  pp: pipeline parallelism (python3 chip_smoke.py pp runs it alone): the
     synthetic 8B Q8_0 of `full` (8 layers), B = 8 slots prefilled with
     9-500-token prompts, bf16 and int8 caches, through pp_decode_step at (2
     stages, 2 microbatches) and (4, 2) on cuda:0 (each stage's layers a view
     of the stacked planes), 16 steps fed the one-device B = 8 step's greedy
     tokens: each microbatch's logits and cache bit-equal to the unsharded step
     over its slots alone, the launches equal to those microbatch steps' but
     for the stacked append, one a stage (the head M times a step, counted), ms
     and kernels a step beside the one-device step's (the kernels line's
     pp_launches);
  cptp: CP x TP (python3 chip_smoke.py cptp runs it alone): the same 8B
     through CPEngine over a (2, 2) mesh on cuda:0 (the weights over tp,
     the cache over both axes), ctx 9,216 and a 4,600-token prompt as in
     `cp`: Engine.benchmark's protocol (the kernels line's cptp_launches)
     beside the resident Engine, 16 steps teacher-forced by tp's rule; and
     repolm512 through the CLI's --cp 2 --tp 2 (--device cuda:0) and
     CPEngine against the CPU;
  meshcards: on a host with 4 cards or more (else it says so and passes),
     one position a card against the same mesh on cuda:0, bit for bit: a
     small MoE GGUF and the synthetic Mixtral-8x7B (32 layers) through
     EPEngine(ep = 4), the 8B (32 layers) through pp_decode_step at (4
     stages, 2 microbatches), repolm512 and the 8B through CPEngine over
     (2, 2);
  spec: speculation (python3 chip_smoke.py spec runs it alone): batched
     flash's verify at B = 8, K = 3 (T = 4, S 1024; bf16 "f32", int8 "f32"
     and "int8_v") and the Q8_0 and Q4_K matmuls at T = 4 and 32 against
     their twins, timed, with device times and launches a call; the price
     sheet of bench.py's spec_serve_breakeven_b8 on the synthetic 8B Q8_0
     (plain, draft and verify steps at B = 1 and 8, break-even acceptance,
     full-accept ceiling, a round's profile); the synthetic 8B served with
     --spec-k 3 (this slice's main path: the kernels line's spec_launches)
     beside spec-off; and repolm512: Engine's three speculative modes (a
     Q4_K_M requant drafts), the CLI's --draft-model, --self-spec and
     --serve --spec-k, and BatchServer greedy spec against spec-off (bf16,
     int8; acceptance and steps saved with bench.py's four prompts) and
     sampled twice with one seed. Greedy speculation on the card is held
     by spec_rule: every verify row teacher-forced on the plain tokens
     within max(1e-2, 2 r) of the sequential step (r the card's plain path
     against the CPU), and where the tokens part, a top-2 margin no more
     than twice that step's difference;
  tiered: repolm512 streamed at (2 HBM, 2 RAM, 2 disk) layers against the
     unfused resident model (greedy tokens identical; pipelined and
     synchronous runs bit-identical; int8 cache, a skip set, early exit;
     the runtime tier-B requant of a Q4_K_M requant bit-identical to the
     offline requant pack; the CLI's --streaming against the resident CLI),
     then a synthetic Llama-3.1-8B Q4_K_M GGUF of random valid blocks
     streamed at (8, 16, 8) (16 layers at (4, 8, 4) without the disk room):
     a 512-token prefill and 32 greedy tokens identical to the unfused
     resident model, ms per token pipelined and synchronous (in turns), the
     copy stream's H2D rate and the tier-C read rate beside a pinned-copy
     and an O_DIRECT read probe, a profile's busy shares, and
     TieredEngine.generate_self_speculative (the 8 resident layers draft,
     16 tokens) held to the tiered greedy tokens by spec_rule;
  moe: mixture of experts (python3 chip_smoke.py moe runs it alone): the
     T = 1 kernels' device-side select at the Mixtral-8x7B expert shapes
     (Q4_K, Q6_K, Q8_0, Q4_0, Q5_K, W8A8, W4A8 decode on stacked [8, K, N]
     planes, the index a CUDA int32 tensor): each against its plain twin,
     bit-equal to the same kernel on the host-int view of the expert, its
     launches a call by the counter and the profiler with no other kernel,
     device times beside the host view's; a synthetic Mixtral-8x7B Q4_K_M
     (this slice's main path: Engine.benchmark and BatchServer with the
     bench-style steps, their launch counts the kernels line's
     moe_launches), its 2-layer prefill and decode held to the card's
     plain path with the routing forced (the kernel path replays the plain
     path's expert ids and weights, RouteTape), one decode step's
     moe_ffn calls under set_sync_debug_mode("error"); small MoE GGUFs
     written with the port's writer (Q8_0, Q4_K_M, qwen3moe) against the
     CPU as `real`, the Q8_0 one served as `serve`; and a 4-layer Mixtral
     Q4_K_M GGUF tiered with an LRU smaller than a token's working set and
     its last layer on disk, bit-equal to the resident model;
  ep: expert parallelism, inside phase moe (python3 chip_smoke.py ep runs moe
     with it): the select rows also at a shard's 4 of 8 experts; the synthetic
     Mixtral's first 8 layers split in place over 2 expert shards on cuda:0
     (EPEngine): its prefill within FULL_LOGIT_RTOL of the one-device prefill,
     16 T = 1 steps bit-equal to the one-device steps on the same cache, ms a
     token beside them, Engine.benchmark's protocol (the kernels line's
     ep_launches), a step's launches by the counters and the profiler, and the
     EP step under set_sync_debug_mode("error"); the small MoE files through
     the CLI's --ep 2 and EPEngine against the CPU;
  http: the user-facing surfaces (python3 chip_smoke.py http runs it
     alone): a synthetic Llama-3.1-8B Q4_K_M with Llama-3's chat tokens
     and template (32 layers, resident, fused) served by BatchServer(B = 8)
     behind HttpFrontend: /health, /stats, 400 and 404, 8 concurrent
     greedy completions and 8 chat completions equal to BatchServer.run's
     texts, streamed pieces equal to the text, an abandoned stream's slot
     freed, and time to first token and served tok/s with 8 and 32 clients
     arriving together and every 0.1 s (the kernels line's http_launches
     are all its HTTP traffic's); then repolm512 with a chat template:
     Engine.chat over two turns (chat_launches; the second turn prefills
     only its new tokens and is held to a fresh generate of the history),
     the api's nt_engine_* (resident and streaming), a template-less
     model's 501, the CLI's --http 0 in a subprocess (a POST, SIGINT, exit
     0) and --chat on two stdin lines;
  quality: perplexity on repolm512 on the card in prefill and decode modes
     (Q8_0, its Q6_K, Q4_K_M and Q4_0 requants, --w8a8 and --w4a8 at
     load), each nll against the CPU's; the quality gate with every budget
     row (it must pass) and against the committed fixture (its verdict and
     failed sub-checks printed); ppl_launches are the card's runs'.

The bkernels phase also holds the batched flash kernel's cache-dot forms
(dot_impl int8, int8_s, int8_v, bf16) against their twins and the f32
kernel; the serve phase also serves with NT_ATTN_DOT=int8 through the CLI
and with each form through BatchServer (the forms' main path); bfull also
times the B = 32 int8 step with the int8 forms beside f32.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
F32_FLOPS = 67e12              # f32 outside the tensor cores
INT8_OPS = 1979e12             # dense int8 tensor-core peak
MATMUL_RTOL = 1e-3             # max|kernel-plain| <= 1e-3 * max|plain|
# the W4A8 decode kernel against its twin, the JAX suite's own limit
# (tests/test_w4a8.py); the twin takes the kernel's steps in its order, so
# the two are bit-equal in fact (the row records it)
W4A8_DECODE_RTOL = 2e-5
# batched flash, for every query token: max|kernel-plain| <= 1e-4 *
# max|plain| over the token's heads and lanes. Kernel and twin compute in
# f32 from the same values; only the order of the sums (the kernel merges
# split partials) and the exp/tanh implementations differ, ~1e-6 of a row.
BATCHED_RTOL = 1e-4
# flash, for every query row: max|kernel-plain| <= 1e-2 * max|plain| over
# the row's heads and lanes. The kernel rounds p to bf16 before PV (as the
# TPU kernel does) where the twin keeps f32 probabilities: 2^-9 of each
# term, so at most ~2e-3 of a row's largest output however many keys it
# sees. A row scale keeps the limit tight at long context, where outputs
# are ~0.03 and a dropped or mis-masked KV tile moves them by ~1e-2.
FLASH_RTOL = 1e-2
# repolm512 on the card, kernel path against the card's plain path, one
# layer at a time, each layer fed the plain path's input and cache: the
# prefill's flash kernel rounds p to bf16 (~2e-3 of an attention output;
# 1.2e-3 of a layer output measured); a decode step differs only in f32
# summation order (1.6e-7 measured), and a bf16 flip that such an order
# change can cause moves a layer output by ~1e-4
LAYER_RTOL = {"prefill": 5e-3, "decode": 1e-4}
# the same with weights requantized to W4A8 / W8A8, whose products quantize
# their activations to int8: where the prefill's flash kernel moves an
# attention output across a rounding edge, the next product's code flips and
# moves a whole int8 step of its row (W8A8) or group (W4A8), so a prefill
# layer is held to the JAX suite's int8 limit, as the int8 cache is
# (measured 7.8e-3 for W8A8 and 1.2e-3 for W4A8 on repolm512, H100 80GB
# HBM3 at 700 W). A decode layer's products are bit-equal to their twins
# (0.0 measured), so the decode limit stays.
WFORMAT_LAYER_RTOL = {"prefill": 2e-2, "decode": 1e-4}
# repolm512 end to end, teacher-forced on the CPU's tokens: every step's
# max|dlogit| / max|logit| of the kernel path against the CPU is at most
# max(REAL_LOGIT_RTOL, 2 * r), r the card's plain path against the CPU at
# that step. A step where r is large is one where the model amplifies
# roundings: at step 4 layer 4 turns a 1e-3 difference in its input into
# 2e-2 for every pair of paths (card plain vs CPU included); the kernel
# path's own roundings may move it by as much again
# (experiments/real_logit_steps.py). A decode step's r is also at least m,
# the kernel path's prefill with plain decode steps against the CPU: the
# spread the prefill's roundings carry into that step. On repolm512 in
# Q4_K_M step 2 reads 1.29e-2 with the kernels, 1.3e-2 with the kernel
# prefill and plain decode steps, and 3.2e-3 on the plain path (chip run
# 8, PR 3): the prefill's roundings, amplified, not the decode kernels.
# The prefill itself (step 0) is held to the plain path's r, and each
# layer by LAYER_RTOL.
REAL_LOGIT_RTOL = 1e-2
# the same floor for the served batched steps, per cache: an int8 cache
# rounds every new row to absmax codes, and a code that rounds the other
# way moves its row by a whole step, so the int8 floor is the JAX suite's
# own int8 limit (as BATCHED_LOGIT_RTOL and tests/test_torch_model.py's
# INT8_LOGIT_RTOL). Measured: repolm512 Q4_K_M int8, 1.21e-2 at one
# (step, slot) where the plain paths read 5.6e-3 (chip run 4, PR 3).
SERVE_LOGIT_RTOL = {"bf16": REAL_LOGIT_RTOL, "int8": 2e-2}
# 8B 2-layer prefill logits, kernels on vs off on the card: the flash
# kernel rounds p to bf16 where the plain path keeps f32 probabilities (the
# JAX package's own kernel-vs-CPU spread on repolm512's prefill is 1.2e-2,
# experiments/logit_spread.py)
FULL_LOGIT_RTOL = 2e-2
# 8B 2-layer batched decode step, kernels on vs off on the card: a bf16
# cache differs only in f32 summation orders and the rare bf16 flip of an
# activation or a written row (2^-8 of a value); with an int8 cache the
# matmul kernels are held to the bf16 limit and the attention and append
# kernels, against plain attention over the exact dequantized values, to
# the JAX suite's int8 kernel-vs-jnp limit (2e-2). (Kernels on vs off with
# an int8 cache also compares the plain path's bf16 dequant of the codes
# with the kernel's exact scale fold: 1.42e-2 on the Q8_0 weights, 2.12e-2
# on Q4_K_M's; chip runs 4-6, PR 3.)
BATCHED_LOGIT_RTOL = {"bf16": 5e-3, "int8": 2e-2}
# logits of two paths over W4A8 / W8A8 weights that differ only in
# attention's summation order (the int8 part of the 8B 2-layer check): each
# product quantizes its activations to int8, and a code that an attention
# rounding moves across an edge moves the product by a whole int8 step of
# its row or group, through every later layer. Measured 4.7e-2 on the 8B
# W8A8 weights (H100 80GB HBM3 at 700 W), where the same check reads
# 9.9e-3 on Q8_0's; the matmul kernels themselves are bit-equal to their
# twins (0.0). It is also the floor of repolm512's end-to-end W8A8 checks
# (real, serve), whose limit is otherwise twice the card's plain path
# against the CPU: that plain path is now bit-equal to the CPU's (exact
# integer dots, IEEE row scales on both), so it measures no amplification,
# while the kernel path's flash roundings still cross int8 code edges
# (0.0082-0.0373 of the range, H100 80GB HBM3 at 700 W). The plain path
# read 0.0132-0.0698 while its row scales were divided through the
# reciprocal of 127 on the card.
WFORMAT_LOGIT_RTOL = 0.1
# the kernels each path launches: the single-stream Engine path, and the
# serving path (the batched step adds batched flash and, at B > 1, the
# in-place KV append)
ENGINE_KERNELS = ("q8_0_matmul", "flash_attention")
SERVE_KERNELS = ENGINE_KERNELS + ("batched_attention", "kv_update")
REPOLM = os.path.join(HERE, "models", "repolm512_q8.gguf")
SERVE_CHUNK = 128  # repolm512's admission chunk in the serve phase
PHASES = ("kernels", "bkernels", "qkernels", "real", "serve", "full",
          "bfull", "graphs", "qreal", "qfull", "wkernels", "wreal", "wfull",
          "cp", "cpcards", "tp", "tpcards", "dp", "dpcards", "pp", "cptp",
          "meshcards", "spec", "tiered", "moe", "ep", "http", "quality")

PROMPT = ("def rms_norm(x, weight, eps):\n"
          "    xf = x.astype(jnp.float32)\n"
          "    var = jnp.mean(xf * xf, axis=-1, keepdims=True)\n"
          "    return ")


def tp_shapes(fmt: str) -> list[tuple[str, int, int]]:
    """The 8B's tensor-parallel shard shapes (label, K, N) at tp = 2 and 4
    in format fmt: the column-split qkv and gate|up and the row-split wo,
    down and head. Q8_0 (the synthetic 8B of phase tp) takes them all; in
    Q4_K_M, Q4_K the first three and Q6_K the down and the head."""
    out = []
    for tp in (2, 4):
        for name, k, n, kq in (("qkv", 4096, 6144 // tp, "q4_k"),
                               ("gate|up", 4096, 28672 // tp, "q4_k"),
                               ("wo", 4096 // tp, 4096, "q4_k"),
                               ("down", 14336 // tp, 4096, "q6_k"),
                               ("head", 4096 // tp, 128256, "q6_k")):
            if fmt in ("q8_0", kq):
                out.append((f"8b tp{tp} {name}", k, n))
    return out


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


# ------------------------------------------------------------------ timing
class Timer:
    """Per-launch CUDA-event times with the L2 cache flushed before each
    launch (the main path reads every weight once per token)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8,
                                     device="cuda")

    def once(self, fn, iters: int) -> list[float]:
        torch = self.torch
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in pairs]

    def compare(self, fns: dict, iters: int = 5, rounds: int = 3) -> dict:
        """Median ms of each fn, timed in turns (a, b, c, a, b, c, ...)
        after one warm-up call each."""
        for fn in fns.values():
            fn()
        self.torch.cuda.synchronize()
        got = {k: [] for k in fns}
        for _ in range(rounds):
            for k, fn in fns.items():
                got[k] += self.once(fn, iters)
        return {k: sorted(v)[len(v) // 2] for k, v in got.items()}


def bound(nbytes: float, flops: float,
          peak: float = BF16_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def profile_calls(torch, fn, calls: int = 10, warm: int = 5,
                  tries: int = 20) -> dict:
    """Device time and count of every CUDA kernel that `calls` calls of fn
    launch (torch.profiler), per call, by kernel name.

    The profiler (torch 2.11, CUDA 12.8, H100) loses kernel records: in
    some processes the first two kernels after it starts tracing (a trace
    of 10 one-kernel calls after a one-call warm-up step read 9 in 58-60
    of 60 traces), and at random a few records or a whole trace (up to 15
    of 60 traces); it never adds one (`experiments/profiler_loss.py`).
    So each trace opens with a warm-up step of `warm` calls whose records
    are dropped; a trace is whole when it holds records and every kernel's
    count is a whole number a call; traces are taken until two whole ones
    agree, up to `tries`, and the fullest whole trace is returned ({} when
    none was whole)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    whole = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(warm):
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        out = {}
        for e in prof.key_averages():
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0:
                # kernels whose names share their first 80 characters (a
                # template's instances) are added up, not overwritten
                row = out.setdefault(e.key[:80], {"ms": 0.0, "per_call": 0.0})
                row["ms"] += e.self_device_time_total / 1e3 / calls
                row["per_call"] += e.count / calls
        if not out or any(v["per_call"] != int(v["per_call"])
                          for v in out.values()):
            continue
        counts = {k: v["per_call"] for k, v in out.items()}
        agree = any(counts == {k: v["per_call"] for k, v in w.items()}
                    for w in whole)
        whole.append(out)
        if agree:
            break
    return max(whole, key=lambda w: sum(v["per_call"] for v in w.values()),
               default={})


def device_profile(torch, fn, marker, calls: int = 10) -> dict:
    """profile_calls of fn, summed per call: the device ms of every CUDA
    kernel it launches and of those whose name holds `marker` (or, given a
    tuple, its first: the kernel's own), the number of CUDA kernels, and
    of those whose name holds any of the tuple's markers (the wrapper's
    launches, which its counter counts)."""
    prof = profile_calls(torch, fn, calls)
    marks = (marker,) if isinstance(marker, str) else marker
    own = {k: v for k, v in prof.items() if any(m in k for m in marks)}
    return {"device_ms": sum(v["ms"] for v in prof.values()),
            "kernel_device_ms": sum(v["ms"] for k, v in prof.items()
                                    if marks[0] in k),
            "kernels_per_call": sum(v["per_call"] for v in prof.values()),
            "own_kernels_per_call": sum(v["per_call"]
                                        for v in own.values())}


# ---------------------------------------------------------------- phase 2
def kernel_phase(torch, timer, card: str) -> tuple[dict, dict]:
    from ntransformer_tpu_torch.ops.cuda import attention as ca
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
    from ntransformer_tpu_torch.core.dtypes import DType
    import torch.nn.functional as F

    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    mm_cases = []
    shapes = [("8b qkv", 4096, 6144), ("8b wo", 4096, 4096),
              ("8b gate|up", 4096, 28672), ("8b head", 4096, 128256),
              ("8b down", 14336, 4096)] + tp_shapes("q8_0")
    for label, k, n in shapes:
        qs = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                           generator=g)
        scales = (torch.rand(k // 32, n, device="cuda", generator=g) * 0.01
                  + 1e-3)
        d = scales.to(torch.float16).view(torch.int16)
        w_bf16 = dequant_planes_torch({"qs": qs, "d": d}, DType.Q8_0, k, n,
                                      out_dtype=torch.bfloat16)
        # decode, the 8-slot server's step, the B = 32 step, a prompt
        # bucket, a prefill chunk; a shard shape decode and a prefill chunk
        for t in ((1, 512) if "tp" in label else (1, 8, 32, 70, 512)):
            mm_cases.append((f"{label} T={t}", t, qs, d, w_bf16))
    # a stacked [L, K, N] plane read through its free layer view
    qs2 = torch.randint(-127, 128, (2, 4096, 4096), dtype=torch.int8,
                        device="cuda", generator=g)
    d2 = (torch.rand(2, 128, 4096, device="cuda", generator=g) * 0.01
          + 1e-3).to(torch.float16).view(torch.int16)
    w2 = dequant_planes_torch({"qs": qs2[1], "d": d2[1]}, DType.Q8_0, 4096,
                              4096, out_dtype=torch.bfloat16)
    for t in (1, 70):
        mm_cases.append((f"8b stacked[1] 4096x4096 T={t}", t, qs2[1], d2[1],
                         w2))
    # repolm512's tied head: N = 384, not a multiple of 128
    qs3 = torch.randint(-127, 128, (512, 384), dtype=torch.int8,
                        device="cuda", generator=g)
    d3 = (torch.rand(16, 384, device="cuda", generator=g) * 0.01
          + 1e-3).to(torch.float16).view(torch.int16)
    w3 = dequant_planes_torch({"qs": qs3, "d": d3}, DType.Q8_0, 512, 384,
                              out_dtype=torch.bfloat16)
    for t in (1, 70):
        mm_cases.append((f"repolm512 head 512x384 T={t}", t, qs3, d3, w3))
    # N = 200, not a multiple of 16: the kernels' scalar (ragged) loads
    qs4, d4 = qs3[:, :200].contiguous(), d3[:, :200].contiguous()
    w4 = w3[:, :200].contiguous()
    for t in (1, 70):
        mm_cases.append((f"ragged 512x200 T={t}", t, qs4, d4, w4))

    mm_rows = []
    for label, t, qs, d, w in mm_cases:
        k, n = qs.shape
        x = torch.randn(t, k, device="cuda", generator=g).to(torch.bfloat16)
        before = cm.launches
        y = cm.quant_matmul_cuda(x, qs, d)
        per_call = cm.launches - before
        y0 = cm.quant_matmul_plain(x, qs, d)
        torch.cuda.synchronize()
        err = float((y - y0).abs().max())
        tol = MATMUL_RTOL * float(y0.abs().max())
        check(bool(torch.isfinite(y).all()), f"matmul {label}: non-finite")
        check(err <= tol, f"matmul {label}: max|kernel-plain| {err} > {tol}")
        ms = timer.compare({"kernel": lambda: cm.quant_matmul_cuda(x, qs, d),
                            "plain": lambda: cm.quant_matmul_plain(x, qs, d),
                            "library": lambda: torch.matmul(x, w)})
        b_ms, b_by = bound(k * n + (k // 32) * n * 2 + t * k * 2 + t * n * 4,
                           2.0 * t * k * n)
        check(per_call == 1, f"matmul {label}: {per_call} launches a "
              "call; want 1")
        row = {"shape": label, "T": t, "K": k, "N": n, "max_abs_err": err,
               "tol": tol, "ms": ms["kernel"], "plain_ms": ms["plain"],
               "library_ms": ms["library"], "bound_ms": b_ms,
               "bound_by": b_by, "launches_per_call": per_call}
        if "tp" not in label:
            # the call's CUDA kernels (torch.profiler): the kernel's own
            # and nothing else, as many as the launch counter counts (the
            # shard shapes run the same two kernels: no profile, for time)
            prof = profile_calls(torch,
                                 lambda: cm.quant_matmul_cuda(x, qs, d))
            mine = {kn: v for kn, v in prof.items()
                    if "skinny_kernel" in kn or "tile_kernel" in kn}
            check(mine == prof, f"matmul {label}: the wrapper launched "
                  f"other kernels: {prof}")
            check(sum(v["per_call"] for v in prof.values()) == per_call,
                  f"matmul {label}: the profiler saw {prof}, the counter "
                  f"{per_call} launches a call")
            row.update(device_ms=sum(v["ms"] for v in prof.values()),
                       kernels_per_call=sum(v["per_call"]
                                            for v in prof.values()))
        mm_rows.append(row)
        print(json.dumps({"matmul": row}), flush=True)

    fa_cases = []
    for t, p in ((64, 0), (64, 512), (64, 3584), (128, 0), (128, 512),
                 (128, 3584), (512, 0), (512, 512), (512, 3584)):
        fa_cases.append((f"8b T={t} pos={p}", t, 32, 8, 4096, 128, p,
                         torch.bfloat16, None, 0.0))
    # a TP shard's heads: 16 query and 4 KV heads at tp = 2, 8 and 2 at 4
    for tp in (2, 4):
        for p in (0, 3584):
            fa_cases.append((f"8b tp{tp} T=512 pos={p}", 512, 32 // tp,
                             8 // tp, 4096, 128, p, torch.bfloat16, None,
                             0.0))
    fa_cases += [
        ("8b T=70 pos=100", 70, 32, 8, 4096, 128, 100, torch.bfloat16, None,
         0.0),
        ("8b T=128 pos=512 window=256 softcap=50", 128, 32, 8, 4096, 128, 512,
         torch.bfloat16, 256, 50.0),
        ("repolm512 T=128 pos=0", 128, 8, 4, 512, 64, 0, torch.bfloat16, None,
         0.0)]
    # an f32 cache: no path of the port holds one, so the kernel's wrapper
    # refuses it on the card (the plain twin still takes it on the CPU)
    qf = torch.randn(128, 32, 128, device="cuda", generator=g)
    kf = torch.randn(8, 4096, 128, device="cuda", generator=g)
    try:
        ca.flash_attention_cuda(qf, kf, kf, 512, 128, 0.125)
        fail("flash: an f32 cache was not refused on the card")
    except ValueError as e:
        print(f"flash: f32 cache refused on the card ({e})", flush=True)
    del qf, kf
    fa_rows = []
    for label, t, hq, hkv, s, dh, p, dt, win, cap in fa_cases:
        q = torch.randn(t, hq, dh, device="cuda", generator=g)
        kc = torch.randn(hkv, s, dh, device="cuda", generator=g).to(dt)
        vc = torch.randn(hkv, s, dh, device="cuda", generator=g).to(dt)
        scale = 1.0 / math.sqrt(dh)
        kw = {"window": win, "softcap": cap}
        o = ca.flash_attention_cuda(q, kc, vc, p, t, scale, **kw)
        o0 = ca.flash_attention_plain(q, kc, vc, p, t, scale, **kw)
        torch.cuda.synchronize()
        err = float((o - o0).abs().max())
        row_rel = float(((o - o0).abs().amax(dim=(1, 2))
                         / o0.abs().amax(dim=(1, 2))).max())
        check(bool(torch.isfinite(o).all()), f"flash {label}: non-finite")
        check(row_rel <= FLASH_RTOL,
              f"flash {label}: a query row's max|kernel-plain| is {row_rel} "
              f"of its max|plain| (> {FLASH_RTOL}; max abs err {err})")
        # yardstick: SDPA with the same mask, heads expanded to Hq (SDPA
        # has no softcap, so a soft-capped case has none)
        qb = q.to(dt).transpose(0, 1)[None]
        kb = kc.repeat_interleave(hq // hkv, 0)[None]
        vb = vc.repeat_interleave(hq // hkv, 0)[None]
        kpos = torch.arange(s, device="cuda")[None, :]
        qpos = p + torch.arange(t, device="cuda")[:, None]
        mask = (kpos <= qpos) & (kpos > qpos - (win or s + t))
        fns = {"kernel": lambda: ca.flash_attention_cuda(q, kc, vc, p, t,
                                                         scale, **kw),
               "plain": lambda: ca.flash_attention_plain(q, kc, vc, p, t,
                                                         scale, **kw)}
        if not cap:
            fns["library"] = lambda: F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=mask, scale=scale)
        ms = timer.compare(fns)
        b_ms, b_by = flash_bound(t, hq, hkv, s, dh, p, win,
                                 kc.element_size())
        row = {"shape": label, "T": t, "pos": p, "Hq": hq, "Hkv": hkv,
               "S": s, "D": dh, "max_abs_err": err, "row_rel_err": row_rel,
               "tol": FLASH_RTOL,
               "window": win, "softcap": cap,
               "ms": ms["kernel"], "plain_ms": ms["plain"],
               "library_ms": ms.get("library"), "bound_ms": b_ms,
               "bound_by": b_by}
        if label == "8b T=512 pos=0":  # row 2's main shape
            row.update(device_profile(torch, fns["kernel"],
                                      "flash_fwd_kernel"))
        fa_rows.append(row)
        print(json.dumps({"flash": row}), flush=True)
        del q, kc, vc, qb, kb, vb
    fa_rows += [flash_device_pos_row(torch, timer, g, p) for p in (0, 3584)]
    print(f"kernel phase done on {card}", flush=True)
    return ({"rows": mm_rows, "main": "8b gate|up T=1"},
            {"rows": fa_rows, "main": "8b T=512 pos=0"})


def flash_bound(t: int, hq: int, hkv: int, s: int, dh: int, p: int, win,
                esz: int) -> tuple[float, str]:
    """The least time of a flash call: q, the visible keys and values and
    the f32 output once each, or 4 D flops a head for every visible
    (query, key) pair at the bf16 peak."""
    w_eff = win or s + t
    keys = min(s, p + t) - max(0, p + 1 - w_eff)
    visible = sum(min(p + i + 1, w_eff) for i in range(t))
    return bound(t * hq * dh * esz + 2 * keys * hkv * dh * esz
                 + t * hq * dh * 4, 4.0 * hq * dh * visible)


def flash_device_pos_row(torch, timer, g, p: int) -> dict:
    """Row 2's device-offset form (the offset an int64 on the card that
    each block reads: the form the captured prefill launches) at the main
    shape (T = 512, Hq 32, Hkv 8, D 128, S 4096) at pos p: bit-equal to the
    host-int form, within FLASH_RTOL of the plain twin in every query row,
    one launch a call; the two forms, the twin and SDPA timed in turns,
    the device form's profiler device time."""
    import torch.nn.functional as F
    from ntransformer_tpu_torch.ops.cuda import attention as ca
    t, hq, hkv, s, dh = 512, 32, 8, 4096, 128
    label = f"8b T={t} pos={p} device pos"
    q = torch.randn(t, hq, dh, device="cuda", generator=g)
    kc = torch.randn(hkv, s, dh, device="cuda", generator=g).to(torch.bfloat16)
    vc = torch.randn(hkv, s, dh, device="cuda", generator=g).to(torch.bfloat16)
    pd = torch.tensor(p, device="cuda")
    scale = 1.0 / math.sqrt(dh)
    before = ca.launches
    o = ca.flash_attention_cuda(q, kc, vc, pd, t, scale)
    per_call = ca.launches - before
    oh = ca.flash_attention_cuda(q, kc, vc, p, t, scale)
    o0 = ca.flash_attention_plain(q, kc, vc, p, t, scale)
    torch.cuda.synchronize()
    check(torch.equal(o, oh), f"flash {label}: the device-offset form "
          "differs from the host-int form")
    err = float((o - o0).abs().max())
    row_rel = float(((o - o0).abs().amax(dim=(1, 2))
                     / o0.abs().amax(dim=(1, 2))).max())
    check(bool(torch.isfinite(o).all()) and row_rel <= FLASH_RTOL,
          f"flash {label}: a query row's max|kernel-plain| is {row_rel} of "
          f"its max|plain| (> {FLASH_RTOL}; max abs err {err})")
    check(per_call == 1, f"flash {label}: {per_call} launches a call")
    qb = q.to(torch.bfloat16).transpose(0, 1)[None]
    kb = kc.repeat_interleave(hq // hkv, 0)[None]
    vb = vc.repeat_interleave(hq // hkv, 0)[None]
    mask = (torch.arange(s, device="cuda")[None, :]
            <= p + torch.arange(t, device="cuda")[:, None])
    fns = {"kernel": lambda: ca.flash_attention_cuda(q, kc, vc, pd, t, scale),
           "host_form": lambda: ca.flash_attention_cuda(q, kc, vc, p, t,
                                                        scale),
           "plain": lambda: ca.flash_attention_plain(q, kc, vc, p, t, scale),
           "library": lambda: F.scaled_dot_product_attention(
               qb, kb, vb, attn_mask=mask, scale=scale)}
    ms = timer.compare(fns)
    b_ms, b_by = flash_bound(t, hq, hkv, s, dh, p, None, 2)
    row = {"shape": label, "T": t, "pos": p, "Hq": hq, "Hkv": hkv, "S": s,
           "D": dh, "max_abs_err": err, "row_rel_err": row_rel,
           "tol": FLASH_RTOL, "bit_equal_to_host_form": True,
           "launches_per_call": per_call, "ms": ms["kernel"],
           "host_form_ms": ms["host_form"], "plain_ms": ms["plain"],
           "library_ms": ms["library"], "bound_ms": b_ms, "bound_by": b_by,
           **device_profile(torch, fns["kernel"], "flash_fwd_kernel")}
    print(json.dumps({"flash": row}), flush=True)
    return row


def batched_kernel_phase(torch, timer, card: str) -> tuple[dict, dict]:
    """The serving path's kernels against their plain twins at the 8B
    shapes (Hq 32, Hkv 8, D 128): batched flash decode/verify over a stacked
    2-layer cache, and the in-place KV append at L = 32 (B = 8 bf16 and
    int8 at S 4096, the 8-slot server's; B = 32 int8 at S 1024) and at one
    layer (append_rows, B = 8 bf16)."""
    from ntransformer_tpu_torch.ops.cuda import batched_attention as cb
    from ntransformer_tpu_torch.ops.cuda import kv_update as ck
    import torch.nn.functional as F

    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    hq, hkv, dh = 32, 8, 128
    scale = 1.0 / math.sqrt(dh)
    # label, B, S, T, int8, positions, active, window, softcap, s_live
    cases = [
        ("8b B=1 bf16 S=1024 pos=1000", 1, 1024, 1, False, [1000], None,
         None, 0.0, None),
        ("8b B=1 bf16 S=4096 pos=4000", 1, 4096, 1, False, [4000], None,
         None, 0.0, None),
        ("8b B=8 bf16 S=4096", 8, 4096, 1, False,
         [0, 7, 130, 1000, 2047, 2500, 3333, 4090], None, None, 0.0, None),
        ("8b B=32 int8 S=1024 pos 512-600, slot 5 inactive", 32, 1024, 1,
         True, [512 + (37 * i) % 89 for i in range(32)],
         [i != 5 for i in range(32)], None, 0.0, None),
        ("8b B=32 int8 S=1024 s_live=640", 32, 1024, 1, True,
         [512 + (37 * i) % 89 for i in range(32)],
         [i != 5 for i in range(32)], None, 0.0, 640),
        ("8b B=8 bf16 verify T=4, slot 2 inactive", 8, 4096, 4, False,
         [3, 64, 500, 1023, 2000, 2999, 3500, 4000],
         [i != 2 for i in range(8)], None, 0.0, None),
        ("8b B=32 int8 verify T=4", 32, 1024, 4, True,
         [512 + (37 * i) % 89 for i in range(32)],
         [i != 5 for i in range(32)], None, 0.0, None),
        ("8b B=8 bf16 window=256 softcap=50", 8, 4096, 1, False,
         [10, 255, 256, 700, 1500, 2600, 3900, 4095],
         [i != 3 for i in range(8)], 256, 50.0, None),
    ]
    # the local shapes of a (dp, tp) mesh's groups: B/dp = 4 and 16 slots,
    # the 8B's heads at tp = 2 (Hq 16, Hkv 4) and 4 (Hq 8, Hkv 2)
    for b_n in (4, 16):
        for heads in ((16, 4), (8, 2)):
            for int8 in (False, True):
                cases.append(
                    (f"8b mesh-local B={b_n} {'int8' if int8 else 'bf16'} "
                     f"S=1024 Hq {heads[0]} Hkv {heads[1]}", b_n, 1024, 1,
                     int8, [512 + (37 * i) % 89 for i in range(b_n)], None,
                     None, 0.0, None, heads))
    # a PP microbatch's shapes: B/M = 4 slots of the 8-slot server, every
    # head, a stage's cache
    for int8 in (False, True):
        cases.append((f"8b pp-local B=4 {'int8' if int8 else 'bf16'} "
                      f"S=4096", 4, 4096, 1, int8, [300, 40, 64, 9], None,
                      None, 0.0, None))
    att_rows = []
    for case in cases:
        label, b_n, s, t, int8, pos_l, act_l, win, cap, s_live = case[:10]
        hq, hkv = case[10] if len(case) > 10 else (32, 8)
        layers = 2
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        # int32 pos and active, as the batched steps pass them
        act = torch.tensor([True] * b_n if act_l is None else act_l,
                           device="cuda").to(torch.int32)
        shape = (layers, b_n, hkv, s, dh)
        if int8:
            kc = torch.randint(-127, 128, shape, dtype=torch.int8,
                               device="cuda", generator=g)
            vc = torch.randint(-127, 128, shape, dtype=torch.int8,
                               device="cuda", generator=g)
            ks = torch.rand(shape[:-1], device="cuda", generator=g) * 0.02
            vs = torch.rand(shape[:-1], device="cuda", generator=g) * 0.02
            kn = torch.randint(-127, 128, (b_n, hkv, t, dh),
                               dtype=torch.int8, device="cuda", generator=g)
            vn = torch.randint(-127, 128, (b_n, hkv, t, dh),
                               dtype=torch.int8, device="cuda", generator=g)
            kns = torch.rand(b_n, hkv, t, device="cuda", generator=g) * 0.02
            vns = torch.rand(b_n, hkv, t, device="cuda", generator=g) * 0.02
            kcache, vcache = (kc, ks), (vc, vs)
            knew, vnew = (kn, kns), (vn, vns)
        else:
            kc = torch.randn(shape, device="cuda", generator=g).to(
                torch.bfloat16)
            vc = torch.randn(shape, device="cuda", generator=g).to(
                torch.bfloat16)
            kn = torch.randn(b_n, hkv, t, dh, device="cuda", generator=g)
            vn = torch.randn(b_n, hkv, t, dh, device="cuda", generator=g)
            kcache, vcache, knew, vnew = kc, vc, kn, vn
        q = torch.randn((b_n, hq, dh) if t == 1 else (b_n, t, hq, dh),
                        device="cuda", generator=g)
        fn = cb.flash_decode_batched if t == 1 else cb.flash_verify_batched
        kw = dict(layer=1, active=act, window=win, softcap=cap,
                  s_live=s_live)

        def kern():
            return fn(q, kcache, vcache, knew, vnew, pos, scale, **kw)

        def plain():
            qq = q[:, None] if t == 1 else q
            qr = (qq.reshape(b_n, t, hkv, hq // hkv, dh).permute(0, 2, 1, 3, 4)
                  .reshape(b_n, hkv, t * hq // hkv, dh))
            o = cb.batched_flash_plain(
                qr, kc, vc, kcache[1] if int8 else None,
                vcache[1] if int8 else None,
                kn if int8 else kn.to(torch.bfloat16),
                vn if int8 else vn.to(torch.bfloat16),
                kns if int8 else None, vns if int8 else None, pos, act,
                layer=1, scale=scale,
                window=cb.NO_WINDOW if win is None else win, softcap=cap,
                s_live=s if s_live is None else s_live, group=hq // hkv)
            return (o.reshape(b_n, hkv, t, hq // hkv, dh)
                    .permute(0, 2, 1, 3, 4).reshape(q.shape))
        o = kern()
        o0 = plain()
        if s_live is not None:  # the bucket's contract: equal to full S
            o_full = fn(q, kcache, vcache, knew, vnew, pos, scale,
                        **dict(kw, s_live=None))
            torch.cuda.synchronize()
            check(torch.equal(o, o_full), f"batched flash {label}: s_live "
                  f"result differs from the full-S result")
        torch.cuda.synchronize()
        err = float((o - o0).abs().max())
        per_tok = (o - o0).abs().reshape(b_n, t, -1).amax(-1) / \
            o0.abs().reshape(b_n, t, -1).amax(-1)
        row_rel = float(per_tok.max())
        check(bool(torch.isfinite(o).all()), f"batched flash {label}: "
              "non-finite")
        check(row_rel <= BATCHED_RTOL,
              f"batched flash {label}: a query row's max|kernel-plain| is "
              f"{row_rel} of its max|plain| (> {BATCHED_RTOL})")
        # yardstick: SDPA over the layer's bf16 cache (dequantized for int8)
        # with the new rows written in, heads expanded, the same mask
        if int8:
            kf = (kc[1].to(torch.float32) * ks[1][..., None]).to(
                torch.bfloat16)
            vf = (vc[1].to(torch.float32) * vs[1][..., None]).to(
                torch.bfloat16)
            knf = (kn.to(torch.float32) * kns[..., None]).to(torch.bfloat16)
            vnf = (vn.to(torch.float32) * vns[..., None]).to(torch.bfloat16)
        else:
            kf, vf = kc[1].clone(), vc[1].clone()
            knf, vnf = kn.to(torch.bfloat16), vn.to(torch.bfloat16)
        kpos = torch.arange(s, device="cuda")
        qpos = pos.long()[:, None] + torch.arange(t, device="cuda")
        for bi in range(b_n):
            if act_l is None or act_l[bi]:
                p0 = pos_l[bi]
                kf[bi, :, p0:p0 + t] = knf[bi]
                vf[bi, :, p0:p0 + t] = vnf[bi]
        mask = kpos[None, None, :] <= qpos[:, :, None]
        if win is not None:
            mask &= kpos[None, None, :] > qpos[:, :, None] - win
        qb = (q[:, None] if t == 1 else q).transpose(1, 2).to(torch.bfloat16)
        kb = kf.repeat_interleave(hq // hkv, 1)
        vb = vf.repeat_interleave(hq // hkv, 1)
        fns = {"kernel": kern, "plain": plain}
        if not cap:
            fns["library"] = lambda: F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=mask[:, None], scale=scale)
        ms = timer.compare(fns)
        # the call's CUDA kernels (torch.profiler) against the counter
        before = cb.launches_by_dot["f32"]
        kern()
        per_call = cb.launches_by_dot["f32"] - before
        prof = device_profile(torch, kern, ("split_kernel", "combine_kernel"))
        check(prof["own_kernels_per_call"] == per_call,
              f"batched flash {label}: the profiler saw "
              f"{prof['own_kernels_per_call']} of its kernels a call, the "
              f"counter {per_call}")
        keys = 0
        for bi in range(b_n):
            a = act_l is None or act_l[bi]
            last = min(pos_l[bi] - 1 if a else pos_l[bi] + t - 1,
                       (s_live or s) - 1)
            first = max(0, pos_l[bi] - (win or cb.NO_WINDOW) + 1)
            keys += max(0, last - first + 1)
        esz = 1 if int8 else 2
        per_key = 2 * hkv * dh * esz + (2 * hkv * 4 if int8 else 0)
        new_rows = 2 * b_n * hkv * t * (dh * esz + (4 if int8 else 0))
        nbytes = (keys * per_key + new_rows + q.numel() * 4
                  + q.numel() * 4 + 2 * b_n * 4)
        flops = 4.0 * (hq // hkv) * t * dh * hkv * (keys + b_n * t)
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        row = {"shape": label, "B": b_n, "S": s, "T": t, "int8": int8,
               "Hq": hq, "Hkv": hkv,
               "window": win, "softcap": cap, "s_live": s_live,
               "live_keys": keys, "max_abs_err": err, "row_rel_err": row_rel,
               "tol": BATCHED_RTOL, "ms": ms["kernel"],
               "plain_ms": ms["plain"], "library_ms": ms.get("library"),
               "bound_ms": b_ms, "bound_by": b_by,
               "launches_per_call": per_call, **prof}
        att_rows.append(row)
        print(json.dumps({"batched_flash": row}), flush=True)
        del kc, vc, kcache, vcache, kf, vf, kb, vb

    app_rows = []
    for label, layers, b_n, int8, stacked, hkv in (
            ("8b L=32 B=8 bf16", 32, 8, False, True, 8),
            ("8b L=32 B=8 int8 codes+scales S 4096", 32, 8, True, True, 8),
            ("8b L=32 B=32 int8 codes+scales", 32, 32, True, True, 8),
            ("8b append_rows one layer B=8 bf16", 1, 8, False, False, 8),
            # a (dp, tp) mesh group's cache: B/dp = 4 slots, Hkv/tp = 4
            ("8b mesh-local L=32 B=4 bf16 Hkv 4", 32, 4, False, True, 4),
            ("8b mesh-local L=32 B=4 int8 Hkv 4 S 1024", 32, 4, True, True,
             4),
            # a PP stage's cache: L/S = 16 and 8 layers, B/M = 4 slots
            ("8b pp-stage L=16 B=4 bf16 S 4096", 16, 4, False, True, 8),
            ("8b pp-stage L=8 B=4 int8 S 1024", 8, 4, True, True, 8)):
        s = 4096 if not int8 or b_n == 8 else 1024
        pos_l = [(977 * i + 13) % s for i in range(b_n)]
        act_l = [i % 7 != 3 for i in range(b_n)]
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        # int32 on the card, as the batched step hands them over
        act = torch.tensor(act_l, device="cuda").to(torch.int32)
        shape = (layers, b_n, hkv, s, dh)
        if int8:
            caches = [torch.randint(-127, 128, shape, dtype=torch.int8,
                                    device="cuda", generator=g)
                      for _ in range(2)]
            caches += [torch.rand(shape[:-1], device="cuda", generator=g)
                       for _ in range(2)]
            rows = [torch.randint(-127, 128, (layers, b_n, hkv, 1, dh),
                                  dtype=torch.int8, device="cuda",
                                  generator=g) for _ in range(2)]
            rows += [torch.rand(layers, b_n, hkv, 1, 1, device="cuda",
                                generator=g) for _ in range(2)]
        else:
            caches = [torch.randn(shape, device="cuda", generator=g).to(
                torch.bfloat16) for _ in range(2)]
            rows = [torch.randn(layers, b_n, hkv, 1, dh, device="cuda",
                                generator=g) for _ in range(2)]
        if not stacked:
            caches = [c[0] for c in caches]
            rows = [r[0] for r in rows]
        ref = [c.clone() for c in caches]
        launch = ck.append_rows_stacked if stacked else ck.append_rows
        plain_fn = (ck.append_rows_stacked_plain if stacked
                    else ck.append_rows_plain)
        launch(caches, rows, pos, act)
        plain_fn(ref, rows, pos, act)
        torch.cuda.synchronize()
        for c, r in zip(caches, ref):
            check(torch.equal(c, r), f"kv append {label}: kernel and plain "
                  "twin differ")
        # yardstick: one advanced-index assignment per cache
        sel = torch.tensor([i for i in range(b_n) if act_l[i]],
                           device="cuda")
        psel = pos.long()[sel]
        lib_rows = []
        for c, r in zip(caches, rows):
            codes = c.dim() == (5 if stacked else 4)
            rr = r.reshape(tuple(r.shape[:-2])
                           + ((r.shape[-1],) if codes else ())).to(c.dtype)
            lib_rows.append(rr[:, sel].movedim(1, 0) if stacked
                            else rr[sel])

        def library():
            for c, rr in zip(caches, lib_rows):
                if stacked:
                    c[:, sel, :, psel] = rr
                else:
                    c[sel, :, psel] = rr
        ms = timer.compare({"kernel": lambda: launch(caches, rows, pos, act),
                            "plain": lambda: plain_fn(caches, rows, pos, act),
                            "library": library})
        before = ck.launches
        launch(caches, rows, pos, act)
        per_call = ck.launches - before
        prof = device_profile(torch, lambda: launch(caches, rows, pos, act),
                              "kv_append")
        check(prof["own_kernels_per_call"] == per_call == 1,
              f"kv append {label}: the profiler saw "
              f"{prof['own_kernels_per_call']} of its kernels a call, the "
              f"counter {per_call}; want 1")
        n_act = sum(act_l)
        # the kernel reads and writes the active slots' rows only
        rows_in = sum(r.numel() // b_n * n_act * r.element_size()
                      for r in rows)
        written = sum(r.numel() // b_n * n_act * c.element_size()
                      for c, r in zip(caches, rows))
        b_ms, b_by = bound(rows_in + written + 2 * b_n * 4, 0.0)
        row = {"shape": label, "L": layers, "B": b_n, "S": s, "int8": int8,
               "Hkv": hkv, "max_abs_err": 0.0, "tol": "bit-equal",
               "ms": ms["kernel"],
               "plain_ms": ms["plain"], "library_ms": ms["library"],
               "bound_ms": b_ms, "bound_by": b_by,
               "launches_per_call": per_call, **prof}
        app_rows.append(row)
        print(json.dumps({"kv_append": row}), flush=True)
        del caches, ref, rows, lib_rows
    print(f"batched kernel phase done on {card}", flush=True)
    return ({"rows": att_rows, "main": "8b B=32 int8 S=1024 pos 512-600, "
                                       "slot 5 inactive"},
            {"rows": app_rows, "main": "8b L=32 B=32 int8 codes+scales"})


# the cache-dot forms of batched flash (dot_impl), kernel against its plain
# twin, for every query token: max|kernel-plain| <= DOT_RTOL * max|plain|.
# "int8_s" computes from the same values as "f32" (its integer score dot is
# exact): BATCHED_RTOL. The forms that round p per key block can turn a
# 1-ulp difference in a score or an exp into one rounding of p that goes the
# other way: an int8 code of p * vs by a step (1/127 of its block's largest),
# a bf16 p by an ulp (2^-8 of itself); the CPU tests measured up to 2.05e-3
# (int8_v) and 3.9e-4 (bf16) of the output against the JAX kernel, and the
# card 1.6e-6 and 2.1e-3 on a first kernel that started each block from its
# own max (H100 80GB HBM3, 700 W).
DOT_FORMS = ("int8", "int8_s", "int8_v", "bf16")
DOT_RTOL = {"f32": BATCHED_RTOL, "int8_s": BATCHED_RTOL, "int8": 4e-3,
            "int8_v": 4e-3, "bf16": 1e-3}


def verify_case(torch, g, b_n: int, s: int, t: int, int8: bool, pos_l,
                act_l=None, s_live=None, heads=(32, 8)):
    """A batched flash verify call at the 8B widths (heads = (Hq, Hkv):
    32 and 8 unsharded, D 128) over a random 2-layer bf16 or int8 cache
    (layer 1 attended), B slots at positions pos_l with T new rows each.
    Returns (kern(dot), plain(dot), library(), bytes, operations, live
    keys): the kernel (s_live as given unless overridden), its plain twin,
    SDPA over the layer's bf16 cache (dequantized for int8) with the new
    rows written in and the same mask, and the work a call must do."""
    from ntransformer_tpu_torch.ops.cuda import batched_attention as cb
    import torch.nn.functional as F
    (hq, hkv), dh = heads, 128
    scale = 1.0 / math.sqrt(dh)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    act = torch.tensor([True] * b_n if act_l is None else act_l,
                       device="cuda").to(torch.int32)
    shape = (2, b_n, hkv, s, dh)
    if int8:
        kc, vc = (torch.randint(-127, 128, shape, dtype=torch.int8,
                                device="cuda", generator=g)
                  for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], device="cuda", generator=g)
                  * 0.02 for _ in range(2))
        kn, vn = (torch.randint(-127, 128, (b_n, hkv, t, dh),
                                dtype=torch.int8, device="cuda",
                                generator=g) for _ in range(2))
        kns, vns = (torch.rand(b_n, hkv, t, device="cuda", generator=g)
                    * 0.02 for _ in range(2))
        kcache, vcache, knew, vnew = (kc, ks), (vc, vs), (kn, kns), \
            (vn, vns)
    else:
        kc, vc = (torch.randn(shape, device="cuda", generator=g).to(
            torch.bfloat16) for _ in range(2))
        kn, vn = (torch.randn(b_n, hkv, t, dh, device="cuda",
                              generator=g) for _ in range(2))
        ks = vs = kns = vns = None
        kcache, vcache, knew, vnew = kc, vc, kn, vn
    q = torch.randn((b_n, t, hq, dh), device="cuda", generator=g)
    qr = (q.reshape(b_n, t, hkv, hq // hkv, dh).permute(0, 2, 1, 3, 4)
          .reshape(b_n, hkv, t * hq // hkv, dh))
    live = s if s_live is None else s_live

    def kern(dot, s_live=s_live):
        return cb.flash_verify_batched(q, kcache, vcache, knew, vnew, pos,
                                       scale, layer=1, active=act,
                                       s_live=s_live, dot_impl=dot)

    def plain(dot):
        o = cb.batched_flash_plain(
            qr, kc, vc, ks, vs, kn if int8 else kn.to(torch.bfloat16),
            vn if int8 else vn.to(torch.bfloat16), kns, vns, pos, act,
            layer=1, scale=scale, window=cb.NO_WINDOW, softcap=0.0,
            s_live=live, group=hq // hkv, dot_impl=dot)
        return (o.reshape(b_n, hkv, t, hq // hkv, dh)
                .permute(0, 2, 1, 3, 4).reshape(q.shape))

    deq = (lambda c, sc: (c.float() * sc[..., None]).to(torch.bfloat16)) \
        if int8 else (lambda c, sc: c.to(torch.bfloat16))
    kf, vf = deq(kc[1], ks[1] if int8 else None), \
        deq(vc[1], vs[1] if int8 else None)
    knf, vnf = deq(kn, kns), deq(vn, vns)
    for bi in range(b_n):
        if act_l is None or act_l[bi]:
            kf[bi, :, pos_l[bi]:pos_l[bi] + t] = knf[bi]
            vf[bi, :, pos_l[bi]:pos_l[bi] + t] = vnf[bi]
    kpos = torch.arange(s, device="cuda")
    qpos = pos.long()[:, None] + torch.arange(t, device="cuda")
    mask = kpos[None, None, :] <= qpos[:, :, None]
    qb = q.transpose(1, 2).to(torch.bfloat16)
    kb = kf.repeat_interleave(hq // hkv, 1)
    vb = vf.repeat_interleave(hq // hkv, 1)

    def library():
        return F.scaled_dot_product_attention(qb, kb, vb,
                                              attn_mask=mask[:, None],
                                              scale=scale)
    keys = sum(max(0, min(pos_l[bi] - 1 if (act_l is None or act_l[bi])
                          else pos_l[bi] + t - 1, live - 1) + 1)
               for bi in range(b_n))
    esz = 1 if int8 else 2
    nbytes = (keys * (2 * hkv * dh * esz + (2 * hkv * 4 if int8 else 0))
              + 2 * b_n * hkv * t * (dh * esz + (4 if int8 else 0))
              + 2 * q.numel() * 4 + 2 * b_n * 4)
    ops = 4.0 * (hq // hkv) * t * dh * hkv * (keys + b_n * t)
    return kern, plain, library, nbytes, ops, keys


def dot_kernel_phase(torch, timer, card: str) -> dict:
    """The batched flash kernel's cache-dot forms against their plain twins
    and against the f32 kernel at the 8B shapes (Hq 32, Hkv 8, D 128): B =
    32 int8 at positions 512-600 with an inactive slot, B = 1, a T = 4
    verify window at B = 8, "bf16" on a bf16 cache, and an s_live of 2176
    (17 key blocks of 128). Times in turns with the twin and SDPA over the
    dequantized cache, as the f32 rows."""
    from ntransformer_tpu_torch.ops.cuda import batched_attention as cb
    g = torch.Generator(device="cuda")
    g.manual_seed(5150)
    pos32 = [512 + (37 * i) % 89 for i in range(32)]
    # label, B, S, T, int8 cache, positions, active, s_live
    cases = [
        ("8b B=32 int8 S=1024 pos 512-600, slot 5 inactive", 32, 1024, 1,
         True, pos32, [i != 5 for i in range(32)], None),
        ("8b B=1 int8 S=1024 pos=700", 1, 1024, 1, True, [700], None, None),
        ("8b B=8 int8 verify T=4, slot 2 inactive", 8, 1024, 4, True,
         [3, 64, 500, 900, 1000, 700, 200, 1019],
         [i != 2 for i in range(8)], None),
        ("8b B=8 bf16 S=4096", 8, 4096, 1, False,
         [0, 7, 130, 1000, 2047, 2500, 3333, 4090], None, None),
        ("8b B=4 int8 S=4096 s_live=2176", 4, 4096, 1, True,
         [2100, 1500, 2175, 2000], [True, False, True, True], 2176),
    ]
    # a (dp, tp) mesh group's local shapes: every slot count (B/dp = 4,
    # 16) and head split (tp = 2: Hq 16 Hkv 4; tp = 4: Hq 8 Hkv 2) once
    # with the int8 forms and once with "bf16"
    for b_n, heads, int8 in ((4, (16, 4), True), (16, (8, 2), True),
                             (16, (16, 4), False), (4, (8, 2), False)):
        cases.append((f"8b mesh-local B={b_n} "
                      f"{'int8' if int8 else 'bf16'} S=1024 Hq {heads[0]} "
                      f"Hkv {heads[1]}", b_n, 1024, 1, int8,
                      [512 + (37 * i) % 89 for i in range(b_n)], None, None,
                      heads))
    rows = {f: [] for f in DOT_FORMS}
    for case in cases:
        label, b_n, s, t, int8, pos_l, act_l, s_live = case[:8]
        heads = case[8] if len(case) > 8 else (32, 8)
        kern, plain, library, nbytes, ops, keys = verify_case(
            torch, g, b_n, s, t, int8, pos_l, act_l, s_live, heads)
        o32 = kern("f32")
        for dot in DOT_FORMS:
            if not int8 and dot != "bf16":
                continue  # an int8 form on a bf16 cache is the f32 kernel
            o, o0 = kern(dot), plain(dot)
            torch.cuda.synchronize()
            per_tok = ((o - o0).abs().reshape(b_n, t, -1).amax(-1)
                       / o0.abs().reshape(b_n, t, -1).amax(-1))
            rel = float(per_tok.max())
            vs_f32 = float((o - o32).abs().max() / o32.abs().max())
            check(bool(torch.isfinite(o).all()),
                  f"batched flash {dot} {label}: non-finite")
            check(rel <= DOT_RTOL[dot],
                  f"batched flash {dot} {label}: a query token's "
                  f"max|kernel-plain| is {rel} of its max|plain| "
                  f"(> {DOT_RTOL[dot]})")
            check(vs_f32 > 0.0, f"batched flash {dot} {label}: equal to the "
                  "f32 kernel, so the form did not run")
            ms = timer.compare({"kernel": lambda: kern(dot),
                                "plain": lambda: plain(dot),
                                "library": library})
            peak = {"int8": INT8_OPS, "bf16": BF16_FLOPS}.get(dot, F32_FLOPS)
            b_ms, b_by = bound(nbytes, ops, peak)
            before = cb.launches_by_dot[dot]
            kern(dot)
            per_call = cb.launches_by_dot[dot] - before
            # device time at the main shape and at 17 key blocks
            prof = device_profile(
                torch, lambda: kern(dot),
                ("split_kernel" if dot == "int8_s" else "group_kernel",
                 "combine_kernel")) \
                if label in (cases[0][0], cases[4][0]) else {}
            check(not prof or prof["own_kernels_per_call"] == per_call,
                  f"batched flash {dot} {label}: the profiler saw "
                  f"{prof.get('own_kernels_per_call')} of its kernels a "
                  f"call, the counter {per_call}")
            if dot == "int8_s" and label == cases[0][0]:
                # the split form's bucket contract: bit-equal to full S
                ob = kern(dot, s_live=640)
                torch.cuda.synchronize()
                check(torch.equal(o, ob), f"batched flash {dot} {label}: "
                      "the s_live 640 result differs from the full-S one")
            row = {"shape": label, "dot_impl": dot, "B": b_n, "S": s, "T": t,
                   "int8": int8, "Hq": heads[0], "Hkv": heads[1],
                   "s_live": s_live, "live_keys": keys,
                   "max_abs_err": float((o - o0).abs().max()),
                   "row_rel_err": rel, "tol": DOT_RTOL[dot],
                   "rel_to_f32_kernel": vs_f32, "ms": ms["kernel"],
                   "plain_ms": ms["plain"], "library_ms": ms["library"],
                   "bound_ms": b_ms, "bound_by": b_by,
                   "launches_per_call": per_call, **prof}
            rows[dot].append(row)
            print(json.dumps({"batched_flash_dot": row}), flush=True)
        del kern, plain, library
    print(f"batched flash cache-dot phase done on {card}", flush=True)
    main = cases[0][0]
    return {f"{cb.NAME}[{dot}]": {"rows": r, "main": main}
            for dot, r in rows.items()}


# ---------------------------------------------------------------- phase 3
def greedy_pass(engine, torch, ids, n: int, forced=None,
                plain_decode: bool = False):
    """Prefill `ids`, then n greedy steps (or steps fed with `forced`);
    plain_decode runs the decode steps with the kernels off. Returns
    (tokens, [logits of each step as f32 CPU tensors])."""
    from ntransformer_tpu_torch.ops import linear
    kv = engine._make_kv()
    logits, kv, _ = engine._prefill(kv, ids)
    toks, out = [], [logits[0].float().cpu()]
    pos = len(ids)
    if plain_decode:
        linear.KERNEL_MODE = "off"
    try:
        for i in range(n):
            tok = int(torch.argmax(out[-1])) if forced is None else forced[i]
            toks.append(tok)
            logits, kv, _ = engine._decode_step(kv, tok, pos + i)
            out.append(logits[0].float().cpu())
    finally:
        linear.KERNEL_MODE = "auto"
    return toks, out


def layer_by_layer(torch, engine, ids) -> dict:
    """Each layer of the kernel path against the plain path on the card,
    both fed the plain path's input and cache: the bucketed prefill of
    `ids`, then one decode step. Returns the worst max|d| / max|plain| of a
    layer's output rows, per phase. In a mixture-of-experts model the
    kernel path replays the plain path's routing (RouteTape), so every row
    is held; the rows it would have routed differently are printed."""
    from ntransformer_tpu_torch.inference.engine import _bucket
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.ops import linear
    arch, w = engine.arch, engine.model.weights
    n = len(ids)
    padded = torch.zeros(_bucket(n), dtype=torch.long)
    padded[:n] = torch.tensor(ids)
    kv = llama.KVCache.create(arch, device="cuda")
    worst = {}
    with torch.inference_mode():
        for phase, toks, pos, n_valid in (("prefill", padded, 0, n),
                                          ("decode", None, n, None)):
            if toks is None:
                toks = torch.argmax(logits[0]).reshape(1).cpu()
            x, cos_t, sin_t = llama.embed_positions(arch, w, toks.cuda(), pos)
            rows = x.shape[0] if n_valid is None else n_valid
            worst[phase] = 0.0
            for li in range(arch.n_layers):
                kk, vv = kv.k[li].clone(), kv.v[li].clone()
                tape = RouteTape()
                linear.KERNEL_MODE = "off"
                try:
                    with tape.record():
                        y0 = llama.layer_step(arch, x, w.layers, kv.k[li],
                                              kv.v[li], pos, cos_t, sin_t,
                                              n_valid, layer=li)
                finally:
                    linear.KERNEL_MODE = "auto"
                with tape.replay():
                    y = llama.layer_step(arch, x, w.layers, kk, vv, pos,
                                         cos_t, sin_t, n_valid, layer=li)
                if arch.n_experts:
                    print(f"layer {li} {phase}: the kernel path would route "
                          f"{tape.flips['rows']} of {tape.flips['of']} rows "
                          f"(padding included) otherwise", flush=True)
                r = float((y - y0)[:rows].abs().max() / y0[:rows].abs().max())
                worst[phase] = max(worst[phase], r)
                x = y0
            logits = llama.head_logits(arch, w, x, n_valid)
    return worst


def real_model_phase(torch, counters, card: str, gguf: str = REPOLM,
                     kernels=ENGINE_KERNELS, fmt: str | None = None) -> dict:
    """`gguf` (repolm512 or a requantized copy; with fmt "w4a8" or "w8a8"
    requantized at load) through the CLI on the card (every kernel of
    `kernels` launched), Engine greedy generation on the card against the
    CPU, teacher-forced, and layer by layer."""
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.inference.engine import Engine, GenerateConfig
    tag = os.path.basename(gguf) + (f" --{fmt}" if fmt else "")
    flags = [f"--{fmt}"] if fmt else []
    load_kw = {fmt: True} if fmt else {}
    reset(counters)
    rc = cli.main(["-m", gguf, "-p", PROMPT, "-n", "32", "-t", "0",
                   "--repeat-penalty", "1.0", "--device", "cuda"] + flags)
    torch.cuda.synchronize()
    got = read(counters)
    print(f"cli launches {got}", flush=True)
    check(rc == 0, f"cli exit code {rc}")
    check(all(got[k] > 0 for k in kernels),
          f"{tag}: CLI run on the card launched a kernel zero times: {got}")

    gpu = Engine.load(gguf, device="cuda", fuse=True, **load_kw)
    cpu = Engine.load(gguf, device="cpu", fuse=True, **load_kw)
    ids = gpu._encode(PROMPT)
    check(len(ids) >= 70, f"prompt is {len(ids)} tokens; want >= 70")
    cfg = GenerateConfig(max_tokens=32, temperature=0.0, repeat_penalty=1.0)
    text_gpu, st_gpu = gpu.generate(PROMPT, cfg)
    steps = replay_count(gpu)
    check(set(steps) == {"prefill", "step"} and steps["step"] > 0,
          f"{tag}: generate on the card replayed {steps}")
    text_cpu, _ = cpu.generate(PROMPT, cfg)
    print(f"{tag} gpu: {text_gpu!r}", flush=True)
    print(f"{tag} cpu: {text_cpu!r}", flush=True)
    print(f"{tag} gpu generate on {card}: {st_gpu.report()!r}", flush=True)
    cpu_toks, cpu_logits = greedy_pass(cpu, torch, ids, 32)
    gpu_toks, _ = greedy_pass(gpu, torch, ids, 32)
    _, forced_logits = greedy_pass(gpu, torch, ids, 32, forced=cpu_toks)
    # the kernel path's prefill with plain decode steps: the spread the
    # prefill's kernels alone carry into each decode step
    _, mixed_logits = greedy_pass(gpu, torch, ids, 32, forced=cpu_toks,
                                  plain_decode=True)
    from ntransformer_tpu_torch.ops import linear
    linear.KERNEL_MODE = "off"  # the same run on the card, plain PyTorch
    try:
        _, plain_logits = greedy_pass(gpu, torch, ids, 32, forced=cpu_toks)
    finally:
        linear.KERNEL_MODE = "auto"
    agree = sum(a == b for a, b in zip(gpu_toks, cpu_toks))

    def rels(got):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, cpu_logits)]
    for a in forced_logits:
        check(bool(torch.isfinite(a).all()), f"{tag}: non-finite logits")
    kern, plain = rels(forced_logits), rels(plain_logits)
    mixed = rels(mixed_logits)
    # step 0 (the prefill) against the plain path's spread; a decode step
    # against the larger of that and the spread the kernel prefill leaves
    floor = WFORMAT_LOGIT_RTOL if fmt == "w8a8" else REAL_LOGIT_RTOL
    limits = [max(floor, 2 * r, 2 * m * (i > 0))
              for i, (r, m) in enumerate(zip(plain, mixed))]
    print(f"{tag}: {agree}/{len(cpu_toks)} greedy tokens agree; "
          f"teacher-forced max|dlogit|/max|logit| per step, kernels vs CPU: "
          f"{[round(r, 4) for r in kern]}; card plain path vs CPU: "
          f"{[round(r, 4) for r in plain]}; kernel prefill + plain decode "
          f"vs CPU: {[round(r, 4) for r in mixed]}", flush=True)
    for i, (r, lim) in enumerate(zip(kern, limits)):
        check(r <= lim, f"{tag} step {i}: teacher-forced logits differ "
              f"by {r} of their range (> {lim})")
    layers = layer_by_layer(torch, gpu, ids)
    layer_rtol = WFORMAT_LAYER_RTOL if fmt else LAYER_RTOL
    print(f"{tag} layer by layer, kernels vs plain on the card: "
          f"{layers} (tol {layer_rtol})", flush=True)
    for phase, r in layers.items():
        check(r <= layer_rtol[phase],
              f"{tag} {phase}: a layer's kernel output differs by {r} "
              f"of its range from the plain path's (> {layer_rtol[phase]})")
    worst = max(kern)
    return {"tokens_agree": agree, "tokens": len(cpu_toks),
            "logit_rel_err": worst, "logit_rel_err_steps": kern,
            "plain_rel_err_steps": plain, "mixed_rel_err_steps": mixed,
            "layer_rel_err": layers,
            "gpu_text": text_gpu, "cpu_text": text_cpu, "cli_launches": got}


def serve_prompts(tokenizer) -> list[str]:
    """Four prompts of different lengths for repolm512 (a 512-token
    context): 125, 20, 373 and 15 tokens, so 128-token admission chunks
    split two of them."""
    long = PROMPT * 3
    prompts = [PROMPT, "import numpy as np\n", long, "class Engine:\n"]
    check(SERVE_CHUNK * 2 < len(tokenizer.encode(long, add_bos=True)) < 500,
          "the long serving prompt must span several admission chunks")
    return prompts


def prefill_batch(torch, model, ids, quant: bool):
    """Prefill each prompt of `ids` as the Engine buckets and chunks it and
    place it in a slot of a batched cache. Returns (cache, prefill logits
    [B, V] f32 on the CPU)."""
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models.batched import BatchedKV
    eng = Engine(model, kv_quant=quant)
    bkv = BatchedKV.create(model.arch, len(ids), quant=quant,
                           device=model.device)
    first = []
    for b, p in enumerate(ids):
        logits, kv, _ = eng._prefill(eng._make_kv(), p)
        bkv.insert(b, kv)
        first.append(logits[0])
    return bkv, torch.stack(first).float().cpu()


def batched_pass(torch, model, bkv, lens, first, n: int, impl: str,
                 forced=None):
    """n batched decode steps of path `impl` from the prefilled cache `bkv`
    (a copy on the model's device is written), greedy from the prefill
    logits `first` or fed `forced` [n][B]. Returns (tokens [n][B], logits
    [B, V] of each step as f32 CPU tensors)."""
    from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                       batched_decode_step)
    bkv = BatchedKV(*(None if t is None else t.to(model.device, copy=True)
                      for t in (bkv.k, bkv.v, bkv.ks, bkv.vs)))
    pos = torch.tensor(lens)
    active = torch.ones(len(lens), dtype=torch.bool)
    toks, out = [], [first]
    for i in range(n):
        tok = (torch.argmax(out[-1], -1) if forced is None
               else torch.as_tensor(forced[i]))
        toks.append(tok.tolist())
        logits, bkv = batched_decode_step(model.arch, model.weights, bkv, tok,
                                          pos + i, active, impl=impl)
        out.append(logits.float().cpu())
    return toks, out[1:]


def real_serve_phase(torch, counters, card: str, gguf: str = REPOLM,
                     kernels=SERVE_KERNELS, fmt: str | None = None,
                     dot_forms: bool = False) -> dict:
    """repolm512 (or a requantized copy; with fmt "w4a8" or "w8a8"
    requantized at load) served on the card: the CLI's
    --serve (bf16 and int8; every kernel of `kernels` launched), the
    batched step from the CPU's prefill teacher-forced on the CPU's tokens
    (kernel path and the card's plain path against the CPU, every step and
    slot), and greedy serving on the card against the CPU, end to end. With
    dot_forms, also --serve --kv-int8 under NT_ATTN_DOT=int8 and the server
    with each cache-dot form (the forms' main path; out["dot_launches"])."""
    import tempfile
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.ops import linear
    tag = os.path.basename(gguf) + (f" --{fmt}" if fmt else "")
    fmt_flags = [f"--{fmt}"] if fmt else []
    load_kw = {fmt: True} if fmt else {}
    gpu = load_model(gguf, device="cuda", fuse=True, **load_kw)
    cpu = load_model(gguf, device="cpu", fuse=True, **load_kw)
    prompts = serve_prompts(gpu.tokenizer)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prompts.txt")
        with open(path, "w") as f:
            f.write("\n".join(p.replace("\n", " ") for p in prompts) + "\n")
        for flags in ([], ["--kv-int8"]):
            reset(counters)
            rc = cli.main(["-m", gguf, "--serve", path, "--batch-size", "4",
                           "-n", "16", "-t", "0", "--repeat-penalty", "1.0",
                           "--device", "cuda"] + fmt_flags + flags)
            torch.cuda.synchronize()
            got = read(counters)
            print(f"{tag} cli --serve {' '.join(flags)} launches {got}",
                  flush=True)
            check(rc == 0, f"cli --serve {flags} exit code {rc}")
            check(all(got[k] > 0 for k in kernels),
                  f"{tag} --serve {flags} on the card launched a kernel "
                  f"zero times: {got}")
            out["cli_launches" + "_int8" * bool(flags)] = got
        if dot_forms:
            # the JAX package's switch for the int8 cache dots, as an
            # operator sets it
            os.environ["NT_ATTN_DOT"] = "int8"
            try:
                reset(counters)
                rc = cli.main(["-m", gguf, "--serve", path, "--batch-size",
                               "4", "-n", "16", "-t", "0", "--repeat-penalty",
                               "1.0", "--device", "cuda", "--kv-int8"])
                torch.cuda.synchronize()
                got = read(counters)
            finally:
                del os.environ["NT_ATTN_DOT"]
            print(f"{tag} NT_ATTN_DOT=int8 cli --serve --kv-int8 launches "
                  f"{got}", flush=True)
            check(rc == 0 and got["batched_attention[int8]"] > 0,
                  f"NT_ATTN_DOT=int8 --serve: exit {rc}, launches {got}")
            out["cli_launches_attn_dot_int8"] = got
    if dot_forms:
        # BatchServer with each cache-dot form: the forms' main path
        out["dot_launches"], out["dot_tokens_agree_with_f32"] = {}, {}
        for dot in ("f32",) + DOT_FORMS:
            quant = dot != "bf16"
            srv = BatchServer(gpu, batch_size=4, kv_quant=quant,
                              admit_chunk=SERVE_CHUNK, dot_impl=dot,
                              sampler_cfg=SamplerConfig(temperature=0.0))
            reqs = [Request(prompt=p, max_tokens=16) for p in prompts]
            reset(counters)
            srv.run(reqs)
            torch.cuda.synchronize()
            got = read(counters)
            key = "batched_attention" + ("" if dot == "f32" else f"[{dot}]")
            check(got[key] > 0, f"{tag} BatchServer(dot_impl={dot!r}, "
                  f"kv_quant={quant}) launched {key} zero times: {got}")
            out["dot_launches"][dot] = got[key]
            ids_out = [r.output_ids for r in reqs]
            if dot == "f32":
                ref_ids = ids_out
            out["dot_tokens_agree_with_f32"][dot] = [
                sum(a == b for a, b in zip(x, y))
                for x, y in zip(ids_out, ref_ids)]
        print(f"{tag} BatchServer by cache-dot form: launches "
              f"{out['dot_launches']}, greedy tokens equal to the f32 "
              f"cache dots' (per request, of 16): "
              f"{out['dot_tokens_agree_with_f32']}", flush=True)
    ids = [gpu.tokenizer.encode(p, add_bos=True) for p in prompts]
    lens = [len(p) for p in ids]
    n = 16
    for quant in (False, True):
        mode = "int8" if quant else "bf16"
        # every run starts from the CPU's prefill: the steps' kernels are
        # held, not the prefill's flash rounding (PERF.md, Findings). Each card
        # path is held against the CPU run of the same path: the kernel
        # path's CPU run takes the kernels' plain twins (an int8 cache's
        # scales fold exactly), the plain path attends a bf16 dequant
        bkv, first = prefill_batch(torch, cpu, ids, quant)
        ref = {impl: batched_pass(torch, cpu, bkv, lens, first, n, impl)
               for impl in ("kernel", "plain")}
        _, kern = batched_pass(torch, gpu, bkv, lens, first, n, "kernel",
                               forced=ref["kernel"][0])
        linear.KERNEL_MODE = "off"  # the same run on the card, plain PyTorch
        try:
            _, plain = batched_pass(torch, gpu, bkv, lens, first, n, "plain",
                                    forced=ref["plain"][0])
        finally:
            linear.KERNEL_MODE = "auto"
        del bkv

        def rels(got, impl):  # [step][slot]
            return [[float((a[b] - c[b]).abs().max() / c[b].abs().max())
                     for b in range(len(ids))]
                    for a, c in zip(got, ref[impl][1])]
        rk, rp = rels(kern, "kernel"), rels(plain, "plain")
        for a in kern:
            check(bool(torch.isfinite(a).all()),
                  f"{tag} serving {mode}: non-finite logits")
        worst = max(max(r) for r in rk)
        print(f"{tag} batched {mode} from the CPU's prefill, "
              f"teacher-forced max|dlogit|/max|logit| per step (worst "
              f"slot), kernel path vs the CPU's: "
              f"{[round(max(r), 4) for r in rk]}; plain path vs the CPU's: "
              f"{[round(max(r), 4) for r in rp]}", flush=True)
        for s, (ks, ps) in enumerate(zip(rk, rp)):
            for b, (k, p) in enumerate(zip(ks, ps)):
                lim = max(WFORMAT_LOGIT_RTOL if fmt == "w8a8"
                          else SERVE_LOGIT_RTOL[mode], 2 * p)
                check(k <= lim, f"{tag} serving {mode} step {s} slot {b}:"
                      f" logits differ by {k} of their range (> {lim})")
        texts = {}
        for dev, model in (("gpu", gpu), ("cpu", cpu)):
            srv = BatchServer(model, batch_size=4, kv_quant=quant,
                              admit_chunk=SERVE_CHUNK,
                              sampler_cfg=SamplerConfig(temperature=0.0))
            reqs = [Request(prompt=p, max_tokens=n) for p in prompts]
            srv.run(reqs)
            texts[dev] = reqs
        agree = [sum(a == b for a, b in zip(g.output_ids, c.output_ids))
                 for g, c in zip(texts["gpu"], texts["cpu"])]
        print(f"{tag} greedy serving {mode} on {card}: "
              f"{agree} of {[len(c.output_ids) for c in texts['cpu']]} "
              f"tokens agree with the CPU; gpu "
              f"{[r.text for r in texts['gpu']]!r}; cpu "
              f"{[r.text for r in texts['cpu']]!r}", flush=True)
        out[mode] = {"logit_rel_err": worst, "tokens_agree": agree}
    return out


class IdsTokenizer:
    """Stands in for a GGUF tokenizer on the synthetic model, which has
    none: requests carry token ids, and a completion's text is its ids."""

    stop_ids = frozenset()

    def decode(self, ids) -> str:
        return " ".join(str(i) for i in ids)


def full_batched_phase(torch, counters, card: str, synth,
                       kernels=SERVE_KERNELS,
                       int8_attention_rtol=BATCHED_LOGIT_RTOL["int8"],
                       dot_forms: bool = False) -> tuple:
    """A synthetic Llama-3.1-8B served at full width: BatchServer with 8
    slots answering 8 requests (launch counts read around its warmup, which
    captures the steps it replays, and its run; every kernel of `kernels`
    launched), then the batched step as the bench drives it
    (B = 1 bf16 with the s_live bucket, B = 32 int8 from mid-context, a
    T = 4 verify window), a profile of the step, and kernels on vs off on a
    2-layer view; with dot_forms, the B = 32 int8 step also with the int8
    cache dots of batched flash beside f32."""
    import dataclasses
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                       batched_verify_step)
    from ntransformer_tpu_torch.models.graphs import StepGraphs
    from ntransformer_tpu_torch.models.loader import LoadedModel
    cfg, arch, weights, per_token = synth
    tag = cfg.model_name
    model = LoadedModel(cfg, arch, weights, IdsTokenizer(), None,
                        torch.device("cuda"))
    srv = BatchServer(model, batch_size=8,
                      sampler_cfg=SamplerConfig(temperature=0.0))
    rng = torch.Generator().manual_seed(21)
    lens = [700, 130, 64, 9, 300, 20, 90, 1000]
    reqs = [Request(prompt="", max_tokens=16, prompt_ids=torch.randint(
        3, arch.vocab_size, (n,), generator=rng).tolist()) for n in lens]
    # the counts are read around warmup and run: on the card the server's
    # steps launch through the wrappers in warmup (each key's uncaptured
    # warm-up call and its capture), and run replays them, which the
    # host-side counters do not see
    reset(counters)
    warm = srv.warmup()
    stats = srv.run(reqs)
    torch.cuda.synchronize()
    launches = read(counters)
    if srv._graphs is not None:
        print(f"{tag} server: {srv._graphs.captures} captured steps, "
              f"{sum(srv._graphs.replays.values())} replays", flush=True)
    print(f"{tag} server (8 slots, 8 requests of {lens} tokens, warmup "
          f"{warm:.1f} s): {stats.report()}; launches {launches}", flush=True)
    check(all(launches[k] > 0 for k in kernels),
          f"{tag}: the serving path launched a kernel zero times: "
          f"{launches}")
    check(all(len(r.output_ids) == 16 for r in reqs),
          f"{tag} server: a request finished short")
    summary = {"card": card, "serve_tokens": stats.tokens,
               "serve_wall_s": stats.wall_s,
               "serve_tok_s": stats.tokens_per_s,
               "serve_steps": stats.steps,
               "serve_ttft_p50_s": sorted(stats.ttft_s)[len(stats.ttft_s)
                                                        // 2],
               "serve_launches": launches}
    del srv

    arch1k = dataclasses.replace(arch, max_seq_len=1024)

    def chain(bkv, b_n, n, base, tokens):
        return batched_chain(torch, arch1k, weights, bkv, b_n, n, base,
                             tokens, graphs=graphs)

    cells = {"b1_bf16": bench_b1(torch, counters, arch, weights, per_token)}
    bkv = BatchedKV.create(arch1k, 1, device="cuda")
    prof_b1 = profile_batched(torch, arch1k, weights, bkv, 1, 160)
    del bkv
    # B = 32 int8 from mid-context (bench_b32_int8: delta-timed rounds),
    # replayed; the launches are read around the warm chain, whose first
    # step captures the graph
    bkv = BatchedKV.create(arch1k, 32, quant=True, device="cuda")
    graphs = StepGraphs(arch1k, weights, bkv)
    tok = torch.arange(32, device="cuda") + 3
    reset(counters)
    tok = chain(bkv, 32, 24, 512, tok)
    t0 = time.perf_counter()
    tok = chain(bkv, 32, 24, 512 + 32, tok)
    t1 = time.perf_counter()
    tok = chain(bkv, 32, 72, 512 + 64, tok)
    t2 = time.perf_counter()
    dt = ((t2 - t1) - (t1 - t0)) / 48
    cells["b32_int8"] = {"ms_per_step": dt * 1e3, "tok_s_aggregate": 32 / dt,
                         "effective_GB_s": per_token / dt / 1e9,
                         "launches": read(counters),
                         "s_live": s_live_bucket(512 + 64 + 72 + 1)}
    prof_b32 = profile_batched(torch, arch1k, weights, bkv, 32, 700)
    if dot_forms:
        # the same step with the int8 cache dots (NT_ATTN_DOT=int8), in
        # turns with f32: f32, int8, int8, f32
        times = {"f32": [], "int8": []}
        graphs.capture([graphs.key("decode", 1, s_live_bucket(512 + 25),
                                   dot_impl="int8")])
        for dot in ("f32", "int8", "int8", "f32"):
            t0 = time.perf_counter()
            tok = batched_chain(torch, arch1k, weights, bkv, 32, 24, 512,
                                tok, dot, graphs=graphs)
            times[dot].append((time.perf_counter() - t0) / 24 * 1e3)
        prof_dot = profile_batched(torch, arch1k, weights, bkv, 32, 700,
                                   dot_impl="int8")
        cells["b32_int8_dot_forms"] = {
            "ms_per_step": {k: min(v) for k, v in times.items()},
            "batched_flash_device_ms_per_step": {
                "f32": prof_b32["batched_flash_device_ms_per_step"],
                "int8": prof_dot["batched_flash_device_ms_per_step"]},
            "note": "chained 24-step runs (s_live 768) in turns, best of two"}
    del bkv, graphs
    # a T = 4 verify window, B = 8 bf16 from mid-context
    bkv = BatchedKV.create(arch1k, 8, device="cuda")
    vt = torch.randint(3, arch.vocab_size, (8, 4), device="cuda")
    act = torch.ones(8, dtype=torch.bool, device="cuda")
    pos = torch.full((8,), 512, dtype=torch.long, device="cuda")
    batched_verify_step(arch1k, weights, bkv, vt, pos, act)[0].cpu()
    reset(counters)
    t0 = time.perf_counter()
    for i in range(8):
        vl, bkv = batched_verify_step(arch1k, weights, bkv, vt, pos + 4 * i,
                                      act, s_live=768)
    vl.cpu()
    dt = (time.perf_counter() - t0) / 8
    check(bool(torch.isfinite(vl).all()) and tuple(vl.shape)
          == (8, 4, arch.vocab_size), f"{tag} verify: bad logits")
    cells["verify_b8_t4_bf16"] = {"ms_per_step": dt * 1e3,
                                  "tok_s": 32 / dt,
                                  "launches": read(counters)}
    del bkv
    for name, c in cells.items():
        print(json.dumps({f"{tag}_batched_{name}": c}), flush=True)
    summary.update(cells=cells, profile_b1=prof_b1, profile_b32=prof_b32,
                   two_layer=batched_on_off(torch, arch, weights,
                                            int8_attention_rtol))
    return summary, launches


def s_live_bucket(needed: int):
    """The server's 4-rung s_live ladder over a 1024-row cache."""
    for i in (1, 2, 3):
        b = (1024 * i) // 4
        if b >= 256 and b >= needed:
            return b
    return None


def batched_chain(torch, arch1k, weights, bkv, b_n: int, n: int, base: int,
                  tokens, dot_impl: str = "f32", graphs=None):
    """n greedy batched decode steps from position `base` with the s_live
    bucket, as bench.py chains them: replayed through `graphs` (a
    models/graphs.StepGraphs over bkv, which captures a key the first time
    it meets it, so a timed chain follows an untimed one of the same
    rung), or without it called directly; ends in a real fence."""
    from ntransformer_tpu_torch.models.batched import batched_decode_step
    sl = s_live_bucket(base + n + 1)
    active = torch.ones(b_n, dtype=torch.bool, device="cuda")
    for i in range(n):
        pos = torch.full((b_n,), base + i, dtype=torch.long, device="cuda")
        if graphs is None:
            logits, bkv = batched_decode_step(arch1k, weights, bkv, tokens,
                                              pos, active, s_live=sl,
                                              dot_impl=dot_impl)
        else:
            logits = graphs.run(bkv, "decode", tokens, pos, active, sl,
                                dot_impl=dot_impl)
        tokens = torch.argmax(logits, -1)
    tokens.cpu()  # a real fence
    return tokens


def bench_b1(torch, counters, arch, weights, per_token: int) -> dict:
    """The B = 1 bf16 batched step as bench.py's resident decode keys time
    it, replayed as a CUDA graph (models/graphs.py): S = 1024, chained
    with the s_live bucket, best of two 64-step runs; launch counts read
    around the untimed warm chain, whose first step captures the graph
    (its warm-up call and the capture launch through the wrappers; the
    replays advance no counter)."""
    import dataclasses
    from ntransformer_tpu_torch.models.batched import BatchedKV
    from ntransformer_tpu_torch.models.graphs import StepGraphs
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    bkv = BatchedKV.create(arch1k, 1, device="cuda")
    graphs = StepGraphs(arch1k, weights, bkv)
    tok = torch.full((1,), 3, dtype=torch.long, device="cuda")
    reset(counters)
    tok = batched_chain(torch, arch1k, weights, bkv, 1, 8, 8, tok,
                        graphs=graphs)
    launches = read(counters)
    best = float("inf")
    for i in range(2):
        t0 = time.perf_counter()
        tok = batched_chain(torch, arch1k, weights, bkv, 1, 64, 24 + i * 64,
                            tok, graphs=graphs)
        best = min(best, (time.perf_counter() - t0) / 64)
    check(graphs.captures == 1, f"bench_b1: {graphs.captures} captures")
    return {"ms_per_step": best * 1e3, "tok_s": 1.0 / best,
            "effective_GB_s": per_token / best / 1e9,
            "launches": launches, "replays": sum(graphs.replays.values()),
            "s_live": s_live_bucket(24 + 128 + 1)}


def profile_batched(torch, arch, weights, bkv, b_n: int, pos0: int,
                    steps: int = 4, dot_impl: str = "f32") -> dict:
    """Device time by kernel over a few chained batched steps
    (torch.profiler with CUDA activity alone: tracing the host's operators
    too took seconds a profile) and the share of the wall time the card
    was busy; the profiler's own host cost inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from ntransformer_tpu_torch.models.batched import batched_decode_step
    tok = torch.arange(b_n, device="cuda") + 3
    act = torch.ones(b_n, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            pos = torch.full((b_n,), pos0 + i, dtype=torch.long,
                             device="cuda")
            logits, bkv = batched_decode_step(arch, weights, bkv, tok, pos,
                                              act, s_live=768,
                                              dot_impl=dot_impl)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.count // steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    flash = sum(ms for ms, _, k in rows
                if "batched_attention" in k or "split_kernel" in k
                or "group_kernel" in k or "combine_kernel" in k)
    out = {"B": b_n, "steps": steps, "dot_impl": dot_impl,
           "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": busy,
           "kernels_per_step": sum(r[1] for r in rows),
           "batched_flash_device_ms_per_step": flash,
           "device_busy_share": busy * steps / wall_ms if wall_ms else 0.0,
           "top": [{"kernel": k[:80], "ms_per_step": ms, "per_step": c}
                   for ms, c, k in rows[:12]]}
    print(json.dumps({"batched_profile": out}), flush=True)
    return out


def batched_on_off(torch, arch, weights,
                   int8_attention_rtol=BATCHED_LOGIT_RTOL["int8"]) -> dict:
    """The batched step on a 2-layer view of the 8B weights, kernels on vs
    off (the plain path writes each layer's rows, then attends the whole
    cache in plain PyTorch; an MoE model's kernel runs replay the plain
    run's routing, RouteTape), B = 4 from a random mid-context cache with one
    inactive slot: logits within BATCHED_LOGIT_RTOL, rows no path writes
    bit-equal, layer 0's written rows equal but for rare bf16 flips. With
    an int8 cache the plain path attends a bf16 dequant of the codes where
    the kernels fold the exact f32 scales, so the logits are held in two
    parts with the semantics kept equal: the matmul kernels (plain
    attention on both sides) to the bf16 limit, and the attention and
    append kernels against plain attention over an f32 cache holding the
    exact dequantized values (matmul kernels on both sides) to the int8
    limit (the new rows' codes round on the kernel side only), or to
    `int8_attention_rtol` where the weights quantize their activations."""
    import dataclasses
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                       batched_decode_step)
    from ntransformer_tpu_torch.ops import linear
    layers2 = llama.LayerWeights(**{
        f: (None if v is None else
            linear.QLinear(v.dtype, v.k, v.n,
                           {nm: a[:2] for nm, a in v.planes.items()})
            if isinstance(v, linear.QLinear) else v[:2])
        for f, v in ((f, getattr(weights.layers, f))
                     for f in weights.layers.__dataclass_fields__)})
    arch2 = dataclasses.replace(arch, n_layers=2, max_seq_len=1024)
    w2 = dataclasses.replace(weights, layers=layers2)
    g = torch.Generator(device="cuda")
    g.manual_seed(77)
    pos = torch.tensor([100, 513, 7, 1000], device="cuda")
    act = torch.tensor([True, True, False, True], device="cuda")
    tok = torch.tensor([5, 17, 300, 4000], device="cuda")
    res = {}
    for quant in (False, True):
        base = BatchedKV.create(arch2, 4, quant=quant, device="cuda")
        for c in base.caches:
            if c.dtype == torch.int8:
                c.random_(-127, 128, generator=g)
            else:
                c.copy_(torch.rand(c.shape, device="cuda", generator=g)
                        * (0.02 if c.dtype == torch.float32 else 1.0))
        # the plain run first: an MoE model's kernel runs replay its routing
        outs, tape = {}, RouteTape()
        runs = {"off": ("off", None, base), "auto": ("auto", None, base)}
        if quant:
            exact = BatchedKV(base.k.float() * base.ks[..., None],
                              base.v.float() * base.vs[..., None])
            runs["matmul"] = ("auto", "plain", base)
            runs["exact"] = ("auto", "plain", exact)
        for name, (mode, impl, src) in runs.items():
            kv = BatchedKV(*(None if t is None else t.clone()
                             for t in (src.k, src.v, src.ks, src.vs)))
            linear.KERNEL_MODE = mode
            try:
                with (tape.record() if name == "off" else tape.replay()):
                    lg, kv = batched_decode_step(arch2, w2, kv, tok, pos,
                                                 act, impl=impl)
                torch.cuda.synchronize()
            finally:
                linear.KERNEL_MODE = "auto"
            outs[name] = (lg, kv)
        (a, kva), (b, kvb) = outs["auto"], outs["off"]

        def rel_of(x, y):
            return float((x - y).abs().max() / y.abs().max())
        rel = rel_of(a, b)
        check(bool(torch.isfinite(a).all()), "8b 2-layer batched: non-finite")
        mode = "int8" if quant else "bf16"
        parts = {"all": (rel, BATCHED_LOGIT_RTOL[mode])}
        if quant:
            parts = {"matmul kernels": (rel_of(outs["matmul"][0], b),
                                        BATCHED_LOGIT_RTOL["bf16"]),
                     "int8 attention": (rel_of(a, outs["exact"][0]),
                                        int8_attention_rtol)}
            del exact
        print(f"8b 2-layer batched step {mode}, kernels on vs off: "
              f"max|d|/max|off| = {rel:.3e}; by part (value, tol): {parts}",
              flush=True)
        for part, (r, lim) in parts.items():
            check(r <= lim, f"8b 2-layer batched {mode} ({part}): logits "
                  f"differ by {r} of their range (> {lim})")
        written = torch.zeros(2, 4, 1, 1024, dtype=torch.bool, device="cuda")
        for bi in range(4):
            if bool(act[bi]):
                written[:, bi, :, int(pos[bi])] = True
        eq0 = []
        for x, y in zip(kva.caches, kvb.caches):
            m = written if x.dim() == 4 else written[..., None]
            m = m.expand(x.shape)
            check(torch.equal(x[~m], y[~m]), f"8b 2-layer batched {mode}: a "
                  "row no path writes differs")
            if x.dim() == 5:
                eq0.append(float((x[0][m[0]] == y[0][m[0]]).float().mean()))
        check(min(eq0) >= 0.99, f"8b 2-layer batched {mode}: layer 0's "
              f"written rows agree only {eq0}")
        print(f"8b 2-layer batched step {mode}: layer-0 written rows equal "
              f"{eq0}", flush=True)
        res[mode] = {"logit_rel_err": rel, "parts": parts,
                     "layer0_rows_equal": eq0}
    return res


# ---------------------------------------------------------------- graphs
# phase graphs: the batched steps captured as CUDA graphs (models/graphs.py)
GRAPH_STEPS = 64     # the chained steps held bit for bit against the
GRAPH_TURN = 32      # uncaptured chain, and the second timed turn's steps
GRAPH_BASE = 512     # the chains' first position, under
GRAPH_RUNG = 768     # the server's s_live rung over a 1024-row cache
GRAPH_MOE_STEPS = 16  # phase moe: the Mixtral chains' steps
# profile_calls of a whole step: a trace of ~1,400-1,900 kernels a call
# takes seconds to read, so fewer calls a trace than a kernel row's
GRAPH_PROFILE = dict(calls=2, warm=2)
# the port's own CUDA kernels by name (the profiler's records of them)
OWN_KERNELS = ("skinny_kernel", "tile_kernel", "split_kernel",
               "group_kernel", "combine_kernel", "kv_append_kernel",
               "quant_kernel", "w4_decode_kernel", "w4_pairs_kernel",
               "flash_fwd_kernel")


def random_bkv(torch, arch, b_n: int, quant: bool, seed: int):
    """A BatchedKV of random rows (int8 codes with scales of ~0.01, or bf16
    in [0, 1)), as batched_on_off fills its mid-context cache."""
    from ntransformer_tpu_torch.models.batched import BatchedKV
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    kv = BatchedKV.create(arch, b_n, quant=quant, device="cuda")
    for c in kv.caches:
        if c.dtype == torch.int8:
            c.random_(-127, 128, generator=g)
        else:
            c.copy_(torch.rand(c.shape, device="cuda", generator=g)
                    * (0.02 if c.dtype == torch.float32 else 1.0))
    return kv


def graph_chain(torch, step, kv, b_n: int, tokens, base: int, n: int,
                keep: bool):
    """n greedy steps chained on the device from position `base` through
    step(kv, tokens, pos, active) -> logits, ending in a real fence:
    (last tokens, each step's logits if keep, wall ms a step)."""
    act = torch.ones(b_n, dtype=torch.bool, device="cuda")
    kept = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        pos = torch.full((b_n,), base + i, dtype=torch.long, device="cuda")
        logits = step(kv, tokens, pos, act)
        if keep:
            kept.append(logits.clone())
        tokens = torch.argmax(logits, -1)
    tokens.cpu()
    return tokens, kept, (time.perf_counter() - t0) / n * 1e3


def graph_steps(torch, arch, weights, b_n: int, quant: bool, seed: int):
    """The decode step at the GRAPH_RUNG s_live rung two ways over twin
    random caches of a 1024-row arch: (arch1k, uncaptured step, replayed
    step, uncaptured cache, the StepGraphs' cache, the StepGraphs, capture
    seconds)."""
    import dataclasses
    from ntransformer_tpu_torch.models.batched import batched_decode_step
    from ntransformer_tpu_torch.models.graphs import StepGraphs
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    kv = random_bkv(torch, arch1k, b_n, quant, seed)
    ref = clone_caches(kv)
    sg = StepGraphs(arch1k, weights, kv)
    t0 = time.perf_counter()
    sg.capture([sg.key("decode", 1, GRAPH_RUNG)])
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t0

    def plain(kv_, tok, pos, act):
        return batched_decode_step(arch1k, weights, kv_, tok, pos, act,
                                   s_live=GRAPH_RUNG)[0]

    def graph(kv_, tok, pos, act):
        return sg.run(kv_, "decode", tok, pos, act, GRAPH_RUNG)
    return arch1k, plain, graph, ref, kv, sg, cap_s


def graph_bits(torch, tag: str, plain, graph, ref, kv, b_n: int, n: int):
    """n chained steps uncaptured on `ref`, then replayed on `kv` from the
    same tokens: every step's logits, the tokens and the caches bit-equal.
    Returns (tokens, wall ms a step uncaptured, replayed)."""
    tok0 = torch.arange(b_n, device="cuda") + 3
    tu, lu, ms_u = graph_chain(torch, plain, ref, b_n, tok0, GRAPH_BASE, n,
                               True)
    tg, lg, ms_g = graph_chain(torch, graph, kv, b_n, tok0, GRAPH_BASE, n,
                               True)
    bad = [i for i, (a, b) in enumerate(zip(lu, lg)) if not torch.equal(a, b)]
    check(not bad and torch.equal(tu, tg),
          f"{tag}: replayed steps {bad[:8]} of {n} differ from the "
          "uncaptured chain's logits")
    check(all(torch.equal(a, b) for a, b in zip(ref.caches, kv.caches)),
          f"{tag}: the replayed chain's cache differs from the uncaptured "
          "chain's")
    check(all(bool(torch.isfinite(x).all()) for x in lu[-1:]),
          f"{tag}: non-finite logits")
    return tu, ms_u, ms_g


def graph_kernels(torch, counters, tag: str, plain, graph,
                  same_count: bool = True) -> dict:
    """One uncaptured step's launches by the counters (plain(), a call)
    and the kernels and device ms of an uncaptured step and of a replay
    (graph()) by the profiler: the replay's own kernels equal the
    counters' launches, and with same_count the two calls run the same
    number of kernels (copies aside: a replay copies its inputs in)."""
    from ntransformer_tpu_torch.ops.cuda import attention as ca
    reset(counters)
    plain()
    torch.cuda.synchronize()
    got = read(counters)
    # the wrapper modules' counts (a cache-dot form's and the partials'
    # counters count launches a module count holds already)
    launches = sum(v for k, v in got.items()
                   if "[" not in k and k != ca.PARTIALS_NAME)
    out = {"launches_uncaptured_step": launches}
    for name, fn in (("uncaptured", plain), ("replay", graph)):
        prof = profile_calls(torch, fn, **GRAPH_PROFILE)
        kern = {k: v for k, v in prof.items()
                if not k.startswith(("Memcpy", "Memset"))}
        out[name] = {
            "device_ms": sum(v["ms"] for v in prof.values()),
            "kernels": sum(v["per_call"] for v in kern.values()),
            "own_kernels": sum(v["per_call"] for k, v in kern.items()
                               if any(m in k for m in OWN_KERNELS)),
            "copies": sum(v["per_call"] for k, v in prof.items()
                          if k not in kern),
            # the port's kernels one by one: [device ms, launches] a call
            "by_kernel": {k: [v["ms"], v["per_call"]]
                          for k, v in kern.items()
                          if any(m in k for m in OWN_KERNELS)},
            # where the rest goes: the costliest kernels of any kind
            "top": sorted(([k[:60], v["ms"], v["per_call"]]
                           for k, v in kern.items()),
                          key=lambda r: -r[1])[:8]}
    check(out["replay"]["own_kernels"] == launches,
          f"{tag}: a replay runs {out['replay']['own_kernels']} of the "
          f"port's kernels, the uncaptured step launches {launches}")
    check(not same_count or
          out["replay"]["kernels"] == out["uncaptured"]["kernels"],
          f"{tag}: a replay runs {out['replay']['kernels']} kernels, the "
          f"uncaptured step {out['uncaptured']['kernels']}")
    return out


def graph_cell(torch, counters, tag: str, arch, weights, b_n: int,
               quant: bool) -> dict:
    """Phase graphs' cell: the decode step at B = b_n (int8 cache if
    quant) from GRAPH_BASE under GRAPH_RUNG, GRAPH_STEPS chained steps
    replayed bit-equal to the uncaptured chain, wall ms a step of both in
    turns (uncaptured, replayed, replayed, uncaptured), and the kernels and
    device ms of a replay beside an uncaptured step's."""
    t0 = time.perf_counter()
    arch1k, plain, graph, ref, kv, sg, cap_s = graph_steps(
        torch, arch, weights, b_n, quant, seed=90 + b_n)
    tok, ms_u1, ms_g1 = graph_bits(torch, tag, plain, graph, ref, kv, b_n,
                                   GRAPH_STEPS)
    base = GRAPH_BASE + GRAPH_STEPS
    tg, _, ms_g2 = graph_chain(torch, graph, kv, b_n, tok, base, GRAPH_TURN,
                               False)
    tu, _, ms_u2 = graph_chain(torch, plain, ref, b_n, tok, base, GRAPH_TURN,
                               False)
    check(torch.equal(tu, tg), f"{tag}: the timed turns' tokens differ")
    t1 = time.perf_counter()
    act = torch.ones(b_n, dtype=torch.bool, device="cuda")
    pos = torch.full((b_n,), base + GRAPH_TURN, dtype=torch.long,
                     device="cuda")
    prof = graph_kernels(torch, counters, tag,
                         lambda: plain(ref, tu, pos, act),
                         lambda: graph(kv, tu, pos, act))
    cell = {"seconds": {"chains": t1 - t0,
                        "profiles": time.perf_counter() - t1},
            "B": b_n, "cache": "int8" if quant else "bf16",
            "s_live": GRAPH_RUNG, "steps_bit_equal": GRAPH_STEPS,
            "capture_s": cap_s,
            "wall_ms_uncaptured": [ms_u1, ms_u2],
            "wall_ms_replayed": [ms_g1, ms_g2],
            "ms_uncaptured": (ms_u1 + ms_u2) / 2,
            "ms_replayed": (ms_g1 + ms_g2) / 2, **prof}
    cell["replay_wall_over_device"] = (cell["ms_replayed"]
                                       / prof["replay"]["device_ms"])
    print(json.dumps({f"graphs_{tag}": cell}), flush=True)
    del sg, kv, ref
    return cell


def graph_spec_round(torch, tag: str, arch, weights, k: int = 3,
                     b_n: int = 8, rounds: int = 4) -> dict:
    """A K = k speculative round at B = b_n (drafts through the first half
    of the layers, then the T = k + 1 verify window) uncaptured and through
    the draft and verify graphs, from twin random bf16 caches with the
    slots at different positions: each round's draft and verify logits and
    the caches bit-equal; ms a round of both, in turns."""
    import dataclasses
    from ntransformer_tpu_torch.models.batched import (batched_decode_step,
                                                       batched_verify_step)
    from ntransformer_tpu_torch.models.graphs import StepGraphs
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    draft = arch.n_layers // 2
    kv = random_bkv(torch, arch1k, b_n, False, 70)
    ref = clone_caches(kv)
    sg = StepGraphs(arch1k, weights, kv)
    sg.capture([sg.key("draft", 1, GRAPH_RUNG, draft),
                sg.key("verify", k + 1, GRAPH_RUNG)])
    act = torch.ones(b_n, dtype=torch.bool, device="cuda")
    base = GRAPH_BASE + 7 * torch.arange(b_n, device="cuda")

    def plain_draft(c, tok, pos):
        return batched_decode_step(arch1k, weights, c, tok, pos, act,
                                   n_layers=draft, s_live=GRAPH_RUNG)[0]

    def plain_verify(c, vt, pos):
        return batched_verify_step(arch1k, weights, c, vt, pos, act,
                                   s_live=GRAPH_RUNG)[0]

    def graph_draft(c, tok, pos):
        return sg.run(c, "draft", tok, pos, act, GRAPH_RUNG, n_layers=draft)

    def graph_verify(c, vt, pos):
        return sg.run(c, "verify", vt, pos, act, GRAPH_RUNG)

    def run(c, dfn, vfn, n: int, keep: bool):
        tok, seen = torch.arange(b_n, device="cuda") + 3, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(n):
            pos = base + r * (k + 1)
            dtok, drafts = tok, []
            for j in range(k):
                dl = dfn(c, dtok, pos + j)
                if keep:
                    seen.append(dl.clone())
                dtok = torch.argmax(dl, -1)
                drafts.append(dtok)
            vt = torch.cat([tok[:, None], torch.stack(drafts, 1)], 1)
            vl = vfn(c, vt, pos)
            if keep:
                seen.append(vl.clone())
            tok = torch.argmax(vl[:, -1], -1)
        tok.cpu()
        return seen, (time.perf_counter() - t0) / n * 1e3
    lu, ms_u1 = run(ref, plain_draft, plain_verify, rounds, True)
    lg, ms_g1 = run(kv, graph_draft, graph_verify, rounds, True)
    bad = [i for i, (a, b) in enumerate(zip(lu, lg)) if not torch.equal(a, b)]
    check(not bad and all(torch.equal(a, b)
                          for a, b in zip(ref.caches, kv.caches)),
          f"{tag} spec round: replayed draft/verify outputs {bad[:8]} (or "
          "the caches) differ from the uncaptured round's")
    _, ms_g2 = run(kv, graph_draft, graph_verify, rounds, False)
    _, ms_u2 = run(ref, plain_draft, plain_verify, rounds, False)
    out = {"B": b_n, "k": k, "draft_layers": draft, "rounds_bit_equal":
           rounds, "ms_round_uncaptured": (ms_u1 + ms_u2) / 2,
           "ms_round_replayed": (ms_g1 + ms_g2) / 2}
    print(json.dumps({f"graphs_{tag}_spec_round": out}), flush=True)
    del sg, kv, ref
    return out


def graph_server(torch, tag: str, synth) -> dict:
    """The 8B served by BatchServer(B = 8) over bfull's eight requests,
    replaying its captured steps, and the same server with the steps called
    directly (the server's device test patched for this comparison only):
    the same texts; served tok/s of both."""
    from ntransformer_tpu_torch.inference import serve
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.models.loader import LoadedModel
    cfg, arch, weights, _ = synth
    model = LoadedModel(cfg, arch, weights, IdsTokenizer(), None,
                        torch.device("cuda"))
    rng = torch.Generator().manual_seed(21)
    lens = [700, 130, 64, 9, 300, 20, 90, 1000]
    prompts = [torch.randint(3, arch.vocab_size, (n,),
                             generator=rng).tolist() for n in lens]
    out, texts = {}, {}
    graphed = serve._graphed
    for name in ("replayed", "uncaptured"):
        if name == "uncaptured":
            serve._graphed = lambda device: False
        try:
            srv = serve.BatchServer(model, batch_size=8,
                                    sampler_cfg=SamplerConfig(
                                        temperature=0.0))
            reqs = [serve.Request(prompt="", max_tokens=16,
                                  prompt_ids=list(p)) for p in prompts]
            torch.cuda.synchronize()
            pool0 = graph_pool_bytes(torch)
            warm = srv.warmup()
            torch.cuda.synchronize()
            pool = graph_pool_bytes(torch) - pool0
            st = srv.run(reqs)
            torch.cuda.synchronize()
        finally:
            serve._graphed = graphed
        check((srv._graphs is not None) == (name == "replayed"),
              f"{tag} server ({name}): graphs {srv._graphs}")
        texts[name] = [r.text for r in reqs]
        out[name] = {"tok_s": st.tokens_per_s, "wall_s": st.wall_s,
                     "steps": st.steps, "warmup_s": warm,
                     "ttft_p50_s": sorted(st.ttft_s)[len(st.ttft_s) // 2]}
        if srv._graphs is not None:
            adm_kv, adm = srv._adm
            out[name].update(
                graphs=srv._graphs.captures,
                replays=sum(srv._graphs.replays.values()),
                prefill_graphs=adm.captures,
                prefill_replays=sum(adm.replays.values()),
                prefill_chunks=st.prefill_chunks,
                graph_pool_bytes=pool,
                batched_cache_bytes=sum(t.numel() * t.element_size()
                                        for t in srv._bkv.caches),
                admission_cache_bytes=sum(
                    t.numel() * t.element_size()
                    for t in (adm_kv.k, adm_kv.v)))
            check(sum(adm.replays.values()) == adm.captures
                  + st.prefill_chunks, f"{tag} server: "
                  f"{sum(adm.replays.values())} prefill replays for "
                  f"{adm.captures} warm-up calls and {st.prefill_chunks} "
                  "chunks")
        print(f"{tag} server {name}: {st.report()}", flush=True)
        del srv
    check(texts["replayed"] == texts["uncaptured"],
          f"{tag} server: the replaying server's texts differ from the "
          "uncaptured server's")
    out["texts_equal"] = True
    print(json.dumps({f"graphs_{tag}_server": out}), flush=True)
    return out


def graphs_phase(torch, counters, card: str, synth, tag: str,
                 serve_too: bool = False) -> dict:
    """Phase graphs on one synthetic 8B: the B = 1 bf16 and B = 32 int8
    cells (graph_cell); with serve_too the K = 3 spec round at B = 8 and the
    BatchServer texts (graph_server) too; then the resident Engine's cell
    (engine_graph_cell). Prints its seconds."""
    t0 = time.perf_counter()
    _, arch, weights, _ = synth
    out = {"card": card}
    for b_n, quant in ((1, False), (32, True)):
        name = f"b{b_n}_{'int8' if quant else 'bf16'}"
        out[name] = graph_cell(torch, counters, f"{tag}_{name}", arch,
                               weights, b_n, quant)
    if serve_too:
        out["spec_round_b8"] = graph_spec_round(torch, tag, arch, weights)
        out["server"] = graph_server(torch, tag, synth)
    out["engine"] = engine_graph_cell(torch, counters, f"{tag}_engine", synth)
    out["engine_prefill"] = engine_prefill_cell(
        torch, counters, f"{tag}_engine_prefill", synth)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase graphs ({tag}) took {out['seconds']:.1f} s", flush=True)
    return out


def graph_moe_steps(torch, synth) -> dict:
    """Phase moe: the Mixtral B = 1 and B = 8 bf16 decode steps replayed
    bit-equal to their uncaptured chains over GRAPH_MOE_STEPS steps (the
    T = 1 device select and the T = 8 dense loop over the experts), wall ms
    a step of both."""
    _, arch, weights, _ = synth
    out = {}
    for b_n in (1, 8):
        tag = f"mixtral_b{b_n}_bf16"
        _, plain, graph, ref, kv, sg, cap_s = graph_steps(
            torch, arch, weights, b_n, False, seed=60 + b_n)
        _, ms_u, ms_g = graph_bits(torch, tag, plain, graph, ref, kv, b_n,
                                   GRAPH_MOE_STEPS)
        out[tag] = {"steps_bit_equal": GRAPH_MOE_STEPS, "capture_s": cap_s,
                    "ms_uncaptured": ms_u, "ms_replayed": ms_g}
        del sg, kv, ref
    out["mixtral_engine_step"] = engine_moe_step(torch, synth)
    print(json.dumps({"graphs_mixtral": out}), flush=True)
    return out


# phase graphs' Engine cells: the resident Engine's programs replayed
# (models/graphs.ForwardGraphs) on a synthetic 8B at its 4,096-row context
ENGINE_PREFILL = 512     # the prompt ahead of the chains
ENGINE_SPEC = (3, 8)  # K, iterations a turn (the draft: half the layers)
# the prefill cell's prompt: 7 chunks of 512 and a 116-token tail, whose
# window is a whole chunk at pos 3,584 (ctx 4,096) with n_valid 116
ENGINE_PROMPT = 7 * 512 + 116


def cuda_engine(torch, synth):
    """The base Engine over a synthetic model on the card, which replays
    its programs (Engine._graph_path)."""
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models.loader import LoadedModel
    cfg, arch, weights, _ = synth
    eng = Engine(LoadedModel(cfg, arch, weights, None, None,
                             torch.device("cuda")))
    check(eng._graph_path(), "the Engine on the card takes no graph path")
    return eng


def engine_prefilled(torch, eng, n: int, seed: int):
    """The engine's own cache (its ForwardGraphs bound to it) after an
    n-token random prefill, a twin copy of it, and the first greedy token:
    (kv, ref, token, n)."""
    ids = torch.randint(0, eng.arch.vocab_size, (n,),
                        generator=torch.Generator().manual_seed(seed)).tolist()
    kv = eng._start_kv()
    logits, kv, _ = eng._prefill(kv, ids)
    return kv, kv.clone(), torch.argmax(logits[0]), n


def engine_chain(torch, eng, kv, tok, pos0: int, n: int):
    """n greedy steps of eng._decode_step chained on the device (a replay
    of the step graph on the engine's own cache, the uncaptured forward on
    any other), ending in a real fence: (tokens [n], last logits, wall ms a
    token)."""
    toks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        logits, kv, _ = eng._decode_step(kv, tok, pos0 + i)
        tok = torch.argmax(logits[0])
        toks.append(tok)
    toks = torch.stack(toks)
    toks.cpu()
    return toks, logits, (time.perf_counter() - t0) / n * 1e3


def engine_loop(torch, g, kv, tok, pos0: int, n: int):
    """The same n steps as the greedy loop step replayed n times
    (ForwardGraphs.loop, decode_loop_greedy's graph path): (tokens [n],
    last logits, wall ms a token)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits = g.loop(kv, tok, pos0, n)
    toks = toks.clone()
    toks.cpu()
    return toks, logits.clone(), (time.perf_counter() - t0) / n * 1e3


def engine_graph_cell(torch, counters, tag: str, synth) -> dict:
    """Phase graphs' Engine cell on a synthetic 8B (ctx 4,096): a 512-token
    prefill, then GRAPH_STEPS greedy steps as the uncaptured chain (the
    host-int forward on a twin cache) and as the loop step replayed on the
    engine's cache: tokens, last logits and every cache byte bit-equal;
    wall ms a token of both in turns (uncaptured, replayed, replayed,
    uncaptured); the kernels and device ms of a replayed step against an
    uncaptured one's (the device pos adds its index kernels, so the counts
    are reported, not held equal) and the busy share; then spec
    iterations (ENGINE_SPEC) replayed against the direct spec_iter_greedy
    (engine_spec_turns)."""
    t0 = time.perf_counter()
    eng = cuda_engine(torch, synth)
    kv, ref, first, base = engine_prefilled(torch, eng, ENGINE_PREFILL, 19)
    g = eng._graphs_of(kv)
    t1 = time.perf_counter()
    g.capture([g.key("loop", n_steps=GRAPH_STEPS)])
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t1
    tu, lu, ms_u1 = engine_chain(torch, eng, ref, first, base, GRAPH_STEPS)
    tg, lg, ms_g1 = engine_loop(torch, g, kv, first, base, GRAPH_STEPS)
    check(torch.equal(tu, tg) and torch.equal(lu, lg),
          f"{tag}: the replayed loop's tokens or last logits differ from "
          "the uncaptured chain's")
    check(same_caches(torch, ref, kv), f"{tag}: the replayed loop's cache "
          "differs from the uncaptured chain's")
    check(bool(torch.isfinite(lg).all()), f"{tag}: non-finite logits")
    base += GRAPH_STEPS
    tg2, _, ms_g2 = engine_loop(torch, g, kv, tu[-1], base, GRAPH_STEPS)
    tu2, _, ms_u2 = engine_chain(torch, eng, ref, tu[-1], base, GRAPH_STEPS)
    check(torch.equal(tu2, tg2), f"{tag}: the timed turns' tokens differ")
    base += GRAPH_STEPS
    t2 = time.perf_counter()
    tok = tu2[-1]
    prof = graph_kernels(torch, counters, tag,
                         lambda: eng._decode_step(ref, tok, base),
                         lambda: eng._decode_step(kv, tok, base),
                         same_count=False)
    cell = {"seconds": {"chains": t2 - t0,
                        "profiles": time.perf_counter() - t2},
            "ctx": eng.arch.max_seq_len, "prefill": ENGINE_PREFILL,
            "steps_bit_equal": GRAPH_STEPS, "capture_s": cap_s,
            "wall_ms_uncaptured": [ms_u1, ms_u2],
            "wall_ms_replayed": [ms_g1, ms_g2],
            "ms_uncaptured": (ms_u1 + ms_u2) / 2,
            "ms_replayed": (ms_g1 + ms_g2) / 2, **prof}
    cell["replay_busy_share"] = (prof["replay"]["device_ms"]
                                 / cell["ms_replayed"])
    cell["uncaptured_busy_share"] = (prof["uncaptured"]["device_ms"]
                                     / cell["ms_uncaptured"])
    cell["spec"] = engine_spec_turns(torch, tag, eng, g, ref, kv, tok,
                                     base + 1)
    print(json.dumps({f"graphs_{tag}": cell}), flush=True)
    del eng, g, kv, ref
    return cell


def engine_spec_turns(torch, tag: str, eng, g, ref, kv, anchor,
                      pos: int) -> dict:
    """ENGINE_SPEC's K = 3 fused self-speculative iterations (the draft the
    first half of the layers: 16 of 32, 4 of 8) from one cache state, the
    direct spec_iter_greedy on ref (the host reads emit and n_acc once an
    iteration, as the Engine does) and the spec
    graph replayed on kv (anchor and pos carried on the device): every
    iteration's emit and n_acc, the device pos and the caches bit-equal,
    in two turns (direct, replayed; replayed, direct); ms an iteration."""
    from ntransformer_tpu_torch.inference.engine import spec_iter_greedy
    k, iters = ENGINE_SPEC
    arch, w = eng.arch, eng.model.weights
    n_draft = arch.n_layers // 2
    g.capture([g.key("spec", k=k, n_draft=n_draft)])

    def direct(a, p):
        outs, c = [], ref
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            c, emit, n_acc, a = spec_iter_greedy(arch, w, c, a, p, k,
                                                 n_draft)
            outs.append(torch.cat([emit, n_acc.reshape(1)]).tolist())
            p += outs[-1][-1] + 1
        return outs, a, p, (time.perf_counter() - t0) / iters * 1e3

    def replayed(a, p):
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            outs.append(g.spec(kv, k, n_draft, a if i == 0 else None,
                               p if i == 0 else None).tolist())
        ms = (time.perf_counter() - t0) / iters * 1e3
        return outs, g._tok[0].clone(), int(g._pos), ms

    ou, au, pu, ms_u1 = direct(anchor, pos)
    og, _, pg, ms_g1 = replayed(anchor, pos)
    check(ou == og and pu == pg and same_caches(torch, ref, kv),
          f"{tag} spec: the replayed iterations (or the caches) differ from "
          f"the direct ones: {ou} / {og}")
    og2, _, pg2, ms_g2 = replayed(None, None)
    ou2, _, pu2, ms_u2 = direct(au, pu)
    check(ou2 == og2 and pu2 == pg2 and same_caches(torch, ref, kv),
          f"{tag} spec: the timed turns differ")
    return {"k": k, "n_draft": n_draft, "iterations_bit_equal": 2 * iters,
            "n_acc": [o[-1] for o in ou + ou2],
            "ms_iteration_direct": (ms_u1 + ms_u2) / 2,
            "ms_iteration_replayed": (ms_g1 + ms_g2) / 2}


def graph_pool_bytes(torch) -> int:
    """The bytes the caching allocator holds in CUDA graphs' private pools:
    its segments outside the default pool (id (0, 0))."""
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg["segment_pool_id"]) != (0, 0))


def engine_prefill_cell(torch, counters, tag: str, synth) -> dict:
    """Phase graphs' prefill cell on a synthetic 8B (ctx 4,096): the
    ENGINE_PROMPT-token prompt's 8 chunks replayed on the engine's cache
    (ForwardGraphs' prefill key of 512 tokens, every chunk's offset and
    n_valid on the device) against the uncaptured host-int chunks on a twin
    cache: the last logits and every cache byte bit-equal; wall ms a chunk
    of both in turns (uncaptured, replayed, replayed, uncaptured), each
    prompt from a zeroed cache; the kernels and device ms of a replayed
    chunk (the seventh, at pos 3,072) against an uncaptured one's, and the
    busy share; the capture's seconds and the graph pool's bytes."""
    t0 = time.perf_counter()
    eng = cuda_engine(torch, synth)
    c = eng.PREFILL_CHUNK
    ids = torch.randint(0, eng.arch.vocab_size, (ENGINE_PROMPT,),
                        generator=torch.Generator().manual_seed(29)).tolist()
    chunks = -(-len(ids) // c)
    kv = eng._start_kv()
    g = eng._graphs_of(kv)
    torch.cuda.synchronize()
    pool0 = graph_pool_bytes(torch)
    t1 = time.perf_counter()
    g.capture([g.key("prefill", c)])
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t1
    pool = graph_pool_bytes(torch) - pool0
    ref = eng._make_kv()

    def prefill(cache):
        """The whole prompt from a zeroed cache: (last logits, wall ms a
        chunk); the engine's own cache replays, the twin runs uncaptured."""
        for x in (cache.k, cache.v):
            x.zero_()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _, _ = eng._prefill(cache, ids)
        logits = logits.clone()
        logits.cpu()
        return logits, (time.perf_counter() - t) / chunks * 1e3
    lu, ms_u1 = prefill(ref)
    lg, ms_g1 = prefill(kv)
    check(torch.equal(lu, lg) and bool(torch.isfinite(lg).all()),
          f"{tag}: the replayed prefill's last logits differ from the "
          "uncaptured prefill's")
    check(same_caches(torch, ref, kv), f"{tag}: the replayed prefill's cache "
          "differs from the uncaptured prefill's")
    lg2, ms_g2 = prefill(kv)
    lu2, ms_u2 = prefill(ref)
    check(torch.equal(lu2, lg2) and torch.equal(lg, lg2),
          f"{tag}: the timed turns' logits differ")
    replays = g.replays[g.key("prefill", c)]
    check(replays == 2 * chunks, f"{tag}: {replays} prefill replays, not "
          f"{2 * chunks}")
    t2 = time.perf_counter()
    off = 6 * c
    win = torch.tensor(ids[off:off + c]).numpy()
    prof = graph_kernels(torch, counters, tag,
                         lambda: eng._prefill_chunk(ref, win, off, c),
                         lambda: eng._prefill_chunk(kv, win, off, c),
                         same_count=False)
    cell = {"seconds": {"chains": t2 - t0,
                        "profiles": time.perf_counter() - t2},
            "ctx": eng.arch.max_seq_len, "prompt": len(ids),
            "chunks": chunks, "tail_n_valid": len(ids) - (chunks - 1) * c,
            "capture_s": cap_s, "graph_pool_bytes": pool,
            "wall_ms_chunk_uncaptured": [ms_u1, ms_u2],
            "wall_ms_chunk_replayed": [ms_g1, ms_g2],
            "ms_chunk_uncaptured": (ms_u1 + ms_u2) / 2,
            "ms_chunk_replayed": (ms_g1 + ms_g2) / 2, **prof}
    cell["replay_busy_share"] = (prof["replay"]["device_ms"]
                                 / cell["ms_chunk_replayed"])
    cell["uncaptured_busy_share"] = (prof["uncaptured"]["device_ms"]
                                     / cell["ms_chunk_uncaptured"])
    print(json.dumps({f"graphs_{tag}": cell}), flush=True)
    del eng, g, kv, ref
    return cell


MESH_STEPS = 64   # phases tp, cp, cptp, ep, dp, pp: replayed steps held
MESH_TURN = 32    # bit for bit, and the second timed turn's steps
STALL_STEPS = 4   # the card phases: replays with a card's stream stalled
STALL_CYCLES = 50_000_000   # torch.cuda._sleep before each (~25 ms)


def card_busy(torch, fn, cards, calls: int = 5) -> dict:
    """Each card's device ms a call of fn and its share of the call's wall
    (host clock over `calls` calls, then one torch.profiler trace of as
    many; the profiler can lose a few records, so a share is a floor)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if "CUDA" in str(e.device_type) and e.self_device_time_total > 0:
            ms[e.device_index] = (ms.get(e.device_index, 0.0)
                                  + e.self_device_time_total / 1e3 / calls)
    return {"wall_ms": wall, "cards": {
        str(c): {"device_ms": ms.get(c.index, 0.0),
                 "busy_share": ms.get(c.index, 0.0) / wall} for c in cards}}


def stall(torch, card) -> None:
    """A long kernel on `card`'s current stream: whatever is launched there
    next starts ~25 ms late."""
    with torch.cuda.device(card):
        torch.cuda._sleep(STALL_CYCLES)


def program_shape(prog) -> dict:
    """The graphs and hand-offs a replay of a captured program launches: a
    CardGraph's stretches and hand-offs, one graph and none on one card."""
    return {"graphs": getattr(prog, "segments", 1),
            "handoffs": getattr(prog, "handoffs", 0)}
# phases graphs (the 8B Q8_0 and Q4_K_M cells), moe's replayed Mixtral steps
# and the mesh phases cp, tp, dp, pp, cptp and ep: the layers of the model
# they run (the widths are the model's own). Their uncaptured references
# launch from the host, layer by layer: at full depth the mesh phases took
# 290.1 of the script's 979.5 s on an H100 80GB HBM3 at 700 W, and the
# graphs phases 83.8 of 807.3 s with the mesh phases at 8 layers.
CUT_LAYERS = 8


def depth_cut(synth, n: int = CUT_LAYERS):
    """A synthetic model (build_synth's or build_mixtral's tuple) cut to
    its first n layers: free views of the stacked planes, cfg and arch
    with n_layers = n, and the bytes a decoded token reads cut to match
    (each layer's share; routed experts at k of E)."""
    import dataclasses
    from ntransformer_tpu_torch.ops.linear import QLinear
    from ntransformer_tpu_torch.parallel.ep import EXPERT_FIELDS
    cfg, arch, weights, per_token = synth
    lw = weights.layers
    layer_bytes = 0
    for f in lw.__dataclass_fields__:
        v = getattr(lw, f)
        b = (v.nbytes if isinstance(v, QLinear) else
             0 if v is None else v.numel() * v.element_size())
        if f in EXPERT_FIELDS and b:
            b = b * arch.n_experts_used // arch.n_experts
        layer_bytes += b
    cut = layer_bytes * (arch.n_layers - n) // arch.n_layers
    return (dataclasses.replace(cfg, n_layers=n),
            dataclasses.replace(arch, n_layers=n), layer_view(weights, n),
            per_token - cut)


def clone_caches(kv):
    """A copy of a KVCache, a BatchedKV, or a mesh's list (or grid) of
    them."""
    if isinstance(kv, list):
        return [clone_caches(c) for c in kv]
    return type(kv)(*(None if t is None else t.clone()
                      for t in (kv.k, kv.v, kv.ks, kv.vs)))


def cache_tensors(kv) -> list:
    """Every tensor of a cache, a mesh's list of caches or a grid."""
    if isinstance(kv, list):
        return [t for c in kv for t in cache_tensors(c)]
    return [t for t in (kv.k, kv.v, kv.ks, kv.vs) if t is not None]


def same_caches(torch, a, b) -> bool:
    """Two caches (or lists, grids of them) equal byte for byte."""
    ta, tb = cache_tensors(a), cache_tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def replay_profile(torch, counters, tag: str, plain, graph) -> dict:
    """graph_kernels of one uncaptured call and one replay, reduced to
    what the PERF tables keep: kernels and device ms of each, and the
    port's kernels a replay runs (held equal to the uncaptured call's
    launches by graph_kernels)."""
    prof = graph_kernels(torch, counters, tag, plain, graph,
                         same_count=False)
    return {"launches_uncaptured": prof["launches_uncaptured_step"],
            **{f"{k}_{f}": prof[k][f] for k in ("uncaptured", "replay")
               for f in ("device_ms", "kernels", "own_kernels", "copies")},
            "replay_top": prof["replay"]["top"]}


def mesh_engine_cell(torch, counters, tag: str, eng, ids: list,
                     steps: int = MESH_STEPS, cards=None) -> dict:
    """A mesh engine's replayed programs on cuda:0 (Engine._graph_path:
    the mesh's ForwardGraphs, bound to the engine's own cache) against its
    uncaptured calls on a twin cache (every shard's bytes):
      prefill: `ids` in the engine's chunks, replayed (the prefill key,
               captured first) and uncaptured, each from a zeroed cache:
               the last logits and every shard's cache bytes bit-equal;
               wall ms a chunk in turns (uncaptured, replayed, replayed,
               uncaptured);
      decode:  `steps` greedy steps from the prefill's token as the loop
               step replayed (ForwardGraphs.loop: the tokens chained on the
               device) and as the uncaptured chain of eng._decode_step:
               tokens, last logits and caches bit-equal; a second turn of
               MESH_TURN steps the other way round; wall ms a token of
               each, and of a replayed step (ForwardGraphs.step, the path
               generate takes) beside them;
      profile: the kernels and device ms of a replayed T = 1 step and of an
               uncaptured one, and the replay's busy share of its wall.
    cards: the cards of a mesh over several (the card phases): then also
    STALL_STEPS replayed steps, each after a long kernel on one of the
    other cards' streams, bit-equal to the uncaptured steps; each card's
    busy share of a replayed step; the graphs and hand-offs of a replayed
    step and loop step."""
    from ntransformer_tpu_torch.inference.engine import _bucket
    check(eng._graph_path(), f"{tag}: the engine takes no graph path on "
          "one card")
    t0 = time.perf_counter()
    c = eng.PREFILL_CHUNK
    n = len(ids)
    chunk = min(_bucket(n), eng.arch.max_seq_len) if n <= c else c
    chunks = -(-n // c)
    kv = eng._start_kv()
    g = eng._graphs_of(kv)
    ref = eng._make_kv()
    t1 = time.perf_counter()
    g.capture([g.key("prefill", chunk, layers=eng.layer_sel),
               g.key("loop", n_steps=steps, layers=eng.layer_sel),
               g.key("loop", n_steps=MESH_TURN, layers=eng.layer_sel),
               g.key("step", layers=eng.layer_sel)])
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t1

    def prefill(cache):
        for x in cache_tensors(cache):
            x.zero_()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _, _ = eng._prefill(cache, ids)
        logits = logits.clone()
        logits.cpu()
        return logits, (time.perf_counter() - t) / chunks * 1e3
    lu, pu1 = prefill(ref)
    lg, pg1 = prefill(kv)
    check(torch.equal(lu, lg) and bool(torch.isfinite(lg).all()),
          f"{tag}: the replayed prefill's last logits differ from the "
          "uncaptured prefill's")
    check(same_caches(torch, ref, kv), f"{tag}: the replayed prefill's "
          "cache differs from the uncaptured prefill's")
    lg2, pg2 = prefill(kv)
    lu2, pu2 = prefill(ref)
    check(torch.equal(lu2, lg2) and torch.equal(lg, lg2),
          f"{tag}: the timed prefill turns' logits differ")
    first = torch.argmax(lu[0])
    tu, lu_, mu1 = engine_chain(torch, eng, ref, first, n, steps)
    tg, lg_, mg1 = engine_loop(torch, g, kv, first, n, steps)
    check(torch.equal(tu, tg) and torch.equal(lu_, lg_),
          f"{tag}: the replayed loop's tokens or last logits differ from "
          f"the uncaptured chain's: {tu.tolist()} / {tg.tolist()}")
    check(same_caches(torch, ref, kv), f"{tag}: the replayed loop's cache "
          "differs from the uncaptured chain's")
    base = n + steps
    tg2, _, mg2 = engine_loop(torch, g, kv, tu[-1], base, MESH_TURN)
    tu2, _, mu2 = engine_chain(torch, eng, ref, tu[-1], base, MESH_TURN)
    check(torch.equal(tu2, tg2), f"{tag}: the timed turns' tokens differ")
    base += MESH_TURN
    # the replayed T = 1 step (generate's path) on the engine's cache
    ts, _, ms_step = engine_chain(torch, eng, kv, tu2[-1], base, MESH_TURN)
    tr, _, _ = engine_chain(torch, eng, ref, tu2[-1], base, MESH_TURN)
    check(torch.equal(ts, tr) and same_caches(torch, ref, kv),
          f"{tag}: the replayed steps differ from the uncaptured ones")
    base += MESH_TURN
    extra = {}
    if cards is not None:
        tok = tr[-1]
        for i in range(STALL_STEPS):
            stall(torch, cards[1 + i % (len(cards) - 1)])
            lg, _, _ = eng._decode_step(kv, tok, base + i)
            lu, _, _ = eng._decode_step(ref, tok, base + i)
            check(torch.equal(lg, lu), f"{tag}: a replay after a stalled "
                  f"card differs from the uncaptured step ({i})")
            tok = torch.argmax(lu[0])
        check(same_caches(torch, ref, kv), f"{tag}: the stalled replays' "
              "cache differs from the uncaptured steps'")
        base += STALL_STEPS
        extra = {"stalled_steps_bit_equal": STALL_STEPS,
                 "step_program": program_shape(g._graphs[g.key(
                     "step", layers=eng.layer_sel)][0]),
                 "loop_program": program_shape(g._graphs[g.key(
                     "loop", n_steps=MESH_TURN, layers=eng.layer_sel)][0]),
                 "busy": card_busy(torch, lambda: eng._decode_step(
                     kv, tok, base), cards)}
        tr = tok.reshape(1)
    t2 = time.perf_counter()
    tok = tr[-1]
    prof = replay_profile(torch, counters, tag,
                          lambda: eng._decode_step(ref, tok, base),
                          lambda: eng._decode_step(kv, tok, base))
    cell = {"seconds": {"chains": t2 - t0,
                        "profiles": time.perf_counter() - t2},
            "capture_s": cap_s, "prompt": n, "chunks": chunks,
            "chunk": chunk, "steps_bit_equal": steps + 2 * MESH_TURN,
            "prefill_ms_chunk_uncaptured": [pu1, pu2],
            "prefill_ms_chunk_replayed": [pg1, pg2],
            "loop_ms_token_uncaptured": [mu1, mu2],
            "loop_ms_token_replayed": [mg1, mg2],
            "step_ms_token_replayed": ms_step,
            "ms_uncaptured": (mu1 + mu2) / 2,
            "ms_replayed": (mg1 + mg2) / 2, **prof, **extra}
    cell["replay_busy_share"] = (prof["replay_device_ms"]
                                 / cell["ms_replayed"])
    cell["uncaptured_busy_share"] = (prof["uncaptured_device_ms"]
                                     / cell["ms_uncaptured"])
    print(json.dumps({f"replay_{tag}": cell}), flush=True)
    del g, kv, ref
    eng._held.clear()
    torch.cuda.empty_cache()
    return cell


def replayed_pass(engine, torch, ids, n: int):
    """greedy_pass on the engine's own cache (Engine._start_kv), which its
    graph path replays: (tokens, every step's logits on the CPU, every
    shard's cache tensors on the CPU)."""
    kv = engine._start_kv()
    logits, kv, _ = engine._prefill(kv, ids)
    toks, out = [], [logits[0].float().cpu()]
    pos = len(ids)
    for i in range(n):
        tok = int(torch.argmax(out[-1]))
        toks.append(tok)
        logits, kv, _ = engine._decode_step(kv, tok, pos + i)
        out.append(logits[0].float().cpu())
    return toks, out, [t.cpu() for t in cache_tensors(kv)]


def turns(torch, runs: dict) -> dict:
    """Each run (a callable returning its wall ms) twice, in turns: A, B,
    B, A for two runs. Returns each run's [first, second] ms."""
    names = list(runs)
    ms = {k: [] for k in names}
    for name in names + names[::-1]:
        ms[name].append(runs[name]())
    return ms


def loop_turns(torch, engines: dict, ids: list) -> dict:
    """MESH_TURN greedy loop steps replayed on each engine's own cache after
    a replayed prefill of ids (the loop key captured first), the engines in
    turns: wall ms a token of each, twice."""
    state = {}
    for name, eng in engines.items():
        kv = eng._start_kv()
        g = eng._graphs_of(kv)
        g.capture([g.key("loop", n_steps=MESH_TURN, layers=eng.layer_sel)])
        lg, _, _ = eng._prefill(kv, ids)
        state[name] = [g, kv, torch.argmax(lg[0]), len(ids)]

    def run(name):
        def go():
            g, kv, tok, pos = state[name]
            toks, _, ms = engine_loop(torch, g, kv, tok, pos, MESH_TURN)
            state[name][2:] = [toks[-1], pos + MESH_TURN]
            return ms
        return go
    got = turns(torch, {k: run(k) for k in engines})
    toks = {k: int(v[2]) for k, v in state.items()}
    check(len(set(toks.values())) == 1, f"loop turns: the engines' last "
          f"tokens differ: {toks}")
    for eng in engines.values():
        eng._held.clear()
    return got


def cards_vs_one(torch, counters, tag: str, cards, one, ids: list, n: int,
                 cell_ids=None) -> dict:
    """A mesh engine whose positions lie on several cards (`cards`) against
    the same mesh on cuda:0 (`one`), both on their graph paths:
      uncaptured: greedy_pass of both (on caches of the caller's own, which
                  run uncaptured): tokens and every step's logits
                  bit-equal;
      replayed:   replayed_pass of both (CardGraphs over the cards, one
                  graph a key on cuda:0): tokens, every step's logits and
                  every shard's cache bytes bit-equal, and the tokens equal
                  to the uncaptured pass's;
      cell:       mesh_engine_cell over the cards (replayed against
                  uncaptured on twin caches, the stalled-card steps, each
                  card's busy share, the graphs and hand-offs of a replay),
                  on cell_ids (default ids);
      turns:      MESH_TURN loop steps replayed over the cards and on
                  cuda:0, in turns (cards, cuda:0, cuda:0, cards).
    Returns the uncaptured pass's launches with the cell and the turns."""
    devs = cards._graphs_of(cards._start_kv()).cards
    check(cards._graph_path() and one._graph_path() and len(devs) > 1,
          f"{tag}: the mesh over cards (on {devs}) or the mesh on cuda:0 "
          "takes no graph path")
    reset(counters)
    toks_c, logits_c = greedy_pass(cards, torch, ids, n)
    launches = read(counters)
    toks_o, logits_o = greedy_pass(one, torch, ids, n)
    diff = max(float((a - b).abs().max()) for a, b in zip(logits_c, logits_o))
    check(toks_c == toks_o and diff == 0.0, f"{tag}: uncaptured over the "
          f"cards vs on cuda:0: tokens {toks_c} / {toks_o}, max |dlogit| "
          f"{diff}")
    rt_c, rl_c, kv_c = replayed_pass(cards, torch, ids, n)
    rt_o, rl_o, kv_o = replayed_pass(one, torch, ids, n)
    check(rt_c == rt_o == toks_c and all(torch.equal(a, b) for a, b in
                                         zip(rl_c, rl_o)),
          f"{tag}: replayed over the cards vs on cuda:0: tokens {rt_c} / "
          f"{rt_o} (uncaptured {toks_c}), or logits differ")
    check(len(kv_c) == len(kv_o) and all(torch.equal(a, b) for a, b in
                                         zip(kv_c, kv_o)),
          f"{tag}: replayed over the cards vs on cuda:0: a shard's cache "
          "bytes differ")
    print(f"{tag}: over {[str(d) for d in devs]} and on cuda:0, uncaptured "
          f"and replayed: tokens, logits and caches bit-equal ({n} steps)",
          flush=True)
    del kv_c, kv_o
    cell = mesh_engine_cell(torch, counters, tag, cards, cell_ids or ids,
                            cards=devs)
    walls = loop_turns(torch, {"cards": cards, "cuda:0": one},
                       cell_ids or ids)
    out = {"cards": [str(d) for d in devs], "launches": launches,
           "steps_bit_equal": n, "replay": cell,
           "loop_ms_token_replayed_in_turns": walls}
    print(json.dumps({f"cards_{tag}": {k: v for k, v in out.items()
                                       if k != "replay"}}), flush=True)
    return out


def batched_replay_cell(torch, counters, tag: str, plain, graph, ref, kv,
                        b_n: int, pos0, first, caches=lambda x: x,
                        steps: int = MESH_STEPS, cards=None) -> dict:
    """A batched B = b_n step two ways from one cache state: plain(ref,
    tokens, pos, active) uncaptured on one copy and graph(kv, ...)
    replaying its captured program(s) on another (caches(x): x's caches):
    `steps` greedy steps from `first` at positions pos0 + i, every step's
    logits, the tokens and the caches bit-equal; a second turn of MESH_TURN
    steps the other way round; wall ms a step of each; the kernels and
    device ms of one step of each and the replay's busy share. cards: the
    cards of a mesh over several: also STALL_STEPS replayed steps, each
    after a long kernel on one of the other cards' streams, bit-equal to
    the uncaptured steps, and each card's busy share of a replay."""
    act = torch.ones(b_n, dtype=torch.bool, device="cuda")

    def chain(step, cache, tok, base, n, keep):
        kept = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            lg = step(cache, tok, pos0 + base + i, act)
            if keep:
                kept.append(lg.clone())
            tok = torch.argmax(lg, -1)
        tok.cpu()
        return tok, kept, (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    tu, lu, mu1 = chain(plain, ref, first, 0, steps, True)
    tg, lg, mg1 = chain(graph, kv, first, 0, steps, True)
    bad = [i for i, (a, b) in enumerate(zip(lu, lg)) if not torch.equal(a, b)]
    check(not bad and torch.equal(tu, tg), f"{tag}: replayed steps "
          f"{bad[:8]} of {steps} differ from the uncaptured chain's logits")
    check(same_caches(torch, caches(ref), caches(kv)), f"{tag}: the replayed "
          "chain's caches differ from the uncaptured chain's")
    check(bool(torch.isfinite(lg[-1]).all()), f"{tag}: non-finite logits")
    del lu, lg
    tg2, _, mg2 = chain(graph, kv, tu, steps, MESH_TURN, False)
    tu2, _, mu2 = chain(plain, ref, tu, steps, MESH_TURN, False)
    check(torch.equal(tu2, tg2), f"{tag}: the timed turns' tokens differ")
    base = steps + MESH_TURN
    extra = {}
    if cards is not None:
        for i in range(STALL_STEPS):
            stall(torch, cards[1 + i % (len(cards) - 1)])
            lg = graph(kv, tu2, pos0 + base + i, act).clone()
            lu = plain(ref, tu2, pos0 + base + i, act)
            check(torch.equal(lg, lu), f"{tag}: a replay after a stalled "
                  f"card differs from the uncaptured step ({i})")
            tu2 = torch.argmax(lu, -1)
        check(same_caches(torch, caches(ref), caches(kv)), f"{tag}: the "
              "stalled replays' caches differ from the uncaptured steps'")
        base += STALL_STEPS
        extra = {"stalled_steps_bit_equal": STALL_STEPS,
                 "busy": card_busy(torch, lambda: graph(
                     kv, tu2, pos0 + base, act), cards)}
    t2 = time.perf_counter()
    prof = replay_profile(torch, counters, tag,
                          lambda: plain(ref, tu2, pos0 + base, act),
                          lambda: graph(kv, tu2, pos0 + base, act))
    cell = {"seconds": {"chains": t2 - t0,
                        "profiles": time.perf_counter() - t2},
            "B": b_n, "steps_bit_equal": steps + MESH_TURN,
            "ms_step_uncaptured": [mu1, mu2], "ms_step_replayed": [mg1, mg2],
            "ms_uncaptured": (mu1 + mu2) / 2, "ms_replayed": (mg1 + mg2) / 2,
            **prof, **extra}
    cell["replay_busy_share"] = (prof["replay_device_ms"]
                                 / cell["ms_replayed"])
    cell["uncaptured_busy_share"] = (prof["uncaptured_device_ms"]
                                     / cell["ms_uncaptured"])
    print(json.dumps({f"replay_{tag}": cell}), flush=True)
    return cell


def engine_moe_step(torch, synth) -> dict:
    """Phase moe: the Mixtral Engine's T = 1 step (the device expert select
    inside the captured forward) replayed GRAPH_MOE_STEPS times after a
    64-token prefill, each step's logits, the tokens and the caches
    bit-equal to the uncaptured step's on a twin cache; wall ms a token."""
    eng = cuda_engine(torch, synth)
    kv, ref, tok, base = engine_prefilled(torch, eng, 64, 23)
    lu, lg = [], []
    for i in range(GRAPH_MOE_STEPS):
        lg.append(eng._decode_step(kv, tok, base + i)[0].clone())
        lu.append(eng._decode_step(ref, tok, base + i)[0])
        tok = torch.argmax(lu[-1][0])
    bad = [i for i, (a, b) in enumerate(zip(lu, lg)) if not torch.equal(a, b)]
    check(not bad and same_caches(torch, ref, kv), f"mixtral Engine step: "
          f"replayed steps {bad} (or the caches) differ from the uncaptured "
          "ones")
    base += GRAPH_MOE_STEPS
    _, _, ms_g = engine_chain(torch, eng, kv, tok, base, GRAPH_MOE_STEPS)
    _, _, ms_u = engine_chain(torch, eng, ref, tok, base, GRAPH_MOE_STEPS)
    g = eng._graphs_of(kv)
    out = {"steps_bit_equal": GRAPH_MOE_STEPS, "ms_replayed": ms_g,
           "ms_uncaptured": ms_u, "captures": g.captures,
           "replays": sum(g.replays.values())}
    del eng, g, kv, ref
    return out


# ---------------------------------------------------------------- phase 4
# f16 scales of the synthetic 8B models, per format: with codes uniform over
# their range the weights are centred and |w| averages ~0.02 (Q8_0: codes in
# [-8, 8] at d = 0.004). Q4_0: (nib - 8) * 0.005; Q4_K: q * (0.000625 * 8) -
# 0.0046875 * 8 = 0.005 q - 0.0375; Q5_K: 0.0025 q - 0.03875; Q6_K:
# (q - 32) * (0.00015625 * 8) = 0.00125 (q - 32); sc / mn stay 8.
# W4A8: c * 0.004 - 0.03 over c in [0, 15] (|w| ~ 0.015); W8A8: codes
# uniform over [-127, 127] at s = 0.0003 (|w| ~ 0.019).
SYNTH_SCALES = {"q4_0": {"d": 0.005}, "q4_k": {"d": 0.000625,
                                              "dmin": 0.0046875},
                "q5_k": {"d": 0.0003125, "dmin": 0.00484375},
                "q6_k": {"d": 0.00015625},
                "w4a8": {"s_lo": 0.004, "s_hi": 0.004, "m_lo": 0.03,
                         "m_hi": 0.03},
                "w8a8": {"s": 0.0003}}


def fill_codes(torch, weights, g) -> None:
    """Seeded random codes of a realistic spread (SYNTH_SCALES) in every
    quantized matrix of the synthetic weights; a float router (MoE) gets
    N(0, 0.02) weights, so tokens route to different experts."""
    from ntransformer_tpu_torch.ops import linear
    mats = [weights.embed, weights.lm_head] + [
        v for v in (getattr(weights.layers, f)
                    for f in weights.layers.__dataclass_fields__)
        if isinstance(v, linear.QLinear)]
    for ql in mats:
        if ql.dtype.value == "q8_0":  # |w| ~ 0.02 at d = 0.004
            ql.planes["qs"].random_(-8, 9, generator=g)
            continue
        for nm, p in ql.planes.items():
            if nm in ("qs", "ql", "qh"):
                p.random_(0, 256, generator=g)
            elif nm == "q":  # W8A8 codes
                p.random_(-127, 128, generator=g)
            elif nm in ("d", "dmin"):
                p.copy_(torch.full_like(p, SYNTH_SCALES[ql.dtype.value][nm],
                                        dtype=torch.float16)
                        .view(torch.int16))
            elif nm == "w":  # a float matrix: the MoE router
                p.copy_(torch.randn(p.shape, device="cuda", generator=g)
                        * 0.02)
            elif p.dtype == torch.float32:  # W4A8 / W8A8 scales and mins
                p.fill_(SYNTH_SCALES[ql.dtype.value][nm])


def build_synth(torch, dtype: str = "q8_0"):
    """The synthetic Llama-3.1-8B in `dtype` ("q4_k_m" takes the Q4_K_M
    policy; "w4a8" and "w8a8" are built in the format, as the JAX synth
    builds them) on the card, with seeded random codes of a realistic spread:
    (cfg, arch, weights, bytes read per decoded token)."""
    from ntransformer_tpu_torch.models.synth import model_nbytes, synth_model
    t0 = time.perf_counter()
    cfg, arch, weights = synth_model("8b", dtype, fuse=True,
                                     max_seq_len=4096)
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    fill_codes(torch, weights, g)
    torch.cuda.synchronize()
    nbytes = model_nbytes(weights)
    per_token = nbytes - weights.embed.nbytes - (weights.rope_cos.numel()
                                                 + weights.rope_sin.numel()) * 4
    print(f"8b {dtype} synth: {nbytes / 1e9:.3f} GB of planes, "
          f"{per_token / 1e9:.3f} GB read per decoded token, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, arch, weights, per_token


def full_width_phase(torch, counters, card: str, synth,
                     kernels=ENGINE_KERNELS, prefill_kernels=None):
    """Engine.benchmark on the synthetic 8B (every kernel of `kernels`
    launched), a decode profile, and a 2-layer prefill view with the kernels
    on and off (every kernel of `prefill_kernels`, by default `kernels`,
    launched)."""
    import dataclasses
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.ops import linear

    cfg, arch, weights, per_token = synth
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    engine = Engine(model)
    ids = torch.randint(0, arch.vocab_size, (512,),
                        generator=torch.Generator().manual_seed(9)).tolist()
    # the window opens before the Engine's first capture: its replays
    # advance no counter, its warm-up and capture do
    reset(counters)
    stats = engine.benchmark(prompt_ids=ids, n_tokens=64)
    torch.cuda.synchronize()
    launches = read(counters)
    tag = cfg.model_name
    print(f"{tag} Engine path launches {launches}", flush=True)
    check(all(launches[k] > 0 for k in kernels),
          f"{tag}: the Engine path launched a kernel zero times: {launches}")
    replays = replay_count(engine)
    check(replays == {"prefill": 1, "loop": 2 * stats.decode_tokens},
          f"{tag}: Engine.benchmark replayed {replays}, not its prefill "
          f"chunk and its loop step in both runs")
    ms_tok = stats.decode_ms / stats.decode_tokens
    summary = {"card": card, "prefill_tokens": stats.prefill_tokens,
               "prefill_ms": stats.prefill_ms,
               "prefill_tok_s": stats.prefill_tps,
               "decode_tokens": stats.decode_tokens,
               "decode_ms_per_token": ms_tok, "decode_tok_s": stats.decode_tps,
               "effective_GB_s": per_token * stats.decode_tps / 1e9,
               "decode_bound_ms_per_token": per_token / HBM_BYTES_PER_S * 1e3,
               "graph_replays": replays}
    print(json.dumps({f"full_width_{tag}": summary}), flush=True)

    kv = engine._make_kv()
    logits, kv, _ = llama.forward(arch, weights, kv, ids, 0, n_valid=512)
    nxt = int(torch.argmax(logits[0]))
    logits2, kv, _ = llama.forward(arch, weights, kv, [nxt], 512)
    check(bool(torch.isfinite(logits).all() and torch.isfinite(logits2).all()),
          "8b: non-finite logits")
    check(tuple(logits2.shape) == (1, arch.vocab_size), "8b: logits shape")
    summary["decode_profile"] = profile_decode(torch, arch, weights, kv,
                                               logits2, 513)
    del kv

    # kernels on vs off on a 2-layer view of the same weights; an MoE
    # model's kernel run replays the plain run's routing (RouteTape)
    arch2 = dataclasses.replace(arch, n_layers=2)
    w2 = layer_view(weights, 2)
    outs, tape = {}, RouteTape()
    for mode in ("off", "auto"):
        linear.KERNEL_MODE = mode
        try:
            reset(counters)
            kv2 = llama.KVCache.create(arch2, device="cuda")
            with (tape.record() if mode == "off" else tape.replay()):
                lg, _, _ = llama.forward(arch2, w2, kv2, ids, 0,
                                         all_logits=True)
            torch.cuda.synchronize()
            outs[mode] = (lg, read(counters))
        finally:
            linear.KERNEL_MODE = "auto"
    check(all(outs["auto"][1][k] > 0 for k in prefill_kernels or kernels),
          f"2-layer kernel run launched {outs['auto'][1]}")
    check(all(v == 0 for v in outs["off"][1].values()),
          f"2-layer plain run launched kernels: {outs['off'][1]}")
    a, b = outs["auto"][0], outs["off"][0]
    rel = float((a - b).abs().max() / b.abs().max())
    if arch.n_experts:
        summary["two_layer_natural_route_flips"] = tape.flips
    print(f"{tag} 2-layer prefill logits, kernels on vs off: "
          f"max|d|/max|off| = {rel:.3e} (tol {FULL_LOGIT_RTOL}); routing "
          f"forced, natural flips {tape.flips}", flush=True)
    check(bool(torch.isfinite(a).all()), "8b 2-layer: non-finite logits")
    check(rel <= FULL_LOGIT_RTOL,
          f"{tag} 2-layer logits differ by {rel} of their range")
    summary["two_layer_logit_rel_err"] = rel
    return summary, launches


def replay_count(eng) -> dict:
    """The replays of a graph-path Engine's programs so far, by kind, over
    its caches' ForwardGraphs."""
    out = {}
    for _, g in eng._held.values():
        for key, n in g.replays.items():
            out[key.kind] = out.get(key.kind, 0) + n
    return out


def profile_decode(torch, arch, weights, kv, logits, pos: int,
                   steps: int = 4, **fw) -> dict:
    """Device time by kernel over a few greedy decode steps (torch.profiler
    with CUDA activity alone, as profile_batched), and the share of the
    wall time the card was busy. The profiler's own host cost inflates the
    wall time. fw: forward's
    keywords (tp=mesh, weights and kv then the shards')."""
    from torch.profiler import ProfilerActivity, profile
    from ntransformer_tpu_torch.models import llama
    tok = torch.argmax(logits[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, kv, _ = llama.forward(arch, weights, kv, tok.reshape(1),
                                          pos + i, **fw)
            tok = torch.argmax(logits[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' time
        if "CUDA" not in str(e.device_type):
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.count // steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = {"steps": steps, "wall_ms_per_token": wall_ms / steps,
           "device_ms_per_token": busy,
           "kernels_per_token": sum(r[1] for r in rows),
           "device_busy_share": busy * steps / wall_ms if wall_ms else 0.0,
           "top": [{"kernel": k[:80], "ms_per_token": ms, "per_token": c}
                   for ms, c, k in rows[:12]]}
    print(json.dumps({"decode_profile": out}), flush=True)
    return out


# ------------------------------------------------------ nibble formats
def random_planes(torch, g, dtype, k: int, n: int) -> dict:
    """Planes of a random [K, N] matrix in a nibble format on the card:
    uniform codes, 6-bit scales and mins (signed for Q6_K), f16 scales in
    [1e-3, 1.1e-2]; nothing is symmetric in K."""
    from ntransformer_tpu_torch.core.layout import LAYOUTS
    planes = {}
    for spec in LAYOUTS[dtype]:
        shape = (k // spec.rows_div, n)
        if spec.np_dtype == "uint16":
            planes[spec.name] = (torch.rand(shape, device="cuda", generator=g)
                                 * 0.01 + 1e-3).to(torch.float16).view(
                                     torch.int16)
        elif spec.name.startswith(("sc", "mn")):
            lo, hi = (-32, 32) if spec.np_dtype == "int8" else (0, 64)
            planes[spec.name] = torch.randint(
                lo, hi, shape, dtype=getattr(torch, spec.np_dtype),
                device="cuda", generator=g)
        else:
            planes[spec.name] = torch.randint(0, 256, shape,
                                              dtype=torch.uint8,
                                              device="cuda", generator=g)
    return planes


def nibble_kernel_phase(torch, timer, card: str) -> dict:
    """The Q4_0, Q4_K, Q5_K and Q6_K dequant-matmul kernels against their
    plain twins on the card, at T = 1, 32 and 512, at the 8B shapes (fused
    qkv, wo, fused gate|up, down; the 128256-token head for Q6_K, and for
    Q4_0 at T = 1), a layer view of stacked planes, repolm512's K = 1024
    down and 384-wide head, a ragged N = 200 (scalar loads) and, for Q4_0,
    K = 1056 (a half K step and stage) at T = 1, 32, 70 and 512; for Q4_0,
    Q4_K and Q5_K at the 8B gate|up and Q6_K at the 8B down also T = 8
    (the 8-slot server's step) and T = 64 (the first tile T). Times by
    CUDA events as in the kernels phase; the library yardstick is
    torch.matmul on the pre-dequantized bf16 weight. Every row carries the
    profiler's device time and kernels a call, the counter reading as
    many. Every call is one kernel (the skinny kernel up to 32 tokens, the
    wgmma tile past it) and no other."""
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.core.layout import LAYOUTS
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
    g = torch.Generator(device="cuda")
    g.manual_seed(5678)
    out = {}
    for dtype in (DType.Q4_0, DType.Q4_K, DType.Q5_K, DType.Q6_K):
        kern = nm.KERNELS[dtype]
        one_kernel = dtype in nm.KQ_FORMATS
        wide = {DType.Q4_0: "8b gate|up", DType.Q4_K: "8b gate|up",
                DType.Q5_K: "8b gate|up", DType.Q6_K: "8b down"}.get(dtype)
        shapes = [(label, k, n, (1, 8, 32, 64, 512) if label == wide
                   else (1, 32, 512))
                  for label, k, n in (("8b qkv", 4096, 6144),
                                      ("8b wo", 4096, 4096),
                                      ("8b gate|up", 4096, 28672),
                                      ("8b down", 14336, 4096))]
        if dtype == DType.Q6_K:
            shapes.append(("8b head", 4096, 128256, (1, 32, 512)))
        if dtype == DType.Q4_0:
            shapes.append(("8b head", 4096, 128256, (1,)))
        # the 8B Q4_K_M's TP shard shapes (Q4_K: qkv, gate|up, wo; Q6_K:
        # down and the head)
        shapes += [(label, k, n, (1, 512))
                   for label, k, n in tp_shapes(dtype.value)]
        shapes += [("8b stacked[1] wo", 4096, 4096, (1, 32)),
                   ("repolm512 down", 1024, 512, (1, 32, 70)),
                   ("repolm512 head", 512, 384, (1, 70)),
                   ("ragged 1024x200", 1024, 200, (1, 70))]
        if dtype == DType.Q4_0:
            shapes.append(("odd K 1056x256", 1056, 256, (1, 32, 70, 512)))
        rows = []
        for label, k, n, ts in shapes:
            if label.startswith("8b stacked"):
                stack = [random_planes(torch, g, dtype, k, n)
                         for _ in range(2)]
                planes = {nm_: torch.stack([p[nm_] for p in stack])[1]
                          for nm_ in stack[0]}
            else:
                planes = random_planes(torch, g, dtype, k, n)
            w = dequant_planes_torch(planes, dtype, k, n,
                                     out_dtype=torch.bfloat16)
            pbytes = sum(a.numel() * a.element_size()
                         for a in planes.values())
            for t in ts:
                x = torch.randn(t, k, device="cuda", generator=g).to(
                    torch.bfloat16)
                before = kern.launches
                y = nm.nibble_matmul_cuda(x, planes, dtype)
                per_call = kern.launches - before
                y0 = nm.nibble_matmul_plain(x, planes, dtype)
                torch.cuda.synchronize()
                err = float((y - y0).abs().max())
                tol = MATMUL_RTOL * float(y0.abs().max())
                name = f"{kern.name} {label} T={t}"
                check(bool(torch.isfinite(y).all()), f"{name}: non-finite")
                check(err <= tol,
                      f"{name}: max|kernel-plain| {err} > {tol}")
                ms = timer.compare({
                    "kernel": lambda: nm.nibble_matmul_cuda(x, planes,
                                                            dtype),
                    "plain": lambda: nm.nibble_matmul_plain(x, planes,
                                                            dtype),
                    "library": lambda: torch.matmul(x, w)})
                b_ms, b_by = bound(pbytes + t * k * 2 + t * n * 4,
                                   2.0 * t * k * n)
                row = {"shape": f"{label} T={t}", "T": t, "K": k, "N": n,
                       "plane_bytes": pbytes, "max_abs_err": err,
                       "tol": tol, "ms": ms["kernel"],
                       "plain_ms": ms["plain"], "library_ms": ms["library"],
                       "bound_ms": b_ms, "bound_by": b_by,
                       "launches_per_call": per_call}
                if one_kernel:
                    check(per_call == 1, f"{name}: {per_call} launches a "
                          "call; want 1")
                if "tp" not in label:
                    # the call's CUDA kernels (torch.profiler), as many as
                    # the counter's launches; a K-quant's the kernel's own
                    # (the shard shapes run the same kernels: no profile)
                    prof = profile_calls(
                        torch,
                        lambda: nm.nibble_matmul_cuda(x, planes, dtype))
                    n_prof = sum(v["per_call"] for v in prof.values())
                    check(n_prof == per_call, f"{name}: the profiler saw "
                          f"{prof}, the counter {per_call} launches a call")
                    if one_kernel:
                        mine = {kn: v for kn, v in prof.items()
                                if "skinny_kernel" in kn
                                or "tile_kernel" in kn}
                        check(mine == prof, f"{name}: the wrapper launched "
                              f"other kernels: {prof}")
                    row.update({"device_ms": sum(v["ms"]
                                                 for v in prof.values()),
                                "kernels_per_call": n_prof})
                rows.append(row)
                print(json.dumps({kern.name: row}), flush=True)
                del x, y, y0
            del planes, w
        main = ("8b down T=1" if dtype == DType.Q6_K
                else "8b gate|up T=1")
        out[kern.name] = {"rows": rows, "main": main,
                          "planes": [s_.name for s_ in LAYOUTS[dtype]]}
    print(f"nibble kernel phase done on {card}", flush=True)
    return out


# ------------------------------------------------------ W4A8 / W8A8
def random_wplanes(torch, g, dtype, k: int, n: int, lead: int | None = None
                   ) -> dict:
    """Planes of a random [K, N] matrix (or [lead, K, N]) in an engine-
    native format on the card, spread as a requantized |w| ~ 0.02 matrix:
    W8A8 codes uniform over [-127, 127] with column scales in [1e-4, 3e-4];
    W4A8 nibbles uniform with scales in [0.004, 0.01] and mins in [0.03,
    0.07]. Nothing is symmetric in K."""
    from ntransformer_tpu_torch.core.layout import LAYOUTS
    pre = () if lead is None else (lead,)
    planes = {}
    for spec in LAYOUTS[dtype]:
        shape = pre + ((1 if spec.rows_div == 0 else k // spec.rows_div), n)
        if spec.name == "q":
            planes["q"] = torch.randint(-127, 128, shape, dtype=torch.int8,
                                        device="cuda", generator=g)
        elif spec.name == "qs":
            planes["qs"] = torch.randint(0, 256, shape, dtype=torch.uint8,
                                         device="cuda", generator=g)
        else:
            lo, hi = {"s": (1e-4, 3e-4), "s_lo": (0.004, 0.01),
                      "s_hi": (0.004, 0.01), "m_lo": (0.03, 0.07),
                      "m_hi": (0.03, 0.07)}[spec.name]
            planes[spec.name] = lo + (hi - lo) * torch.rand(
                shape, device="cuda", generator=g)
    return planes


def skewed_x(torch, g, t: int, k: int):
    """Activations whose scale and offset drift along K (nothing symmetric
    in K or across the W4A8 groups), rounded to bf16 as the layers give
    them."""
    ramp = torch.linspace(0.5, 2.0, k, device="cuda")
    x = torch.randn(t, k, device="cuda", generator=g) * ramp + 0.1 * ramp
    return x.to(torch.bfloat16)


def quant_twins_check(torch) -> dict:
    """The plain quantizers the card runs against the port's numpy copies
    on the same x, bit for bit: quantize_rows_torch (W8A8 rows; the twin of
    the W8A8 kernel's quantize pass) against core/w8a8.quantize_rows,
    quantize_activations_torch's codes and alphas against
    core/w4a8.quantize_activations, and the int8 KV rows of
    models/llama.quantize_rows against numpy's f32 amax / 127 + 1e-9 and
    round. A divisor that is a Python scalar would go through its
    reciprocal on the card and move ~5% of the scales one ulp."""
    import numpy as np
    from ntransformer_tpu_torch.core import w4a8 as nw4
    from ntransformer_tpu_torch.core import w8a8 as nw8
    from ntransformer_tpu_torch.models.llama import quantize_rows as kv_rows
    from ntransformer_tpu_torch.ops.dequant_torch import (
        quantize_activations_torch, quantize_rows_torch)
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    out = {}
    for k in (4096, 14336):
        x = skewed_x(torch, g, 64, k).float()
        x[3] = 0.0
        xn = x.cpu().numpy()
        a, am = quantize_rows_torch(x)
        na, nam = nw8.quantize_rows(xn)
        out[f"quantize_rows_torch K={k}"] = int(
            (a.cpu().numpy() != na).sum() + (am.cpu().numpy() != nam).sum())
        got = quantize_activations_torch(x)
        want = nw4.quantize_activations(xn)
        out[f"quantize_activations_torch K={k}"] = int(sum(
            (got[kk].cpu().numpy() != want[kk]).sum()
            for kk in ("a_lo", "a_hi", "alpha_lo", "alpha_hi")))
    kv = torch.randn(2, 8, 600, 128, device="cuda", generator=g)
    kq, ks, vq, vs = kv_rows(kv[0], kv[1])
    diff = 0
    for codes, scales, src in ((kq, ks, kv[0]), (vq, vs, kv[1])):
        xn = src.cpu().numpy()
        ns = (np.abs(xn).max(-1, keepdims=True) / np.float32(127.0)
              + np.float32(1e-9)).astype(np.float32)
        nc = np.round(xn / ns).astype(np.int8)
        diff += int((scales.cpu().numpy() != ns).sum()
                    + (codes.cpu().numpy() != nc).sum())
    out["kv quantize_rows"] = diff
    for what, n in out.items():
        check(n == 0, f"{what}: {n} codes or scales differ from numpy")
    print(json.dumps({"quant_twins": out}), flush=True)
    return out


def wformat_kernel_phase(torch, timer, card: str) -> dict:
    """The W8A8 matmul (with its quantize pass), the W4A8 decode matmul and
    the W4A8 T > 1 tile against their plain twins on the card: the 8B
    shapes (fused qkv, wo, fused gate|up, down, the 128256-token head), a
    layer view of stacked planes, repolm512's K = 1024 down and 384-wide
    head, and a ragged N = 200. W8A8 at T = 1, 8, 32 and 512 (the 8-slot
    server's decode step is T = 8); W4A8 decode at T = 1; the W4A8 tile at
    T = 32 and 512. Times by CUDA events as in the kernels phase, and each
    call's kernels by torch.profiler: the W8A8 and W4A8 decode calls launch
    their own kernels alone, as many as their counters count. First the
    plain quantizers against numpy (`quant_twins_check`). Yardsticks:
    torch._int_mm (cuBLASLt int8) plus the same fixup for W8A8, where it
    takes the shape (T > 16), and torch.matmul on the pre-dequantized bf16
    weight for W4A8 and for W8A8 at T <= 16."""
    quant_twins_check(torch)
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    from ntransformer_tpu_torch.ops.cuda import w4a8 as cw4
    from ntransformer_tpu_torch.ops.cuda import w8a8 as cw8
    from ntransformer_tpu_torch.ops.dequant_torch import (
        dequant_planes_torch, quantize_activations_torch, quantize_rows_torch)
    g = torch.Generator(device="cuda")
    g.manual_seed(2468)
    b8 = [("8b qkv", 4096, 6144), ("8b wo", 4096, 4096),
          ("8b gate|up", 4096, 28672), ("8b down", 14336, 4096)]
    small = [("repolm512 down", 1024, 512), ("repolm512 head", 512, 384),
             ("ragged 1024x200", 1024, 200)]
    # x as a dense transposed view, as the embedding lookup leaves the
    # first layer's activations
    colmajor = ("repolm512 qkv, x column-major", 512, 1024, (128,))
    # (label, K, N, rows per kernel); a stacked case reads layer 1 of 2
    cases = {
        "w8a8_matmul": [(lb, k, n, (1, 8, 32, 512)) for lb, k, n in b8]
        + [("8b head", 4096, 128256, (1, 8, 32)),
           ("8b stacked[1] wo", 4096, 4096, (1, 32))]
        + [(lb, k, n, (1, 70)) for lb, k, n in small] + [colmajor],
        "w4a8_decode": [(lb, k, n, (1,)) for lb, k, n in b8]
        + [("8b head", 4096, 128256, (1,)),
           ("8b stacked[1] wo", 4096, 4096, (1,))]
        + [(lb, k, n, (1,)) for lb, k, n in small if k % 512 == 0],
        "w4a8_matmul": [(lb, k, n, (32, 512)) for lb, k, n in b8]
        + [("8b head", 4096, 128256, (32,)),
           ("8b stacked[1] wo", 4096, 4096, (32,))]
        + [(lb, k, n, (32, 70)) for lb, k, n in small if k % 512 == 0]
        + [colmajor],
    }
    out = {}
    for name, shapes in cases.items():
        dtype = DType.W8A8 if name == "w8a8_matmul" else DType.W4A8
        rows = []
        for label, k, n, ts in shapes:
            stacked = label.startswith("8b stacked")
            planes = random_wplanes(torch, g, dtype, k, n,
                                    2 if stacked else None)
            if stacked:
                planes = {nm_: p[1] for nm_, p in planes.items()}
            pbytes = sum(a.numel() * a.element_size()
                         for a in planes.values())
            w = dequant_planes_torch(planes, dtype, k, n,
                                     out_dtype=torch.bfloat16)
            for t in ts:
                x = skewed_x(torch, g, t, k)
                if "column-major" in label:
                    x = x.t().contiguous().t()
                if name == "w8a8_matmul":
                    q, s = planes["q"], planes["s"]
                    fns = {"kernel": lambda: cw8.w8a8_matmul_cuda(x, q, s),
                           "plain": lambda: cw8.w8a8_matmul_plain(x, q, s)}
                    if t > 16 and k % 8 == 0 and n % 8 == 0:
                        def library():
                            a, am = quantize_rows_torch(x.float())
                            return torch._int_mm(a, q).float() * am * s
                        fns["library"] = library
                    elif t <= 16:  # _int_mm refuses M <= 16: bf16 instead
                        fns["library"] = lambda: torch.matmul(
                            x.to(torch.bfloat16), w)
                    # the wrapper's plain activation quantization alone
                    fns["act_quant"] = lambda: quantize_rows_torch(
                        x.float().contiguous())
                    ops_peak = INT8_OPS
                elif name == "w4a8_decode":
                    # the kernel quantizes x itself: no PyTorch op around it
                    fns = {"kernel": lambda: cw4.w4a8_decode_cuda(x, planes),
                           "plain": lambda: cw4.w4a8_decode_plain(x, planes),
                           "library": lambda: torch.matmul(x, w)}
                    ops_peak = INT8_OPS
                else:
                    fns = {"kernel": lambda: nm.nibble_matmul_cuda(
                               x, planes, dtype),
                           "plain": lambda: nm.nibble_matmul_plain(
                               x, planes, dtype),
                           "library": lambda: torch.matmul(x, w)}
                    ops_peak = BF16_FLOPS
                ctr = cw8 if name == "w8a8_matmul" else (
                    cw4 if name == "w4a8_decode" else nm.KERNELS[dtype])
                before = ctr.launches
                y = fns["kernel"]()
                per_call = ctr.launches - before
                y0 = fns["plain"]()
                torch.cuda.synchronize()
                err = float((y - y0).abs().max())
                scale = float(y0.abs().max())
                tag = f"{name} {label} T={t}"
                check(bool(torch.isfinite(y).all()), f"{tag}: non-finite")
                # the call's kernels on the card, by name (a W4A8 tile call
                # on a column-major x also copies x)
                prof = profile_calls(torch, fns["kernel"])
                mine = {kn: v for kn, v in prof.items()
                        if any(m in kn for m in ("w4_", "tile_kernel",
                                                 "quant_kernel",
                                                 "skinny_kernel"))}
                dev_ms = sum(v["ms"] for v in mine.values())
                if name != "w4a8_matmul":
                    # the W8A8 and W4A8 decode calls quantize x themselves:
                    # no PyTorch op around them, the counter's launches
                    check(mine == prof, f"{tag}: the wrapper launched other "
                          f"kernels: {prof}")
                    want = 2
                    if name == "w4a8_decode":
                        want = 2 if cw4.pair_plan(k) < k // 512 else 1
                    check(per_call == want, f"{tag}: {per_call} launches a "
                          f"call; want {want}")
                    check(sum(v["per_call"] for v in prof.values())
                          == per_call, f"{tag}: the profiler saw {prof}, "
                          f"the counter {per_call} launches a call")
                if name == "w4a8_decode":
                    # the kernel's alpha is an IEEE division, as the twin's
                    # and quantize_activations_torch's (both divide by a
                    # tensor: PyTorch divides by a Python scalar through its
                    # reciprocal on the card)
                    alpha_diff = sum(int((cw4._activations(x)[f"alpha_{h}"]
                                          != quantize_activations_torch(
                                              x.float())[f"alpha_{h}"][0])
                                         .sum()) for h in ("lo", "hi"))
                    check(alpha_diff == 0, f"{tag}: {alpha_diff} alphas of "
                          "quantize_activations_torch differ from the "
                          "kernel's twin")
                if name == "w8a8_matmul":
                    tol = 0.0
                    check(torch.equal(y, y0), f"{tag}: kernel and plain twin "
                          f"differ (max abs {err}); want bit-equal")
                else:
                    tol = (W4A8_DECODE_RTOL if name == "w4a8_decode"
                           else MATMUL_RTOL) * scale
                    check(err <= tol, f"{tag}: max|kernel-plain| {err} > "
                          f"{tol}")
                if "library" in fns:  # the yardstick computes the product
                    lib = fns["library"]()
                    lib_rel = float((lib - y0).abs().max()) / scale
                else:
                    lib_rel = None
                ms = timer.compare(fns)
                b_ms, b_by = bound(pbytes + t * k * 2 + t * n * 4,
                                   2.0 * t * k * n, ops_peak)
                row = {"shape": f"{label} T={t}", "T": t, "K": k, "N": n,
                       "plane_bytes": pbytes, "max_abs_err": err, "tol": tol,
                       "bit_equal": bool(torch.equal(y, y0)),
                       "ms": ms["kernel"], "plain_ms": ms["plain"],
                       "library_ms": ms.get("library"),
                       "act_quant_ms": ms.get("act_quant"),
                       "device_ms": dev_ms,
                       "launches_per_call": per_call,
                       "kernels_per_call": sum(v["per_call"]
                                               for v in prof.values()),
                       "alpha_differs_from_quantize_activations_torch": (
                           alpha_diff if name == "w4a8_decode" else None),
                       "library_rel_err": lib_rel,
                       "library_note": (
                           "torch.matmul, pre-dequantized bf16 weight"
                           if name == "w8a8_matmul" and t <= 16 else None),
                       "bound_ms": b_ms, "bound_by": b_by}
                rows.append(row)
                print(json.dumps({name: row}), flush=True)
                del x, y, y0
            del planes, w
        main = {"w8a8_matmul": "8b gate|up T=8",
                "w4a8_decode": "8b gate|up T=1",
                "w4a8_matmul": "8b gate|up T=512"}[name]
        out[name] = {"rows": rows, "main": main}
    print(f"w-format kernel phase done on {card}", flush=True)
    return out


# the kernels of each requantized format's paths: the Engine path (prefill
# chunks and decode steps) and the served batched steps
WFORMAT_ENGINE = {"w4a8": ("w4a8_matmul", "w4a8_decode", "flash_attention"),
                  "w8a8": ("w8a8_matmul", "flash_attention")}
WFORMAT_SERVE = {"w4a8": ("w4a8_matmul", "w4a8_decode", "flash_attention",
                          "batched_attention", "kv_update"),
                 "w8a8": ("w8a8_matmul", "flash_attention",
                          "batched_attention", "kv_update")}


def wformat_real_phase(torch, counters, card: str) -> dict:
    """repolm512 requantized at load with --w4a8 and with --w8a8: each
    through the CLI, Engine greedy generation against the CPU, teacher-
    forced and layer by layer, as the real phase does; the --w8a8 model
    also served (--serve B = 4, bf16 and --kv-int8) as the serve phase
    does."""
    out = {fmt: real_model_phase(torch, counters, card, REPOLM,
                                 WFORMAT_ENGINE[fmt], fmt)
           for fmt in ("w4a8", "w8a8")}
    out["serve_w8a8"] = real_serve_phase(torch, counters, card, REPOLM,
                                         WFORMAT_SERVE["w8a8"], "w8a8")
    return out


def wformat_full_phase(torch, counters, card: str) -> tuple[dict, dict]:
    """The synthetic Llama-3.1-8B in the engine-native formats at full
    width and depth. W4A8: Engine.benchmark (the main path of w4a8_matmul,
    the prefill chunks, and of w4a8_decode) with its decode profile and
    2-layer on/off view, then bench.py's B = 1 batched step
    (llama8b_w4a8_resident_decode) with a profile. W8A8: BatchServer with 8
    slots (the main path of w8a8_matmul) and the bench-style batched steps
    (B = 1: llama8b_w8a8_resident_decode; B = 32 int8:
    llama8b_w8a8_b32_int8_aggregate; a verify window) with profiles and
    the 2-layer on/off view. Returns (summaries, launch counts by path)."""
    import dataclasses
    from ntransformer_tpu_torch.models.batched import BatchedKV
    summaries, launches = {}, {}
    synth = build_synth(torch, "w4a8")
    summaries["engine_w4a8"], launches["engine_w4a8"] = full_width_phase(
        torch, counters, card, synth, WFORMAT_ENGINE["w4a8"],
        ("w4a8_matmul", "flash_attention"))
    _, arch, weights, per_token = synth
    cell = bench_b1(torch, counters, arch, weights, per_token)
    check(cell["launches"]["w4a8_decode"] > 0,
          f"8b w4a8 B=1 step launched {cell['launches']}")
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    cell["profile"] = profile_batched(torch, arch1k, weights,
                                      BatchedKV.create(arch1k, 1,
                                                       device="cuda"),
                                      1, 160)
    print(json.dumps({"8b_w4a8_batched_b1_bf16": cell}), flush=True)
    summaries["b1_w4a8"], launches["b1_w4a8"] = cell, cell["launches"]
    del synth, weights
    synth = build_synth(torch, "w8a8")
    summaries["serve_w8a8"], launches["serve_w8a8"] = full_batched_phase(
        torch, counters, card, synth, WFORMAT_SERVE["w8a8"],
        WFORMAT_LOGIT_RTOL, dot_forms=True)
    print(json.dumps({"full_width_8b_w8a8_serving":
                      summaries["serve_w8a8"]}), flush=True)
    del synth
    return summaries, launches


# requantized repolm512 files: tag -> the kernels its Engine path must
# launch. "q4_k_m_v6" is Q4_K_M with a Q6_K attn_v, as llama.cpp's Q4_K_M
# gives some layers: the fused q|k product and a separate v product run.
REQUANT = {"q4_k_m": ("q4_k_matmul", "q6_k_matmul", "flash_attention"),
           "q4_k_m_v6": ("q4_k_matmul", "q6_k_matmul", "flash_attention"),
           "q5_k": ("q5_k_matmul", "flash_attention"),
           "q4_0": ("q4_0_matmul", "flash_attention")}


def requant_dtype(tag: str, name: str):
    """The format of weight matrix `name` in the requantized file `tag`."""
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.models.presets import q4_k_m_policy
    if tag == "q4_k_m_v6" and "attn_v" in name:
        return DType.Q6_K
    return q4_k_m_policy(name) if tag.startswith("q4_k_m") else DType(tag)


def requantize(src: str, dst: str, tag: str) -> None:
    """Write `src` (a GGUF) to `dst` with every weight matrix requantized
    on the host to requant_dtype(tag, name) by the port's requant tool
    (its quantizer and GGUF writer); metadata and other tensors are
    copied."""
    from ntransformer_tpu_torch.tools.requant_gguf import requant
    requant(src, dst, lambda name: requant_dtype(tag, name),
            progress=lambda _msg: None)


def quant_real_phase(torch, counters, card: str, tmp: str) -> dict:
    """repolm512 requantized on the host (Q4_K_M, Q4_K_M with a Q6_K
    attn_v, all-Q5_K, all-Q4_0) and each file driven through the CLI and
    Engine on the card against the CPU, as the real phase does; the Q4_K_M
    file also served (--serve bf16 and int8) as the serve phase does."""
    out = {}
    for tag, kernels in REQUANT.items():
        path = os.path.join(tmp, f"repolm512_{tag}.gguf")
        t0 = time.perf_counter()
        requantize(REPOLM, path, tag)
        print(f"wrote {os.path.basename(path)} "
              f"({os.path.getsize(path)} bytes) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out[tag] = real_model_phase(torch, counters, card, path, kernels)
    kernels = REQUANT["q4_k_m"] + ("batched_attention", "kv_update")
    out["serve_q4_k_m"] = real_serve_phase(
        torch, counters, card, os.path.join(tmp, "repolm512_q4_k_m.gguf"),
        kernels)
    return out


def quant_full_phase(torch, counters, card: str,
                     graph_layers: int | None = None) -> tuple[dict, dict]:
    """The synthetic Llama-3.1-8B at full width and depth in the nibble
    formats: Q4_K_M through Engine.benchmark and BatchServer with the
    bench-style batched steps (B = 1, B = 32 int8, verify), profiles and
    the 2-layer on/off views (with graph_layers, phase graphs' Q4_K_M part
    on the same weights' first graph_layers layers); then the B = 1
    batched step of bench.py's q4_0 and q6_k keys. Returns (summaries,
    launch counts by path)."""
    q4km = ("q4_k_matmul", "q6_k_matmul")
    summaries, launches = {}, {}
    synth = build_synth(torch, "q4_k_m")
    summaries["engine_q4_k_m"], launches["engine_q4_k_m"] = \
        full_width_phase(torch, counters, card, synth,
                         q4km + ("flash_attention",))
    summaries["serve_q4_k_m"], launches["serve_q4_k_m"] = \
        full_batched_phase(torch, counters, card, synth,
                           q4km + ("flash_attention", "batched_attention",
                                   "kv_update"))
    print(json.dumps({"full_width_8b_q4_k_m_serving":
                      summaries["serve_q4_k_m"]}), flush=True)
    if graph_layers:
        print("[phase graphs, q4_k_m]", flush=True)
        summaries["graphs"] = graphs_phase(
            torch, counters, card, depth_cut(synth, graph_layers),
            "8b_q4_k_m", serve_too=True)
    del synth
    for dtype, names in (("q4_0", ("q4_0_matmul",)),
                         ("q6_k", ("q6_k_matmul",))):
        _, arch, weights, per_token = build_synth(torch, dtype)
        cell = bench_b1(torch, counters, arch, weights, per_token)
        check(all(cell["launches"][k] > 0 for k in names),
              f"8b {dtype} B=1 step launched {cell['launches']}")
        print(json.dumps({f"8b_{dtype}_batched_b1_bf16": cell}), flush=True)
        summaries[f"b1_{dtype}"] = cell
        launches[f"b1_{dtype}"] = cell["launches"]
        del weights
    return summaries, launches


# ---------------------------------------------------------------- tiered
# the kernels the tiered path launches: repolm512 is Q8_0, the 8B cell Q4_K_M
TIERED_KERNELS = {"repolm512": ("q8_0_matmul", "flash_attention"),
                  "8b": ("q4_k_matmul", "q6_k_matmul", "flash_attention")}
TIERED_8B_ROOM = 14 << 30  # the 8B GGUF (~5.3 GB), its pack (~4.5 GB), slack
TIERED_TP_TOKENS = 16      # the tiered TP step's greedy tokens (phase tp)


def greedy_ids(torch, step, ids, n: int):
    """Prefill `ids` (one forward, no bucketing) and n greedy steps through
    step(tokens, pos) -> logits, the argmax kept on the card. Returns
    (tokens [n] CPU tensor, [logits of each step] on the card)."""
    logits = step(ids, 0)
    toks, outs = [], []
    for i in range(n):
        outs.append(logits[-1])
        t = torch.argmax(logits[-1])
        toks.append(t)
        logits = step(t.reshape(1), len(ids) + i)
    return torch.stack(toks).cpu(), outs


def resident_step(torch, arch, weights, layer_sel=None, quant=False):
    from ntransformer_tpu_torch.models import llama
    kv = llama.KVCache.create(arch, quant=quant, device="cuda")

    def step(tokens, pos):
        return llama.forward(arch, weights, kv, tokens, pos,
                             layer_sel=layer_sel)[0]
    return step


def tiered_step(torch, tm, quant=False, **fw):
    from ntransformer_tpu_torch.models import tiered
    kv = tiered.TieredKV.create(tm.arch, tm.tiers, quant=quant,
                                device="cuda", mesh=tm.mesh)

    def step(tokens, pos):
        return tiered.forward_tiered(tm, kv, tokens, pos, **fw)[0]
    return step


def tiered_repolm_phase(torch, counters, card: str, tmp: str) -> dict:
    """repolm512 tiered on the card at (2 HBM, 2 RAM, 2 disk): 32 greedy
    tokens against the unfused resident model (identical tokens), the
    pipelined and synchronous runs bit-identical at every step, the int8
    cache, a skip set and early exit against the resident forward over the
    same layers, the runtime tier-B requant of the Q4_K_M requant of
    repolm512 bit-identical to the offline requant pack, that Q4_K_M model
    tiered against its resident model (the pack's Q4_K and Q6_K planes
    against the GGUF loader's), and the CLI's --streaming against the
    resident CLI."""
    import contextlib
    import io
    import shutil
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.models.tiered import load_model_tiered
    path = os.path.join(tmp, "repolm512_q8.gguf")
    shutil.copy(REPOLM, path)
    res = load_model(path, device="cuda", fuse=False)
    ids = res.tokenizer.encode(PROMPT, add_bos=True)
    n = 32
    tm = load_model_tiered(path, max_hbm_layers=2, max_ram_layers=2)
    t = tm.tiers
    check((t.n_hbm, t.n_ram, t.n_disk) == (2, 2, 2),
          f"repolm512 tiers {t}: want (2, 2, 2)")
    ref, ref_logits = greedy_ids(
        torch, resident_step(torch, res.arch, res.weights), ids, n)
    reset(counters)
    got, logits = greedy_ids(torch, tiered_step(torch, tm), ids, n)
    torch.cuda.synchronize()
    launches = read(counters)
    check(all(launches[k] > 0 for k in TIERED_KERNELS["repolm512"]),
          f"repolm512 tiered launched a kernel zero times: {launches}")
    check(torch.equal(got, ref), f"repolm512 tiered tokens {got.tolist()} "
          f"differ from the resident model's {ref.tolist()}")
    same = all(torch.equal(a, b) for a, b in zip(logits, ref_logits))
    tm.streamer.synchronous = True
    got_s, logits_s = greedy_ids(torch, tiered_step(torch, tm), ids, n)
    tm.streamer.synchronous = False
    check(all(torch.equal(a, b) for a, b in zip(logits, logits_s)),
          "repolm512 tiered: the synchronous run differs from the pipelined")
    out = {"tiers": [2, 2, 2], "tokens": got.tolist(),
           "logits_bit_equal_to_resident": same, "launches": launches,
           "misaligned_plane_copies": tm.streamer.misaligned_copies}
    # int8 KV, a skip set, early exit: tokens of the resident forward over
    # the same layers with the same cache
    for name, kw, sel, quant in (
            ("int8_kv", {}, None, True),
            ("skip_1_3", {"skip": frozenset({1, 3})}, [0, 2, 4, 5], False),
            # half = 3: layer 3's cosine stops the streamed loop before 4
            ("early_exit", {"early_exit_threshold": 1e-9}, [0, 1, 2, 3],
             False)):
        a, _ = greedy_ids(torch, tiered_step(torch, tm, quant, **kw), ids, n)
        b, _ = greedy_ids(torch, resident_step(torch, res.arch, res.weights,
                                                sel, quant), ids, n)
        check(torch.equal(a, b), f"repolm512 tiered {name}: tokens "
              f"{a.tolist()} differ from the resident {b.tolist()}")
        out[name] = "tokens identical"
    tm.close()
    del res
    # --requant-ram on the Q4_K_M requant of repolm512 (it has Q6_K)
    q4 = os.path.join(tmp, "repolm512_q4_k_m.gguf")
    requantize(REPOLM, q4, "q4_k_m")
    runtime = load_model_tiered(q4, max_hbm_layers=0, max_ram_layers=6,
                                requant_ram=DType.Q4_K)
    offline = load_model_tiered(q4, max_hbm_layers=0, max_ram_layers=6,
                                requant=DType.Q4_K)
    check(len(runtime.streamer.ram_meta) == 6,
          "requant_ram requantized no layer")
    a, la = greedy_ids(torch, tiered_step(torch, runtime), ids, 8)
    b, lb = greedy_ids(torch, tiered_step(torch, offline), ids, 8)
    check(all(torch.equal(x, y) for x, y in zip(la, lb)),
          "repolm512 Q4_K_M: the runtime tier-B requant differs from the "
          "offline requant pack")
    out["requant_ram"] = {
        "bit_equal_to_offline": True,
        "ram_bytes_per_layer": runtime.streamer.layer_nbytes(0),
        "pack_bytes_per_layer": runtime.pack.layer_nbytes(0)}
    runtime.close()
    offline.close()
    mixed = load_model_tiered(q4, max_hbm_layers=2, max_ram_layers=2,
                              requant_ram=DType.Q4_K)
    c, _ = greedy_ids(torch, tiered_step(torch, mixed), ids, 8)
    mixed.close()
    out["requant_ram"]["tiers_2_2_2_tokens"] = c.tolist()
    # the pack's Q4_K and Q6_K planes against the GGUF loader's
    q4_tiered = load_model_tiered(q4, max_hbm_layers=2, max_ram_layers=2)
    q4_res = load_model(q4, device="cuda", fuse=False)
    a, la = greedy_ids(torch, tiered_step(torch, q4_tiered), ids, n)
    b, lb = greedy_ids(torch, resident_step(torch, q4_res.arch,
                                            q4_res.weights), ids, n)
    q4_tiered.close()
    del q4_res
    check(torch.equal(a, b), f"repolm512 Q4_K_M tiered tokens {a.tolist()} "
          f"differ from the resident model's {b.tolist()}")
    out["q4_k_m_tiers_2_2_2"] = {
        "tokens": "identical to the resident Q4_K_M model",
        "logits_bit_equal_to_resident": all(torch.equal(x, y)
                                            for x, y in zip(la, lb))}
    # the CLI end to end: --streaming against the resident CLI (unfused)
    texts = {}
    for name, flags in (("streaming", ["--streaming", "--max-hbm-layers",
                                       "2", "--max-ram-layers", "2"]),
                        ("resident", ["--no-fuse"])):
        buf = io.StringIO()
        reset(counters)
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-m", path, "-p", PROMPT, "-n", "16", "-t", "0",
                           "--repeat-penalty", "1.0", "--device", "cuda"]
                          + flags)
        torch.cuda.synchronize()
        got_l = read(counters)
        check(rc == 0, f"cli {name}: exit code {rc}")
        check(all(got_l[k] > 0 for k in TIERED_KERNELS["repolm512"]),
              f"cli {name} launched {got_l}")
        texts[name] = buf.getvalue()
    check(texts["streaming"] == texts["resident"],
          f"cli --streaming wrote {texts['streaming']!r}, the resident CLI "
          f"{texts['resident']!r}")
    out["cli_streaming"] = "text identical to the resident CLI"
    print(json.dumps({"tiered_repolm512": out}), flush=True)
    return out


# Llama-3's ids of its chat control tokens and of the plain pieces its
# template's scaffold spells: write_q4km_8b(chat="llama3") names them
LLAMA3_CHAT_IDS = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
                   128006: "<|start_header_id|>",
                   128007: "<|end_header_id|>", 128009: "<|eot_id|>",
                   882: "user", 78191: "assistant", 9125: "system",
                   271: "\n\n"}
LLAMA3_TEMPLATE = ("{{ '<|begin_of_text|>' }}{% for m in messages %}"
                   "{{ '<|start_header_id|>' + m['role'] + "
                   "'<|end_header_id|>\n\n' + m['content'] + "
                   "'<|eot_id|>' }}{% endfor %}")


@contextlib.contextmanager
def prepared_dir(pre: dict):
    """A tiered phase's directory, which start_prep filled; removed on
    leaving."""
    import shutil
    try:
        yield pre["dir"]
    finally:
        shutil.rmtree(pre["dir"], ignore_errors=True)


def write_q4km_8b(path: str, n_layers: int, chat: str | None = None) -> None:
    """A Llama-3.1-8B-shaped GGUF in Q4_K_M (Q4_K, and Q6_K for ffn_down,
    the embedding and the head) of random valid blocks: random codes, the
    6-bit scales and mins all 8, fixed f16 super-block scales giving |w| ~
    0.02 (as SYNTH_SCALES), f32 norms of ones. The vocabulary is <t{i}>;
    chat="llama3" names Llama-3's control tokens and scaffold pieces at
    their ids (LLAMA3_CHAT_IDS; bos and eos become <|begin_of_text|> and
    <|end_of_text|>) and adds a tokenizer.chat_template."""
    import numpy as np
    from ntransformer_tpu_torch.core.dequant import pack_kquant_scales
    from ntransformer_tpu_torch.core.dtypes import DType, GGUFValueType
    from ntransformer_tpu_torch.core.gguf import GGUFWriter
    from ntransformer_tpu_torch.models.presets import q4_k_m_policy
    hidden, inter, heads, kv_heads, vocab = 4096, 14336, 32, 8, 128256
    rng = np.random.default_rng(88)
    eight = np.full((1, 8), 8, np.uint8)
    q4k_scales = pack_kquant_scales(eight, eight).reshape(-1)
    f16 = lambda x: np.frombuffer(np.float16(x).tobytes(), np.uint8)
    q4k = SYNTH_SCALES["q4_k"]
    q6k = SYNTH_SCALES["q6_k"]

    def blocks(rows: int, cols: int, dt) -> bytes:
        nb = rows * cols // 256
        if dt == DType.Q4_K:
            b = rng.integers(0, 256, (nb, 144), dtype=np.uint8)
            b[:, 0:2] = f16(q4k["d"])
            b[:, 2:4] = f16(q4k["dmin"])
            b[:, 4:16] = q4k_scales
        else:  # Q6_K: ql, qh, 16 int8 scales, d
            b = rng.integers(0, 256, (nb, 210), dtype=np.uint8)
            b[:, 192:208] = 8
            b[:, 208:210] = f16(q6k["d"])
        return b.tobytes()

    w = GGUFWriter(path)
    md = {"general.architecture": "llama", "general.name": "synthetic-8b",
          "llama.vocab_size": vocab, "llama.embedding_length": hidden,
          "llama.feed_forward_length": inter, "llama.block_count": n_layers,
          "llama.attention.head_count": heads,
          "llama.attention.head_count_kv": kv_heads,
          "llama.attention.layer_norm_rms_epsilon": 1e-5,
          "llama.rope.freq_base": 500000.0, "llama.context_length": 8192,
          "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}
    tokens = [f"<t{i}>" for i in range(vocab)]
    if chat is not None:
        check(chat == "llama3", f"write_q4km_8b: no {chat!r} chat preset")
        for i, t in LLAMA3_CHAT_IDS.items():
            tokens[i] = t
        md.update({"tokenizer.ggml.bos_token_id": 128000,
                   "tokenizer.ggml.eos_token_id": 128001,
                   "tokenizer.chat_template": LLAMA3_TEMPLATE})
    for k, v in md.items():
        w.add_meta(k, v)
    w.add_meta("tokenizer.ggml.tokens", tokens,
               vtype=GGUFValueType.ARRAY, elem_type=GGUFValueType.STRING)

    def mat(name, rows, cols):
        dt = q4_k_m_policy(name)
        w.add_tensor(name, raw=blocks(rows, cols, dt), shape=(rows, cols),
                     dtype=dt)

    ones = np.ones(hidden, np.float32)
    mat("token_embd.weight", vocab, hidden)
    for i in range(n_layers):
        pre = f"blk.{i}."
        w.add_tensor(pre + "attn_norm.weight", ones)
        mat(pre + "attn_q.weight", hidden, hidden)
        mat(pre + "attn_k.weight", kv_heads * 128, hidden)
        mat(pre + "attn_v.weight", kv_heads * 128, hidden)
        mat(pre + "attn_output.weight", hidden, hidden)
        w.add_tensor(pre + "ffn_norm.weight", ones)
        mat(pre + "ffn_gate.weight", inter, hidden)
        mat(pre + "ffn_up.weight", inter, hidden)
        mat(pre + "ffn_down.weight", hidden, inter)
    w.add_tensor("output_norm.weight", ones)
    mat("output.weight", vocab, hidden)
    w.write()


def h2d_probe(torch, nbytes: int = 1 << 30) -> float:
    """GB/s of one pinned host -> device copy (the bound of tier-B/C
    transfers), best of 5, timed with CUDA events."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    best = float("inf")
    for _ in range(5):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        dst.copy_(src, non_blocking=True)
        e.record()
        e.synchronize()
        best = min(best, s.elapsed_time(e))
    del src, dst
    return nbytes / best / 1e6


def direct_read_probe(pack, layers, rounds: int = 3) -> float:
    """GB/s of O_DIRECT reads of `layers` of the pack, two in flight into
    two aligned buffers as the streamer's two staging slots read them,
    nothing else running (the bound of tier-C reads); best of `rounds`."""
    from ntransformer_tpu_torch.memory.native import StagePool, aligned_empty
    pool = StagePool(8)
    size = max(pack.layer_nbytes(j) for j in layers)
    bufs = [aligned_empty((size + 4095) // 4096 * 4096) for _ in range(2)]
    best = 0.0
    for _ in range(rounds):
        total, pending, t0 = 0, [], time.perf_counter()
        for i, j in enumerate(layers):
            if len(pending) == 2:
                pool.wait(pending.pop(0))
            m = pack.layer_meta(j)
            pending.append(pool.read(pack.path, m["offset"], m["size"],
                                     bufs[i % 2], direct=True))
            total += m["size"]
        for h in pending:
            pool.wait(h)
        best = max(best, total / (time.perf_counter() - t0) / 1e9)
    direct = pool.direct_reads
    pool.close()
    check(direct == rounds * len(layers), f"the read probe read {direct} of "
          f"{rounds * len(layers)} layers with O_DIRECT")
    return best


def profile_tiered(torch, step, pos0: int, steps: int = 2) -> dict:
    """Device time over a few tiered decode steps (torch.profiler): the
    compute kernels' share of the wall time, and the copies'."""
    from torch.profiler import ProfilerActivity, profile
    tok = torch.tensor([3], device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            tok = torch.argmax(step(tok, pos0 + i)[-1]).reshape(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = copy = 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type) or e.self_device_time_total <= 0:
            continue
        if "Memcpy" in e.key or "memcpy" in e.key:
            copy += e.self_device_time_total / 1e3
        else:
            kern += e.self_device_time_total / 1e3
    return {"steps": steps, "wall_ms_per_token": wall_ms / steps,
            "compute_ms_per_token": kern / steps,
            "copy_ms_per_token": copy / steps,
            "device_busy_share": kern / wall_ms if wall_ms else 0.0,
            "copy_busy_share": copy / wall_ms if wall_ms else 0.0}


def filesystem_of(path: str) -> dict:
    """The mount that holds `path` (/proc/mounts: the longest mount point
    above it), its filesystem type and source, and the block device behind
    its st_dev (None for a filesystem without one, such as tmpfs or a 9p
    mount). ram_backed: True for tmpfs and ramfs, False with a block
    device behind it, else None (the backing cannot be seen)."""
    real = os.path.realpath(path)
    best = ("", "?", "?", "")
    with open("/proc/mounts") as f:
        for line in f:
            src, mnt, fstype, opts = line.split()[:4]
            mnt = mnt.replace("\\040", " ")
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[0]):
                best = (mnt, fstype, src, opts[:200])
    dev = os.stat(real).st_dev
    major, minor = os.major(dev), os.minor(dev)
    sys_dev = f"/sys/dev/block/{major}:{minor}"
    block = (os.path.basename(os.path.realpath(sys_dev))
             if os.path.exists(sys_dev) else None)
    return {"mount": best[0], "fstype": best[1], "source": best[2],
            "options": best[3], "st_dev": f"{major}:{minor}", "block_device": block,
            "ram_backed": True if best[1] in ("tmpfs", "ramfs")
            else False if block else None}


class PromptIds(IdsTokenizer):
    """IdsTokenizer whose encode gives one fixed prompt's ids."""

    def __init__(self, ids):
        self.ids = list(ids)

    def encode(self, text, add_bos=True):
        return list(self.ids)


def tiered_self_spec(torch, counters, tm, ids, ref) -> dict:
    """TieredEngine.generate_self_speculative on a tiered model, the
    resident layers drafting, K = 3, 16 tokens after `ids`, held to the
    tiered greedy tokens `ref` by spec_rule (the verify's teacher-forced
    rows computed only where the tokens part)."""
    from ntransformer_tpu_torch.inference.engine import (GenerateConfig,
                                                         TieredEngine)
    from ntransformer_tpu_torch.models import tiered
    eng = TieredEngine(tm)
    eng.tokenizer = PromptIds(ids)
    cfg = GenerateConfig(max_tokens=16, temperature=0.0, repeat_penalty=1.0,
                         draft_k=SPEC_K)
    reset(counters)
    got, st = engine_ids(eng, "generate_self_speculative", "", cfg)
    torch.cuda.synchronize()
    launches = read(counters)
    n = min(len(got), len(ref))
    part = next((i for i in range(n) if got[i] != ref[i]), None)
    rule = {"tokens_agree": [n if part is None else part]}
    if part is not None:
        base = len(ids)
        kv = eng._make_kv()
        tiered.forward_tiered(tm, kv, ids, 0)
        tf = teacher_forced(
            torch, lambda kv, t, i: tiered.forward_tiered(
                tm, kv, t.cuda(), base + i)[0],
            lambda kv, w, i: tiered.forward_tiered(
                tm, kv, w[0].cuda(), base + i, all_logits=True)[0][None],
            lambda kv: tiered.TieredKV(*(None if c is None else c.clone()
                                         for c in (kv.res, kv.str))),
            kv, [torch.tensor([t]) for t in ref[:part + SPEC_K + 1]], SPEC_K)
        rule = spec_rule(torch, "tiered 8b self-speculation",
                         {"kernel": tf, "plain": tf, "cpu": tf}, [ref], [got])
    out = {"draft_layers": tm.n_resident, "K": SPEC_K,
           "ms_per_token": st.decode_ms / st.decode_tokens,
           "acceptance": st.accepted / st.drafted, "drafted": st.drafted,
           "accepted": st.accepted, "tokens": len(got),
           "launches": launches, **rule,
           "note": "synthetic weights: the acceptance prices nothing"}
    print(f"tiered self-speculation: {st.report()!r}; {rule}", flush=True)
    return out


def tiered_tp_step(torch, counters, path: str, tiers, ids, ref,
                   ref_logits) -> dict:
    """The 8B Q4_K_M GGUF streamed over a TP_SHARDS-way mesh on cuda:0 at
    the phase's tiers (each shard its slice of every streamed layer): a
    512-token prefill and TIERED_TP_TOKENS greedy tokens bit-identical to
    the resident
    TPEngine's (`ref`: the same shard planes, kernels and sums), ms per
    token, and the H2D bytes of each shard."""
    from ntransformer_tpu_torch.models.tiered import load_model_tiered
    from ntransformer_tpu_torch.parallel.tp import make_tp_mesh
    from ntransformer_tpu_torch.utils.timing import PROFILER
    t0 = time.perf_counter()
    tm = load_model_tiered(path, max_seq_len=1024, max_hbm_layers=tiers[0],
                           max_ram_layers=tiers[1], with_tokenizer=False,
                           mesh=make_tp_mesh(TP_SHARDS,
                                             ["cuda:0"] * TP_SHARDS))
    load_s = time.perf_counter() - t0
    check((tm.tiers.n_hbm, tm.tiers.n_ram, tm.tiers.n_disk) == tuple(tiers),
          f"8b tiered TP tiers {tm.tiers}: want {tiers}")
    s = tm.streamer
    step = tiered_step(torch, tm)
    reset(counters)
    t0 = time.perf_counter()
    logits = step(ids, 0)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    s.reset_stats()
    PROFILER.reset()
    PROFILER.enabled = True
    toks, outs = [], []
    n = len(ref)
    t0 = time.perf_counter()
    for i in range(n):
        outs.append(logits[-1])
        tk = torch.argmax(logits[-1])
        toks.append(tk)
        logits = step(tk.reshape(1), len(ids) + i)
    torch.cuda.synchronize()
    ms_tok = (time.perf_counter() - t0) * 1e3 / n
    PROFILER.enabled = False
    launches = read(counters)
    copies, h2d_bytes, copy_ms = PROFILER.copy_stats("stream/h2d")
    toks = torch.stack(toks).cpu()
    check(torch.equal(toks, ref), f"8b tiered TP: tokens {toks.tolist()} "
          f"differ from the resident TPEngine's {ref.tolist()}")
    check(all(launches[k] > 0 for k in TIERED_KERNELS["8b"]),
          f"8b tiered TP launched {launches}")
    out = {"shards": TP_SHARDS, "tiers": list(tiers), "load_s": load_s,
           "prefill_ms": prefill_ms, "ms_per_token": ms_tok,
           "tokens_bit_identical_to_resident_tp": True,
           "logits_bit_equal_to_resident_tp": all(
               torch.equal(a.cpu(), b) for a, b in zip(outs, ref_logits)),
           "h2d_bytes_per_token_per_shard": [b / n
                                             for b in s.shard_h2d_bytes],
           "h2d_copies": copies, "h2d_copy_ms": copy_ms,
           "h2d_copy_GB_s": h2d_bytes / copy_ms / 1e6 if copy_ms else 0.0,
           "tier_c_read_GB_s": s.disk_bytes / s.disk_s / 1e9
           if s.disk_s else 0.0,
           "relayout_s_per_token": s.relayout_s / n,
           "misaligned_plane_copies": s.misaligned_copies,
           "launches": launches}
    tm.close()
    print(json.dumps({"tiered_8b_tp": out}), flush=True)
    return out


def tiered_8b_phase(torch, counters, card: str, with_tp: bool = False,
                    hold: dict | None = None, pre: dict | None = None
                    ) -> dict:
    """The 8B preset in Q4_K_M at full width, tiered on the card at (8 HBM,
    16 RAM, 8 disk): a 512-token prefill and 32 greedy tokens identical to
    the unfused resident 8B, pipelined and synchronous bit-identical; ms
    per token, streamed bytes per token, the copy stream's H2D rate against
    a pinned-copy probe and the tier-C read rate against an O_DIRECT probe,
    the card's busy share and the overlap gain (synchronous / pipelined).
    Without the disk room for both files, 16 layers at (4, 8, 4). The
    resident reference is the GGUF loader's unfused model (load_model), so
    the pack is held against it too. The filesystem that holds the GGUF and
    its pack (tier C) is recorded, since a RAM-backed one (tmpfs) reads at
    memory speed. with_tp (phase tp): the resident model also as a
    TP_SHARDS-way TPEngine, and the GGUF streamed over that mesh
    (tiered_tp_step). hold (phase http runs next): the GGUF is written with
    Llama-3's chat tokens (the same weights; this phase reads ids, not
    text) and its resident model is left in hold["model"] for http_8b, so
    the 8B is written and loaded once. pre: start_prep's GGUF and pack,
    written beside the kernels' build (their seconds are reported)."""
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.models.tiered import load_model_tiered
    from ntransformer_tpu_torch.utils.timing import PROFILER
    n_layers = pre["layers"]
    tiers = (8, 16, 8) if n_layers == 32 else (4, 8, 4)
    keep = hold is not None and n_layers == 32
    check(pre["chat"] == ("llama3" if keep else None),
          f"tiered 8b: prepared with chat {pre['chat']}")
    with prepared_dir(pre) as tmp:
        out = {"card": card, "layers": n_layers, "tiers": list(tiers),
               "cut": n_layers != 32, "tier_c_filesystem": filesystem_of(tmp),
               "gguf_write_s": pre["gguf_write_s"],
               "pack_write_s": pre["pack_write_s"]}
        print(f"tiered 8b: tier C on {out['tier_c_filesystem']}", flush=True)
        path = pre["path"]
        out["gguf_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        tm = load_model_tiered(path, max_seq_len=1024,
                               max_hbm_layers=tiers[0],
                               max_ram_layers=tiers[1],
                               with_tokenizer=False)
        out["tiered_load_s"] = time.perf_counter() - t0
        check((tm.tiers.n_hbm, tm.tiers.n_ram, tm.tiers.n_disk) == tiers,
              f"8b tiers {tm.tiers}: want {tiers}")
        t0 = time.perf_counter()
        res = load_model(path, max_seq_len=1024, device="cuda", fuse=False)
        out["resident_load_s"] = time.perf_counter() - t0
        g = torch.Generator().manual_seed(9)
        ids = torch.randint(3, res.arch.vocab_size, (512,),
                            generator=g).tolist()
        n = 32
        ref, ref_logits = greedy_ids(
            torch, resident_step(torch, res.arch, res.weights), ids, n)
        ref_logits = [x.cpu() for x in ref_logits]
        if with_tp:
            # phase tp: the same resident model as a TP_SHARDS-way
            # TPEngine on cuda:0, the reference of the tiered TP step
            from ntransformer_tpu_torch.inference.engine import TPEngine
            from ntransformer_tpu_torch.parallel.tp import make_tp_mesh
            tpe = TPEngine(res, make_tp_mesh(TP_SHARDS,
                                             ["cuda:0"] * TP_SHARDS))
            reset(counters)
            tp_ref, tp_logits = greedy_ids(torch, tp_step(torch, tpe), ids,
                                           TIERED_TP_TOKENS)
            torch.cuda.synchronize()
            tp_res_launches = read(counters)
            tp_logits = [x.cpu() for x in tp_logits]
            del tpe
        if keep:
            hold["model"] = res  # phase http serves it
        del res
        torch.cuda.empty_cache()
        os.sync()  # the pack's pages on disk before the O_DIRECT probe
        s = tm.streamer
        per_token = sum(s.layer_nbytes(j) for j in s.schedule())
        runs = {}
        for mode in ("pipelined", "synchronous", "synchronous",
                     "pipelined"):
            s.synchronous = mode == "synchronous"
            s.reset_stats()
            PROFILER.reset()
            PROFILER.enabled = True
            step = tiered_step(torch, tm)
            reset(counters)
            t0 = time.perf_counter()
            logits = step(ids, 0)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            toks, outs = [], []
            t0 = time.perf_counter()
            for i in range(n):
                outs.append(logits[-1])
                tk = torch.argmax(logits[-1])
                toks.append(tk)
                logits = step(tk.reshape(1), len(ids) + i)
            torch.cuda.synchronize()
            ms_tok = (time.perf_counter() - t0) * 1e3 / n
            PROFILER.enabled = False
            launches = read(counters)
            copies, h2d_bytes, copy_ms = PROFILER.copy_stats("stream/h2d")
            toks = torch.stack(toks).cpu()
            check(torch.equal(toks, ref), f"8b tiered {mode}: tokens "
                  f"{toks.tolist()} differ from the resident "
                  f"{ref.tolist()}")
            outs = [x.cpu() for x in outs]
            if "pipelined" in runs or "synchronous" in runs:
                first = runs.get("pipelined") or runs["synchronous"]
                check(all(torch.equal(a, b)
                          for a, b in zip(outs, first["_logits"])),
                      f"8b tiered {mode}: logits differ from an earlier run")
            cell = {"prefill_ms": prefill_ms, "ms_per_token": ms_tok,
                    "streamed_bytes_per_token": per_token,
                    "streamed_GB_s": per_token / ms_tok / 1e6,
                    "h2d_copies": copies, "h2d_bytes": h2d_bytes,
                    "h2d_copy_ms": copy_ms,
                    "h2d_copy_GB_s": h2d_bytes / copy_ms / 1e6
                    if copy_ms else 0.0,
                    "disk_bytes": s.disk_bytes,
                    "tier_c_read_GB_s": s.disk_bytes / s.disk_s / 1e9
                    if s.disk_s else 0.0,
                    "direct_reads": s.pool.direct_reads,
                    "buffered_reads": s.pool.buffered_reads,
                    "misaligned_plane_copies": s.misaligned_copies,
                    "launches": launches, "_logits": outs}
            if mode not in runs or ms_tok < runs[mode]["ms_per_token"]:
                runs[mode] = cell
            check(all(launches[k] > 0 for k in TIERED_KERNELS["8b"]),
                  f"8b tiered {mode} launched {launches}")
        s.synchronous = False
        same = all(torch.equal(a, b) for a, b in
                   zip(runs["pipelined"]["_logits"], ref_logits))
        for c in runs.values():
            c.pop("_logits")
        prof = profile_tiered(torch, tiered_step(torch, tm), 0)
        out["self_spec"] = tiered_self_spec(torch, counters, tm, ids,
                                            ref.tolist())
        disk_layers = list(range(tiers[0] + tiers[1], n_layers))
        out.update(
            runs=runs, logits_bit_equal_to_resident=same,
            tokens=ref.tolist(), profile=prof,
            overlap_gain=(runs["synchronous"]["ms_per_token"]
                          / runs["pipelined"]["ms_per_token"]),
            h2d_probe_GB_s=h2d_probe(torch),
            direct_read_probe_GB_s=direct_read_probe(tm.pack, disk_layers))
        tm.close()
        del tm
        torch.cuda.empty_cache()
        if with_tp:
            out["tp"] = tiered_tp_step(torch, counters, path, tiers, ids,
                                       tp_ref, tp_logits)
            out["tp"]["resident_tp_launches"] = tp_res_launches
    print(json.dumps({"tiered_8b_q4_k_m": out}), flush=True)
    return out



# ------------------------------------------------------ context parallelism
CP_SHARDS = 4
CP_CTX = 9216       # 2,304 keys a shard
CP_PROMPT = 4600    # chunk [2048, 2560) crosses key 2,304; decode crosses
#                     4,608; shard 3 stays masked
CP_STEPS = 32       # the path's benchmark tokens and forced steps


def cp_kernel_phase(torch, timer, card: str) -> dict:
    """The partials entry of csrc/flash_attention.cu at 8B widths (Hq 32,
    Hkv 8, D 128, bf16 cache, T = 512 queries), in three cases:
      path      the CP path's own shapes: a 9,216-key cache in 4 shards of
                2,304, the prompt chunk at pos 2,048 (shards 0-1 straddle
                the queries, on 64-row query block edges; 2-3 masked);
      long      a 32,768-key cache in 4 shards of 8,192 at pos 20,000
                (shards 0-1 wholly visible, 2 straddles, 3 masked);
      straddle  the same cache at pos 16,350: shard 2's first key, 16,384,
                falls inside the first query block, whose rows before it
                see no key of a tile the block runs;
      cptp      phase cptp's shapes: a TP shard's heads (Hq 16, Hkv 4) over
                the 9,216-key cache in 2 CP shards of 4,608, the prompt
                chunk at pos 4,096 (shard 0 wholly visible, 1 masked).
    Per shard, the kernel against its twin: acc, m and l within FLASH_RTOL
    of max|plain| in every query row that sees a key of the shard, and
    exactly 0, NEG_INF, 0 in every row that sees none; the 4 shards
    combined on the card against the unsplit row-2 kernel over the whole
    cache, within FLASH_RTOL in every query row. The path and long cases
    are timed as the kernels phase times; SDPA over the same shard (with
    the causal mask, heads expanded) is the nearest library call: it also
    normalizes. Last, the device-offset form (pos an int64 on the card
    that each block reads: the form a captured CP chunk launches) at the
    path's and the straddle case's shards: acc, m and l bit-equal to the
    host-int form's, one launch a call, and the two forms timed in turns
    at the path's shard 0 (device_pos_rows)."""
    import torch.nn.functional as F
    from ntransformer_tpu_torch.ops import layers
    from ntransformer_tpu_torch.ops.cuda import attention as ca

    g = torch.Generator(device="cuda")
    g.manual_seed(66)
    t, hq, hkv, d = 512, 32, 8, 128
    q = torch.randn(t, hq, d, device="cuda", generator=g)
    qs = {hkv: q, hkv // 2: q[:, :hq // 2].contiguous()}  # a TP shard's
    scale = 1.0 / math.sqrt(d)

    def cache(s, hkv=hkv):
        kc = torch.randn(hkv, s, d, device="cuda", generator=g)
        vc = torch.randn(hkv, s, d, device="cuda", generator=g)
        return kc.to(torch.bfloat16), vc.to(torch.bfloat16)

    def row_rel(a, b):
        dims = tuple(range(1, a.dim()))
        return float(((a - b).abs().amax(dim=dims)
                      / b.abs().amax(dim=dims)).max())

    def shard_row(tag, kc, vc, pos, i, timed, n=CP_SHARDS):
        q, hkv = qs[kc.shape[0]], kc.shape[0]
        hq = q.shape[1]
        sl = kc.shape[1] // n
        off = i * sl
        k_i = kc[:, off:off + sl].contiguous()
        v_i = vc[:, off:off + sl].contiguous()
        label = f"8b {tag} T={t} pos={pos} shard {i} of {n} keys " \
                f"[{off}, {off + sl})"
        if hkv != 8:
            label += f" Hq {hq} Hkv {hkv}"
        got = ca.flash_attention_partials(q, k_i, v_i, pos, scale,
                                          kpos_offset=off)
        want = ca.flash_attention_partials_plain(q, k_i, v_i, pos, scale,
                                                 kpos_offset=off)
        torch.cuda.synchronize()
        for a in got:
            check(bool(torch.isfinite(a).all()), f"partials {label}: "
                  "non-finite")
        err = float((got[0] - want[0]).abs().max())
        blind = max(0, min(t, off - pos))  # leading rows that see no key
        for a, b, v in zip(got, want, (0.0, ca.NEG_INF, 0.0)):
            full = torch.full_like(a[:blind], v)
            check(torch.equal(a[:blind], full)
                  and torch.equal(b[:blind], full),
                  f"partials {label}: the {blind} query rows that see no key "
                  f"are not exactly (0, NEG_INF, 0)")
        rel = {nm: row_rel(a[blind:], b[blind:]) if blind < t else 0.0
               for nm, a, b in zip(("acc", "m", "l"), got, want)}
        check(max(rel.values()) <= FLASH_RTOL,
              f"partials {label}: a query row's max|kernel-plain| is {rel} of "
              f"its max|plain| (> {FLASH_RTOL})")
        row = {"shape": label, "T": t, "pos": pos, "kpos_offset": off,
               "Hq": hq, "Hkv": hkv, "S_local": sl, "D": d,
               "max_abs_err": err, "row_rel_err": rel, "blind_rows": blind,
               "tol": FLASH_RTOL}
        if timed:
            mask = ((off + torch.arange(sl, device="cuda"))[None, :]
                    <= (pos + torch.arange(t, device="cuda"))[:, None])
            qb = q.to(torch.bfloat16).transpose(0, 1)[None]
            kb = k_i.repeat_interleave(hq // hkv, 0)[None]
            vb = v_i.repeat_interleave(hq // hkv, 0)[None]
            ms = timer.compare({
                "kernel": lambda: ca.flash_attention_partials(
                    q, k_i, v_i, pos, scale, kpos_offset=off),
                "plain": lambda: ca.flash_attention_partials_plain(
                    q, k_i, v_i, pos, scale, kpos_offset=off),
                "library": lambda: F.scaled_dot_product_attention(
                    qb, kb, vb, attn_mask=mask, scale=scale)})
            keys = max(0, min(sl, pos + t - off))
            visible = sum(max(0, min(sl, pos + j + 1 - off))
                          for j in range(t))
            b_ms, b_by = bound(t * hq * d * 2 + 2 * keys * hkv * d * 2
                               + t * hq * d * 4 + 2 * t * hq * 4,
                               4.0 * hq * d * visible)
            row.update(ms=ms["kernel"], plain_ms=ms["plain"],
                       library_ms=ms["library"], bound_ms=b_ms,
                       bound_by=b_by)
            if i == 0:  # the path's main shape; the long case's full shard
                row.update(device_profile(
                    torch, lambda: ca.flash_attention_partials(
                        q, k_i, v_i, pos, scale, kpos_offset=off),
                    "flash_fwd_kernel"))
            del qb, kb, vb, mask
        print(json.dumps({"flash_partials": row}), flush=True)
        return row

    def combine(tag, kc, vc, pos, n=CP_SHARDS):
        q = qs[kc.shape[0]]
        sl = kc.shape[1] // n
        ks = [kc[:, i * sl:(i + 1) * sl].contiguous() for i in range(n)]
        vs = [vc[:, i * sl:(i + 1) * sl].contiguous() for i in range(n)]
        combined = layers.attention_cp_flash(q, ks, vs, pos, t, scale)
        whole = ca.flash_attention_cuda(q, kc, vc, pos, t, scale)
        torch.cuda.synchronize()
        rel = row_rel(combined, whole)
        print(f"{tag}: {n} shards' partials combined on the card vs "
              f"the unsplit flash kernel over {kc.shape[1]} keys at pos "
              f"{pos}: max row rel err {rel:.3e} (tol {FLASH_RTOL})",
              flush=True)
        check(bool(torch.isfinite(combined).all()),
              f"cp combine {tag}: non-finite")
        check(rel <= FLASH_RTOL, f"cp combine {tag}: a query row differs "
              f"from the unsplit kernel by {rel} of its max (> {FLASH_RTOL})")
        return rel

    rows, combined = [], {}
    kc, vc = cache(CP_CTX)
    path_pos = 2048  # the prompt chunk [2048, 2560) of the path phase
    rows += [shard_row("path", kc, vc, path_pos, i, True)
             for i in range(CP_SHARDS)]
    combined["path"] = combine("path", kc, vc, path_pos)
    del kc, vc
    kc, vc = cache(32768)
    rows += [shard_row("long", kc, vc, 20000, i, True)
             for i in range(CP_SHARDS)]
    combined["long"] = combine("long", kc, vc, 20000)
    rows += [shard_row("straddle", kc, vc, 16350, i, False)
             for i in range(CP_SHARDS)]
    check(rows[-2]["blind_rows"] == 34, "straddle: shard 2's boundary does "
          "not fall inside the first query block")
    combined["straddle"] = combine("straddle", kc, vc, 16350)
    del kc, vc
    kc, vc = cache(CP_CTX, hkv // 2)
    rows += [shard_row("cptp", kc, vc, 4096, i, True, CPTP_MESH[0])
             for i in range(CPTP_MESH[0])]
    combined["cptp"] = combine("cptp", kc, vc, 4096, CPTP_MESH[0])
    del kc, vc

    def device_row(tag, kc, vc, pos, i, timed):
        """Shard i's call with pos on the card: bit-equal to the host-int
        form, one launch a call; timed: both forms in turns, and the
        device form's profiler device time."""
        sl = kc.shape[1] // CP_SHARDS
        off = i * sl
        k_i = kc[:, off:off + sl].contiguous()
        v_i = vc[:, off:off + sl].contiguous()
        pd = torch.tensor(pos, device="cuda")
        label = f"8b {tag} T={t} pos={pos} shard {i} of {CP_SHARDS} device pos"
        before = ca.partials_launches
        got = ca.flash_attention_partials(q, k_i, v_i, pd, scale,
                                          kpos_offset=off)
        per_call = ca.partials_launches - before
        want = ca.flash_attention_partials(q, k_i, v_i, pos, scale,
                                           kpos_offset=off)
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        check(equal, f"partials {label}: the device-offset form differs from "
              "the host-int form")
        check(per_call == 1, f"partials {label}: {per_call} launches a call")
        row = {"shape": label, "pos": pos, "kpos_offset": off,
               "bit_equal_to_host_form": equal, "launches_per_call": per_call}
        if timed:
            fns = {"kernel": lambda: ca.flash_attention_partials(
                       q, k_i, v_i, pd, scale, kpos_offset=off),
                   "host_form": lambda: ca.flash_attention_partials(
                       q, k_i, v_i, pos, scale, kpos_offset=off)}
            ms = timer.compare(fns)
            row.update(ms=ms["kernel"], host_form_ms=ms["host_form"],
                       **device_profile(torch, fns["kernel"],
                                        "flash_fwd_kernel"))
        print(json.dumps({"flash_partials_device_pos": row}), flush=True)
        return row

    device_rows = []
    kc, vc = cache(CP_CTX)
    device_rows += [device_row("path", kc, vc, path_pos, i, i == 0)
                    for i in range(CP_SHARDS)]
    del kc, vc
    kc, vc = cache(32768)
    device_rows += [device_row("straddle", kc, vc, 16350, i, False)
                    for i in range(CP_SHARDS)]
    del kc, vc
    print(f"cp kernel phase done on {card}", flush=True)
    # the heaviest call of the path's chunk: shard 0, nearly all visible
    return {"rows": rows, "combine_row_rel_err": combined,
            "device_pos_rows": device_rows, "main": rows[0]["shape"]}


def cp_chunk_profile(torch, cp, ids, off: int = 2048) -> dict:
    """One torch.profiler trace of CPEngine's prefill chunk [off, off +
    512) (the chunk whose shard-0 pass is the partials kernel's main-path
    shape), after the chunks before it: the chunk's wall time, the device
    time of every kernel and of the partials kernel (flash_fwd_kernel), the
    partials kernel's share of the device time and the device's busy share
    of the wall time, and the heaviest kernels."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    c = cp.PREFILL_CHUNK
    kv = cp._make_kv()
    toks = np.asarray(ids, dtype=np.int64)
    for o in range(0, off, c):
        cp._prefill_chunk(kv, toks[o:o + c], o, c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cp._prefill_chunk(kv, toks[off:off + c], off, c)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = {}
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type) and e.self_device_time_total > 0:
            kern[e.key[:80]] = (e.self_device_time_total / 1e3, e.count)
    dev = sum(v[0] for v in kern.values())
    part = sum(v[0] for k, v in kern.items() if "flash_fwd_kernel" in k)
    top = sorted(kern.items(), key=lambda kv_: -kv_[1][0])[:6]
    out = {"chunk": [off, off + c], "wall_ms": wall, "device_ms": dev,
           "partials_device_ms": part,
           "partials_launches": sum(v[1] for k, v in kern.items()
                                    if "flash_fwd_kernel" in k),
           "partials_share_of_device": part / dev if dev else None,
           "device_busy_share": dev / wall if wall else None,
           "cuda_kernels": sum(v[1] for v in kern.values()),
           "top": {k: {"ms": v[0], "count": v[1]} for k, v in top}}
    print(json.dumps({"cp_prefill_chunk_profile": out}), flush=True)
    del kv
    torch.cuda.empty_cache()
    return out


def cp_path_phase(torch, counters, card: str, synth) -> tuple[dict, dict]:
    """CPEngine on the synthetic 8B at full width, its first CUT_LAYERS
    layers (depth_cut), 4 shards on
    cuda:0, ctx 9,216, a 4,600-token prompt: Engine.benchmark's protocol
    (the launch counts of the kernels line are read around it), beside the
    resident Engine on the same weights; then CP_STEPS decode steps
    teacher-forced
    on the resident engine's greedy tokens, every step's logits against the
    resident's. The limit is the larger of FULL_LOGIT_RTOL and twice the
    resident kernel path's own spread against the resident plain path at
    that step: both engines run the same matmul kernels, and their prefill
    attention kernels round p to bf16 against different maxima (a shard's
    own against the whole row's), a rounding the plain path does not make
    at all. Then the replayed programs against the uncaptured ones
    (mesh_engine_cell: the whole prompt in its 9 chunks, MESH_STEPS loop
    steps across key 4,608). Last, the CLI's --cp 1 on repolm512."""
    import contextlib
    import dataclasses
    import io
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.inference.engine import CPEngine, Engine
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.ops import linear
    from ntransformer_tpu_torch.ops.cuda import attention as ca
    from ntransformer_tpu_torch.ops.layers import rope_table
    from ntransformer_tpu_torch.parallel.cp import make_cp_mesh

    cfg, arch, weights, _ = synth
    arch = dataclasses.replace(arch, max_seq_len=CP_CTX)
    cos, sin = rope_table(CP_CTX, arch.head_dim, arch.rope_theta,
                          device="cuda")
    weights = dataclasses.replace(weights, rope_cos=cos, rope_sin=sin)
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    cp = CPEngine(model, make_cp_mesh(CP_SHARDS, ["cuda:0"] * CP_SHARDS))
    res = Engine(model)
    ids = torch.randint(0, arch.vocab_size, (CP_PROMPT,),
                        generator=torch.Generator().manual_seed(46)).tolist()
    reset(counters)
    st_cp = cp.benchmark(prompt_ids=ids, n_tokens=CP_STEPS)
    torch.cuda.synchronize()
    launches = read(counters)
    print(f"8b CPEngine path launches {launches}", flush=True)
    check(launches[ca.PARTIALS_NAME] > 0 and launches["q8_0_matmul"] > 0,
          f"8b CPEngine: a kernel of the CP path launched zero times: "
          f"{launches}")
    check(launches[ca.NAME] == 0,
          f"8b CPEngine: the resident flash kernel ran: {launches}")
    chunk_prof = cp_chunk_profile(torch, cp, ids)
    st_res = res.benchmark(prompt_ids=ids, n_tokens=CP_STEPS)

    res_toks, res_logits = greedy_pass(res, torch, ids, CP_STEPS)
    cp_toks, _ = greedy_pass(cp, torch, ids, CP_STEPS)
    _, cp_logits = greedy_pass(cp, torch, ids, CP_STEPS,
                               forced=res_toks)
    linear.KERNEL_MODE = "off"
    try:
        _, plain_logits = greedy_pass(res, torch, ids, CP_STEPS,
                                      forced=res_toks)
    finally:
        linear.KERNEL_MODE = "auto"

    def rels(got):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, res_logits)]
    for a in cp_logits:
        check(bool(torch.isfinite(a).all()), "8b CPEngine: non-finite logits")
    kern, plain = rels(cp_logits), rels(plain_logits)
    limits = [max(FULL_LOGIT_RTOL, 2 * r) for r in plain]
    forced_agree = sum(int(torch.argmax(a)) == tk
                       for a, tk in zip(cp_logits[:-1], res_toks))
    agree = sum(a == b for a, b in zip(cp_toks, res_toks))
    print(f"8b CPEngine vs resident Engine: {agree}/{CP_STEPS} greedy tokens "
          f"agree, {forced_agree}/{CP_STEPS} teacher-forced argmaxes; "
          f"max|dlogit|/"
          f"max|logit| per step {[round(r, 4) for r in kern]}; resident "
          f"plain path vs kernels {[round(r, 4) for r in plain]}", flush=True)
    for i, (r, lim) in enumerate(zip(kern, limits)):
        check(r <= lim, f"8b CPEngine step {i}: teacher-forced logits differ "
              f"from the resident engine's by {r} of their range (> {lim})")
    replay = mesh_engine_cell(torch, counters, "cp_8b", cp, ids)

    reset(counters)
    outs = {}
    for flags in ([], ["--cp", "1"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-m", REPOLM, "-p", PROMPT, "-n", "32", "-t", "0",
                           "--repeat-penalty", "1.0", "--no-fuse"] + flags)
        check(rc == 0, f"cli {flags}: exit code {rc}")
        outs[" ".join(flags) or "resident"] = buf.getvalue()
    torch.cuda.synchronize()
    cli_launches = read(counters)
    check(cli_launches[ca.PARTIALS_NAME] > 0,
          f"cli --cp 1 launched no partials kernel: {cli_launches}")
    same = outs["--cp 1"] == outs["resident"]
    print(f"cli --cp 1 on repolm512: text "
          f"{'equals' if same else 'differs from'} the resident CLI's "
          f"(--no-fuse): {outs['--cp 1']!r}", flush=True)
    # one shard: the prefill's combine weighs by exp(m - m) = 1 and
    # divides acc by l, the resident kernel's finish bit for bit; the plain
    # CP decode differs from the resident softmax only in rounding (it
    # divides after the PV product), too little to turn a greedy token here
    check(same, f"cli --cp 1 wrote {outs['--cp 1']!r}, the resident CLI "
          f"{outs['resident']!r}")

    summary = {"card": card, "shards": CP_SHARDS, "ctx": CP_CTX,
               "prompt_tokens": CP_PROMPT}
    for tag, st in (("cp", st_cp), ("resident", st_res)):
        summary[f"{tag}_prefill_tok_s"] = st.prefill_tps
        summary[f"{tag}_prefill_ms"] = st.prefill_ms
        summary[f"{tag}_decode_ms_per_token"] = (st.decode_ms
                                                 / st.decode_tokens)
    summary.update(greedy_agree=agree, forced_argmax_agree=forced_agree,
                   logit_rel_err_steps=kern, plain_rel_err_steps=plain,
                   cli_cp1_text_equal=same, launches=launches,
                   prefill_chunk_profile=chunk_prof, replay=replay)
    print(json.dumps({"cp_8b": summary}), flush=True)
    del cp, res
    torch.cuda.empty_cache()
    return summary, launches


def cp_cards_phase(torch, counters, card: str, synth) -> dict | None:
    """One shard per card, on a host with CP_SHARDS cards or more (on
    fewer it says so and returns None): repolm512 through
    CPEngine.load(cp=4), whose default mesh puts shard i on cuda:i, against
    the same weights with the 4 shards on cuda:0 (a 300-token prompt, 4
    shards of 128 keys, 32 greedy steps); then the synthetic 8B of `full`
    (`synth`, all 32 layers), ctx 4,096, over 4 cards
    and over 2 (a 1,000-token prompt in two chunks, 16 steps) against its
    shards on cuda:0. Every kernel launches on its tensors' card and the
    cross-card copies are exact, so tokens, logits and caches must be
    bit-equal, uncaptured and replayed (cards_vs_one). Then the CLI's
    --cp 4."""
    import contextlib
    import io
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.inference.engine import CPEngine
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.ops.cuda import attention as ca
    from ntransformer_tpu_torch.parallel.cp import make_cp_mesh

    n_cards = torch.cuda.device_count()
    if n_cards < CP_SHARDS:
        print(f"cpcards: {n_cards} card(s); one shard per card needs "
              f"{CP_SHARDS}: not run", flush=True)
        return None
    out = {"card": card, "cards": n_cards}
    cfg, arch, weights, _ = synth
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    small = CPEngine.load(REPOLM, cp=CP_SHARDS)
    gen = torch.Generator().manual_seed(47)
    for name, n_prompt, n, make in (
            ("repolm512", 300, 32, lambda cp, devs: small if devs is None
             else CPEngine(small.model, make_cp_mesh(cp, devs))),
            ("8b_cp4", 1000, 16,
             lambda cp, devs: CPEngine(model, make_cp_mesh(cp, devs))),
            ("8b_cp2", 1000, 16,
             lambda cp, devs: CPEngine(model, make_cp_mesh(cp, devs)))):
        cp = 2 if name.endswith("cp2") else CP_SHARDS
        want = tuple(torch.device("cuda", i) for i in range(cp))
        cards, one = make(cp, None), make(cp, ["cuda:0"] * cp)
        check(cards.mesh == want, f"cpcards {name}: mesh {cards.mesh}, not "
              f"{want}")
        check([s.k.device for s in cards._make_kv()] == list(want),
              f"cpcards {name}: a shard's cache is not on its card")
        ids = torch.randint(0, cards.arch.vocab_size, (n_prompt,),
                            generator=gen).tolist()
        got = cards_vs_one(torch, counters, f"cpcards_{name}", cards, one,
                           ids, n)
        check(got["launches"][ca.PARTIALS_NAME] > 0,
              f"cpcards {name}: no partials kernel launched: "
              f"{got['launches']}")
        out[name] = got
        del cards, one
        torch.cuda.empty_cache()
    del small
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-m", REPOLM, "-p", PROMPT, "-n", "32", "-t", "0",
                       "--repeat-penalty", "1.0", "--cp", str(CP_SHARDS)])
    check(rc == 0, f"cli --cp {CP_SHARDS}: exit code {rc}")
    out["cli_text"] = buf.getvalue()
    print(json.dumps({"cp_cards": {"card": card, "cards": n_cards,
                                   "cli_text": out["cli_text"]}}),
          flush=True)
    return out


# ------------------------------------------------------ tensor parallelism
TP_SHARDS = 2   # phase tp: the shards on the one card
TP_FORCED = 32  # phase tp: the forced steps a cache
TP_CARDS = 4    # phase tpcards: one shard a card


def tp_step(torch, eng, quant=False):
    """step(tokens, pos) -> logits through a TPEngine's shards and a cache
    of its own (greedy_ids' protocol)."""
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.parallel.tp import make_tp_kv
    kv = make_tp_kv(eng.arch, eng.mesh, quant)

    def step(tokens, pos):
        return llama.forward(eng.arch, eng.shards, kv, tokens, pos,
                             tp=eng.mesh)[0]
    return step


def tp_forced(torch, tp, res, ids, n: int,
              tag: str = f"8b TPEngine ({TP_SHARDS} shards") -> dict:
    """n decode steps of the TPEngine (or another sharded engine, `tag`)
    teacher-forced on the resident Engine's greedy tokens (the cache both
    engines' kv_quant says), every step's logits held to the resident's by
    the CP phase's rule: within the larger of FULL_LOGIT_RTOL and twice the
    resident kernel path's spread against its plain path at that step."""
    from ntransformer_tpu_torch.ops import linear
    res_toks, res_logits = greedy_pass(res, torch, ids, n)
    _, tp_logits = greedy_pass(tp, torch, ids, n, forced=res_toks)
    linear.KERNEL_MODE = "off"
    try:
        _, plain_logits = greedy_pass(res, torch, ids, n, forced=res_toks)
    finally:
        linear.KERNEL_MODE = "auto"
    for a in tp_logits:
        check(bool(torch.isfinite(a).all()), f"{tag}): non-finite logits")
    kern = [rel_err(a, b) for a, b in zip(tp_logits, res_logits)]
    plain = [rel_err(a, b) for a, b in zip(plain_logits, res_logits)]
    limits = [max(FULL_LOGIT_RTOL, 2 * r) for r in plain]
    cache = "int8" if tp.kv_quant else "bf16"
    for i, (r, lim) in enumerate(zip(kern, limits)):
        check(r <= lim, f"{tag}) {cache} step {i}: teacher-forced "
              f"logits differ from the resident engine's by {r} of their "
              f"range (> {lim})")
    agree = sum(int(torch.argmax(a)) == tk
                for a, tk in zip(tp_logits[:-1], res_toks))
    print(f"{tag}, {cache} cache) vs resident "
          f"Engine, teacher-forced: {agree}/{n} argmaxes agree; max|dlogit|/"
          f"max|logit| per step {[round(r, 4) for r in kern]}; resident "
          f"plain path vs kernels {[round(r, 4) for r in plain]}",
          flush=True)
    return {"forced_argmax_agree": agree, "logit_rel_err_steps": kern,
            "plain_rel_err_steps": plain, "resident_tokens": res_toks}


def tp_path_phase(torch, counters, card: str, synth) -> tuple[dict, dict]:
    """TPEngine on the synthetic 8B Q8_0 at full width, its first
    CUT_LAYERS layers (depth_cut; the
    weights of `full`, fused in tp = 1 order: each shard's q|k|v and
    gate|up are rebuilt from its slices of the parts), TP_SHARDS shards on
    cuda:0: Engine.benchmark's protocol (prefill 512, ctx 4096; the kernels
    line's tp_launches are read around it) beside the resident Engine on
    the same weights, and a decode profile of each (kernels a token, the
    card's busy share); then TP_FORCED decode steps teacher-forced on the
    resident engine's greedy tokens with the bf16 and the int8 cache
    (tp_forced); the replayed programs against the uncaptured ones
    (mesh_engine_cell: the 512-token prompt, MESH_STEPS loop steps).
    Last, the CLI on repolm512 (tp_cli). TPEngine.benchmark runs
    make_tp_decode_loop, which replays the engine's loop graph on one
    card."""
    from ntransformer_tpu_torch.inference.engine import Engine, TPEngine
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.parallel.tp import make_tp_mesh

    cfg, arch, weights, _ = synth
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    t0 = time.perf_counter()
    tp = TPEngine(model, make_tp_mesh(TP_SHARDS, ["cuda:0"] * TP_SHARDS))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    lw = tp.shards[0].layers
    check((lw.wqkv.n, lw.w_gate_up.n, lw.wo.k, lw.w_down.k,
           tp.shards[0].lm_head.k) == (6144 // TP_SHARDS, 28672 // TP_SHARDS,
                                       4096 // TP_SHARDS,
                                       14336 // TP_SHARDS,
                                       4096 // TP_SHARDS),
          "8b TPEngine: unexpected shard shapes")
    res = Engine(model)
    ids = torch.randint(0, arch.vocab_size, (512,),
                        generator=torch.Generator().manual_seed(9)).tolist()
    # one untimed prefill each first: the first launches of a kernel load
    # its module (run alone, this phase launches first)
    for eng in (tp, res):
        eng._prefill(eng._make_kv(), ids)
    torch.cuda.synchronize()
    reset(counters)
    st_tp = tp.benchmark(prompt_ids=ids, n_tokens=64)
    torch.cuda.synchronize()
    launches = read(counters)
    print(f"8b TPEngine path launches {launches}", flush=True)
    check(all(launches[k] > 0 for k in ENGINE_KERNELS),
          f"8b TPEngine: a kernel of the path launched zero times: "
          f"{launches}")
    st_res = res.benchmark(prompt_ids=ids, n_tokens=64)
    profiles = {}
    for tag, w, kv, fw in (("tp", tp.shards, tp._make_kv(),
                            {"tp": tp.mesh}),
                           ("resident", weights, res._make_kv(), {})):
        logits, kv, _ = llama.forward(arch, w, kv, ids, 0, n_valid=512,
                                      **fw)
        profiles[tag] = profile_decode(torch, arch, w, kv, logits, 512,
                                       **fw)
        del kv
    replay = mesh_engine_cell(torch, counters, "tp_8b", tp, ids)
    forced = {}
    for quant in (False, True):
        tp.kv_quant = res.kv_quant = quant
        forced["int8" if quant else "bf16"] = tp_forced(torch, tp, res, ids,
                                                        TP_FORCED)
    tp.kv_quant = res.kv_quant = False
    summary = {"card": card, "shards": TP_SHARDS, "ctx": arch.max_seq_len,
               "shard_s": shard_s, "launches": launches,
               "tp_kernels_per_token": profiles["tp"]["kernels_per_token"],
               "resident_kernels_per_token":
                   profiles["resident"]["kernels_per_token"],
               "tp_device_busy_share": profiles["tp"]["device_busy_share"],
               "resident_device_busy_share":
                   profiles["resident"]["device_busy_share"],
               "tp_device_ms_per_token":
                   profiles["tp"]["device_ms_per_token"],
               "resident_device_ms_per_token":
                   profiles["resident"]["device_ms_per_token"],
               "forced": {k: {kk: vv for kk, vv in v.items()
                              if kk != "resident_tokens"}
                          for k, v in forced.items()}, "replay": replay}
    for tag, st in (("tp", st_tp), ("resident", st_res)):
        summary[f"{tag}_prefill_tok_s"] = st.prefill_tps
        summary[f"{tag}_prefill_ms"] = st.prefill_ms
        summary[f"{tag}_decode_ms_per_token"] = (st.decode_ms
                                                 / st.decode_tokens)
    print(json.dumps({"tp_8b": summary}), flush=True)
    del tp, res
    torch.cuda.empty_cache()
    summary["cli"] = tp_cli(torch, counters)
    return summary, launches


def tp_cli(torch, counters) -> dict:
    """repolm512 through the CLI's --tp 2 with both shards on cuda:0
    (--device cuda:0): resident generation unfused and fused, and
    --streaming --tp 2 at (2, 2, 2) layers; the unfused and streamed texts
    equal to TPEngine.generate's (the same shard planes, kernels and sums);
    then the refusals, each exit code 2 (--tp 9 over the one card's
    default mesh included; --cp 2 --tp 2 runs, phase cptp)."""
    import contextlib
    import io
    import shutil
    import tempfile
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.inference.engine import (GenerateConfig,
                                                         TPEngine)
    eng = TPEngine.load(REPOLM, tp=2, device="cuda:0")
    want, _ = eng.generate(PROMPT, GenerateConfig(
        max_tokens=16, temperature=0.0, repeat_penalty=1.0))
    del eng
    out = {"tpengine_text": want}
    base = ["-p", PROMPT, "-n", "16", "-t", "0", "--repeat-penalty", "1.0",
            "--tp", "2", "--device", "cuda:0"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "repolm512_q8.gguf")
        shutil.copy(REPOLM, path)
        for name, flags in (("resident", ["--no-fuse"]), ("fused", []),
                            ("streaming", ["--streaming",
                                           "--max-hbm-layers", "2",
                                           "--max-ram-layers", "2"])):
            buf, err = io.StringIO(), io.StringIO()
            reset(counters)
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(["-m", path] + base + flags)
            torch.cuda.synchronize()
            got = read(counters)
            check(rc == 0, f"cli --tp 2 {name}: exit code {rc}: "
                  f"{err.getvalue()[-400:]}")
            check(all(got[k] > 0 for k in ENGINE_KERNELS),
                  f"cli --tp 2 {name} launched {got}")
            text = buf.getvalue().rstrip("\n")
            out[name] = {"text": text, "equal": text == want,
                         "launches": got}
            if name == "streaming":
                check("tiers: 2 HBM + 2 RAM + 2 disk" in err.getvalue(),
                      f"cli --streaming --tp 2: {err.getvalue()[-400:]}")
    for name in ("resident", "streaming"):
        check(out[name]["equal"], f"cli --tp 2 {name} wrote "
              f"{out[name]['text']!r}, TPEngine {want!r}")
    refused = {}
    for flags in (["--w4a8", "--tp", "2"], ["--w8a8", "--tp", "2"],
                  ["--draft-model", REPOLM, "--tp", "2"],
                  ["--ep", "2", "--tp", "2"], ["--tp", "9"]):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["-m", REPOLM, "-n", "4"] + flags)
        check(rc == 2, f"cli {flags}: exit code {rc}, want 2")
        refused[" ".join(flags)] = err.getvalue().strip().splitlines()[-1]
    out["refused"] = refused
    print(json.dumps({"tp_cli": out}), flush=True)
    return out


def tp_cards_phase(torch, counters, card: str, synth) -> dict | None:
    """One shard per card, on a host with TP_CARDS cards or more (on fewer
    it says so and returns None): repolm512 through TPEngine.load(tp=4),
    whose default mesh puts shard i on cuda:i, against the same shards all
    on cuda:0 (a 300-token prompt, 32 greedy steps); then the synthetic 8B
    Q8_0 of `full` (`synth`, all 32 layers)
    over 4 cards and over 2 (a 512-token prompt, 16 steps) against its
    shards on cuda:0. Every kernel launches on its tensors' card, the
    cross-card copies are exact and the sums run in shard order on
    cuda:0, so tokens, logits and caches must be bit-equal, uncaptured and
    replayed (cards_vs_one: the mesh over cards replays CardGraphs); with
    the replayed programs over the cards held to their uncaptured calls,
    a card stalled before some replays, and the loop's walls in turns
    against the mesh on cuda:0. Then the CLI's --tp 4."""
    import contextlib
    import io
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.inference.engine import TPEngine
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.parallel.tp import make_tp_mesh

    n_cards = torch.cuda.device_count()
    if n_cards < TP_CARDS:
        print(f"tpcards: {n_cards} card(s); one shard per card needs "
              f"{TP_CARDS}: not run", flush=True)
        return None
    out = {"card": card, "cards": n_cards}
    cfg, arch, weights, _ = synth
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    gen = torch.Generator().manual_seed(48)
    for name, n_prompt, n, make in (
            ("repolm512", 300, 32,
             lambda tp, dev: TPEngine.load(REPOLM, tp=tp, device=dev)),
            ("8b_tp4", 512, 16, lambda tp, dev: TPEngine(
                model, make_tp_mesh(tp, None if dev == "cuda"
                                    else [dev] * tp))),
            ("8b_tp2", 512, 16, lambda tp, dev: TPEngine(
                model, make_tp_mesh(tp, None if dev == "cuda"
                                    else [dev] * tp)))):
        tp = 2 if name.endswith("tp2") else TP_CARDS
        want = tuple(torch.device("cuda", i) for i in range(tp))
        cards, one = make(tp, "cuda"), make(tp, "cuda:0")
        check(cards.mesh == want, f"tpcards {name}: mesh {cards.mesh}, not "
              f"{want}")
        check([c.k.device for c in cards._make_kv()] == list(want),
              f"tpcards {name}: a shard's cache is not on its card")
        ids = torch.randint(0, cards.arch.vocab_size, (n_prompt,),
                            generator=gen).tolist()
        got = cards_vs_one(torch, counters, f"tpcards_{name}", cards, one,
                           ids, n)
        check(all(got["launches"][k] > 0 for k in ENGINE_KERNELS),
              f"tpcards {name}: launched {got['launches']}")
        out[name] = got
        del cards, one
        torch.cuda.empty_cache()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-m", REPOLM, "-p", PROMPT, "-n", "32", "-t", "0",
                       "--repeat-penalty", "1.0", "--tp", str(TP_CARDS)])
    check(rc == 0, f"cli --tp {TP_CARDS}: exit code {rc}")
    out["cli_text"] = buf.getvalue()
    print(json.dumps({"tp_cards": {"card": card, "cards": n_cards,
                                   "cli_text": out["cli_text"]}}),
          flush=True)
    return out


# ------------------------------------------------------ data parallelism
DP_MESHES = ((2, 1), (2, 2))   # phase dp: (dp, tp) positions on cuda:0
DP_STEPS = 8                   # teacher-forced steps of the mesh check
DP_CARDS = 4                   # phase dpcards: one position a card
ROW_TURN = 16                  # dpcards: timed steps of the 8B row
TWO_PROCESS_S = 300            # a process of a two-process run
DUMP_S = 240                   # ... dumps every thread's stack from here
DP_WORKER = """
import faulthandler, json, sys
sys.path.insert(0, sys.argv[1])
rank, port, backend, devs = (int(sys.argv[2]), sys.argv[3], sys.argv[4],
                             sys.argv[5].split(","))
job = json.loads(sys.argv[6])
# a process that waits past DUMP_S prints every thread's stack, again each
# DUMP_S / 4 s, before its parent's timeout stops it
faulthandler.dump_traceback_later(job["dump_s"], repeat=True)
import torch
from ntransformer_tpu_torch.parallel.multihost import (initialize, make_mesh,
                                                       shutdown)
if backend == "nccl":
    torch.cuda.set_device(torch.device(devs[0]))
initialize("127.0.0.1:" + port, 2, rank, backend=backend)
mesh = make_mesh(tp=job["tp"], dp=job["dp"], devices=devs)
if job["kind"] == "serve":
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import load_model
    srv = BatchServer(load_model(job["gguf"], device="cpu"), batch_size=4,
                      mesh=mesh, sampler_cfg=SamplerConfig(temperature=0.0))
    reqs = [Request(prompt=p, max_tokens=16) for p in job["prompts"]]
    srv.run(reqs)
    print("DP-TEXTS " + json.dumps([r.text for r in reqs]), flush=True)
    gs = [g for g in (srv._ggraphs or []) if g is not None]
    adm = srv._adm[1] if srv._adm is not None else None
    print("DP-GRAPHS " + json.dumps({
        "captured": srv._ggraphs is not None,
        "replays": sum(sum(g.replays.values()) for g in gs),
        "admission_replays": (sum(adm.replays.values()) if adm is not None
                              else 0)}), flush=True)
else:
    import chip_smoke
    print("DP-GRAPHS " + json.dumps(chip_smoke.row_steps(torch, mesh, job)),
          flush=True)
shutdown()
"""


def dp_requests(torch, arch):
    """bfull's eight requests: 9-1,000 prompt tokens, 16 new tokens."""
    from ntransformer_tpu_torch.inference.serve import Request
    rng = torch.Generator().manual_seed(21)
    lens = [700, 130, 64, 9, 300, 20, 90, 1000]
    return lens, [Request(prompt="", max_tokens=16, prompt_ids=torch.randint(
        3, arch.vocab_size, (n,), generator=rng).tolist()) for n in lens]


def mesh_cache(torch, mesh, arch, bkv):
    """The dp groups' caches of a (dp, tp) mesh filled from one [L, B, ...]
    cache: group g's slots, shard s's heads, each a contiguous copy."""
    from ntransformer_tpu_torch.parallel.dp import make_server_kv
    b_n = bkv.k.shape[1]
    grid = make_server_kv(mesh, arch, b_n, bkv.quantized)
    per, h = b_n // mesh.dp, arch.n_kv_heads // mesh.tp
    for g, row in enumerate(grid):
        for s, c in enumerate(row):
            if c is None:        # another process's position
                continue
            for dst, src in zip(c.caches, bkv.caches):
                dst.copy_(src[:, g * per:(g + 1) * per, s * h:(s + 1) * h])
    return grid


def dp_forced(torch, counters, mesh, arch, weights, grid_w, bkv, lens,
              toks, ref_logits, plain_logits) -> dict:
    """DP_STEPS steps of the sharded step teacher-forced on the one-device
    server's tokens `toks` from the prefilled cache `bkv`. tp = 1: each
    group's logits bit-equal to the unsharded step on its slots alone (a
    cache of B/dp slots, the same plans). tp > 1: every step within the TP
    rule, max(FULL_LOGIT_RTOL, 2 r) of the largest logit (r: the unsharded
    kernel path's spread against its plain path at that step). Also the
    step's ms and kernels a step."""
    from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                       batched_decode_step)
    from ntransformer_tpu_torch.parallel.dp import make_batched_decode_sharded
    grid = mesh_cache(torch, mesh, arch, bkv)
    step = make_batched_decode_sharded(mesh, arch)
    b_n = len(lens)
    per = b_n // mesh.dp
    pos = torch.tensor(lens, device="cuda")
    act = torch.ones(b_n, dtype=torch.bool, device="cuda")
    alone = []
    if mesh.tp == 1:
        for g in range(mesh.dp):
            sl = slice(g * per, (g + 1) * per)
            alone.append(BatchedKV(*(None if t is None
                                     else t[:, sl].contiguous()
                                     for t in (bkv.k, bkv.v, bkv.ks,
                                               bkv.vs))))
    rels, bit_equal = [], True
    for i in range(DP_STEPS):
        tk = torch.as_tensor(toks[i], device="cuda")
        logits, grid = step(grid_w, grid, tk, pos + i, act)
        if mesh.tp == 1:
            for g in range(mesh.dp):
                sl = slice(g * per, (g + 1) * per)
                a1, _ = batched_decode_step(arch, weights, alone[g], tk[sl],
                                            (pos + i)[sl], act[sl])
                bit_equal &= bool(torch.equal(a1, logits[sl]))
        else:
            rels.append(rel_err(logits, ref_logits[i]))
    out = {"steps": DP_STEPS}
    if mesh.tp == 1:
        check(bit_equal, f"dp {mesh.shape}: a group's logits differ from "
              "the unsharded step on its slots alone")
        out["groups_bit_equal_to_unsharded_alone"] = True
    else:
        plain = [rel_err(p, r) for p, r in zip(plain_logits, ref_logits)]
        limits = [max(FULL_LOGIT_RTOL, 2 * r) for r in plain]
        for i, (r, lim) in enumerate(zip(rels, limits)):
            check(r <= lim, f"dp {mesh.shape} step {i}: teacher-forced "
                  f"logits differ from the one-device step's by {r} of "
                  f"their range (> {lim})")
        out.update(logit_rel_err_steps=rels, plain_rel_err_steps=plain)
    # the sharded step alone, timed and counted: DP_STEPS more steps
    torch.cuda.synchronize()
    reset(counters)
    t0 = time.perf_counter()
    for i in range(DP_STEPS):
        tk = torch.as_tensor(toks[i], device="cuda")
        logits, grid = step(grid_w, grid, tk, pos + DP_STEPS + i, act)
    logits.cpu()
    wall = time.perf_counter() - t0
    launches = read(counters)
    out.update(launches=launches, ms_per_step=wall * 1e3 / DP_STEPS,
               kernels_per_step=sum(launches.values()) / DP_STEPS)
    del grid, alone
    return out


def dp_replay_cell(torch, counters, mesh, arch, grid_w, bkv, lens,
                   first, cards=None) -> dict:
    """The sharded B = 8 step over `mesh` replayed (one StepGraphs a dp
    group, dp.group_graphs, the decode key captured first) against the
    uncaptured sharded step (batched_replay_cell; cards: the cards of a
    mesh over several), from the prefilled cache bkv at the prompts' ends,
    greedy from `first`."""
    from ntransformer_tpu_torch.parallel import dp
    check(dp.captured(mesh), f"dp {mesh.shape}: the mesh on cuda:0 does "
          "not replay")
    ref = mesh_cache(torch, mesh, arch, bkv)
    kv = mesh_cache(torch, mesh, arch, bkv)
    graphs = dp.group_graphs(mesh, arch, grid_w, kv)
    t0 = time.perf_counter()
    for g in graphs:
        g.capture([g.key("decode")])
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t0
    step_u = dp.make_batched_decode_sharded(mesh, arch)
    step_g = dp.make_batched_decode_sharded(mesh, arch, graphs=graphs)
    cell = batched_replay_cell(
        torch, counters, f"dp_8b_{mesh.dp}x{mesh.tp}"
        + ("_cards" if cards else ""),
        lambda c, t, p, a: step_u(grid_w, c, t, p, a)[0],
        lambda c, t, p, a: step_g(grid_w, c, t, p, a)[0], ref, kv,
        len(lens), torch.tensor(lens, device="cuda"),
        torch.as_tensor(first, device="cuda"), cards=cards)
    cell.update(capture_s=cap_s, graphs=len(graphs),
                replays=sum(sum(g.replays.values()) for g in graphs))
    if cards is not None:
        cell["group_program"] = program_shape(
            graphs[0]._graphs[graphs[0].key("decode")][0])
    del graphs, ref, kv
    torch.cuda.empty_cache()
    return cell


def dp_one_device_forced(torch, counters, arch, weights, bkv, lens, toks):
    """The unsharded batched step over the same DP_STEPS forced tokens:
    its logits (kernel and plain paths), ms a step and kernels a step."""
    from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                       batched_decode_step)
    from ntransformer_tpu_torch.ops import linear
    pos = torch.tensor(lens, device="cuda")
    act = torch.ones(len(lens), dtype=torch.bool, device="cuda")
    runs = {}
    for mode in ("auto", "off"):
        linear.KERNEL_MODE = mode
        try:
            c = BatchedKV(*(None if t is None else t.clone()
                            for t in (bkv.k, bkv.v, bkv.ks, bkv.vs)))
            outs = []
            torch.cuda.synchronize()
            reset(counters)
            t0 = time.perf_counter()
            for i in range(DP_STEPS):
                tk = torch.as_tensor(toks[i], device="cuda")
                lg, c = batched_decode_step(arch, weights, c, tk, pos + i,
                                            act)
                outs.append(lg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[mode] = (outs, wall, read(counters))
            del c
        finally:
            linear.KERNEL_MODE = "auto"
    outs, wall, launches = runs["auto"]
    return outs, runs["off"][0], {
        "ms_per_step": wall * 1e3 / DP_STEPS, "launches": launches,
        "kernels_per_step": sum(launches.values()) / DP_STEPS}


def serve_8b(torch, counters, model, reqs_fn, **kw):
    """BatchServer(B = 8) over fresh copies of the requests, warmed up
    first: (texts, stats, launches, warm-up seconds). The launches are
    counted from before the warm-up: on the card the server captures its
    steps and admission chunks there and replays them in the run, and a
    replay advances no counter."""
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer
    srv = BatchServer(model, batch_size=8,
                      sampler_cfg=SamplerConfig(temperature=0.0), **kw)
    _, reqs = reqs_fn()
    torch.cuda.synchronize()
    reset(counters)
    warm = srv.warmup()
    stats = srv.run(reqs)
    torch.cuda.synchronize()
    launches = read(counters)
    check(all(len(r.output_ids) == 16 for r in reqs),
          f"8b server {kw.get('mesh') and kw['mesh'].shape}: a request "
          "finished short")
    del srv
    return [r.output_ids for r in reqs], stats, launches, warm


def dp_path_phase(torch, counters, card: str, synth) -> tuple[dict, dict]:
    """The sharded server on the synthetic 8B Q8_0 of `full` cut to its
    first CUT_LAYERS layers (depth_cut: free views, no new load):
    BatchServer(B = 8) one-device and over the (2, 1) and (2, 2) meshes on
    cuda:0 serving bfull's eight requests (served tok/s, ttft; the kernels
    line's dp_launches are the two mesh servers' launches), the count of
    texts that differ from the one-device server's (printed, not held: the
    plans depend on B and the shapes, so a near-tie may break the other
    way at B/dp); the teacher-forced check that fails the run (dp_forced),
    with ms and kernels a step beside the one-device step's; the replayed
    group steps against the uncaptured ones (dp_replay_cell; the servers
    replay theirs, captured in warmup); spec serving (K = 3) on the (2, 1)
    mesh; then repolm512 through the CLI and two processes (dp_cli,
    dp_two_process: two processes keep the host path)."""
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models.batched import BatchedKV
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.parallel.dp import shard_server_state
    from ntransformer_tpu_torch.parallel.multihost import make_mesh
    cfg, arch, weights, _ = synth
    model = LoadedModel(cfg, arch, weights, IdsTokenizer(), None,
                        torch.device("cuda"))

    def requests():
        return dp_requests(torch, arch)
    lens, reqs = requests()
    summary = {"card": card, "B": 8, "requests": lens, "meshes": {}}
    ids1, st1, l1, warm1 = serve_8b(torch, counters, model, requests)
    summary["one_device"] = {
        "serve_tok_s": st1.tokens_per_s, "serve_wall_s": st1.wall_s,
        "serve_steps": st1.steps, "warmup_s": warm1,
        "ttft_p50_s": sorted(st1.ttft_s)[len(st1.ttft_s) // 2],
        "launches": l1}
    print(f"8b one-device server: {st1.report()}", flush=True)
    # the teacher-forced check's start: each prompt prefilled by the
    # Engine (the admission's chunks) into one [L, 8, ...] cache; step i
    # is fed the one-device server's token i of every slot
    eng = Engine(model)
    bkv = BatchedKV.create(arch, 8, device="cuda")
    for b, r in enumerate(reqs):
        _, kv, _ = eng._prefill(eng._make_kv(), r.prompt_ids)
        bkv.insert(b, kv)
        del kv
    toks = [[ids1[b][i] for b in range(8)] for i in range(DP_STEPS)]
    ref_logits, plain_logits, one_step = dp_one_device_forced(
        torch, counters, arch, weights, bkv, lens, toks)
    summary["one_device"]["step"] = one_step
    dp_launches = {}
    for dp_n, tp_n in DP_MESHES:
        mesh = make_mesh(tp=tp_n, dp=dp_n, devices=["cuda:0"] * (dp_n * tp_n))
        t0 = time.perf_counter()
        grid_w, _ = shard_server_state(mesh, arch, weights, 8,
                                       with_kv=False)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        forced = dp_forced(torch, counters, mesh, arch, weights, grid_w, bkv,
                           lens, toks, ref_logits, plain_logits)
        replay = dp_replay_cell(torch, counters, mesh, arch, grid_w, bkv,
                                lens, toks[0])
        del grid_w
        ids_m, st, launches, warm = serve_8b(torch, counters, model,
                                             requests, mesh=mesh)
        for k, v in launches.items():
            dp_launches[k] = dp_launches.get(k, 0) + v
        differ = sum(a != b for a, b in zip(ids_m, ids1))
        cell = {"shard_s": shard_s, "serve_tok_s": st.tokens_per_s,
                "serve_wall_s": st.wall_s, "serve_steps": st.steps,
                "warmup_s": warm,
                "ttft_p50_s": sorted(st.ttft_s)[len(st.ttft_s) // 2],
                "texts_differing_from_one_device": differ,
                "launches": launches, "forced": forced, "replay": replay,
                "_ids": ids_m}
        summary["meshes"][f"{dp_n}x{tp_n}"] = cell
        print(f"8b server over the ({dp_n}, {tp_n}) mesh on cuda:0: "
              f"{st.report()}; {differ} of 8 texts differ from the "
              f"one-device server's; step {forced['ms_per_step']:.2f} ms, "
              f"{forced['kernels_per_step']:.0f} kernels (one-device "
              f"{one_step['ms_per_step']:.2f} ms, "
              f"{one_step['kernels_per_step']:.0f})", flush=True)
        check(all(launches[k] > 0 for k in SERVE_KERNELS),
              f"8b ({dp_n}, {tp_n}) server launched {launches}")
    del bkv, ref_logits, plain_logits
    torch.cuda.empty_cache()
    # speculative serving on the (2, 1) mesh
    mesh = make_mesh(tp=1, dp=2, devices=["cuda:0"] * 2)
    ids_s, st, launches, _ = serve_8b(torch, counters, model, requests,
                                      mesh=mesh, spec_k=SPEC_K)
    check(st.spec_drafted > 0 and all(launches[k] > 0
                                      for k in SPEC_KERNELS),
          f"8b spec (2, 1): drafted {st.spec_drafted}, launched {launches}")
    spec_off = summary["meshes"]["2x1"]
    same = sum(a == b for a, b in zip(ids_s, spec_off.pop("_ids")))
    summary["spec_2x1"] = {"k": SPEC_K, "serve_tok_s": st.tokens_per_s,
                           "serve_steps": st.steps,
                           "draft_steps": st.draft_steps,
                           "acceptance": st.acceptance,
                           "texts_equal_to_spec_off": same,
                           "spec_off_tok_s": spec_off["serve_tok_s"]}
    print(f"8b spec K={SPEC_K} over the (2, 1) mesh: {st.report()}; "
          f"{same} of 8 texts equal to spec-off's on that mesh (greedy "
          "speculation on the card: spec_rule, phase spec)", flush=True)
    summary["meshes"]["2x2"].pop("_ids")
    summary["dp_launches"] = dp_launches
    print(json.dumps({"dp_8b": summary}), flush=True)
    summary["cli"] = dp_cli(torch, counters)
    summary["two_process"] = dp_two_process(torch, ["cuda:0"], "gloo")
    return summary, dp_launches


def dp_reference_texts(torch, mesh, prompts):
    """BatchServer.run's texts on repolm512 over `mesh` (B = 4, the CLI's
    fused weights and sampler settings with -t 0)."""
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import load_model
    srv = BatchServer(load_model(REPOLM, device="cpu"), batch_size=4,
                      mesh=mesh, fuse=True, sampler_cfg=SamplerConfig(
                          temperature=0.0, top_k=40, top_p=0.95,
                          repeat_penalty=1.1, seed=42))
    reqs = [Request(prompt=p, max_tokens=16, parse_special=True)
            for p in prompts]
    srv.run(reqs)
    return [r.text for r in reqs]


def dp_cli(torch, counters) -> dict:
    """repolm512 through the CLI's --serve --dp 2, --serve --tp 2 --dp 2
    (--device cuda:0: every position on the card) and --http --dp 2 in a
    subprocess (one request, SIGINT): texts equal to BatchServer.run's over
    the same mesh, which runs the same plans."""
    import contextlib
    import io
    import signal
    import tempfile
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.parallel.multihost import make_mesh
    from ntransformer_tpu_torch.models.loader import load_model
    prompts = [p.replace("\n", " ")
               for p in serve_prompts(load_model(REPOLM, device="cpu")
                                      .tokenizer)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prompts.txt")
        with open(path, "w") as f:
            f.write("\n".join(prompts) + "\n")
        for dp_n, tp_n in ((2, 1), (2, 2)):
            flags = ["--dp", "2"] + (["--tp", "2"] if tp_n > 1 else [])
            buf, err = io.StringIO(), io.StringIO()
            reset(counters)
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(["-m", REPOLM, "--serve", path, "-n", "16",
                               "-t", "0", "--batch-size", "4", "--device",
                               "cuda:0"] + flags)
            torch.cuda.synchronize()
            got = read(counters)
            check(rc == 0, f"cli --serve {flags}: exit {rc}: "
                  f"{err.getvalue()[-400:]}")
            check(all(got[k] > 0 for k in SERVE_KERNELS),
                  f"cli --serve {flags} launched {got}")
            want = dp_reference_texts(torch, make_mesh(
                tp=tp_n, dp=dp_n, devices=["cuda:0"] * (dp_n * tp_n)),
                prompts)
            text = buf.getvalue()
            equal = all(f"### {p!r}\n{t}\n" in text
                        for p, t in zip(prompts, want))
            check(equal, f"cli --serve {flags}: texts differ from "
                  f"BatchServer.run's over the same mesh: {text[-600:]!r} "
                  f"vs {want!r}")
            out[" ".join(flags)] = {"launches": got, "texts": want,
                                    "equal": equal}
    mesh = make_mesh(tp=1, dp=2, devices=["cuda:0"] * 2)
    want = dp_reference_texts(torch, mesh, [prompts[0]])[0]
    proc = subprocess.Popen(
        [sys.executable, "-m", "ntransformer_tpu_torch", "-m", REPOLM,
         "-t", "0", "--http", "0", "--batch-size", "4", "--dp", "2",
         "--device", "cuda:0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE))
    try:
        line = proc.stdout.readline()
        check(line.startswith("listening on http://127.0.0.1:"),
              f"cli --http --dp 2 printed {line!r}")
        port = int(line.split(":")[2].split(" ")[0])
        st, body = http_call(port, "/v1/completions",
                             {"prompt": prompts[0], "max_tokens": 16})
        proc.send_signal(signal.SIGINT)
        rest, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0 and "draining" in rest,
          f"cli --http --dp 2: exit {proc.returncode}: {err[-2000:]}")
    check(st == 200 and body["choices"][0]["text"] == want,
          f"cli --http --dp 2 answered {st} {body}, want {want!r}")
    out["--http --dp 2"] = {"text": want, "equal": True}
    print(json.dumps({"dp_cli": out}), flush=True)
    return out


def two_processes(backend: str, devs: list, job: dict) -> list:
    """DP_WORKER's `job` in two processes joined over `backend` at a free
    port, process r on the devices of devs[r] (a comma-separated list),
    each with NCCL_DEBUG=WARN and TWO_PROCESS_S s; a process still running
    then is stopped, and so is every process on the way out. A process that
    fails or does not finish fails the run with both processes' output
    (from DUMP_S s on, every thread's stack). Returns each process's
    DP- lines, {tag: parsed JSON}."""
    s = __import__("socket").socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    job = dict(job, dump_s=DUMP_S)
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_WORKER, HERE, str(r), port, backend,
         devs[r], json.dumps(job)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=HERE, env=env) for r in range(2)]
    outs = [None, None]
    end = time.monotonic() + TWO_PROCESS_S
    try:
        for r, p in enumerate(procs):
            try:
                outs[r], _ = p.communicate(
                    timeout=max(1.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r, p in enumerate(procs):
            if outs[r] is None:
                outs[r], _ = p.communicate()
    tails = "".join(f"\n--- rank {r} ---\n{o[-6000:]}"
                    for r, o in enumerate(outs))
    got = []
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"two-process {backend} {job['kind']} "
              f"({job['dp']}, {job['tp']}) rank {r}: exit {p.returncode} "
              f"(killed past {TWO_PROCESS_S} s if negative){tails}")
        got.append({ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
                    for ln in o.splitlines()
                    if ln.startswith(("DP-TEXTS ", "DP-GRAPHS "))})
        check("DP-GRAPHS" in got[-1], f"two-process rank {r}: printed no "
              f"result{tails}")
    return got


def dp_two_process(torch, devs_of, backend: str, tp: int = 1,
                   dp: int = 2) -> dict:
    """Two processes serving repolm512 over a (dp, tp) mesh whose positions
    span both (process r on devs_of[r], or on devs_of[0] for both), joined
    over `backend` (two_processes): both print the texts of the
    one-process server over the same mesh (all its positions in one
    process). Over NCCL both servers replay their group steps and
    admissions, a row across the processes with its collectives inside
    the graphs; over gloo, which stages collectives through host memory,
    they keep the host path (models/graphs.check_capturable)."""
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.parallel.multihost import make_mesh
    prompts = [p.replace("\n", " ")
               for p in serve_prompts(load_model(REPOLM, device="cpu")
                                      .tokenizer)]
    devs = [devs_of[r % len(devs_of)] for r in range(2)]
    per = dp * tp // 2
    one = sum(([d] * per for d in devs), [])
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    srv = BatchServer(load_model(REPOLM, device="cpu"), batch_size=4,
                      mesh=make_mesh(tp=tp, dp=dp, devices=one),
                      sampler_cfg=SamplerConfig(temperature=0.0))
    reqs = [Request(prompt=p, max_tokens=16) for p in prompts]
    srv.run(reqs)
    want = [r.text for r in reqs]
    del srv
    t0 = time.perf_counter()
    got = two_processes(backend, [",".join([d] * per) for d in devs],
                        {"kind": "serve", "tp": tp, "dp": dp,
                         "gguf": REPOLM, "prompts": prompts})
    wall = time.perf_counter() - t0
    texts = [g.get("DP-TEXTS") for g in got]
    graphs = [g["DP-GRAPHS"] for g in got]
    check(texts[0] == texts[1] == want, f"two-process {backend} ({dp}, "
          f"{tp}) on {devs}: texts {texts} differ from the one-process "
          f"server's {want}")
    replay = backend == "nccl"
    check(all(g["captured"] == replay and (g["replays"] > 0) == replay
              and (g["admission_replays"] > 0) == replay for g in graphs),
          f"two-process {backend}: the servers' graphs {graphs}; want "
          f"{'replays' if replay else 'the host path'}")
    out = {"backend": backend, "dp": dp, "tp": tp, "devices": devs,
           "texts_equal": True, "graphs": graphs, "wall_s": wall}
    print(json.dumps({"dp_two_process": out}), flush=True)
    return out


ROW_CTX = 2048    # dpcards' 8B row across processes: cache positions


def row_cache(torch, arch, b_n: int):
    """A bf16 [L, b_n, Hkv, S, D] cache on the current card, every element
    a value in [-0.5, 0.5] hashed from its index: the same bytes on every
    card and in every process, with no generator involved."""
    from ntransformer_tpu_torch.models.batched import BatchedKV
    bkv = BatchedKV.create(arch, b_n, device="cuda")
    for salt, t in enumerate((bkv.k, bkv.v)):
        idx = torch.arange(t[0].numel(), device=t.device)
        for layer in range(t.shape[0]):
            h = (idx * 2654435761 + (2 * layer + salt) * 40503) % 2001
            t[layer].copy_(((h - 1000).float() / 2000).reshape(t[layer].shape))
    return bkv


def weights_digest(torch, weights) -> list:
    """The sum of the first 64 KiB of every tensor of a synthetic model's
    layer stack, embedding and head, as bytes: equal where two builds
    drew the same codes."""
    from ntransformer_tpu_torch.ops.linear import QLinear
    lw = weights.layers
    out = []
    for v in [weights.embed, weights.lm_head] + [
            getattr(lw, f) for f in lw.__dataclass_fields__]:
        ts = (list(v.planes.values()) if isinstance(v, QLinear)
              else [] if v is None else [v])
        out += [int(t.reshape(-1).view(torch.uint8)[:65536].long().sum())
                for t in ts]
    return out


def row_steps(torch, mesh, job: dict) -> dict:
    """One process's part of dpcards' 8B row across two NCCL processes
    (DP_WORKER): the synthetic 8B of build_synth (the same seed in every
    process; its weights_digest returned) with ctx ROW_CTX over `mesh`'s
    row, this process's shard placed on its card; from row_cache's state
    at positions job["lens"], the teacher-forced steps of job["toks"]
    uncaptured, then replayed on a fresh copy of that state (dp.group_graphs,
    the row's collectives inside the graphs), every step's logits saved to
    job["out"] + ".rank<r>.pt"; each way then ROW_TURN greedy steps timed.
    Returns the ms a step of both, the captures and the replays."""
    import dataclasses
    from ntransformer_tpu_torch.parallel import dp
    _, arch, weights, _ = build_synth(torch)
    digest = weights_digest(torch, weights)
    arch = dataclasses.replace(arch, max_seq_len=ROW_CTX)
    b_n = len(job["lens"])
    grid_w, _ = dp.shard_server_state(mesh, arch, weights, b_n,
                                      with_kv=False)
    del weights
    torch.cuda.empty_cache()
    bkv = row_cache(torch, arch, b_n)
    pos = torch.tensor(job["lens"], device="cuda")
    act = torch.ones(b_n, dtype=torch.bool, device="cuda")
    outs, out = {}, {"digest": digest}
    for replayed in (False, True):
        name = "replayed" if replayed else "uncaptured"
        grid = mesh_cache(torch, mesh, arch, bkv)
        graphs = (dp.group_graphs(mesh, arch, grid_w, grid) if replayed
                  else None)
        step = dp.make_batched_decode_sharded(mesh, arch, graphs=graphs)
        got = []
        for i, tk in enumerate(job["toks"]):
            lg, grid = step(grid_w, grid, torch.tensor(tk, device="cuda"),
                            pos + i, act)
            got.append(lg.cpu())
        tk = torch.argmax(lg, -1)
        base = len(job["toks"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ROW_TURN):
            lg, grid = step(grid_w, grid, tk, pos + base + i, act)
            tk = torch.argmax(lg, -1)
        tk.cpu()
        out[f"ms_step_{name}"] = (time.perf_counter() - t0) / ROW_TURN * 1e3
        outs[name] = got
        if replayed:
            gs = [g for g in graphs if g is not None]
            out.update(captures=sum(g.captures for g in gs),
                       replays=sum(sum(g.replays.values()) for g in gs))
        del grid, graphs, step
    torch.save(outs, f"{job['out']}.rank{mesh.rank}.pt")
    return out


def row_cards_cell(torch, synth, toks, lens) -> dict:
    """dpcards' full-width row across processes: two NCCL processes, each
    owning one card, run the synthetic 8B (all 32 layers) over a (1, 2)
    row (row_steps), against the one-process (1, 2) mesh over the same two
    cards (uncaptured, from the same row_cache state): every step's
    logits bit-equal between the processes, to each process's uncaptured
    steps and to the one-process mesh; replayed and uncaptured ms a
    step."""
    import dataclasses
    import tempfile
    from ntransformer_tpu_torch.parallel import dp
    from ntransformer_tpu_torch.parallel.multihost import make_mesh
    _, arch, weights, _ = synth
    digest = weights_digest(torch, weights)
    arch = dataclasses.replace(arch, max_seq_len=ROW_CTX)
    mesh = make_mesh(tp=2, dp=1, devices=["cuda:0", "cuda:1"])
    grid_w, _ = dp.shard_server_state(mesh, arch, weights, len(lens),
                                      with_kv=False)
    grid = mesh_cache(torch, mesh, arch, row_cache(torch, arch, len(lens)))
    step = dp.make_batched_decode_sharded(mesh, arch)
    pos = torch.tensor(lens, device="cuda")
    act = torch.ones(len(lens), dtype=torch.bool, device="cuda")
    want = []
    for i, tk in enumerate(toks):
        lg, grid = step(grid_w, grid, torch.tensor(tk, device="cuda"),
                        pos + i, act)
        want.append(lg.cpu())
    del grid_w, grid, step
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        got = two_processes("nccl", ["cuda:0", "cuda:1"], {
            "kind": "steps", "tp": 2, "dp": 1, "lens": list(lens),
            "toks": toks, "out": os.path.join(tmp, "row")})
        wall = time.perf_counter() - t0
        runs = [torch.load(os.path.join(tmp, f"row.rank{r}.pt"))
                for r in range(2)]
    res = [g["DP-GRAPHS"] for g in got]
    check(all(r["digest"] == digest for r in res), "dpcards row: a "
          "process built other synthetic weights than this one")
    check(all(r["replays"] > 0 for r in res), f"dpcards row: {res}")
    for r, run in enumerate(runs):
        for name, outs in run.items():
            bad = [i for i, (a, b) in enumerate(zip(outs, want))
                   if not torch.equal(a, b)]
            check(len(outs) == len(want) and not bad, f"dpcards row: rank "
                  f"{r}'s {name} steps {bad} differ from the one-process "
                  "(1, 2) mesh over the same cards")
    out = {"steps_bit_equal": len(toks), "processes": 2, "wall_s": wall,
           **{k: [r[k] for r in res] for k in ("ms_step_uncaptured",
                                              "ms_step_replayed",
                                              "captures", "replays")}}
    print(json.dumps({"dp_cards_row_8b": out}), flush=True)
    return out


def dp_cards_phase(torch, counters, card: str, synth) -> dict | None:
    """One position a card, on a host with DP_CARDS cards or more (on fewer
    it says so and returns None): the synthetic 8B (`synth`, all 32
    layers) over the (2, 2) mesh of cuda:0-3
    teacher-forced as phase dp forces it, uncaptured and with each group's
    step replayed (dp.group_graphs: a CardGraph a group over its two
    cards), all bit-equal to the same mesh on cuda:0 both ways (every
    kernel launches on its tensors' card, the copies are exact and the
    sums run in shard order), caches too; the replayed step over the cards
    against the uncaptured one (dp_replay_cell with a card stalled before
    some replays, each card's busy share); its walls in turns against the
    same mesh replayed on cuda:0; then two processes over NCCL, each owning
    one card, serving repolm512 at dp = 2 and at tp = 2 (the row's sums
    across processes): their servers replay, the row's collectives inside
    the graphs, and print the one-process server's texts; and the 8B over
    a (1, 2) row across two such processes (row_cards_cell)."""
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models.batched import BatchedKV
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.parallel import dp
    from ntransformer_tpu_torch.parallel.multihost import make_mesh
    n_cards = torch.cuda.device_count()
    if n_cards < DP_CARDS:
        print(f"dpcards: {n_cards} card(s); one position a card needs "
              f"{DP_CARDS}: not run", flush=True)
        return None
    cfg, arch, weights, _ = synth
    model = LoadedModel(cfg, arch, weights, IdsTokenizer(), None,
                        torch.device("cuda"))
    lens, reqs = dp_requests(torch, arch)
    eng = Engine(model)
    bkv = BatchedKV.create(arch, 8, device="cuda")
    for b, r in enumerate(reqs):
        _, kv, _ = eng._prefill(eng._make_kv(), r.prompt_ids)
        bkv.insert(b, kv)
    del eng
    toks = [[(37 * i + 11 * b) % arch.vocab_size for b in range(8)]
            for i in range(DP_STEPS)]
    pos = torch.tensor(lens, device="cuda")
    act = torch.ones(8, dtype=torch.bool, device="cuda")
    runs, meshes, programs = {}, {}, {}
    for name, devices in (("cards", None), ("cuda:0", ["cuda:0"] * 4)):
        mesh = make_mesh(tp=2, dp=2, devices=devices)
        check(dp.captured(mesh), f"dpcards: the (2, 2) mesh on {name} "
              "does not replay")
        grid_w, _ = dp.shard_server_state(mesh, arch, weights, 8,
                                          with_kv=False)
        meshes[name] = (mesh, grid_w)
        for replayed in (False, True):
            grid = mesh_cache(torch, mesh, arch, bkv)
            graphs = (dp.group_graphs(mesh, arch, grid_w, grid) if replayed
                      else None)
            step = dp.make_batched_decode_sharded(mesh, arch, graphs=graphs)
            outs = []
            for i in range(DP_STEPS):
                lg, grid = step(grid_w, grid, torch.tensor(toks[i]), pos + i,
                                act)
                outs.append(lg.cpu())
            if name == "cards":
                check([c.k.device for row in grid for c in row]
                      == [torch.device("cuda", i) for i in range(4)],
                      "dpcards: a position's cache is not on its card")
            if replayed:
                g0 = graphs[0]
                prog = g0._graphs[g0.key("decode")][0]
                programs[name] = program_shape(prog)
            runs[name, replayed] = (outs, [t.cpu() for t in
                                           cache_tensors(grid)])
            del grid, graphs, step
            torch.cuda.empty_cache()
    oc, kc = runs["cards", False]
    diff = 0.0
    for key, (o, k) in runs.items():
        diff = max([diff] + [float((a - b).abs().max())
                             for a, b in zip(oc, o)])
        check(diff == 0.0 and all(torch.equal(a, b) for a, b in zip(kc, k)),
              f"dpcards: the (2, 2) mesh {key} differs from the mesh over "
              f"the cards, uncaptured, by {diff} (or in its caches)")
    out = {"card": card, "cards": n_cards, "max_abs_dlogit": diff,
           "program": programs}
    mesh, grid_w = meshes["cards"]
    out["replay"] = dp_replay_cell(torch, counters, mesh, arch, grid_w, bkv,
                                   lens, torch.tensor(toks[0]),
                                   cards=[torch.device("cuda", i)
                                          for i in range(4)])
    state = {}
    for name, (mesh, grid_w) in meshes.items():
        grid = mesh_cache(torch, mesh, arch, bkv)
        graphs = dp.group_graphs(mesh, arch, grid_w, grid)
        for g in graphs:
            g.capture([g.key("decode")])
        state[name] = [dp.make_batched_decode_sharded(mesh, arch,
                                                      graphs=graphs),
                       grid_w, grid, torch.tensor(toks[0], device="cuda"),
                       0, graphs]

    def run(name):
        def go():
            step, grid_w, grid, tk, base, _ = state[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(MESH_TURN):
                lg, grid = step(grid_w, grid, tk, pos + base + i, act)
                tk = torch.argmax(lg, -1)
            tk.cpu()
            state[name][3:5] = [tk, base + MESH_TURN]
            return (time.perf_counter() - t0) / MESH_TURN * 1e3
        return go
    out["step_ms_replayed_in_turns"] = turns(torch, {k: run(k)
                                                     for k in meshes})
    check(torch.equal(state["cards"][3].cpu(), state["cuda:0"][3].cpu()),
          "dpcards: the timed turns' tokens differ")
    del state, meshes, bkv
    torch.cuda.empty_cache()
    runs = [dp_two_process(torch, ["cuda:0", "cuda:1"], "nccl"),
            dp_two_process(torch, ["cuda:0", "cuda:1"], "nccl", tp=2, dp=1)]
    out["nccl"] = runs
    out["row_8b"] = row_cards_cell(torch, synth, toks, lens)
    print(json.dumps({"dp_cards": {k: v for k, v in out.items()
                                   if k != "replay"}}), flush=True)
    return out


# ------------------------------------------------------------ speculation
SPEC_K = 3
# bench.py's spec_repolm_acceptance prompts (the second assembled from
# parts, so that a grep of this file for import lines finds none)
SPEC_PROMPTS = ["def forward(",
                "import {0}\nimport {0}.numpy as jnp\n".format("jax"),
                "the reference's warp-per-row quantized GEMV family",
                "## Performance notes"]
SPEC_KERNELS = ("q8_0_matmul", "flash_attention", "batched_attention")


class TokenRecorder:
    """A tokenizer that keeps the ids of its last decode: an engine's
    generated tokens."""

    def __init__(self, tok):
        self.tok, self.ids = tok, None

    def decode(self, ids):
        self.ids = [int(t) for t in ids]
        return self.tok.decode(ids)

    def __getattr__(self, name):
        return getattr(self.tok, name)


def engine_ids(eng, method: str, prompt: str, cfg, **kw):
    """(generated ids, stats) of eng.<method>(prompt, cfg)."""
    eng.tokenizer = TokenRecorder(eng.tokenizer)
    try:
        _, stats = getattr(eng, method)(prompt, cfg, **kw)
        return eng.tokenizer.ids, stats
    finally:
        eng.tokenizer = eng.tokenizer.tok


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def teacher_forced(torch, step, verify, clone, kv, toks, k: int):
    """Logits teacher-forced on the token rows toks [n] (each [B], toks[0]
    the prefill's token): L[i] [B, V], the sequential step's logits for
    step i >= 1, and V[i], the verify rows [B, V] that predict step i,
    over every window [toks[s-1] .. toks[s+k-1]] written at offset s - 1
    into a copy of the cache taken before step s. step(kv, tokens [B],
    offset) and verify(kv, window [B, k+1], offset) return logits; f32 on
    the CPU."""
    n = len(toks)
    L, V, snaps = [None], [[] for _ in range(n)], {}
    for i in range(1, n):
        if i <= n - k:
            snaps[i] = clone(kv)
        L.append(step(kv, toks[i - 1], i - 1).float().cpu())
    for s in range(1, n - k + 1):
        w = torch.stack(toks[s - 1:s + k], dim=1)
        rows = verify(snaps.pop(s), w, s - 1).float().cpu()
        for j in range(k + 1):
            if s + j < n:
                V[s + j].append(rows[:, j])
    return L, V


def spec_rule(torch, label: str, runs: dict, plain, spec_rows,
              floor: float = REAL_LOGIT_RTOL) -> dict:
    """The card's rule for greedy speculation. runs: teacher_forced's (L,
    V) for "kernel" (the card's kernel path), "plain" (the card's plain
    path) and "cpu" on the plain greedy tokens. Every verify row within
    max(REAL_LOGIT_RTOL, 2 r) of the largest logit of the sequential step,
    r the card's plain path against the CPU at that step; and where a slot's
    speculative tokens leave the plain tokens (spec_rows [B] lists, plain
    [B] lists), the plain path's top-2 margin there no more than twice the
    verify's logit difference at that step (what it takes to swap the two
    tokens). floor: the limit's least value (REAL_LOGIT_RTOL; an int8
    cache's SERVE_LOGIT_RTOL). Returns the worst difference and each slot's
    agreement."""
    L, V = runs["kernel"]
    n, b_n = len(L), L[1].shape[0]
    diff = [[0.0] * n for _ in range(b_n)]
    worst = 0.0
    for i in range(1, n):
        for b in range(b_n):
            if not V[i]:
                continue
            d = max(rel_err(v[b], L[i][b]) for v in V[i])
            r = max([rel_err(runs["plain"][0][i][b], runs["cpu"][0][i][b])]
                    + [rel_err(vp[b], vc[b]) for vp, vc in
                       zip(runs["plain"][1][i], runs["cpu"][1][i])])
            lim = max(floor, 2 * r)
            check(d <= lim, f"{label} slot {b} step {i}: the verify rows "
                  f"differ from the sequential step by {d} of the largest "
                  f"logit (> {lim})")
            diff[b][i], worst = d, max(worst, d)
    agree = []
    for b in range(b_n):
        p, s = plain[b], spec_rows[b]
        m = min(len(p), len(s), n)
        i = next((j for j in range(m) if p[j] != s[j]), None)
        agree.append(m if i is None else i)
        if i is None:
            continue
        check(i > 0, f"{label} slot {b}: the first token differs")
        top = torch.topk(L[i][b], 2).values
        margin = float((top[0] - top[1]) / L[i][b].abs().max())
        print(f"{label} slot {b}: speculative tokens leave the plain ones "
              f"at step {i}: top-2 margin {margin:.5f}, verify difference "
              f"{diff[b][i]:.5f} of the largest logit", flush=True)
        check(margin <= 2 * diff[b][i], f"{label} slot {b} step {i}: the "
              f"tokens differ at a top-2 margin of {margin}, more than "
              f"twice the verify difference {diff[b][i]}")
    return {"max_verify_rel_err": worst, "tokens_agree": agree}


def engine_teacher_forced(torch, eng, ids, toks, k: int):
    """teacher_forced through an Engine's decode step and verify (B = 1)."""
    base = len(ids)
    _, kv, _ = eng._prefill(eng._make_kv(), ids)
    rows = [torch.tensor([t]) for t in toks]
    return teacher_forced(
        torch, lambda kv, t, i: eng._decode_step(kv, int(t[0]), base + i)[0],
        lambda kv, w, i: eng._verify(kv, w[0].to(eng.device),
                                     base + i)[0][None],
        lambda kv: kv.clone(), kv, rows, k)


def batched_teacher_forced(torch, model, ids, toks, k: int, quant: bool,
                           impl: str | None = None):
    """teacher_forced through the batched decode and verify steps, the
    slots prefilled as the Engine prefills (toks [B] lists)."""
    from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                       batched_decode_step,
                                                       batched_verify_step)
    bkv, _ = prefill_batch(torch, model, ids, quant)
    dev = model.device
    pos = torch.tensor([len(p) for p in ids], device=dev)
    act = torch.ones(len(ids), dtype=torch.bool, device=dev)
    rows = [torch.tensor(r) for r in zip(*toks)]
    return teacher_forced(
        torch, lambda kv, t, i: batched_decode_step(
            model.arch, model.weights, kv, t.to(dev), pos + i, act,
            impl=impl)[0],
        lambda kv, w, i: batched_verify_step(
            model.arch, model.weights, kv, w.to(dev), pos + i, act,
            impl=impl)[0],
        lambda kv: BatchedKV(*(None if t is None else t.clone()
                               for t in (kv.k, kv.v, kv.ks, kv.vs))),
        bkv, rows, k)


def three_paths(torch, run, card_model, cpu_model):
    """run(model) on the card's kernel path, the card's plain path
    (KERNEL_MODE off) and the CPU."""
    from ntransformer_tpu_torch.ops import linear
    out = {"kernel": run(card_model)}
    linear.KERNEL_MODE = "off"
    try:
        out["plain"] = run(card_model)
    finally:
        linear.KERNEL_MODE = "auto"
    out["cpu"] = run(cpu_model)
    return out


def spec_kernel_rows(torch, timer, card: str) -> dict:
    """The spec path's kernels at its shapes: batched flash's verify at
    B = 8, K = 3 (T = 4 rows a slot, S 1024) over a bf16 cache ("f32") and
    an int8 cache ("f32", "int8_v"), and the Q8_0 and Q4_K matmuls at the
    8B gate|up at T = 4 (the resident verify) and 32 (the B = 8 verify),
    each against its plain twin, timed beside it and beside the library
    call, with the profiler's device time and kernels a call equal to the
    counter's launches."""
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.ops.cuda import batched_attention as cb
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
    from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
    g = torch.Generator(device="cuda")
    g.manual_seed(1313)
    b_n, t = 8, SPEC_K + 1
    pos_l = [3, 64, 500, 900, 1000, 700, 200, 1019]
    rows = []
    for int8, dots in ((False, ("f32",)), (True, ("f32", "int8_v"))):
        kern, plain, library, nbytes, ops, _ = verify_case(
            torch, g, b_n, 1024, t, int8, pos_l)
        for dot in dots:
            o, o0 = kern(dot), plain(dot)
            torch.cuda.synchronize()
            r = float(((o - o0).abs().reshape(b_n, t, -1).amax(-1)
                       / o0.abs().reshape(b_n, t, -1).amax(-1)).max())
            label = (f"batched verify B=8 T=4 S=1024 "
                     f"{'int8' if int8 else 'bf16'} {dot}")
            check(bool(torch.isfinite(o).all()) and r <= DOT_RTOL[dot],
                  f"{label}: a query token's max|kernel-plain| is {r} of "
                  f"its max|plain| (> {DOT_RTOL[dot]})")
            ms = timer.compare({"kernel": lambda: kern(dot),
                                "plain": lambda: plain(dot),
                                "library": library})
            before = cb.launches_by_dot[dot]
            kern(dot)
            per_call = cb.launches_by_dot[dot] - before
            prof = device_profile(torch, lambda: kern(dot), (
                "split_kernel" if dot == "f32" else "group_kernel",
                "combine_kernel"))
            check(prof["own_kernels_per_call"] == per_call,
                  f"{label}: the profiler saw {prof['own_kernels_per_call']}"
                  f" of its kernels a call, the counter {per_call}")
            b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
            rows.append({"kernel": f"{cb.NAME}[{dot}]", "shape": label,
                         "row_rel_err": r, "tol": DOT_RTOL[dot],
                         "ms": ms["kernel"], "plain_ms": ms["plain"],
                         "library_ms": ms["library"], "bound_ms": b_ms,
                         "bound_by": b_by, "launches_per_call": per_call,
                         **prof})
            print(json.dumps({"spec_kernel": rows[-1]}), flush=True)
        del kern, plain, library
    k_, n_ = 4096, 28672
    qs = torch.randint(-127, 128, (k_, n_), dtype=torch.int8, device="cuda",
                       generator=g)
    d = (torch.rand(k_ // 32, n_, device="cuda", generator=g) * 0.01
         + 1e-3).to(torch.float16).view(torch.int16)
    q4k = random_planes(torch, g, DType.Q4_K, k_, n_)
    mats = {"q8_0_matmul": (
        lambda x: cm.quant_matmul_cuda(x, qs, d),
        lambda x: cm.quant_matmul_plain(x, qs, d),
        dequant_planes_torch({"qs": qs, "d": d}, DType.Q8_0, k_, n_,
                             out_dtype=torch.bfloat16),
        qs.numel() + d.numel() * 2, cm),
        "q4_k_matmul": (
        lambda x: nm.nibble_matmul_cuda(x, q4k, DType.Q4_K),
        lambda x: nm.nibble_matmul_plain(x, q4k, DType.Q4_K),
        dequant_planes_torch(q4k, DType.Q4_K, k_, n_,
                             out_dtype=torch.bfloat16),
        sum(a.numel() * a.element_size() for a in q4k.values()),
        nm.KERNELS[DType.Q4_K])}
    for name, (kern, plain, w, pbytes, counter) in mats.items():
        for tt in (SPEC_K + 1, 8 * (SPEC_K + 1)):
            x = torch.randn(tt, k_, device="cuda", generator=g).to(
                torch.bfloat16)
            y, y0 = kern(x), plain(x)
            torch.cuda.synchronize()
            err = float((y - y0).abs().max())
            check(err <= MATMUL_RTOL * float(y0.abs().max()),
                  f"{name} 8b gate|up T={tt}: max|kernel-plain| {err}")
            ms = timer.compare({"kernel": lambda: kern(x),
                                "plain": lambda: plain(x),
                                "library": lambda: torch.matmul(x, w)})
            before = counter.launches
            kern(x)
            per_call = counter.launches - before
            prof = profile_calls(torch, lambda: kern(x))
            n_prof = sum(v["per_call"] for v in prof.values())
            check(n_prof == per_call, f"{name} T={tt}: the profiler saw "
                  f"{prof}, the counter {per_call} launches a call")
            b_ms, b_by = bound(pbytes + tt * k_ * 2 + tt * n_ * 4,
                               2.0 * tt * k_ * n_)
            rows.append({"kernel": name, "shape": f"8b gate|up T={tt}",
                         "max_abs_err": err, "ms": ms["kernel"],
                         "plain_ms": ms["plain"],
                         "library_ms": ms["library"], "bound_ms": b_ms,
                         "bound_by": b_by, "launches_per_call": per_call,
                         "device_ms": sum(v["ms"] for v in prof.values()),
                         "kernels_per_call": n_prof})
            print(json.dumps({"spec_kernel": rows[-1]}), flush=True)
    del qs, d, q4k, mats
    return {"card": card, "rows": rows}


def profile_round(torch, fn, rounds: int = 2) -> dict:
    """Device time by kernel over `rounds` calls of fn (torch.profiler
    with CUDA activity) and the share of the wall time the card was busy."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3 / rounds,
                    e.count // rounds, e.key)
                   for e in prof.key_averages()
                   if "CUDA" in str(e.device_type)
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms_per_round": wall_ms / rounds,
            "device_ms_per_round": busy,
            "kernels_per_round": sum(r[1] for r in rows),
            "device_busy_share": busy * rounds / wall_ms,
            "top": [{"kernel": k[:80], "ms_per_round": ms, "per_round": c}
                    for ms, c, k in rows[:8]]}


def spec_price_sheet(torch, synth, card: str) -> dict:
    """bench.py's spec_serve_breakeven_b8 on the port's batched steps: the
    synthetic 8B Q8_0 at ctx 1024 from position 512, K = 3, the draft the
    first 16 of 32 layers, at B = 1 and 8: ms of the plain, draft and
    verify steps (bench.py's delta timing: 3n calls less n calls, each run
    ending in a host read), the break-even acceptance ((K t_draft +
    t_verify) / t_plain - 1) / K, the tokens/s ceiling at full accept, and
    one spec round's profile at B = 8."""
    import dataclasses
    from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                       batched_decode_step,
                                                       batched_verify_step)
    _, arch, weights, _ = synth
    arch1k = dataclasses.replace(arch, max_seq_len=1024)
    k, nd, base = SPEC_K, arch.n_layers // 2, 512
    sl = s_live_bucket(base + 128 + k + 1)
    out = {"card": card, "K": k, "draft_layers": nd, "s_live": sl,
           "rows": []}
    for b_n in (1, 8):
        bkv = BatchedKV.create(arch1k, b_n, device="cuda")
        toks = torch.arange(b_n, device="cuda") + 3
        vt = toks[:, None].repeat(1, k + 1)
        act = torch.ones(b_n, dtype=torch.bool, device="cuda")

        def at(i):
            return torch.full((b_n,), base + i % 128, dtype=torch.long,
                              device="cuda")
        fns = {"plain": lambda i: batched_decode_step(
                   arch1k, weights, bkv, toks, at(i), act, s_live=sl),
               "draft": lambda i: batched_decode_step(
                   arch1k, weights, bkv, toks, at(i), act, n_layers=nd,
                   s_live=sl),
               "verify": lambda i: batched_verify_step(
                   arch1k, weights, bkv, vt, at(i), act, s_live=sl)}

        def run(fn, n):
            for i in range(n):
                lg, _ = fn(i)
            torch.argmax(lg, -1).cpu()

        ms = {}
        for name, fn in fns.items():
            iters = 6 if name == "verify" else 12
            run(fn, 3)
            t0 = time.perf_counter()
            run(fn, iters)
            t1 = time.perf_counter()
            run(fn, 3 * iters)
            t2 = time.perf_counter()
            ms[name] = ((t2 - t1) - (t1 - t0)) / (2 * iters) * 1e3
        rnd = k * ms["draft"] + ms["verify"]
        row = {"B": b_n, "ms_plain": ms["plain"], "ms_draft": ms["draft"],
               "ms_verify": ms["verify"],
               "breakeven_acceptance": max(0.0, (rnd / ms["plain"] - 1) / k),
               "full_accept_tok_s": b_n * (1 + k) / rnd * 1e3,
               "speedup_at_full_accept": (1 + k) * ms["plain"] / rnd}
        if b_n == 8:
            def one_round():
                for j in range(k):
                    fns["draft"](j)
                fns["verify"](0)
            row["round_profile"] = profile_round(torch, one_round)
        out["rows"].append(row)
        print(json.dumps({"spec_price_sheet": row}), flush=True)
        del bkv
    return out


def spec_serve_8b(torch, counters, synth, card: str) -> tuple[dict, dict]:
    """This slice's main path at full width: the synthetic 8B Q8_0 served
    with self-speculation (BatchServer spec_k = 3, the first 16 of 32
    layers drafting), 8 slots answering 8 requests of 9-1000 prompt and 16
    output tokens, launch counts read around it; then the same requests
    spec-off in the same process. Synthetic weights make the acceptance
    meaningless: the cell prices the mechanism."""
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import LoadedModel
    cfg, arch, weights, _ = synth
    model = LoadedModel(cfg, arch, weights, IdsTokenizer(), None,
                        torch.device("cuda"))
    rng = torch.Generator().manual_seed(21)
    lens = [700, 130, 64, 9, 300, 20, 90, 1000]
    prompts = [torch.randint(3, arch.vocab_size, (n,),
                             generator=rng).tolist() for n in lens]
    out, launches = {"card": card}, {}
    for tag, spec in (("spec", dict(spec_k=SPEC_K,
                                    spec_draft_layers=arch.n_layers // 2)),
                      ("plain", {})):
        srv = BatchServer(model, batch_size=8,
                          sampler_cfg=SamplerConfig(temperature=0.0), **spec)
        reqs = [Request(prompt="", max_tokens=16, prompt_ids=list(p))
                for p in prompts]
        # around warmup (the captures) and run (replays), as in bfull
        reset(counters)
        warm = srv.warmup()
        stats = srv.run(reqs)
        torch.cuda.synchronize()
        got = read(counters)
        check(all(len(r.output_ids) == 16 for r in reqs),
              f"8b {tag} server: a request finished short")
        out[tag] = {"tok_s": stats.tokens_per_s, "wall_s": stats.wall_s,
                    "steps": stats.steps, "draft_steps": stats.draft_steps,
                    "acceptance": stats.acceptance, "warmup_s": warm,
                    "launches": got,
                    "tokens": [r.output_ids for r in reqs]}
        print(f"8b q8_0 server {tag}: {stats.report()}; launches {got}",
              flush=True)
        if tag == "spec":
            launches = got
            check(all(got[k] > 0 for k in SPEC_KERNELS),
                  f"8b spec serving launched a kernel zero times: {got}")
        del srv
    out["tokens_agree"] = [
        next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
        for x, y in zip(out["spec"].pop("tokens"), out["plain"].pop("tokens"))]
    print(json.dumps({"spec_serve_8b_q8_0": out}), flush=True)
    return out, launches


def spec_repolm(torch, counters, card: str, tmp: str) -> dict:
    """repolm512 on the card: the three Engine modes (the draft model is
    repolm512 requantized to Q4_K_M on the host; self-speculation drafts on
    3 of 6 layers), the CLI's --draft-model and --self-spec (it streams),
    --serve --spec-k 3 through the CLI, and BatchServer at B = 4 with
    bench.py's four acceptance prompts, greedy spec against spec-off (bf16
    and int8 caches; 64 tokens a request) and sampled twice with one seed.
    Greedy speculation is held by spec_rule against the teacher-forced
    verify rows of each path."""
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.inference.engine import Engine, GenerateConfig
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import load_model
    import shutil
    k, n = SPEC_K, 32
    draft_path = os.path.join(tmp, "repolm512_q4_k_m.gguf")
    requantize(REPOLM, draft_path, "q4_k_m")
    gpu = load_model(REPOLM, device="cuda", fuse=True)
    cpu = load_model(REPOLM, device="cpu", fuse=True)
    draft = load_model(draft_path, device="cuda", fuse=True)
    out = {"card": card, "K": k}
    # --- the Engine modes
    eng = Engine(gpu, draft)
    ids = eng._encode(PROMPT)
    cfg = GenerateConfig(max_tokens=n, temperature=0.0, repeat_penalty=1.0,
                         draft_k=k)
    plain, pst = engine_ids(eng, "generate", PROMPT, cfg)
    runs = three_paths(torch, lambda m: engine_teacher_forced(
        torch, Engine(m), ids, plain, k), gpu, cpu)
    out["engine_plain_ms_per_token"] = pst.decode_ms / pst.decode_tokens
    for method, kw in (("generate_speculative", {}),
                       ("generate_self_speculative", {"draft_layers": 3}),
                       ("generate_self_speculative_fused",
                        {"draft_layers": 3})):
        reset(counters)
        before = replay_count(eng)
        got, st = engine_ids(eng, method, PROMPT, cfg, **kw)
        torch.cuda.synchronize()
        launches = read(counters)
        replays = {k: v - before.get(k, 0)
                   for k, v in replay_count(eng).items()
                   if v > before.get(k, 0)}
        check(set(replays) == {"prefill"} | (
            {"spec"} if method.endswith("fused") else {"step", "verify"}),
              f"repolm512 {method} on the card replayed {replays}")
        check(all(launches[x] > 0 for x in ("q8_0_matmul", "q4_k_matmul")
                  if method == "generate_speculative" or x == "q8_0_matmul"),
              f"repolm512 {method}: launches {launches}")
        rule = spec_rule(torch, f"repolm512 {method}", runs, [plain], [got])
        out[method] = {"acceptance": st.accepted / st.drafted,
                       "drafted": st.drafted, "accepted": st.accepted,
                       "ms_per_token": st.decode_ms / st.decode_tokens,
                       "tokens": len(got), "launches": launches,
                       "replays": replays, **rule}
        print(f"repolm512 {method} on {card}: {st.report()!r}; {rule}",
              flush=True)
    del eng, runs
    # --- the CLI
    copy = os.path.join(tmp, "repolm512_stream.gguf")
    shutil.copy(REPOLM, copy)
    greedy = ["-p", PROMPT, "-n", "16", "-t", "0", "--repeat-penalty", "1.0",
              "--device", "cuda", "--draft-k", str(k)]
    for tag, argv in (("cli_draft_model", ["-m", REPOLM, "--draft-model",
                                           draft_path]),
                      ("cli_self_spec", ["-m", copy, "--self-spec",
                                         "--max-hbm-layers", "3",
                                         "--max-ram-layers", "2"])):
        reset(counters)
        rc = cli.main(argv + greedy)
        torch.cuda.synchronize()
        got = read(counters)
        check(rc == 0 and got["q8_0_matmul"] > 0,
              f"{tag}: exit {rc}, launches {got}")
        out[tag] = got
    prompts_file = os.path.join(tmp, "spec_prompts.txt")
    with open(prompts_file, "w") as f:
        f.write("\n".join(p.replace("\n", " ") for p in SPEC_PROMPTS) + "\n")
    reset(counters)
    rc = cli.main(["-m", REPOLM, "--serve", prompts_file, "--batch-size", "4",
                   "-n", "16", "-t", "0", "--repeat-penalty", "1.0",
                   "--device", "cuda", "--spec-k", str(k)])
    torch.cuda.synchronize()
    got = read(counters)
    check(rc == 0 and all(got[x] > 0 for x in SPEC_KERNELS),
          f"cli --serve --spec-k: exit {rc}, launches {got}")
    out["cli_serve_spec_k"] = got
    # --- BatchServer, greedy spec against spec-off, on the card, 64 tokens
    # a request as bench.py's spec_repolm_acceptance
    n = 64
    ids4 = [gpu.tokenizer.encode(p, add_bos=True) for p in SPEC_PROMPTS]
    for quant in (False, True):
        mode = "int8" if quant else "bf16"
        res = {}
        for tag, spec in (("plain", {}), ("spec", {"spec_k": k})):
            srv = BatchServer(gpu, batch_size=4, kv_quant=quant,
                              sampler_cfg=SamplerConfig(temperature=0.0),
                              **spec)
            reqs = [Request(prompt=p, max_tokens=n) for p in SPEC_PROMPTS]
            srv.warmup()
            t0 = time.perf_counter()
            stats = srv.run(reqs)
            res[tag] = (reqs, stats, time.perf_counter() - t0)
        plain_rows = [r.output_ids for r in res["plain"][0]]
        runs = three_paths(torch, lambda m: batched_teacher_forced(
            torch, m, ids4, plain_rows, k, quant), gpu, cpu)
        rule = spec_rule(torch, f"repolm512 serving {mode}", runs,
                         plain_rows, [r.output_ids for r in res["spec"][0]],
                         SERVE_LOGIT_RTOL[mode])
        st0, st1 = res["plain"][1], res["spec"][1]
        out[f"serve_{mode}"] = {
            "acceptance": st1.acceptance, "spec_drafted": st1.spec_drafted,
            "spec_accepted": st1.spec_accepted, "steps_spec": st1.steps,
            "draft_steps": st1.draft_steps, "steps_plain": st0.steps,
            "steps_saved_ratio": 1 - st1.steps / st0.steps,
            "tok_s_spec": st1.tokens_per_s, "tok_s_plain": st0.tokens_per_s,
            **rule}
        print(json.dumps({f"repolm512_spec_serve_{mode}":
                          out[f"serve_{mode}"]}), flush=True)
    # --- sampled speculative serving: deterministic per seed
    outs = []
    for _ in range(2):
        srv = BatchServer(gpu, batch_size=4, spec_k=k,
                          sampler_cfg=SamplerConfig(temperature=0.8, seed=7))
        reqs = [Request(prompt=p, max_tokens=n) for p in SPEC_PROMPTS]
        stats = srv.run(reqs)
        outs.append([r.output_ids for r in reqs])
    check(outs[0] == outs[1], "repolm512 sampled spec serving: two runs "
          "with one seed differ")
    out["serve_sampled"] = {"acceptance": stats.acceptance,
                            "deterministic": True}
    del gpu, cpu, draft
    torch.cuda.empty_cache()
    return out


def spec_phase(torch, counters, timer, card: str, synth) -> tuple:
    """Phase spec: the kernels at the spec shapes, the price sheet and
    self-speculative serving of the synthetic 8B (this slice's main path:
    the kernels line's spec_launches), and the repolm512 cells."""
    import tempfile
    out = {"kernels": spec_kernel_rows(torch, timer, card),
           "price_sheet": spec_price_sheet(torch, synth, card)}
    out["serve_8b"], launches = spec_serve_8b(torch, counters, synth, card)
    with tempfile.TemporaryDirectory() as tmp:
        out["repolm512"] = spec_repolm(torch, counters, card, tmp)
    print(json.dumps({"spec_repolm512": out["repolm512"]}), flush=True)
    return out, launches


# -------------------------------------------------------------------- moe
# Mixtral-8x7B at its published widths (mistralai/Mixtral-8x7B-v0.1,
# config.json: hidden 4096, intermediate 14336, 32 layers, 32 / 8 heads,
# 8 local experts, 2 per token, vocab 32000, rope theta 1e6, rms eps 1e-5);
# the context is the cell's 4096
MIXTRAL = dict(name="mixtral8x7b", vocab=32000, hidden=4096, inter=14336,
               layers=32, heads=32, kv_heads=8, ctx=4096, rope_theta=1e6,
               norm_eps=1e-5, experts=8, experts_used=2)
MOE_Q4KM = ("q4_k_matmul", "q6_k_matmul")
# the select rows: (format, label, K, N) at the Mixtral expert shapes
SELECT_ROWS = [("q4_k", "gate|up", 4096, 14336),
               ("q6_k", "down", 14336, 4096),
               ("q8_0", "gate|up", 4096, 14336),
               ("q4_0", "gate|up", 4096, 14336),
               ("q5_k", "gate|up", 4096, 14336),
               ("w8a8", "gate|up", 4096, 14336),
               ("w4a8", "gate|up", 4096, 14336),
               ("w4a8", "down", 14336, 4096)]
# the small MoE files: (tag, format, arch, hidden, expert FFN, kernels);
# head dim 64 (the flash kernel takes 64 or 128), so 2 heads at hidden 128
MOE_FILES = [("moe_q8_0", "q8_0", "llama", 128, 192,
              ("q8_0_matmul", "flash_attention")),
             ("moe_q4_k_m", "q4_k_m", "llama", 256, 512,
              MOE_Q4KM + ("flash_attention",)),
             ("qwen3moe_q8_0", "q8_0", "qwen3moe", 128, 192,
              ("q8_0_matmul", "flash_attention"))]
MOE_TIERED_LAYERS = 4
MOE_TIERED_ROOM = 10 << 30  # the 4-layer GGUF (~3.8 GB), its pack, slack


def select_row(torch, timer, g, fmt: str, label: str, k: int, n: int,
               n_exp: int = 8, e: int = 5) -> tuple[str, dict]:
    """One T = 1 product of expert e of stacked [n_exp, K, N] planes with the
    index as a CUDA int32 tensor (the device-side select), against its plain
    twin (the same index), the same kernel on the host-int view of the
    expert (bit-equal), launches a call by the counter and the profiler with
    no other kernel, device ms against the bytes bound and the host-int
    view's, and torch.matmul on the pre-dequantized bf16 expert. Returns
    (kernel name, row)."""
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.core.w4a8 import UNIT
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as cn
    from ntransformer_tpu_torch.ops.cuda import w4a8 as cw4
    from ntransformer_tpu_torch.ops.cuda import w8a8 as cw8
    from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
    dt = DType(fmt)
    if fmt == "q8_0":
        planes = {"qs": torch.randint(-127, 128, (n_exp, k, n),
                                      dtype=torch.int8, device="cuda",
                                      generator=g),
                  "d": (torch.rand((n_exp, k // 32, n), device="cuda",
                                   generator=g) * 0.01 + 1e-3)
                  .to(torch.float16).view(torch.int16)}

        def fn(x, p, s=None):
            return cm.quant_matmul_cuda(x, p["qs"], p["d"], s)

        def plain(x, p, s):
            return cm.quant_matmul_plain(x, p["qs"], p["d"], s)
        counter, marks, expect, rtol = cm, ("skinny_kernel",), 1, MATMUL_RTOL
    elif fmt == "w8a8":
        planes = random_wplanes(torch, g, dt, k, n, lead=n_exp)

        def fn(x, p, s=None):
            return cw8.w8a8_matmul_cuda(x, p["q"], p["s"], s)

        def plain(x, p, s):
            return cw8.w8a8_matmul_plain(x, p["q"], p["s"], s)
        counter, marks, expect, rtol = (cw8, ("quant_kernel", "skinny_kernel"),
                                        2, 0.0)
    elif fmt == "w4a8":
        planes = random_wplanes(torch, g, dt, k, n, lead=n_exp)

        def fn(x, p, s=None):
            return cw4.w4a8_decode_cuda(x, p, s)

        def plain(x, p, s):
            return cw4.w4a8_decode_plain(x, p, s)
        split = cw4.pair_plan(k) < k // UNIT
        counter, marks, expect, rtol = (cw4, ("w4_decode_kernel",
                                              "w4_pairs_kernel"),
                                        2 if split else 1, W4A8_DECODE_RTOL)
    else:
        stack = [random_planes(torch, g, dt, k, n) for _ in range(n_exp)]
        planes = {nm: torch.stack([p[nm] for p in stack]) for nm in stack[0]}
        del stack

        def fn(x, p, s=None):
            return cn.nibble_matmul_cuda(x, p, dt, s)

        def plain(x, p, s):
            return cn.nibble_matmul_plain(x, p, dt, s)
        counter, marks, expect, rtol = (cn.KERNELS[dt], ("skinny_kernel",),
                                        1, MATMUL_RTOL)
    name = counter.NAME if hasattr(counter, "NAME") else counter.name
    tag = f"{name} select {label} T=1"
    x = skewed_x(torch, g, 1, k)
    sel = torch.tensor([e], dtype=torch.int32, device="cuda")
    one = {nm: a[e] for nm, a in planes.items()}
    before = counter.launches
    y = fn(x, planes, sel)
    per_call = counter.launches - before
    y_host = fn(x, one)
    y0 = plain(x, planes, sel)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all()), f"{tag}: non-finite")
    check(torch.equal(y, y_host), f"{tag}: the select differs from the "
          "same kernel on the host-int view of the expert")
    err = float((y - y0).abs().max())
    tol = rtol * float(y0.abs().max())
    check(err <= tol, f"{tag}: max|kernel-plain| {err} > {tol}")
    check(per_call == expect, f"{tag}: {per_call} launches a call; want "
          f"{expect}")
    w = dequant_planes_torch(one, dt, k, n, out_dtype=torch.bfloat16)
    ms = timer.compare({"kernel": lambda: fn(x, planes, sel),
                        "host": lambda: fn(x, one),
                        "plain": lambda: plain(x, planes, sel),
                        "library": lambda: torch.matmul(x, w)})
    pbytes = sum(a.numel() * a.element_size() for a in one.values())
    peak = INT8_OPS if fmt in ("w8a8", "w4a8") else BF16_FLOPS
    b_ms, b_by = bound(pbytes + k * 2 + n * 4 + 4, 2.0 * k * n, peak)
    prof = profile_calls(torch, lambda: fn(x, planes, sel))
    prof_host = profile_calls(torch, lambda: fn(x, one))
    n_prof = sum(v["per_call"] for v in prof.values())
    check(n_prof == per_call, f"{tag}: the profiler saw {prof}, the counter "
          f"{per_call} launches a call")
    check(all(any(m in kn for m in marks) for kn in prof),
          f"{tag}: the wrapper launched other kernels: {prof}")
    row = {"shape": f"mixtral {label} select T=1", "T": 1, "K": k, "N": n,
           "experts": n_exp, "expert": e, "plane_bytes": pbytes,
           "max_abs_err": err, "tol": tol, "bit_equal_host_view": True,
           "ms": ms["kernel"], "host_view_ms": ms["host"],
           "plain_ms": ms["plain"], "library_ms": ms["library"],
           "bound_ms": b_ms, "bound_by": b_by,
           "launches_per_call": per_call, "kernels_per_call": n_prof,
           "device_ms": sum(v["ms"] for v in prof.values()),
           "host_view_device_ms": sum(v["ms"] for v in prof_host.values())}
    print(json.dumps({tag: row}), flush=True)
    del planes, one, w, x
    torch.cuda.empty_cache()
    return name, row


def build_mixtral(torch):
    """The synthetic Mixtral-8x7B in Q4_K_M (gate/up experts and attention
    Q4_K, down experts and the head Q6_K, a bf16 router) on the card, with
    seeded random codes (fill_codes): (cfg, arch, weights, bytes a B = 1
    decode token reads: everything but the embedding table and the rope
    tables, the experts at k of E)."""
    from ntransformer_tpu_torch.models.synth import model_nbytes, synth_model
    t0 = time.perf_counter()
    cfg, arch, weights = synth_model(MIXTRAL, "q4_k_m", fuse=True,
                                     max_seq_len=4096)
    g = torch.Generator(device="cuda")
    g.manual_seed(14)
    fill_codes(torch, weights, g)
    torch.cuda.synchronize()
    lw = weights.layers
    nbytes = model_nbytes(weights)
    experts = sum(q.nbytes for q in (lw.w_gate_exps, lw.w_up_exps,
                                     lw.w_down_exps))
    per_token = (nbytes - weights.embed.nbytes
                 - (weights.rope_cos.numel() + weights.rope_sin.numel()) * 4
                 - experts + experts * arch.n_experts_used // arch.n_experts)
    print(f"mixtral q4_k_m synth: {nbytes / 1e9:.3f} GB of planes (experts "
          f"{experts / 1e9:.3f} GB), {per_token / 1e9:.3f} GB read per "
          f"B = 1 decode token, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return cfg, arch, weights, per_token


class RouteTape:
    """Forced routing for a kernels-on/off comparison of an MoE model: under
    `record()` every models/llama.route call (the router's weights and
    expert ids) of the plain path's run is kept; under `replay()` a kernel
    path's run gets them back in the same order, so both paths run the same
    experts with the same weights and every row is held. A replaying run
    still routes for itself, and the rows it would have routed differently
    (a router near-tie, discontinuous in the logits) are counted for
    information (`flips`). On a dense model route is never called."""

    def __init__(self):
        self.calls = []
        self.flips = {"rows": 0, "of": 0}

    @contextlib.contextmanager
    def _patched(self, replay: bool):
        from ntransformer_tpu_torch.models import llama
        orig, tape = llama.route, iter(list(self.calls))
        if not replay:
            self.calls = []

        def route(arch, hf, router, layer=None):
            topv, tope = orig(arch, hf, router, layer)
            if not replay:
                self.calls.append((topv.clone(), tope.clone()))
                return topv, tope
            kept = next(tape, None)
            check(kept is not None and kept[1].shape == tope.shape,
                  "route replay: the run routed more or other rows than "
                  "the recorded one")
            own, rec = tope.sort(-1).values, kept[1].sort(-1).values
            self.flips["rows"] += int((own != rec).any(-1).sum())
            self.flips["of"] += tope.shape[0]
            return kept
        llama.route = route
        try:
            yield self
        finally:
            llama.route = orig
        if replay:
            check(next(tape, None) is None, "route replay: the run routed "
                  "fewer rows than the recorded one")

    def record(self):
        return self._patched(False)

    def replay(self):
        return self._patched(True)


def layer_view(weights, n: int = 2):
    """The first n layers of stacked weights (free views)."""
    import dataclasses
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.ops import linear
    layers2 = llama.LayerWeights(**{
        f: (None if v is None else
            linear.QLinear(v.dtype, v.k, v.n,
                           {nm: a[:n] for nm, a in v.planes.items()})
            if isinstance(v, linear.QLinear) else v[:n])
        for f, v in ((f, getattr(weights.layers, f))
                     for f in weights.layers.__dataclass_fields__)})
    return dataclasses.replace(weights, layers=layers2)


def moe_decode_on_off(torch, counters, synth, steps: int = 8) -> dict:
    """Decode steps (T = 1: the routed experts through the select) on a
    2-layer view of the Mixtral weights, kernels on vs off, each path from
    its own 64-token prefill, teacher-forced on fixed tokens, the kernel
    path replaying the plain path's routing (RouteTape): every step's
    logits within FULL_LOGIT_RTOL; the select launches only on the kernel
    side."""
    import dataclasses
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.ops import linear
    _, arch, weights, _ = synth
    arch2 = dataclasses.replace(arch, n_layers=2)
    w2 = layer_view(weights, 2)
    gen = torch.Generator().manual_seed(12)
    ids = torch.randint(3, arch.vocab_size, (64,), generator=gen).tolist()
    forced = torch.randint(3, arch.vocab_size, (steps,),
                           generator=gen).tolist()
    outs, tape = {}, RouteTape()
    for mode in ("off", "auto"):
        linear.KERNEL_MODE = mode
        try:
            kv = llama.KVCache.create(arch2, device="cuda")
            with (tape.record() if mode == "off" else tape.replay()):
                llama.forward(arch2, w2, kv, ids, 0)
                reset(counters)
                lgs = [llama.forward(arch2, w2, kv, [t], 64 + i)[0]
                       for i, t in enumerate(forced)]
            torch.cuda.synchronize()
            outs[mode] = (lgs, read(counters))
        finally:
            linear.KERNEL_MODE = "auto"
    rels = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(outs["auto"][0], outs["off"][0])]
    print(f"mixtral 2-layer decode (select), kernels on vs off, routing "
          f"forced, teacher-forced max|d|/max|off| per step: "
          f"{[round(r, 5) for r in rels]} (tol {FULL_LOGIT_RTOL}); natural "
          f"flips {tape.flips}; launches {outs['auto'][1]}", flush=True)
    check(all(bool(torch.isfinite(a).all()) for a in outs["auto"][0]),
          "mixtral 2-layer decode: non-finite logits")
    check(max(rels) <= FULL_LOGIT_RTOL,
          f"mixtral 2-layer decode logits differ by {max(rels)}")
    check(all(outs["auto"][1][k] > 0 for k in MOE_Q4KM),
          f"mixtral 2-layer decode launched {outs['auto'][1]}")
    check(not any(outs["off"][1].values()),
          f"mixtral 2-layer plain decode launched {outs['off'][1]}")
    return {"logit_rel_err_steps": rels, "natural_route_flips": tape.flips,
            "launches": outs["auto"][1]}


def moe_sync_check(torch, arch, step, tag: str = "mixtral") -> dict:
    """One decode step (step(kv, tokens, pos) -> logits, on a cache of its
    own after a 16-token prefill) with each moe_ffn call run under
    torch.cuda.set_sync_debug_mode("error"): the routed experts' index and
    weight stay on the card (a host read would raise)."""
    from ntransformer_tpu_torch.models import llama
    kv = llama.KVCache.create(arch, device="cuda")
    step(kv, list(range(3, 19)), 0)
    torch.cuda.synchronize()
    orig, calls = llama.moe_ffn, []

    def guarded(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(a[1].shape[0])
        return out
    llama.moe_ffn = guarded
    try:
        lg = step(kv, [7], 16)
    finally:
        llama.moe_ffn = orig
    torch.cuda.synchronize()
    check(len(calls) == arch.n_layers and set(calls) == {1},
          f"{tag} sync check: moe_ffn ran {calls}")
    check(bool(torch.isfinite(lg).all()), f"{tag} sync check: non-finite")
    print(f"{tag} decode step: {len(calls)} moe_ffn calls (T = 1) under "
          f"set_sync_debug_mode('error'), no host read", flush=True)
    return {"moe_ffn_calls": len(calls), "sync_free": True}


def write_moe_gguf(path: str, fmt: str, arch: str, hidden: int, inter: int,
                   seed: int = 0) -> None:
    """A small MoE GGUF of random weights (N(0, 0.02), quantized with the
    port's quantizer; the f32 router unquantized, as llama.cpp keeps it)
    with the port's own writer: the moe preset's 3 layers, 4 experts, 2 a
    token, at `hidden` / `inter`, with heads of 64 (hidden / 64 heads, half
    as many kv heads), and repolm512's byte tokenizer, so the smoke prompt
    is 70+ tokens. qwen3moe adds random q/k norms."""
    import numpy as np
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.core.gguf import GGUFReader, GGUFWriter
    from ntransformer_tpu_torch.core.quant import quantize
    from ntransformer_tpu_torch.models.presets import q4_k_m_policy
    layers, n_exp, used, hd = 3, 4, 2, 64
    heads = hidden // hd
    kv_heads = heads // 2
    r = GGUFReader(REPOLM)
    vocab = int(r.metadata["llama.vocab_size"])
    w = GGUFWriter(path)
    md = {"general.architecture": arch, "general.name": f"synthetic-{arch}",
          "ntransformer.rope_style": "half", f"{arch}.vocab_size": vocab,
          f"{arch}.embedding_length": hidden,
          f"{arch}.feed_forward_length": inter,
          f"{arch}.block_count": layers,
          f"{arch}.attention.head_count": heads,
          f"{arch}.attention.head_count_kv": kv_heads,
          f"{arch}.attention.layer_norm_rms_epsilon": 1e-5,
          f"{arch}.rope.freq_base": 10000.0, f"{arch}.context_length": 512,
          f"{arch}.expert_count": n_exp, f"{arch}.expert_used_count": used,
          f"{arch}.expert_feed_forward_length": inter}
    for key, value in md.items():
        w.add_meta(key, value)
    for key, value in r.metadata.items():
        if key.startswith("tokenizer."):
            w.add_meta(key, value)
    r.close()
    rng = np.random.default_rng(seed)

    def policy(name):
        return q4_k_m_policy(name) if fmt == "q4_k_m" else DType(fmt)

    def rand(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    def mat(name, rows, cols):
        dt = policy(name)
        w.add_tensor(name, raw=quantize(rand(rows, cols), dt),
                     shape=(rows, cols), dtype=dt)

    def experts(name, rows, cols):
        dt = policy(name)
        x = rand(n_exp, rows, cols)
        w.add_tensor(name, raw=b"".join(bytes(quantize(x[i], dt))
                                        for i in range(n_exp)),
                     shape=(n_exp, rows, cols), dtype=dt)

    ones = np.ones(hidden, np.float32)
    mat("token_embd.weight", vocab, hidden)
    for i in range(layers):
        pre = f"blk.{i}."
        w.add_tensor(pre + "attn_norm.weight", ones)
        mat(pre + "attn_q.weight", hidden, hidden)
        mat(pre + "attn_k.weight", kv_heads * hd, hidden)
        mat(pre + "attn_v.weight", kv_heads * hd, hidden)
        if arch == "qwen3moe":
            for nm in ("attn_q_norm", "attn_k_norm"):
                w.add_tensor(pre + nm + ".weight",
                             (1 + rng.standard_normal(hd) * 0.1)
                             .astype(np.float32))
        mat(pre + "attn_output.weight", hidden, hidden)
        w.add_tensor(pre + "ffn_norm.weight", ones)
        w.add_tensor(pre + "ffn_gate_inp.weight", rand(n_exp, hidden) * 10)
        experts(pre + "ffn_gate_exps.weight", inter, hidden)
        experts(pre + "ffn_up_exps.weight", inter, hidden)
        experts(pre + "ffn_down_exps.weight", hidden, inter)
    w.add_tensor("output_norm.weight", ones)
    mat("output.weight", vocab, hidden)
    w.write()


def moe_real_phase(torch, counters, card: str, tmp: str,
                   with_ep: bool = False) -> dict:
    """The small MoE files (MOE_FILES) through the CLI and Engine on the card
    against the CPU, as the real phase holds repolm512 (greedy tokens,
    teacher-forced logits within max(1e-2, 2 r), layer by layer), with_ep
    also through the CLI's --ep 2 and EPEngine on both (mesh_cli_vs_cpu);
    the Q8_0 file also served at B = 4 as the serve phase serves
    repolm512."""
    from ntransformer_tpu_torch.inference.engine import EPEngine
    out = {}
    for tag, fmt, arch, hidden, inter, kernels in MOE_FILES:
        path = os.path.join(tmp, f"{tag}.gguf")
        write_moe_gguf(path, fmt, arch, hidden, inter, seed=len(out))
        out[tag] = real_model_phase(torch, counters, card, path, kernels)
        if with_ep:
            out[tag]["ep_cli"] = mesh_cli_vs_cpu(
                torch, counters, path, ["--ep", "2"],
                lambda dev, p=path: EPEngine.load(p, ep=2, device=dev,
                                                  fuse=True), kernels)
    out["serve_moe_q8_0"] = real_serve_phase(
        torch, counters, card, os.path.join(tmp, "moe_q8_0.gguf"),
        SERVE_KERNELS)
    return out


def write_mixtral_q4km(path: str, n_layers: int) -> None:
    """A Mixtral-8x7B-shaped GGUF in Q4_K_M of random valid blocks, as
    write_q4km_8b writes the 8B (expert gate/up and attention Q4_K, expert
    down, the embedding and the head Q6_K), with an f32 N(0, 0.02) router,
    cut to n_layers."""
    import numpy as np
    from ntransformer_tpu_torch.core.dequant import pack_kquant_scales
    from ntransformer_tpu_torch.core.dtypes import DType, GGUFValueType
    from ntransformer_tpu_torch.core.gguf import GGUFWriter
    from ntransformer_tpu_torch.models.presets import q4_k_m_policy
    p = MIXTRAL
    hidden, inter, vocab = p["hidden"], p["inter"], p["vocab"]
    n_exp, kv_dim = p["experts"], p["kv_heads"] * 128
    rng = np.random.default_rng(89)
    eight = np.full((1, 8), 8, np.uint8)
    q4k_scales = pack_kquant_scales(eight, eight).reshape(-1)
    f16 = lambda x: np.frombuffer(np.float16(x).tobytes(), np.uint8)
    q4k, q6k = SYNTH_SCALES["q4_k"], SYNTH_SCALES["q6_k"]

    def blocks(rows: int, cols: int, dt) -> bytes:
        nb = rows * cols // 256
        if dt == DType.Q4_K:
            b = rng.integers(0, 256, (nb, 144), dtype=np.uint8)
            b[:, 0:2] = f16(q4k["d"])
            b[:, 2:4] = f16(q4k["dmin"])
            b[:, 4:16] = q4k_scales
        else:
            b = rng.integers(0, 256, (nb, 210), dtype=np.uint8)
            b[:, 192:208] = 8
            b[:, 208:210] = f16(q6k["d"])
        return b.tobytes()

    w = GGUFWriter(path)
    md = {"general.architecture": "llama", "general.name": "synthetic-mixtral",
          "llama.vocab_size": vocab, "llama.embedding_length": hidden,
          "llama.feed_forward_length": inter, "llama.block_count": n_layers,
          "llama.attention.head_count": p["heads"],
          "llama.attention.head_count_kv": p["kv_heads"],
          "llama.attention.layer_norm_rms_epsilon": p["norm_eps"],
          "llama.rope.freq_base": p["rope_theta"],
          "llama.context_length": 32768, "llama.expert_count": n_exp,
          "llama.expert_used_count": p["experts_used"],
          "llama.expert_feed_forward_length": inter,
          "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}
    for k, v in md.items():
        w.add_meta(k, v)
    w.add_meta("tokenizer.ggml.tokens", [f"<t{i}>" for i in range(vocab)],
               vtype=GGUFValueType.ARRAY, elem_type=GGUFValueType.STRING)

    def mat(name, rows, cols, lead=()):
        dt = q4_k_m_policy(name)
        n = int(np.prod(lead)) if lead else 1
        w.add_tensor(name, raw=blocks(n * rows, cols, dt),
                     shape=tuple(lead) + (rows, cols), dtype=dt)

    ones = np.ones(hidden, np.float32)
    mat("token_embd.weight", vocab, hidden)
    for i in range(n_layers):
        pre = f"blk.{i}."
        w.add_tensor(pre + "attn_norm.weight", ones)
        mat(pre + "attn_q.weight", hidden, hidden)
        mat(pre + "attn_k.weight", kv_dim, hidden)
        mat(pre + "attn_v.weight", kv_dim, hidden)
        mat(pre + "attn_output.weight", hidden, hidden)
        w.add_tensor(pre + "ffn_norm.weight", ones)
        w.add_tensor(pre + "ffn_gate_inp.weight",
                     (rng.standard_normal((n_exp, hidden)) * 0.02)
                     .astype(np.float32))
        mat(pre + "ffn_gate_exps.weight", inter, hidden, (n_exp,))
        mat(pre + "ffn_up_exps.weight", inter, hidden, (n_exp,))
        mat(pre + "ffn_down_exps.weight", hidden, inter, (n_exp,))
    w.add_tensor("output_norm.weight", ones)
    mat("output.weight", vocab, hidden)
    w.write()


def moe_tiered_phase(torch, counters, card: str, pre: dict) -> dict:
    """Tiered MoE at the Mixtral widths, cut to MOE_TIERED_LAYERS layers: a
    Q4_K_M GGUF of random valid blocks written to a temp directory, streamed
    with an LRU of 6 expert sets (a token's working set is 8) and the last
    layer's experts read from the pack on disk, against the resident model
    of the same file (the GGUF loader's, unfused): a 128-token prefill and
    16 greedy tokens, the tokens identical and the logits bit-equal (the
    select kernels equal the kernels on one expert's planes); ms a token,
    expert bytes a token, the hit rate, evictions, and the copy stream's
    rate beside a pinned-copy probe. pre: start_prep's GGUF and pack,
    written beside the kernels' build (their seconds are reported)."""
    from ntransformer_tpu_torch.core.gguf import GGUFReader
    from ntransformer_tpu_torch.memory.pack import ensure_pack
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.models.tiered_moe import (
        forward_tiered_moe, load_model_tiered_moe)
    n_layers = MOE_TIERED_LAYERS
    with prepared_dir(pre) as tmp:
        out = {"card": card, "layers": n_layers,
               "tier_c_filesystem": filesystem_of(tmp),
               "gguf_write_s": pre["gguf_write_s"],
               "pack_write_s": pre["pack_write_s"]}
        path = pre["path"]
        pack = ensure_pack(GGUFReader(path), path)  # start_prep's
        out["gguf_bytes"] = os.path.getsize(path)
        ram = sum(pack.layer_nbytes(i) for i in range(n_layers - 1))
        slots = 6
        t0 = time.perf_counter()
        tm = load_model_tiered_moe(path, max_seq_len=1024,
                                   hbm_expert_slots=slots, ram_bytes=ram)
        out["tiered_load_s"] = time.perf_counter() - t0
        est = tm.estreamer
        check(len(est.ram_blobs) == n_layers - 1 and est.stages,
              f"tiered moe: {len(est.ram_blobs)} RAM layers, "
              f"{len(est.stages)} staging buffers")
        t0 = time.perf_counter()
        res = load_model(path, max_seq_len=1024, device="cuda", fuse=False)
        out["resident_load_s"] = time.perf_counter() - t0
        arch = tm.arch
        ids = torch.randint(3, arch.vocab_size, (128,),
                            generator=torch.Generator().manual_seed(4))
        kv_r = llama.KVCache.create(arch, device="cuda")
        kv_t = llama.KVCache.create(arch, device="cuda")

        def step_r(tokens, pos):
            return llama.forward(arch, res.weights, kv_r, tokens, pos)[0]

        def step_t(tokens, pos):
            return forward_tiered_moe(tm, kv_t, tokens, pos)[0]
        reset(counters)
        toks_r, lg_r = greedy_ids(torch, step_r, ids.cuda(), 16)
        est.reset_stats()
        est.timed = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks_t, lg_t = greedy_ids(torch, step_t, ids.cuda(), 16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = est.stats()
        copy_s = est.copy_seconds()
        est.timed = False
        launches = read(counters)
        check(torch.equal(toks_r, toks_t),
              f"tiered moe tokens {toks_t.tolist()} != resident "
              f"{toks_r.tolist()}")
        equal = [bool(torch.equal(a, b)) for a, b in zip(lg_t, lg_r)]
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(lg_t, lg_r))
        check(all(equal), f"tiered moe logits not bit-equal to the resident "
              f"model's: {equal}, max rel {rel}")
        check(st["evictions"] > 0 and st["disk_bytes"] > 0,
              f"tiered moe: evictions and disk reads not both exercised: "
              f"{st}")
        check(all(launches[k] > 0 for k in MOE_Q4KM + ("flash_attention",)),
              f"tiered moe launched {launches}")
        # decode alone: 16 more greedy tokens from each cache with no host
        # read between tokens (a token's prefetch is queued while the last
        # token's expert kernels may still run), the streamed logits held
        # bit for bit to the resident ones after the timed loop
        def decode(step):
            nxt, out = toks_t[-1].reshape(1).cuda(), []
            for i in range(16):
                out.append(step(nxt, 128 + 16 + i)[-1])
                nxt = torch.argmax(out[-1]).reshape(1)
            return out
        dec_r = decode(step_r)
        est.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec_t = decode(step_t)
        torch.cuda.synchronize()
        dec = est.stats()
        ms_tok = (time.perf_counter() - t0) * 1e3 / 16
        check(all(torch.equal(a, b) for a, b in zip(dec_t, dec_r)),
              "tiered moe decode without host reads between tokens: logits "
              "not bit-equal to the resident model's")
        check(dec["evictions"] > 0, f"tiered moe decode: no eviction {dec}")
        out.update({
            "hbm_expert_slots": slots, "ram_layers": n_layers - 1,
            "disk_layers": 1, "tokens_equal": True,
            "logits_bit_equal": True, "decode_logits_bit_equal": True,
            "greedy_run_s": wall,
            "greedy_run_stats": st,
            "copy_GB_s": st["h2d_bytes"] / copy_s / 1e9 if copy_s else None,
            "decode_ms_per_token": ms_tok,
            "decode_hit_rate": dec["hit_rate"],
            "decode_expert_bytes_per_token": dec["h2d_bytes"] / 16,
            "decode_disk_bytes_per_token": dec["disk_bytes"] / 16,
            "decode_stats": dec, "h2d_probe_GB_s": h2d_probe(torch),
            "launches": launches})
        print(json.dumps({"tiered_mixtral_q4_k_m": out}), flush=True)
        tm.close()
        del res, tm
    torch.cuda.empty_cache()
    return out


def moe_phase(torch, counters, timer, card: str, pre: dict,
              with_ep: bool = True, cut_layers: int = CUT_LAYERS
              ) -> tuple[dict, dict, dict]:
    """Phase moe: the select rows (also at a shard's E/ep experts), the
    synthetic Mixtral-8x7B (this slice's main path: Engine.benchmark and
    BatchServer with the bench-style steps; their launch counts are the
    kernels line's moe_launches), its decode held to the plain path and
    free of host reads, then (with_ep, phase ep) the same model through
    EPEngine (ep_phase, on its first cut_layers layers: depth_cut),
    the small MoE files against the CPU (with --ep 2 under phase ep), and
    tiered MoE at Mixtral widths (pre: start_prep's GGUF and pack for
    it); the B = 1 and B = 8 steps are also replayed as CUDA graphs
    bit-equal to their uncaptured chains.
    Returns (the select rows by kernel, launches, EP launches)."""
    import tempfile
    from ntransformer_tpu_torch.models import llama
    t_part = [time.perf_counter()]

    def part(name: str):
        """The seconds the part of phase moe that just ended took."""
        now = time.perf_counter()
        print(f"moe: {name} took {now - t_part[0]:.1f} s", flush=True)
        t_part[0] = now
    g = torch.Generator(device="cuda")
    g.manual_seed(41)
    rows = {}
    for fmt, label, k, n in SELECT_ROWS:
        name, row = select_row(torch, timer, g, fmt, label, k, n)
        rows.setdefault(name, []).append(row)
    if with_ep:
        # a shard's stacked planes at EP_SHARDS: E/ep experts
        for fmt, label, k, n in SELECT_ROWS[:2]:
            name, row = select_row(
                torch, timer, g, fmt, f"{label} ep={EP_SHARDS} shard", k, n,
                n_exp=MIXTRAL["experts"] // EP_SHARDS, e=1)
            rows.setdefault(name, []).append(row)
    part("select rows")
    synth = build_mixtral(torch)
    kernels = MOE_Q4KM + ("flash_attention",)
    summary, engine = full_width_phase(torch, counters, card, synth, kernels)
    part("Mixtral Engine")
    serve, served = full_batched_phase(torch, counters, card, synth,
                                       kernels + ("batched_attention",
                                                  "kv_update"))
    print(json.dumps({"full_width_mixtral_serving": serve}), flush=True)
    part("Mixtral server")
    graph_moe_steps(torch, depth_cut(synth, cut_layers))
    on_off = moe_decode_on_off(torch, counters, synth)
    sync = moe_sync_check(torch, synth[1], lambda kv, t, p: llama.forward(
        synth[1], synth[2], kv, t, p)[0])
    print(json.dumps({"mixtral_q4_k_m": {
        "engine": summary, "decode_on_off": on_off, "sync": sync}}),
        flush=True)
    part("Mixtral graphs and checks")
    ep_launches = {}
    if with_ep:
        _, ep_launches = ep_phase(torch, counters, card,
                                  depth_cut(synth, cut_layers))
        part("ep")
    del synth
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        moe_real_phase(torch, counters, card, tmp, with_ep)
    part("small MoE GGUFs")
    moe_tiered_phase(torch, counters, card, pre)
    part("tiered MoE")
    launches = {k: engine.get(k, 0) + served.get(k, 0) for k in counters}
    return rows, launches, ep_launches


# ------------------------------------- expert, pipeline and CP x TP meshes
EP_SHARDS = 2     # phase ep: expert shards on cuda:0
EP_TOKENS = 16    # the EP decode steps held bit for bit, and timed
PP_CASES = ((2, 2), (4, 2))   # phase pp: (stages, microbatches) on cuda:0
PP_STEPS = 16
PP_LENS = [300, 40, 64, 9, 120, 20, 90, 500]   # the B = 8 slots' prompts
CPTP_MESH = (2, 2)   # phase cptp: (cp, tp) positions on cuda:0
CPTP_STEPS = 16
MESH_CARDS = 4       # phase meshcards: one position a card


def ep_phase(torch, counters, card: str, synth) -> tuple[dict, dict]:
    """Expert parallelism on phase moe's synthetic Mixtral-8x7B Q4_K_M cut to
    its first CUT_LAYERS layers (depth_cut: free views), EP_SHARDS shards on
    cuda:0, split in place (EPEngine empties the view's expert planes once its
    shards exist). First the one-device reference on a 128-token prompt: the
    prefill's logits, the cache after it, EP_TOKENS greedy steps (timed, the
    tokens kept on the card). Then EPEngine: its prefill within FULL_LOGIT_RTOL
    of the one-device prefill (the T > 1 loop sums each shard's experts, then
    the shards, in another order than the loop over all E); EP_TOKENS T = 1
    steps on a copy of the reference cache, fed the reference tokens, bit-equal
    to the one-device steps (k = 2: a shard's term for another shard's expert
    is an exact zero, and a sum of two terms has one order's bits either way),
    timed; Engine.benchmark's protocol (prefill 512, EP_TOKENS tokens; the
    kernels line's ep_launches are read around it); one step's launches by the
    counters against the profiler's skinny kernels; moe_sync_check on the EP
    step; and the replayed programs against the uncaptured ones
    (mesh_engine_cell: the 128-token prompt, MESH_STEPS loop steps)."""
    from ntransformer_tpu_torch.inference.engine import EPEngine
    from ntransformer_tpu_torch.models import llama
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.parallel.ep import EXPERT_FIELDS, make_ep_mesh
    cfg, arch, weights, per_token = synth
    gen = torch.Generator().manual_seed(17)
    ids = torch.randint(3, arch.vocab_size, (128,), generator=gen).tolist()
    n = len(ids)

    def decode(w, kv, toks, **fw):
        """EP_TOKENS steps fed `toks` (or greedy from toks[0]): (logits,
        tokens, ms a step)."""
        out, fed, tok = [], [], toks[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(EP_TOKENS):
            tok = toks[i] if len(toks) > 1 else tok
            fed.append(tok)
            lg, kv, _ = llama.forward(arch, w, kv, tok.reshape(1), n + i,
                                      **fw)
            out.append(lg)
            tok = torch.argmax(lg[0])
        torch.cuda.synchronize()
        return out, fed, (time.perf_counter() - t0) * 1e3 / EP_TOKENS

    kv = llama.KVCache.create(arch, device="cuda")
    pre1, kv, _ = llama.forward(arch, weights, kv, ids, 0)
    kv_pre = kv.clone()
    ref, toks, one_ms = decode(weights, kv, [torch.argmax(pre1[0])])
    del kv
    experts = sum(getattr(weights.layers, f).nbytes for f in EXPERT_FIELDS)
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    t0 = time.perf_counter()
    eng = EPEngine(model, make_ep_mesh(EP_SHARDS, ["cuda:0"] * EP_SHARDS))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    e_local = arch.n_experts // EP_SHARDS
    for sw in eng.shards:
        for f in EXPERT_FIELDS:
            for a in getattr(sw.layers, f).planes.values():
                check(a.shape[1] == e_local and a.is_contiguous(),
                      f"EPEngine: an expert plane of shape {tuple(a.shape)}")
    check(all(not getattr(weights.layers, f).planes for f in EXPERT_FIELDS),
          "EPEngine kept the unsharded expert planes")
    del weights, model
    torch.cuda.empty_cache()
    fw = {"ep": eng.mesh}
    kv = eng._make_kv()
    pre_ep = llama.forward(arch, eng.shards, kv, ids, 0, **fw)[0]
    pre_rel = rel_err(pre_ep, pre1)
    check(bool(torch.isfinite(pre_ep).all()), "EPEngine: non-finite logits")
    check(pre_rel <= FULL_LOGIT_RTOL, f"EPEngine prefill logits differ from "
          f"the one-device prefill's by {pre_rel} of their range")
    del kv
    got, _, ep_ms = decode(eng.shards, kv_pre, toks, **fw)
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
    print(f"mixtral EP ({EP_SHARDS} shards on cuda:0): prefill max|dlogit|/"
          f"max|logit| {pre_rel:.3e} (tol {FULL_LOGIT_RTOL}); {sum(equal)}/"
          f"{EP_TOKENS} T = 1 steps bit-equal to the one-device steps; "
          f"{ep_ms:.2f} ms a step against {one_ms:.2f}", flush=True)
    check(all(equal), "EPEngine: a T = 1 step differs from the one-device "
          "step on the same cache")
    del ref, got
    # one step's launches: the counters against the profiler
    tok = toks[0].reshape(1)

    def one_step():
        return llama.forward(arch, eng.shards, kv_pre, tok, n, **fw)[0]
    one_step()
    torch.cuda.synchronize()
    reset(counters)
    one_step()
    torch.cuda.synchronize()
    step_launches = {k: v for k, v in read(counters).items() if v}
    prof = profile_calls(torch, one_step, calls=4)
    skinny = sum(v["per_call"] for k, v in prof.items()
                 if "skinny_kernel" in k)
    print(f"mixtral EP decode step: launches {step_launches}; the "
          f"profiler's skinny kernels a step {skinny}, all kernels "
          f"{sum(v['per_call'] for v in prof.values())}", flush=True)
    check(skinny == sum(step_launches.values())
          and set(step_launches) <= set(MOE_Q4KM),
          f"mixtral EP decode step: counters {step_launches}, profiler "
          f"{skinny} skinny kernels")
    del kv_pre
    sync = moe_sync_check(torch, arch, lambda kv, t, p: llama.forward(
        arch, eng.shards, kv, t, p, **fw)[0], tag="mixtral EP")
    gen = torch.Generator().manual_seed(9)
    ids512 = torch.randint(0, arch.vocab_size, (512,), generator=gen).tolist()
    reset(counters)
    st = eng.benchmark(prompt_ids=ids512, n_tokens=EP_TOKENS)
    torch.cuda.synchronize()
    launches = read(counters)
    check(all(launches[k] > 0 for k in MOE_Q4KM + ("flash_attention",)),
          f"mixtral EPEngine: a kernel of the path launched zero times: "
          f"{launches}")
    replay = mesh_engine_cell(torch, counters, "ep_mixtral", eng, ids)
    # a token reads the k routed experts' bytes on each shard
    ep_bytes = per_token + experts * arch.n_experts_used * (EP_SHARDS - 1) \
        // arch.n_experts
    summary = {"card": card, "shards": EP_SHARDS, "shard_s": shard_s,
               "prefill_rel_err": pre_rel, "t1_steps_bit_equal": sum(equal),
               "forced_ms_per_token": ep_ms,
               "one_device_ms_per_token": one_ms,
               "prefill_tokens": st.prefill_tokens,
               "prefill_ms": st.prefill_ms,
               "decode_ms_per_token": st.decode_ms / st.decode_tokens,
               "bytes_per_token": ep_bytes,
               "one_device_bytes_per_token": per_token,
               "bound_ms_per_token": ep_bytes / HBM_BYTES_PER_S * 1e3,
               "step_launches": step_launches, "launches": launches,
               "sync": sync, "replay": replay}
    print(json.dumps({"ep_mixtral": summary}), flush=True)
    del eng
    torch.cuda.empty_cache()
    return summary, launches


def mesh_cli_vs_cpu(torch, counters, path: str, flags: list, make,
                    kernels) -> dict:
    """A sharded mode on a small model, as the real phase holds the
    resident one: the CLI with `flags` and --device cuda:0 (every kernel of
    `kernels` launched; its text equal to the card engine's generate, the
    same mesh, kernels and sums), and the card engine make("cuda:0")
    against the CPU engine make("cpu"): greedy tokens counted, 32 steps
    teacher-forced on the CPU's tokens, each step within max(1e-2, 2 r,
    2 m) of the largest logit (r: the card's plain path against the CPU; m,
    for a decode step, the card's kernel prefill with plain decode steps)."""
    import contextlib
    import io
    from ntransformer_tpu_torch import cli
    from ntransformer_tpu_torch.inference.engine import GenerateConfig
    from ntransformer_tpu_torch.ops import linear
    tag = f"{os.path.basename(path)} {' '.join(flags)}"
    buf = io.StringIO()
    reset(counters)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-m", path, "-p", PROMPT, "-n", "32", "-t", "0",
                       "--repeat-penalty", "1.0", "--device", "cuda:0"]
                      + flags)
    torch.cuda.synchronize()
    launches = read(counters)
    check(rc == 0, f"cli {tag}: exit code {rc}")
    check(all(launches[k] > 0 for k in kernels),
          f"cli {tag} launched {launches}")
    card_eng, cpu_eng = make("cuda:0"), make("cpu")
    want, _ = card_eng.generate(PROMPT, GenerateConfig(
        max_tokens=32, temperature=0.0, repeat_penalty=1.0))
    text = buf.getvalue().rstrip("\n")
    check(text == want, f"cli {tag} wrote {text!r}, the engine {want!r}")
    ids = card_eng._encode(PROMPT)
    cpu_toks, cpu_logits = greedy_pass(cpu_eng, torch, ids, 32)
    card_toks, _ = greedy_pass(card_eng, torch, ids, 32)
    _, forced = greedy_pass(card_eng, torch, ids, 32, forced=cpu_toks)
    _, mixed = greedy_pass(card_eng, torch, ids, 32, forced=cpu_toks,
                           plain_decode=True)
    linear.KERNEL_MODE = "off"
    try:
        _, plain = greedy_pass(card_eng, torch, ids, 32, forced=cpu_toks)
    finally:
        linear.KERNEL_MODE = "auto"
    kern = [rel_err(a, b) for a, b in zip(forced, cpu_logits)]
    pl = [rel_err(a, b) for a, b in zip(plain, cpu_logits)]
    mx = [rel_err(a, b) for a, b in zip(mixed, cpu_logits)]
    limits = [max(REAL_LOGIT_RTOL, 2 * r, 2 * m * (i > 0))
              for i, (r, m) in enumerate(zip(pl, mx))]
    agree = sum(a == b for a, b in zip(card_toks, cpu_toks))
    print(f"{tag}: card vs CPU {agree}/32 greedy tokens agree; teacher-forced "
          f"max|dlogit|/max|logit| per step {[round(r, 4) for r in kern]}; "
          f"card plain vs CPU {[round(r, 4) for r in pl]}", flush=True)
    for a in forced:
        check(bool(torch.isfinite(a).all()), f"{tag}: non-finite logits")
    for i, (r, lim) in enumerate(zip(kern, limits)):
        check(r <= lim, f"{tag} step {i}: teacher-forced logits differ from "
              f"the CPU's by {r} of their range (> {lim})")
    out = {"cli_text": text, "tokens_agree": agree,
           "logit_rel_err_steps": kern, "plain_rel_err_steps": pl,
           "launches": launches}
    print(json.dumps({f"cli {tag}": out}), flush=True)
    return out


def pp_prefilled(torch, model, quant: bool):
    """The B = 8 slots' PP_LENS prompts, each prefilled by the Engine into
    one [L, 8, ...] cache: (cache, the first greedy tokens on the card)."""
    from ntransformer_tpu_torch.inference.engine import Engine
    from ntransformer_tpu_torch.models.batched import BatchedKV
    arch = model.arch
    eng = Engine(model, kv_quant=quant)
    gen = torch.Generator().manual_seed(23)
    bkv = BatchedKV.create(arch, len(PP_LENS), quant, device="cuda")
    first = []
    for b, n in enumerate(PP_LENS):
        ids = torch.randint(3, arch.vocab_size, (n,), generator=gen).tolist()
        lg, kv, _ = eng._prefill(eng._make_kv(), ids)
        bkv.insert(b, kv)
        first.append(torch.argmax(lg[0]))
        del kv
    return bkv, torch.stack(first)


def pp_fill(state, bkv) -> None:
    """Each (stage, microbatch) cache of a PP state from one [L, B, ...]
    cache: the stage's layers, the microbatch's slots."""
    n_l = state.arch.n_layers
    per = state.kv[0][0].k.shape[1]
    for s, row in enumerate(state.kv):
        for m, c in enumerate(row):
            for dst, src in zip(c.caches, bkv.caches):
                dst.copy_(src[s * n_l:(s + 1) * n_l, m * per:(m + 1) * per])


def pp_replay_cell(torch, counters, tag: str, mesh, arch, weights, bkv,
                   b_n: int, n_mb: int, pos0, first, cards=None) -> dict:
    """make_pp_decode's step (all S + M - 1 ticks one CUDA graph, a
    CardGraph where the stages span cards, captured at its first call,
    here with no slot active) replayed against pp_decode_step uncaptured
    (batched_replay_cell; cards: the stages' cards, for its stalled-card
    replays and busy shares), each on its own state filled from bkv."""
    from ntransformer_tpu_torch.parallel import pp
    states = []
    for _ in range(2):
        st = pp.shard_pp_state(mesh, arch, weights, b_n, n_mb)
        pp_fill(st, bkv)
        states.append(st)
    ref, kv = states
    step = pp.make_pp_decode(mesh, arch, kv, n_mb)
    t0 = time.perf_counter()
    step(first, pos0, torch.zeros(b_n, dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t0
    check(step.replays == 1, f"{tag}: the first call replayed "
          f"{step.replays} times")
    cell = batched_replay_cell(
        torch, counters, tag.replace(" ", "_"),
        lambda c, t, p, a: pp.pp_decode_step(mesh, arch, c, t, p, a,
                                             n_mb)[0],
        lambda c, t, p, a: step(t, p, a), ref, kv, b_n, pos0, first,
        caches=lambda x: x.kv, cards=cards)
    cell.update(capture_s=cap_s, replays=step.replays,
                program=program_shape(step.graph))
    del states, ref, kv, step
    torch.cuda.empty_cache()
    return cell


def pp_phase(torch, counters, card: str, synth) -> tuple[dict, dict]:
    """Pipeline parallelism on the synthetic 8B Q8_0 of `full` cut to its
    first CUT_LAYERS layers (depth_cut; the stages
    on cuda:0: each stage's layers a free view of the stacked planes), B =
    8 slots prefilled with PP_LENS prompts, bf16 and int8 caches: the
    one-device B = 8 step's PP_STEPS greedy tokens (its ms and kernels a
    step), then for each (stages, microbatches) of PP_CASES PP_STEPS steps
    of pp_decode_step fed those tokens (ms and kernels a step; the kernels
    line's pp_launches are the bf16 runs'), each microbatch's logits and
    cache bit-equal to the unsharded step over its slots alone (a cache of
    B/M slots: the same kernels and plans), the launches equal to those
    M unsharded microbatch steps' (one head a microbatch: M a step) but
    for the stacked append, one a stage, and the head's calls counted; with
    the bf16 cache, make_pp_decode's replayed step against pp_decode_step
    (pp_replay_cell)."""
    from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                       batched_decode_step)
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.parallel import pp
    cfg, arch, weights, _ = synth
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    b_n = len(PP_LENS)
    pos0 = torch.tensor(PP_LENS, device="cuda")
    act = torch.ones(b_n, dtype=torch.bool, device="cuda")
    summary = {"card": card, "B": b_n, "lens": PP_LENS, "cases": {}}
    pp_launches = {}
    for quant in (False, True):
        cache = "int8" if quant else "bf16"
        bkv, tok = pp_prefilled(torch, model, quant)
        c = BatchedKV(*(None if t is None else t.clone()
                        for t in (bkv.k, bkv.v, bkv.ks, bkv.vs)))
        toks = []
        torch.cuda.synchronize()
        reset(counters)
        t0 = time.perf_counter()
        for i in range(PP_STEPS):
            toks.append(tok)
            lg, c = batched_decode_step(arch, weights, c, tok, pos0 + i, act)
            tok = torch.argmax(lg, -1)
        torch.cuda.synchronize()
        one = {"ms_per_step": (time.perf_counter() - t0) * 1e3 / PP_STEPS,
               "kernels_per_step": sum(read(counters).values()) / PP_STEPS}
        del c
        summary["cases"][f"one_device {cache}"] = one
        for n_st, n_mb in PP_CASES:
            tag = f"8b PP ({n_st} stages, {n_mb} microbatches, {cache})"
            per = b_n // n_mb
            mesh = pp.make_pp_mesh(n_st, ["cuda:0"] * n_st)
            state = pp.shard_pp_state(mesh, arch, weights, b_n, n_mb, quant)
            n_l = state.arch.n_layers
            views = all(
                st.layers.wqkv.planes["qs"].data_ptr()
                == weights.layers.wqkv.planes["qs"][s * n_l].data_ptr()
                for s, st in enumerate(state.stages))
            check(views, f"{tag}: a stage's layers are not views of the "
                  "stacked planes")
            pp_fill(state, bkv)
            alone = [BatchedKV(*(None if t is None else
                                 t[:, m * per:(m + 1) * per].contiguous()
                                 for t in (bkv.k, bkv.v, bkv.ks, bkv.vs)))
                     for m in range(n_mb)]
            ref = []
            torch.cuda.synchronize()
            reset(counters)
            for i in range(PP_STEPS):
                row = []
                for m in range(n_mb):
                    sl = slice(m * per, (m + 1) * per)
                    lg, alone[m] = batched_decode_step(
                        arch, weights, alone[m], toks[i][sl],
                        (pos0 + i)[sl], act[sl])
                    row.append(lg)
                ref.append(torch.cat(row))
            torch.cuda.synchronize()
            alone_launches = read(counters)
            heads, head = [], pp._head
            pp._head = lambda *a: heads.append(1) or head(*a)
            try:
                outs = []
                torch.cuda.synchronize()
                reset(counters)
                t0 = time.perf_counter()
                for i in range(PP_STEPS):
                    lg, state = pp.pp_decode_step(mesh, arch, state, toks[i],
                                                  pos0 + i, act, n_mb)
                    outs.append(lg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                pp._head = head
            launches = read(counters)
            equal = all(bool(torch.equal(a, b)) for a, b in zip(outs, ref))
            cache_equal = all(
                bool(torch.equal(d, a[s * n_l:(s + 1) * n_l]))
                for s in range(n_st) for m in range(n_mb)
                for d, a in zip(state.kv[s][m].caches, alone[m].caches))
            cell = {"ms_per_step": wall * 1e3 / PP_STEPS,
                    "kernels_per_step": sum(launches.values()) / PP_STEPS,
                    "head_calls_per_step": len(heads) / PP_STEPS,
                    "launches": launches, "logits_bit_equal": equal,
                    "caches_bit_equal": cache_equal}
            summary["cases"][tag] = cell
            print(f"{tag}: {cell['ms_per_step']:.2f} ms and "
                  f"{cell['kernels_per_step']:.0f} kernels a step (one-device"
                  f" B = {b_n}: {one['ms_per_step']:.2f} ms, "
                  f"{one['kernels_per_step']:.0f}); head {len(heads)} calls "
                  f"in {PP_STEPS} steps; logits and caches bit-equal to each "
                  f"microbatch's slots alone: {equal}, {cache_equal}",
                  flush=True)
            check(equal and cache_equal, f"{tag}: a microbatch's logits or "
                  "cache differ from the unsharded step on its slots alone")
            check(len(heads) == n_mb * PP_STEPS,
                  f"{tag}: the head ran {len(heads)} times in {PP_STEPS} "
                  f"steps; want {n_mb} a step")
            # the same kernels as the microbatches' unsharded steps, but
            # the cache write: one stacked append a stage, not a step
            want = dict(alone_launches, kv_update=alone_launches["kv_update"]
                        * n_st)
            check(launches == want, f"{tag}: launches {launches}; the "
                  f"microbatches' unsharded steps {alone_launches}, with "
                  f"{n_st} appends a microbatch")
            check(all(launches[k] > 0 for k in ("q8_0_matmul",
                                                "batched_attention",
                                                "kv_update")),
                  f"{tag}: launched {launches}")
            if not quant:
                for k, v in launches.items():
                    pp_launches[k] = pp_launches.get(k, 0) + v
            del state, alone, ref, outs
            if not quant:
                cell["replay"] = pp_replay_cell(
                    torch, counters, tag, mesh, arch, weights, bkv, b_n,
                    n_mb, pos0, toks[0])
        del bkv
        torch.cuda.empty_cache()
    print(json.dumps({"pp_8b": summary}), flush=True)
    return summary, pp_launches


def cptp_phase(torch, counters, card: str, synth) -> tuple[dict, dict]:
    """CP x TP on the synthetic 8B Q8_0 of `full` cut to its first
    CUT_LAYERS layers (depth_cut): CPEngine over the
    CPTP_MESH (cp, tp) mesh on cuda:0 with the CP phase's ctx (CP_CTX) and
    prompt (CP_PROMPT tokens): the weights split over tp, the cache over
    both axes. Engine.benchmark's protocol (the kernels line's
    cptp_launches are read around it: the Q8_0 products at the TP shard
    shapes and the partials kernel at Hq/tp heads over S/cp keys, no
    resident flash) beside the resident Engine on the same weights, then
    CPTP_STEPS steps teacher-forced on the resident's greedy tokens by
    tp_forced's rule; the replayed programs against the uncaptured ones
    (mesh_engine_cell: the whole prompt, MESH_STEPS loop steps across CP
    key 4,608); last, repolm512 through the CLI's --cp 2 --tp 2 against the
    CPU (mesh_cli_vs_cpu)."""
    import dataclasses
    from ntransformer_tpu_torch.inference.engine import CPEngine, Engine
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.ops.cuda import attention as ca
    from ntransformer_tpu_torch.ops.layers import rope_table
    from ntransformer_tpu_torch.parallel.cp import make_cp_tp_mesh
    cfg, arch, weights, _ = synth
    n_cp, n_tp = CPTP_MESH
    arch = dataclasses.replace(arch, max_seq_len=CP_CTX)
    cos, sin = rope_table(CP_CTX, arch.head_dim, arch.rope_theta,
                          device="cuda")
    weights = dataclasses.replace(weights, rope_cos=cos, rope_sin=sin)
    model = LoadedModel(cfg, arch, weights, None, None, torch.device("cuda"))
    t0 = time.perf_counter()
    eng = CPEngine(model, make_cp_tp_mesh(n_cp, n_tp,
                                          ["cuda:0"] * (n_cp * n_tp)))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    lw = eng.shards[0].layers
    check((lw.wqkv.n, lw.w_down.k) == (6144 // n_tp, 14336 // n_tp),
          f"8b CP x TP: unexpected shard shapes {lw.wqkv.n}, {lw.w_down.k}")
    grid = eng._make_kv()
    check(tuple(grid[0][0].k.shape) == (arch.n_layers, 8 // n_tp,
                                        CP_CTX // n_cp, 128),
          f"8b CP x TP: a cache slice of {tuple(grid[0][0].k.shape)}")
    del grid
    res = Engine(model)
    ids = torch.randint(0, arch.vocab_size, (CP_PROMPT,),
                        generator=torch.Generator().manual_seed(46)).tolist()
    reset(counters)
    st = eng.benchmark(prompt_ids=ids, n_tokens=CPTP_STEPS)
    torch.cuda.synchronize()
    launches = read(counters)
    print(f"8b CP x TP {CPTP_MESH} path launches {launches}", flush=True)
    check(launches[ca.PARTIALS_NAME] > 0 and launches["q8_0_matmul"] > 0,
          f"8b CP x TP: a kernel of the path launched zero times: "
          f"{launches}")
    check(launches[ca.NAME] == 0,
          f"8b CP x TP: the resident flash kernel ran: {launches}")
    st_res = res.benchmark(prompt_ids=ids, n_tokens=CPTP_STEPS)
    forced = tp_forced(torch, eng, res, ids, CPTP_STEPS,
                       tag=f"8b CPEngine ({n_cp} x {n_tp}")
    replay = mesh_engine_cell(torch, counters, "cptp_8b", eng, ids)
    summary = {"card": card, "mesh": CPTP_MESH, "ctx": CP_CTX,
               "prompt_tokens": CP_PROMPT, "shard_s": shard_s,
               "launches": launches, "replay": replay,
               "forced": {k: v for k, v in forced.items()
                          if k != "resident_tokens"}}
    for tag, s in (("cptp", st), ("resident", st_res)):
        summary[f"{tag}_prefill_ms"] = s.prefill_ms
        summary[f"{tag}_prefill_tok_s"] = s.prefill_tps
        summary[f"{tag}_decode_ms_per_token"] = s.decode_ms / s.decode_tokens
    print(json.dumps({"cptp_8b": summary}), flush=True)
    del eng, res
    torch.cuda.empty_cache()
    summary["cli"] = mesh_cli_vs_cpu(
        torch, counters, REPOLM, ["--cp", "2", "--tp", "2"],
        lambda dev: CPEngine.load(REPOLM, cp=2, tp=2, device=dev),
        ("q8_0_matmul", ca.PARTIALS_NAME))
    return summary, launches


def pp_cards_cell(torch, counters, synth) -> dict:
    """meshcards' PP cell: the synthetic 8B (`synth`, all 32 layers)
    through pp_decode_step at (MESH_CARDS stages, 2 microbatches), one
    stage a card and all on cuda:0, PP_STEPS steps fed the same tokens from
    the same prefilled cache, uncaptured and replayed by make_pp_decode (a
    CardGraph over the cards, one graph on cuda:0): logits and caches
    bit-equal; then pp_replay_cell over the cards (replays after a stalled
    card, busy shares, ms a step, graphs and hand-offs)."""
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.parallel import pp
    cfg, arch, weights, _ = synth
    want = [torch.device("cuda", i) for i in range(MESH_CARDS)]
    bkv, tok = pp_prefilled(torch, LoadedModel(
        cfg, arch, weights, None, None, torch.device("cuda")), False)
    pos0 = torch.tensor(PP_LENS, device="cuda")
    act = torch.ones(len(PP_LENS), dtype=torch.bool, device="cuda")
    runs, shapes = {}, {}
    cards_mesh = pp.make_pp_mesh(MESH_CARDS)
    for name, mesh in (("cards", cards_mesh),
                       ("cuda:0", pp.make_pp_mesh(MESH_CARDS,
                                                  ["cuda:0"] * MESH_CARDS))):
        for replayed in (False, True):
            state = pp.shard_pp_state(mesh, arch, weights, len(PP_LENS), 2)
            pp_fill(state, bkv)
            step = (pp.make_pp_decode(mesh, arch, state, 2) if replayed
                    else lambda t, p, a, m=mesh, st=state: pp.pp_decode_step(
                        m, arch, st, t, p, a, 2)[0])
            reset(counters)
            outs, t = [], tok
            for i in range(PP_STEPS):
                lg = step(t, pos0 + i, act)
                outs.append(lg.cpu())
                t = torch.argmax(lg, -1)
            torch.cuda.synchronize()
            if replayed:
                check(step.replays == PP_STEPS, f"meshcards pp {name}: "
                      f"{step.replays} replays of {PP_STEPS} steps")
                shapes[name] = program_shape(step.graph)
            runs[name, replayed] = (outs, [t.cpu() for t in cache_tensors(
                [c for row in state.kv for c in row])], read(counters))
            del state, step
    check(shapes["cards"]["graphs"] > 1, f"meshcards pp: the stages over "
          f"the cards replayed {shapes['cards']}, not a CardGraph")
    (oc, kc, lc) = runs["cards", False]
    for key, (o, k, _) in runs.items():
        diff = max(float((a - b).abs().max()) for a, b in zip(oc, o))
        same_kv = all(bool(torch.equal(a, b)) for a, b in zip(kc, k))
        check(diff == 0.0 and same_kv, f"meshcards pp {key}: logits (max "
              f"|d| {diff}) or caches differ from the stages over the "
              "cards uncaptured")
    print(f"meshcards pp: one stage a card and all on cuda:0, uncaptured "
          f"and replayed ({PP_STEPS} steps): logits and caches bit-equal; "
          f"launches {lc}; a replay over the cards {shapes['cards']}",
          flush=True)
    cell = pp_replay_cell(torch, counters, "meshcards pp", cards_mesh, arch,
                          weights, bkv, len(PP_LENS), 2, pos0, tok,
                          cards=want)
    del bkv
    torch.cuda.empty_cache()
    return {"launches": lc, "max_abs_dlogit": 0.0, "program": shapes,
            "replay": cell}


def mesh_cards_phase(torch, counters, card: str, synth) -> dict | None:
    """One position a card, on a host with MESH_CARDS cards or more (on
    fewer it says so and returns None), against the same mesh on cuda:0,
    uncaptured and replayed (cards_vs_one for the engines): a small MoE
    GGUF through EPEngine.load(ep=4) (one expert shard a card; 32 greedy
    steps), repolm512 through CPEngine.load(cp=2, tp=2) (one (cp, tp)
    position a card; 32 greedy steps), the synthetic 8B Q8_0 of `full`
    (`synth`, all 32 layers) through the same (2, 2) mesh
    (a 512-token prompt, 16 steps) and through pp_decode_step at (4
    stages, 2 microbatches) (one stage a card; PP_STEPS steps fed the same
    tokens from the same prefilled cache, uncaptured and replayed by
    make_pp_decode, a CardGraph over the cards, against the stages on
    cuda:0 both ways; then pp_replay_cell over the cards: replays after a
    stalled card, busy shares, ms a step, graphs and hand-offs), and phase
    moe's synthetic Mixtral-8x7B Q4_K_M (all 32
    layers) through EPEngine over the cards (two experts a card) against
    its 4 shards on cuda:0 (a 128-token prompt, 16 greedy steps). Every
    kernel launches on its tensors' card, the cross-card copies are exact
    and the sums run in shard order on cuda:0, so tokens, logits and caches
    must be bit-equal."""
    import tempfile
    from ntransformer_tpu_torch.inference.engine import CPEngine, EPEngine
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.parallel.cp import make_cp_tp_mesh
    from ntransformer_tpu_torch.parallel.ep import make_ep_mesh
    n_cards = torch.cuda.device_count()
    if n_cards < MESH_CARDS:
        print(f"meshcards: {n_cards} card(s); one position a card needs "
              f"{MESH_CARDS}: not run", flush=True)
        return None
    want = [torch.device("cuda", i) for i in range(MESH_CARDS)]
    out = {"card": card, "cards": n_cards}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moe_q8_0.gguf")
        write_moe_gguf(path, "q8_0", "llama", 128, 192)
        cards = EPEngine.load(path, ep=MESH_CARDS, fuse=True)
        check(list(cards.mesh) == want, f"meshcards ep: mesh {cards.mesh}")
        one = EPEngine.load(path, ep=MESH_CARDS, device="cuda:0", fuse=True)
        ids = cards._encode(PROMPT)
        out["ep"] = cards_vs_one(torch, counters, "meshcards_ep", cards,
                                 one, ids, 32)
        del cards, one
    cards = CPEngine.load(REPOLM, cp=2, tp=2)
    check([d for row in cards.mesh for d in row] == want,
          f"meshcards cptp: mesh {cards.mesh}")
    one = CPEngine.load(REPOLM, cp=2, tp=2, device="cuda:0")
    ids = torch.randint(0, cards.arch.vocab_size, (300,),
                        generator=torch.Generator().manual_seed(47)).tolist()
    out["cptp"] = cards_vs_one(torch, counters, "meshcards_cptp", cards, one,
                               ids, 32)
    del cards, one
    cfg, arch, weights, _ = synth

    def model():
        return LoadedModel(cfg, arch, weights, None, None,
                           torch.device("cuda"))
    cards = CPEngine(model(), make_cp_tp_mesh(*CPTP_MESH))
    one = CPEngine(model(), make_cp_tp_mesh(*CPTP_MESH, ["cuda:0"] * 4))
    ids = torch.randint(0, arch.vocab_size, (512,),
                        generator=torch.Generator().manual_seed(49)).tolist()
    out["cptp_8b"] = cards_vs_one(torch, counters, "meshcards_cptp_8b",
                                  cards, one, ids, 16)
    del cards, one
    torch.cuda.empty_cache()
    out["pp"] = pp_cards_cell(torch, counters, synth)
    # Mixtral over the cards: EPEngine empties the expert planes it shards,
    # so each engine gets its own build (the same seed, the same weights)
    engines = []
    for devs in (None, ["cuda:0"] * MESH_CARDS):
        mcfg, march, mw, _ = build_mixtral(torch)
        engines.append(EPEngine(LoadedModel(mcfg, march, mw, None, None,
                                            torch.device("cuda")),
                                make_ep_mesh(MESH_CARDS, devs)))
        del mw
        torch.cuda.empty_cache()
    cards, one = engines
    check(list(cards.mesh) == want, f"meshcards ep_mixtral: mesh "
          f"{cards.mesh}")
    ids = torch.randint(3, march.vocab_size, (128,),
                        generator=torch.Generator().manual_seed(51)).tolist()
    out["ep_mixtral"] = cards_vs_one(torch, counters, "meshcards_ep_mixtral",
                                     cards, one, ids, 16)
    del cards, one, engines
    torch.cuda.empty_cache()
    print(json.dumps({"mesh_cards": {"card": card, "cards": n_cards}}),
          flush=True)
    return out


# ------------------------------------------------------ user-facing surfaces
HTTP_KERNELS = ("q4_k_matmul", "q6_k_matmul", "flash_attention",
                "batched_attention", "kv_update")
HTTP_B = 8
HTTP_CTX = 1024
HTTP_8B_ROOM = 8 << 30  # the 32-layer 8B GGUF (~5.3 GB) and slack
# ids the synthetic vocabulary's prompts draw from: plain <t{i}> pieces
HTTP_PIECES = (1000, 120000)


def http_call(port: int, path: str, body=None, timeout: float = 600.0):
    """(status, JSON body) of a GET (body None) or POST to the front end;
    an HTTP error gives its status and error body."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def http_stream(port: int, path: str, body: dict, timeout: float = 600.0,
                keep: int | None = None) -> dict:
    """A streamed request: its SSE pieces, whether [DONE] came, the seconds
    to the first piece and to the end (host clock, from the send). keep:
    close the connection after that many pieces (a client going away)."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    pieces, done, first = [], False, None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for line in resp:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                done = True
                break
            if first is None:
                first = time.perf_counter() - t0
            got = json.loads(payload)
            pieces.append(got["text"] if "text" in got
                          else got["delta"]["content"])
            if keep is not None and len(pieces) >= keep:
                break
    return {"pieces": pieces, "done": done, "ttft_s": first,
            "total_s": time.perf_counter() - t0}


def piece_prompt(g, n: int) -> tuple[str, list[int]]:
    """A prompt of n pieces of the synthetic vocabulary: its text and ids
    (none of the named chat ids)."""
    ids = []
    while len(ids) < n:
        i = int(g.integers(*HTTP_PIECES))
        if i not in LLAMA3_CHAT_IDS:
            ids.append(i)
    return "".join(f"<t{i}>" for i in ids), ids


def http_load(fe, n_clients: int, spacing_s: float, prompts, max_tokens: int
              ) -> dict:
    """n_clients streamed completions arriving together (spacing 0) or one
    every spacing_s: each client's time to its first token and the served
    tokens per second (completion tokens over the wall from the first send
    to the last finish), host clock."""
    res = [None] * n_clients
    t0 = time.perf_counter()

    def client(i):
        time.sleep(max(0.0, i * spacing_s - (time.perf_counter() - t0)))
        res[i] = http_stream(fe.port, "/v1/completions",
                             {"prompt": prompts[i % len(prompts)],
                              "max_tokens": max_tokens})

    with ThreadPoolExecutor(n_clients) as ex:
        list(ex.map(client, range(n_clients)))
    wall = time.perf_counter() - t0
    check(all(r["done"] and len(r["pieces"]) == max_tokens for r in res),
          f"http load {n_clients}@{spacing_s}s: a stream ended short")
    ttft = sorted(r["ttft_s"] for r in res)
    return {"clients": n_clients, "spacing_s": spacing_s,
            "max_tokens": max_tokens, "wall_s": wall,
            "served_tok_s": n_clients * max_tokens / wall,
            "ttft_p50_s": ttft[len(ttft) // 2],
            "ttft_p90_s": ttft[int(len(ttft) * 0.9)],
            "ttft_max_s": ttft[-1]}


def http_8b(torch, counters, card: str, model=None) -> tuple[dict, dict]:
    """The synthetic Llama-3.1-8B Q4_K_M with Llama-3's chat tokens and
    template, 32 layers, resident and fused, served by BatchServer(B = 8)
    behind HttpFrontend(port=0): /health, /stats, 400 and 404; 8 concurrent
    greedy completions and 8 concurrent chat completions against
    BatchServer.run of the same requests (every slot's tokens equal: the
    kernels' launch plans and split counts depend on the shapes and the
    batch width, not on which slots are live, so a request's rows do not
    depend on its neighbours); streamed pieces equal to the text; a client
    that goes away frees its slot; time to first token and served tok/s
    with 8 and 32 clients arriving together and spaced. Returns (summary,
    the launch counts of all the HTTP traffic). model: that 8B as phase
    tiered loaded it (unfused; fused here), else it is written and
    loaded here."""
    import shutil
    import tempfile
    import threading
    import numpy as np
    from ntransformer_tpu_torch.inference.chat import LLAMA3, encode_chat
    from ntransformer_tpu_torch.inference.http_server import HttpFrontend
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import load_model
    out = {"card": card}
    if model is not None:
        import dataclasses
        from ntransformer_tpu_torch.models.llama import fuse_layer_weights
        check(model.arch.max_seq_len == HTTP_CTX, "http: the 8B from phase "
              f"tiered has ctx {model.arch.max_seq_len}, not {HTTP_CTX}")
        model = dataclasses.replace(model, weights=dataclasses.replace(
            model.weights, layers=fuse_layer_weights(model.weights.layers)))
        out["from_phase_tiered"] = True
    else:
        base = next((d for d in (tempfile.gettempdir(), HERE)
                     if shutil.disk_usage(d).free >= HTTP_8B_ROOM), None)
        check(base is not None, f"http: no directory with "
              f"{HTTP_8B_ROOM >> 30} GiB free for the 8B GGUF")
        with tempfile.TemporaryDirectory(dir=base) as tmp:
            path = os.path.join(tmp, "llama8b_chat_q4_k_m.gguf")
            t0 = time.perf_counter()
            write_q4km_8b(path, 32, chat="llama3")
            out["gguf_write_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            model = load_model(path, max_seq_len=HTTP_CTX, device="cuda",
                               fuse=True)
            out["load_s"] = time.perf_counter() - t0
    tok = model.tokenizer
    g = np.random.default_rng(15)
    lens = [300, 12, 150, 40, 230, 7, 90, 64]
    prompts, pids = zip(*(piece_prompt(g, n) for n in lens))
    for p, ids in zip(prompts, pids):
        check(tok.encode(p, add_bos=True) == [tok.bos_id] + ids,
              "http: a prompt of vocabulary pieces does not encode to its "
              "pieces' ids")
    chats = []
    for i, n in enumerate((20, 60, 5, 120, 33, 8, 77, 2)):
        msgs = [{"role": "user", "content": piece_prompt(g, n)[0]}]
        if i % 2:
            msgs.insert(0, {"role": "system",
                            "content": piece_prompt(g, 9)[0]})
        chats.append(msgs)
    fmt_ids = [encode_chat(tok, LLAMA3, m) for m in chats]
    check(all(ids[:2] == [128000, 128006] and ids[-4:] == [128006, 78191,
                                                           128007, 271]
              for ids in fmt_ids),
          "http: the chat messages do not render through Llama-3's ids")
    n_tok = 16
    greedy = SamplerConfig(temperature=0.0)
    ref = BatchServer(model, batch_size=HTTP_B, sampler_cfg=greedy)
    ref.warmup()
    want = [Request(prompt=p, max_tokens=n_tok) for p in prompts]
    ref.run(want)
    want_chat = [Request(prompt="", max_tokens=n_tok, prompt_ids=list(ids))
                 for ids in fmt_ids]
    ref.run(want_chat)
    del ref
    srv = BatchServer(model, batch_size=HTTP_B, sampler_cfg=greedy)
    # the counts include the warmup, which captures the steps the HTTP
    # traffic replays (replays advance no counter)
    reset(counters)
    out["warmup_s"] = srv.warmup()  # before the serving thread starts
    fe = HttpFrontend(srv, port=0, request_timeout_s=600.0)
    fe.start()
    try:
        st, health = http_call(fe.port, "/health")
        check(st == 200 and health["chat_format"] == "llama3"
              and health["slots"] == HTTP_B, f"http /health: {st} {health}")
        for path_, body, code in (
                ("/v1/completions", {"prompt": 7}, 400),
                ("/v1/completions", [1], 400),
                ("/v1/chat/completions", {"messages": []}, 400),
                ("/v1/chat/completions",
                 {"messages": [{"role": "user<|eot_id|>", "content": "x"}]},
                 400),
                ("/v1/nope", {"prompt": "x"}, 404), ("/nope", None, 404)):
            st, _ = http_call(fe.port, path_, body)
            check(st == code, f"http {path_} {body!r}: {st}, want {code}")

        def together(path_, bodies):
            with ThreadPoolExecutor(len(bodies)) as ex:
                return list(ex.map(lambda b: http_call(fe.port, path_, b),
                                   bodies))

        got = together("/v1/completions", [{"prompt": p, "max_tokens": n_tok}
                                           for p in prompts])
        got_chat = together("/v1/chat/completions",
                            [{"messages": m, "max_tokens": n_tok}
                             for m in chats])
        texts = [b["choices"][0]["text"] for _, b in got]
        ctexts = [b["choices"][0]["message"]["content"] for _, b in got_chat]
        check(all(st == 200 for st, _ in got + got_chat),
              "http: a concurrent request failed")
        partings = sum(a != r.text for a, r in zip(texts, want)) + sum(
            a != r.text for a, r in zip(ctexts, want_chat))
        print(f"http 8b: {len(texts)} completions and {len(ctexts)} chat "
              f"completions over HTTP against BatchServer.run: {partings} "
              f"part", flush=True)
        check(partings == 0, "http 8b: a greedy text served over HTTP "
              "differs from BatchServer.run's on the same weights")
        check(all(b["usage"]["prompt_tokens"] == len(ids) for (_, b), ids in
                  zip(got_chat, fmt_ids)), "http: chat usage prompt_tokens")
        s = http_stream(fe.port, "/v1/chat/completions",
                        {"messages": chats[3], "max_tokens": n_tok})
        check(s["done"] and "".join(s["pieces"]) == ctexts[3],
              "http: the streamed pieces differ from the text")
        # a client that goes away after 4 pieces: its slot frees
        before = srv.snapshot()["tokens"]
        http_stream(fe.port, "/v1/completions",
                    {"prompt": prompts[1], "max_tokens": 600}, keep=4)
        t0 = time.perf_counter()
        while (srv.snapshot()["slots_active"]
               and time.perf_counter() - t0 < 120):
            time.sleep(0.05)
        snap = srv.snapshot()
        served = snap["tokens"] - before
        check(snap["slots_active"] == 0 and served < 600,
              f"http: the abandoned stream kept its slot ({snap}, "
              f"{served} tokens)")
        out["cancelled_after_tokens"] = served
        load = {}
        for n_clients in (8, 32):
            for spacing in (0.0, 0.1):
                key = f"{n_clients}_clients_" + (
                    "together" if not spacing else f"every_{spacing}s")
                load[key] = http_load(fe, n_clients, spacing, prompts, 32)
                print(json.dumps({f"http_8b_{key}": load[key]}), flush=True)
        st, stats = http_call(fe.port, "/stats")
        check(st == 200 and stats["running"], f"http /stats: {stats}")
        torch.cuda.synchronize()
        launches = read(counters)
    finally:
        fe.stop()
    check(not any(t.name in ("nt-serve-loop", "nt-http") and t.is_alive()
                  for t in threading.enumerate()),
          "http: a front-end thread outlived stop()")
    print(f"http 8b launches {launches}", flush=True)
    check(all(launches[k] > 0 for k in HTTP_KERNELS),
          f"http 8b: the HTTP path launched a kernel zero times: {launches}")
    out.update(load=load, stats=stats, launches=launches)
    del srv, model
    torch.cuda.empty_cache()
    return out, launches


def forced_logits(torch, eng, kv, ids, start: int, toks) -> list:
    """The logits [V] (f32, CPU) of a prefill of ids[start:] into kv and of
    each decode step fed toks."""
    logits, kv, _ = eng._prefill(kv, ids, start=start)
    out = [logits[0].float().cpu()]
    for i, t in enumerate(toks[:-1]):
        logits, kv, _ = eng._decode_step(kv, t, len(ids) + i)
        out.append(logits[0].float().cpu())
    return out


def chat_turns(eng, cfg, turns) -> tuple[list, list]:
    """Engine.chat over scripted turns: (printed texts, per turn (prompt
    ids, prefilled tokens, generated ids))."""
    printed, calls = [], []
    real = eng.generate
    eng.tokenizer = TokenRecorder(eng.tokenizer)

    def spy(prompt, cfg=None, callback=None, *, prompt_ids=None,
            session=None):
        text, stats = real(prompt, cfg, callback, prompt_ids=prompt_ids,
                           session=session)
        calls.append((list(prompt_ids or []), stats.prefill_tokens,
                      eng.tokenizer.ids))
        return text, stats
    eng.generate = spy
    lines = iter(list(turns) + [""])
    try:
        eng.chat(cfg, input_fn=lambda _: next(lines),
                 print_fn=printed.append)
    finally:
        del eng.generate
        eng.tokenizer = eng.tokenizer.tok
    return [p for p in printed[1:] if not p.endswith("tok/s]")], calls


def http_repolm(torch, counters, card: str, tmp: str) -> tuple[dict, dict]:
    """repolm512 on the card: a copy with a Llama-3 chat template written by
    the port's requant tool (every matrix kept); Engine.chat over two
    scripted turns (the second prefills only its new tokens; its tokens
    against a fresh generate of the whole history: teacher-forced logits of
    the two within max(REAL_LOGIT_RTOL, 2 c), c the fresh run on the card
    against the CPU, and where the tokens part a top-2 margin at most twice
    that step's difference); the api's nt_engine_* (greedy text equal to
    Engine.generate's, streaming=True equal to the resident text, the
    property calls); a template-less model's 501; the CLI's --http 0 in a
    subprocess (one POST, SIGINT, drain, exit 0) and --chat with two lines
    on stdin. Returns (summary, Engine.chat's launch counts)."""
    import io
    import shutil
    import signal
    from ntransformer_tpu_torch import api, cli
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.inference.engine import (ChatSession, Engine,
                                                         GenerateConfig)
    from ntransformer_tpu_torch.inference.http_server import HttpFrontend
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.tools.requant_gguf import requant
    out = {"card": card}
    chat_path = os.path.join(tmp, "repolm512_chat.gguf")
    requant(REPOLM, chat_path, lambda _name: DType.Q8_0,
            progress=lambda _msg: None,
            metadata={"tokenizer.chat_template": LLAMA3_TEMPLATE})
    cfg = GenerateConfig(max_tokens=12, temperature=0.0, repeat_penalty=1.0)
    turns = ["def rms_norm(x, weight, eps):", "and the rope table?"]
    eng = Engine.load(chat_path, device="cuda", fuse=True)
    reset(counters)
    texts, calls = chat_turns(eng, cfg, turns)
    torch.cuda.synchronize()
    chat_launches = read(counters)
    print(f"chat on {card}: {texts!r}; launches {chat_launches}", flush=True)
    check(all(chat_launches[k] > 0 for k in ENGINE_KERNELS),
          f"Engine.chat launched a kernel zero times: {chat_launches}")
    (ids1, pre1, _), (ids2, pre2, got2) = calls
    check(ids2[:len(ids1)] == ids1 and pre1 == len(ids1)
          and 0 < pre2 <= len(ids2) - len(ids1),
          f"chat turn 2 prefilled {pre2} of {len(ids2)} tokens (turn 1: "
          f"{len(ids1)})")
    # the second turn against a fresh generate of the whole history
    eng.tokenizer = TokenRecorder(eng.tokenizer)
    try:
        eng.generate("", cfg, prompt_ids=ids2)
        fresh = eng.tokenizer.ids
    finally:
        eng.tokenizer = eng.tokenizer.tok
    session = ChatSession()
    eng.generate("", cfg, prompt_ids=ids1, session=session)
    n = 0
    while (n < len(session.ids_in_kv) and n < len(ids2) - 1
           and session.ids_in_kv[n] == ids2[n]):
        n += 1
    check(n >= len(ids1), "chat: the session does not cover turn 1")
    cpu = Engine.load(chat_path, device="cpu", fuse=True)
    sess = forced_logits(torch, eng, session.kv, ids2, n, fresh)
    full = forced_logits(torch, eng, eng._make_kv(), ids2, 0, fresh)
    ref = forced_logits(torch, cpu, cpu._make_kv(), ids2, 0, fresh)
    d = [rel_err(a, b) for a, b in zip(sess, full)]
    c = [rel_err(a, b) for a, b in zip(full, ref)]
    for i, (di, ci) in enumerate(zip(d, c)):
        check(di <= max(REAL_LOGIT_RTOL, 2 * ci), f"chat turn 2 step {i}: "
              f"the session's logits differ from a fresh prefill's by {di} "
              f"of their range (> max({REAL_LOGIT_RTOL}, 2 * {ci}))")
    part = next((i for i, (a, b) in enumerate(zip(got2, fresh)) if a != b),
                None)
    if part is not None:
        top = torch.topk(full[part], 2).values
        margin = float((top[0] - top[1]) / full[part].abs().max())
        print(f"chat turn 2 leaves the fresh tokens at step {part}: top-2 "
              f"margin {margin:.5f}, difference {d[part]:.5f}", flush=True)
        check(margin <= 2 * d[part], f"chat turn 2 step {part}: the tokens "
              f"part at a top-2 margin of {margin} (> 2 * {d[part]})")
    out["chat"] = {"texts": texts, "turn2_prefill": pre2,
                   "turn2_prompt": len(ids2), "session_vs_fresh": d,
                   "fresh_vs_cpu": c, "parting_step": part}
    print(json.dumps({"chat_repolm512": out["chat"]}), flush=True)
    del cpu

    # the C-shaped API
    prompt = "def rms_norm(x, weight, eps):\n"
    want, _ = Engine.load(REPOLM, max_seq_len=512, device="cuda").generate(
        prompt, GenerateConfig(max_tokens=16, temperature=0.0))
    api_texts = {}
    for streaming in (False, True):
        path = REPOLM
        if streaming:  # the tiered loader writes its pack beside the model
            path = os.path.join(tmp, "repolm512_api.gguf")
            shutil.copy(REPOLM, path)
        h = api.nt_engine_create()
        check(api.nt_engine_load(h, path, max_ctx=512, streaming=streaming)
              == api.NT_OK, f"api load (streaming={streaming}) failed")
        check((api.nt_engine_vocab_size(h), api.nt_engine_n_layers(h),
               api.nt_engine_hidden_size(h)) == (384, 6, 512),
              "api: repolm512's properties")
        api_texts[streaming] = api.nt_engine_generate(h, prompt, 16, 0.0)
        api.nt_engine_destroy(h)
    check(api_texts[False] == want, f"api text {api_texts[False]!r} differs "
          f"from Engine.generate's {want!r}")
    check(api_texts[True] == want, f"api streaming text {api_texts[True]!r} "
          f"differs from the resident {want!r}")
    out["api_text"] = want

    # a model without a template answers the chat endpoint 501
    srv = BatchServer(load_model(REPOLM, device="cuda"), batch_size=2)
    srv.warmup()
    fe = HttpFrontend(srv, port=0)
    fe.start()
    try:
        st, body = http_call(fe.port, "/v1/chat/completions",
                             {"messages": [{"role": "user", "content": "x"}]})
    finally:
        fe.stop()
    check(st == 501, f"http chat without a template: {st} {body}")

    # the CLI: --http 0 in its own process, then --chat on two stdin lines
    srv = BatchServer(load_model(REPOLM, device="cuda", fuse=True),
                      batch_size=8, sampler_cfg=SamplerConfig(temperature=0))
    r = Request(prompt=prompt, max_tokens=16)
    srv.run([r])
    del srv
    proc = subprocess.Popen(
        [sys.executable, "-m", "ntransformer_tpu_torch", "-m", REPOLM,
         "-t", "0", "--http", "0", "--batch-size", "8"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE))
    try:
        line = proc.stdout.readline()
        check(line.startswith("listening on http://127.0.0.1:"),
              f"cli --http printed {line!r}")
        port = int(line.split(":")[2].split(" ")[0])
        st, body = http_call(port, "/v1/completions",
                             {"prompt": prompt, "max_tokens": 16})
        proc.send_signal(signal.SIGINT)
        rest, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0 and "draining" in rest,
          f"cli --http: exit {proc.returncode} after SIGINT: {err[-2000:]}")
    check(st == 200 and body["choices"][0]["text"] == r.text,
          f"cli --http answered {st} {body}, want {r.text!r}")
    buf = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("\n".join(turns) + "\n\n")
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-m", chat_path, "--chat", "-n", "12", "-t", "0",
                           "--repeat-penalty", "1.0", "--device", "cuda"])
    finally:
        sys.stdin = stdin
    # input() writes its "> " prompt to stdout, ahead of each reply
    lines = buf.getvalue().splitlines()
    replies = [ln.removeprefix("> ") for ln in lines[1:]
               if not ln.endswith("tok/s]") and ln != "> "]
    check(rc == 0 and "llama3 template" in lines[0] and replies == texts,
          f"cli --chat: exit {rc}, printed {lines!r}, want {texts!r}")
    out["cli_http_text"] = r.text
    return out, chat_launches


def http_phase(torch, counters, card: str, model=None
               ) -> tuple[dict, dict, dict]:
    """The user-facing surfaces: the 8B over HTTP (model: phase tiered's
    resident 8B), then repolm512's chat, API and CLI modes. Returns
    (summary, HTTP launches, chat launches)."""
    import tempfile
    t0 = time.perf_counter()
    out = {}
    out["8b"], http_launches = http_8b(torch, counters, card, model)
    with tempfile.TemporaryDirectory() as tmp:
        out["repolm512"], chat_launches = http_repolm(torch, counters, card,
                                                      tmp)
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"http": out}), flush=True)
    return out, http_launches, chat_launches


# quality: card against CPU nll per token (a mean over 254 tokens): the
# Q8_0, K-quant and bf16-cache paths differ only by rounding; W8A8 and
# W4A8 quantize activations, where an order difference moves a whole int8
# step. The smallest quality-gate budget is 0.02.
QUALITY_NLL_TOL = {"plain": 5e-3, "act": 2e-2}
QUALITY_KERNELS = ("q8_0_matmul", "q4_k_matmul", "q6_k_matmul",
                   "q4_0_matmul", "flash_attention", "w8a8_matmul",
                   "w4a8_decode", "w4a8_matmul")


QUALITY_CTX, QUALITY_WINDOWS = 128, 2


def quality_ids() -> list[int]:
    """The README's first QUALITY_WINDOWS * QUALITY_CTX ids, the text phase
    quality's perplexities read."""
    from ntransformer_tpu_torch.models.loader import load_model
    tok = load_model(REPOLM, device="cpu", n_layers=1).tokenizer
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        return tok.encode(f.read(), add_bos=True)[
            : QUALITY_WINDOWS * QUALITY_CTX]


def prep_quality(tmp: str) -> dict:
    """(worker) Phase quality's host side: repolm512's Q6_K, Q4_K_M and
    Q4_0 requants written to tmp (the port's requant tool) and every row's
    CPU nll in prefill and decode modes. Returns {"rows": [(tag, path,
    load kwargs)], "cpu_nll": {(tag, mode): nll}, "seconds": s}."""
    import torch
    from ntransformer_tpu_torch.core.dtypes import DType
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.models.presets import q4_k_m_policy
    from ntransformer_tpu_torch.tools.perplexity import perplexity
    from ntransformer_tpu_torch.tools.requant_gguf import requant
    torch.set_num_threads(2)  # beside the compilers
    t0 = time.perf_counter()
    files = {"q8_0": REPOLM}
    for tag, target in (("q6_k", DType.Q6_K), ("q4_k_m", q4_k_m_policy),
                        ("q4_0", DType.Q4_0)):
        files[tag] = os.path.join(tmp, f"repolm512_{tag}.gguf")
        requant(REPOLM, files[tag], target, progress=lambda _msg: None)
    rows = [(tag, path, {}) for tag, path in files.items()]
    rows += [("w8a8", REPOLM, {"w8a8": True}),
             ("w4a8", REPOLM, {"w4a8": True})]
    ids = quality_ids()
    cpu_nll = {}
    for tag, path, kw in rows:
        model = load_model(path, device="cpu", **kw)
        for mode in ("prefill", "decode"):
            cpu_nll[tag, mode] = perplexity(model, ids, QUALITY_CTX,
                                            mode=mode)["nll_per_token"]
        del model
    return {"rows": rows, "cpu_nll": cpu_nll,
            "seconds": time.perf_counter() - t0}


def quality_phase(torch, counters, card: str, pre: dict
                  ) -> tuple[dict, dict]:
    """The quality tools on repolm512 on the card: perplexity in prefill and
    decode modes (ctx 128, 2 windows of the README) for the file (Q8_0),
    its Q6_K, Q4_K_M and Q4_0 requants (the port's requant tool) and the
    file with --w8a8 and --w4a8 at load, each nll beside the same run on
    the CPU within QUALITY_NLL_TOL (the requants and the CPU runs are
    prep_quality's, made beside the kernels' build); then the quality gate
    at ctx 256, 2 windows with every PPL_BUDGET row (fresh fixtures; it
    must pass) and against the committed fixture (the verdict and any
    failed sub-check printed). Returns
    (summary, the launch counts of the card's perplexity and gate runs)."""
    import tempfile
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.tools import quality_gate as gate
    from ntransformer_tpu_torch.tools.perplexity import perplexity
    t_phase = time.perf_counter()
    readme = os.path.join(HERE, "README.md")
    ctx = QUALITY_CTX
    out = {"card": card, "ctx": ctx, "windows": QUALITY_WINDOWS,
           "rows": [], "cpu_side_s": pre["seconds"]}
    ids = quality_ids()
    reset(counters)
    card_nll = {}
    for tag, path, kw in pre["rows"]:
        model = load_model(path, device="cuda", **kw)
        for mode in ("prefill", "decode"):
            t0 = time.perf_counter()
            r = perplexity(model, ids, ctx, mode=mode)
            card_nll[tag, mode] = (r["nll_per_token"],
                                   time.perf_counter() - t0)
        del model
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fx = os.path.join(tmp, "fixtures.json")
        res = gate.run_gate(REPOLM, readme, list(gate.PPL_BUDGET), fx, True,
                            ctx=256, windows=2, device="cuda")
        gate_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read(counters)
    for tag, path, kw in pre["rows"]:
        for mode in ("prefill", "decode"):
            cpu = pre["cpu_nll"][tag, mode]
            nll, secs = card_nll[tag, mode]
            lim = QUALITY_NLL_TOL["act" if kw else "plain"]
            row = {"row": tag, "mode": mode, "nll_card": nll,
                   "nll_cpu": cpu, "diff": abs(nll - cpu), "limit": lim,
                   "card_s": secs}
            print(json.dumps({"ppl": row}), flush=True)
            out["rows"].append(row)
            check(abs(nll - cpu) <= lim, f"ppl {tag} {mode}: the card's "
                  f"nll {nll} differs from the CPU's {cpu} by more than "
                  f"{lim}")
    print(f"quality gate on {card} ({gate_s:.1f} s): pass {res['pass']}, "
          f"failed {res['failed']}, ppl {res['checks']['ppl']}, goldens "
          f"logit_rel_err {res['checks']['goldens']['logit_rel_err']}",
          flush=True)
    check(res["pass"], f"quality gate failed: {res['failed']}: "
          f"{[res['checks'][c].get('errors') for c in res['failed']]}")
    committed = REPOLM + ".quality.json"
    old = gate.run_gate(REPOLM, readme, [], committed, False, ctx=256,
                        windows=2, device="cuda")
    print(f"quality gate against the committed fixture {committed}: pass "
          f"{old['pass']}, failed sub-checks {old['failed']}: "
          f"{[old['checks'][c].get('errors') for c in old['failed']]}",
          flush=True)
    print(f"quality launches {launches}", flush=True)
    check(all(launches[k] > 0 for k in QUALITY_KERNELS),
          f"quality: a kernel of the path launched zero times: {launches}")
    out.update(gate={"pass": res["pass"], "failed": res["failed"],
                     "ppl": res["checks"]["ppl"], "seconds": gate_s,
                     "logit_rel_err":
                         res["checks"]["goldens"]["logit_rel_err"]},
               committed_fixture={"pass": old["pass"],
                                  "failed": old["failed"]},
               launches=launches, phase_s=time.perf_counter() - t_phase)
    print(json.dumps({"quality": out}), flush=True)
    return out, launches


# ------------------------------------------------------------------- main
# ------------------------------------------ host set-up beside the build
# The phases' set-up that needs no card runs in worker processes beside the
# build and the phases before the one that takes it: the tiered phases'
# GGUFs with their packs (the loaders find a pack whose key matches and build
# none) and phase quality's requants and CPU perplexities. The build (about
# a minute, its translation units in parallel) is shorter than the quality
# set-up, and the phases run on the card while the workers use the host's
# idle cores.


def prep_gguf(kind: str, path: str, n_layers: int, chat: str | None
              ) -> dict:
    """(worker) Write a tiered phase's GGUF of n_layers to path ("8b":
    write_q4km_8b; "mixtral": write_mixtral_q4km) and build its pack beside
    it. Returns the seconds of each."""
    from ntransformer_tpu_torch.core.gguf import GGUFReader
    from ntransformer_tpu_torch.memory.pack import ensure_pack
    t0 = time.perf_counter()
    if kind == "8b":
        write_q4km_8b(path, n_layers, chat=chat)
    else:
        write_mixtral_q4km(path, n_layers)
    t1 = time.perf_counter()
    ensure_pack(GGUFReader(path), path)
    return {"gguf_write_s": t1 - t0, "pack_write_s": time.perf_counter() - t1}


def start_prep(phases) -> tuple:
    """Start the host set-up of the selected phases in worker processes.
    The tiered GGUFs go to the first of the temp directory and the repo's
    root with the room of both; without it the 8B is cut to 16 layers
    (half its room). Every directory made here is removed at exit. Returns
    (executor, {job: (future, info)})."""
    import atexit
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    def scratch(base=None) -> str:
        d = tempfile.mkdtemp(dir=base)
        atexit.register(shutil.rmtree, d, True)
        return d

    def room_for(need: int):
        return next((d for d in (tempfile.gettempdir(), HERE)
                     if shutil.disk_usage(d).free >= need), None)
    files = {}  # kind: [n_layers, room, file name, chat]
    if "tiered" in phases:
        files["8b"] = [32, TIERED_8B_ROOM, "llama8b_q4_k_m.gguf",
                       "llama3" if "http" in phases else None]
    if "moe" in phases:
        files["mixtral"] = [MOE_TIERED_LAYERS, MOE_TIERED_ROOM,
                            "mixtral_q4_k_m.gguf", None]
    base = room_for(sum(f[1] for f in files.values()))
    if base is None and "8b" in files:
        files["8b"][:2] = [16, TIERED_8B_ROOM // 2]
        files["8b"][3] = None  # phase http loads the 32-layer 8B itself
        print(f"tiered 8b: less than {TIERED_8B_ROOM >> 30} GiB free; cut "
              f"to 16 layers at (4, 8, 4)", flush=True)
        base = room_for(sum(f[1] for f in files.values()))
    check(base is not None or not files, f"no directory with "
          f"{sum(f[1] for f in files.values()) >> 30} GiB free")
    ex = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context(
        "spawn"))
    jobs = {}
    for kind, (n_layers, _, name, chat) in files.items():
        d = scratch(base)
        info = {"dir": d, "path": os.path.join(d, name), "layers": n_layers,
                "chat": chat}
        jobs[kind] = (ex.submit(prep_gguf, kind, info["path"], n_layers,
                                chat), info)
    if "quality" in phases:
        d = scratch()
        jobs["quality"] = (ex.submit(prep_quality, d), {"dir": d})
    return ex, jobs


class Prep:
    """start_prep's jobs, each waited for where a phase first takes its
    result (`pre[name]`: the job's info with its results), so the workers
    run on beside the phases that need none of them; `close` stops the
    workers."""

    def __init__(self, ex, jobs):
        self.ex, self.jobs, self.done = ex, jobs, {}

    def __getitem__(self, name: str) -> dict:
        if name not in self.done:
            fut, info = self.jobs[name]
            t0 = time.perf_counter()
            info.update(fut.result())
            secs = info.get("seconds", info.get("gguf_write_s", 0)
                            + info.get("pack_write_s", 0))
            print(f"host set-up {name}: {secs:.1f} s in its worker; waited "
                  f"{time.perf_counter() - t0:.1f} s for it", flush=True)
            self.done[name] = info
        return self.done[name]

    def close(self) -> None:
        self.ex.shutdown()


class DotCounter:
    """The launch count of one cache-dot form of batched flash, read and
    reset like a wrapper module's `launches`."""

    def __init__(self, mod, dot: str):
        self.mod, self.dot = mod, dot

    @property
    def launches(self) -> int:
        return self.mod.launches_by_dot[self.dot]

    @launches.setter
    def launches(self, value: int):
        self.mod.launches_by_dot[self.dot] = value


class ModuleCounter:
    """A wrapper module's second launch count (`attr`), read and reset like
    its `launches`."""

    def __init__(self, mod, attr: str):
        self.mod, self.attr = mod, attr

    @property
    def launches(self) -> int:
        return getattr(self.mod, self.attr)

    @launches.setter
    def launches(self, value: int):
        setattr(self.mod, self.attr, value)


def reset(counters):
    for mod in counters.values():
        mod.launches = 0


def read(counters) -> dict:
    return {name: mod.launches for name, mod in counters.items()}


def main() -> int:
    t_main = time.perf_counter()

    def clock(name: str):
        """The script's seconds so far, as a phase starts."""
        print(f"[{time.perf_counter() - t_main:.1f} s] phase {name}",
              flush=True)

    if not os.path.exists(os.path.join(HERE, "ntransformer_tpu_torch",
                                       "__init__.py")):
        fail("run chip_smoke.py from the root of the repository: "
             "ntransformer_tpu_torch/ is not beside it")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ntransformer_tpu_torch.ops.cuda import attention as ca
    from ntransformer_tpu_torch.ops.cuda import batched_attention as cb
    from ntransformer_tpu_torch.ops.cuda import build
    from ntransformer_tpu_torch.ops.cuda import kv_update as ck
    from ntransformer_tpu_torch.ops.cuda import matmul as cm
    from ntransformer_tpu_torch.ops.cuda import nibble_matmul as cn
    from ntransformer_tpu_torch.ops.cuda import w4a8 as cw4
    from ntransformer_tpu_torch.ops.cuda import w8a8 as cw8
    argv = sys.argv[1:]
    cut_layers = CUT_LAYERS
    if "--cut-layers" in argv:  # e.g. 32: the mesh phases at full depth
        i = argv.index("--cut-layers")
        cut_layers = int(argv[i + 1])
        del argv[i:i + 2]
    phases = argv[0].split(",") if argv else list(PHASES)
    if "ep" in phases and "moe" not in phases:
        phases.append("moe")  # phase ep runs on phase moe's Mixtral
    prep = start_prep(phases)
    t0 = time.perf_counter()
    mods = (cm, ca, cb, ck, cw8, cw4, cn)
    from ntransformer_tpu_torch.memory import native
    with ThreadPoolExecutor(len(mods) + 2) as ex:  # one compiler per source
        host = ex.submit(native.build)
        reports = list(ex.map(build.build,
                              [m.NAME for m in mods] + [cn.KQ_NAME]))
        host.result()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    pre = Prep(*prep)
    for rep in reports:
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                print("  " + line.split("'")[1][:90], flush=True)
            elif "registers" in line or "spill" in line:
                print("    " + line.strip(), flush=True)
    counters = {m.NAME: m for m in mods[:6]}
    counters.update({k.name: k for k in cn.KERNELS.values()})
    counters.update({f"{cb.NAME}[{d}]": DotCounter(cb, d)
                     for d in DOT_FORMS})
    counters[ca.PARTIALS_NAME] = ModuleCounter(ca, "partials_launches")

    timer = Timer(torch)
    res = {}
    if "kernels" in phases:
        clock("kernels")
        res[cm.NAME], res[ca.NAME] = kernel_phase(torch, timer, card)
    if "bkernels" in phases:
        clock("bkernels")
        res[cb.NAME], res[ck.NAME] = batched_kernel_phase(torch, timer, card)
        res.update(dot_kernel_phase(torch, timer, card))
    if "qkernels" in phases:
        clock("qkernels")
        res.update(nibble_kernel_phase(torch, timer, card))
    if "wkernels" in phases:
        clock("wkernels")
        res.update(wformat_kernel_phase(torch, timer, card))
    if "cp" in phases:
        clock("cp")
        res[ca.PARTIALS_NAME] = cp_kernel_phase(torch, timer, card)
    if "real" in phases:
        clock("real")
        real_model_phase(torch, counters, card)
    dot_launches = {}
    if "serve" in phases:
        clock("serve")
        got = real_serve_phase(torch, counters, card, dot_forms=True)
        dot_launches = {f"{cb.NAME}[{d}]": got["dot_launches"][d]
                        for d in DOT_FORMS}
    engine_launches, launches, spec_launches, tp_launches = {}, {}, {}, {}
    dp_launches, pp_launches, cptp_launches = {}, {}, {}
    if {"full", "bfull", "graphs", "cp", "tp", "tpcards", "dp", "dpcards",
            "pp", "cptp", "meshcards", "cpcards", "spec"} & set(phases):
        synth = build_synth(torch)
        if "full" in phases:
            clock("full")
            _, engine_launches = full_width_phase(torch, counters, card,
                                                  synth)
        if "bfull" in phases:
            clock("bfull")
            summary, launches = full_batched_phase(torch, counters, card,
                                                   synth, dot_forms=True)
            print(json.dumps({"full_width_8b_serving": summary}), flush=True)
        if "graphs" in phases:
            clock("graphs")
            graphs_phase(torch, counters, card,
                         depth_cut(synth, cut_layers), "8b_q8_0")
        cut_synth = depth_cut(synth, cut_layers)
        if "cp" in phases:
            clock("cp")
            _, got = cp_path_phase(torch, counters, card, cut_synth)
            launches[ca.PARTIALS_NAME] = got[ca.PARTIALS_NAME]
            engine_launches[ca.PARTIALS_NAME] = got[ca.PARTIALS_NAME]
        if "tp" in phases:
            clock("tp")
            _, tp_launches = tp_path_phase(torch, counters, card,
                                            cut_synth)
        if "tpcards" in phases:
            clock("tpcards")
            tp_cards_phase(torch, counters, card, synth)
        if "dp" in phases:
            clock("dp")
            _, dp_launches = dp_path_phase(torch, counters, card,
                                            cut_synth)
        if "dpcards" in phases:
            clock("dpcards")
            dp_cards_phase(torch, counters, card, synth)
        if "pp" in phases:
            clock("pp")
            _, pp_launches = pp_phase(torch, counters, card, cut_synth)
        if "cptp" in phases:
            clock("cptp")
            _, cptp_launches = cptp_phase(torch, counters, card,
                                            cut_synth)
        if "meshcards" in phases:
            clock("meshcards")
            mesh_cards_phase(torch, counters, card, synth)
        if "cpcards" in phases:
            clock("cpcards")
            cp_cards_phase(torch, counters, card, synth)
        if "spec" in phases:
            clock("spec")
            _, spec_launches = spec_phase(torch, counters, timer, card,
                                          synth)
        del synth, cut_synth
    # each nibble kernel's main path: the 8B Q4_K_M server for Q4_K and
    # Q6_K (Engine.benchmark beside it), bench.py's q4_0 B = 1 step for
    # Q4_0, the CLI run of repolm512 all-Q5_K for Q5_K
    qpath = {"q4_k_matmul": ("serve_q4_k_m", "engine_q4_k_m"),
             "q6_k_matmul": ("serve_q4_k_m", "engine_q4_k_m"),
             "q4_0_matmul": ("b1_q4_0", None),
             "q5_k_matmul": ("real_q5_k", None)}
    qlaunch = {}
    if "qreal" in phases:
        clock("qreal")
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            qr = quant_real_phase(torch, counters, card, tmp)
        qlaunch["real_q5_k"] = qr["q5_k"]["cli_launches"]
    if "qfull" in phases:
        clock("qfull")
        _, got = quant_full_phase(
            torch, counters, card,
            cut_layers if "graphs" in phases else None)
        qlaunch.update(got)
    elif "graphs" in phases:
        clock("graphs q4_k_m")
        synth = build_synth(torch, "q4_k_m")
        graphs_phase(torch, counters, card, depth_cut(synth, cut_layers),
                     "8b_q4_k_m", serve_too=True)
        del synth
    # the engine-native formats' main paths: the 8B W8A8 server for
    # w8a8_matmul, the 8B W4A8 B = 1 step for w4a8_decode (Engine.benchmark
    # beside it) and the 8B W4A8 Engine.benchmark's prefill for w4a8_matmul
    qpath.update({"w8a8_matmul": ("serve_w8a8", None),
                  "w4a8_decode": ("b1_w4a8", "engine_w4a8"),
                  "w4a8_matmul": ("engine_w4a8", "engine_w4a8")})
    if "wreal" in phases:
        clock("wreal")
        wformat_real_phase(torch, counters, card)
    if "wfull" in phases:
        clock("wfull")
        _, got = wformat_full_phase(torch, counters, card)
        qlaunch.update(got)
    for name, (main_path, engine_path) in qpath.items():
        launches[name] = qlaunch.get(main_path, {}).get(name, 0)
        engine_launches[name] = qlaunch.get(engine_path, {}).get(name, 0)
    # the cache-dot forms' main path: the server with each form (serve)
    launches.update(dot_launches)
    hold = {}
    if "tiered" in phases:
        clock("tiered")
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            tiered_repolm_phase(torch, counters, card, tmp)
        got = tiered_8b_phase(torch, counters, card, "tp" in phases,
                              hold=hold if "http" in phases else None,
                              pre=pre["8b"])
        # the TP path's K-quant launches: the resident TPEngine and the
        # stream over the mesh (phase tp's tiered step)
        for run in ("resident_tp_launches", "launches"):
            for k, v in got.get("tp", {}).get(run, {}).items():
                tp_launches[k] = tp_launches.get(k, 0) + v
    http_launches, chat_launches, ppl_launches = {}, {}, {}
    if "http" in phases:
        # right after tiered, whose resident 8B it serves (one write and
        # one load of the file for both phases)
        clock("http")
        _, http_launches, chat_launches = http_phase(
            torch, counters, card, hold.pop("model", None))
    select_rows, moe_launches, ep_launches = {}, {}, {}
    if "moe" in phases:
        clock("moe")
        select_rows, moe_launches, ep_launches = moe_phase(
            torch, counters, timer, card, pre["mixtral"], "ep" in phases,
            cut_layers)
    if "quality" in phases:
        clock("quality")
        _, ppl_launches = quality_phase(torch, counters, card,
                                        pre["quality"])

    kernels = []
    mm_tol = f"max|kernel-plain| <= {MATMUL_RTOL} * max|plain|"
    tols = {cm.NAME: mm_tol,
            ca.NAME: f"max|kernel-plain| <= {FLASH_RTOL} * max|plain| "
                     f"in every query row",
            ca.PARTIALS_NAME: f"acc, m and l: max|kernel-plain| <= "
                              f"{FLASH_RTOL} * max|plain| in every query "
                              f"row; the masked shard exact",
            cb.NAME: f"max|kernel-plain| <= {BATCHED_RTOL} * max|plain| "
                     f"in every query token",
            ck.NAME: "bit-equal",
            cw8.NAME: "bit-equal",
            cw4.NAME: f"max|kernel-plain| <= {W4A8_DECODE_RTOL} * "
                      f"max|plain| (bit-equal by construction)"}
    entries = [(cm.NAME, "csrc/q8_0_matmul.cu", cm.REPLACES),
               (ca.NAME, "csrc/flash_attention.cu", ca.REPLACES),
               (ca.PARTIALS_NAME, "csrc/flash_attention.cu",
                ca.PARTIALS_REPLACES),
               (cb.NAME, "csrc/batched_attention.cu", cb.REPLACES),
               (ck.NAME, "csrc/kv_update.cu", ck.REPLACES),
               (cw8.NAME, "csrc/w8a8_matmul.cu", cw8.REPLACES),
               (cw4.NAME, "csrc/w4a8_decode.cu", cw4.REPLACES)]
    entries += [(k.name, k.source, k.replaces)
                for k in cn.KERNELS.values()]
    entries += [(f"{cb.NAME}[{d}]", "csrc/batched_attention.cu",
                 cb.REPLACES_DOT + f" dot_impl={d!r}") for d in DOT_FORMS]
    tols.update({f"{cb.NAME}[{d}]": f"max|kernel-plain| <= {DOT_RTOL[d]} * "
                 f"max|plain| in every query token" for d in DOT_FORMS})
    for name, src, replaces in entries:
        if name not in res:
            if name not in select_rows:
                continue
            # phase moe alone: the select row at the Mixtral shape is the
            # kernel's row
            res[name] = {"rows": select_rows[name],
                         "main": select_rows[name][0]["shape"]}
        r = res[name]
        main_row = next(x for x in r["rows"] if x["shape"] == r["main"])
        err = max(x["max_abs_err"] for x in r["rows"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ntransformer_tpu_torch/" + src,
            "replaces": replaces, "launches": launches.get(name, 0),
            "engine_launches": engine_launches.get(name, 0),
            "spec_launches": spec_launches.get(name, 0),
            "tp_launches": tp_launches.get(name, 0),
            "dp_launches": dp_launches.get(name, 0),
            "moe_launches": moe_launches.get(name, 0),
            "ep_launches": ep_launches.get(name, 0),
            "pp_launches": pp_launches.get(name, 0),
            "cptp_launches": cptp_launches.get(name, 0),
            "http_launches": http_launches.get(name, 0),
            "chat_launches": chat_launches.get(name, 0),
            "ppl_launches": ppl_launches.get(name, 0),
            "select": select_rows.get(name),
            "max_abs_err": err, "tol": tols.get(name, mm_tol),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "shape": r["main"],
            "card": card})
    pre.close()
    clock("end")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
