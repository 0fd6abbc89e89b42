"""Captured batched steps: the port's counterpart of `jax.jit` over the
batched decode and verify steps, as CUDA graphs.

The JAX package runs each batched step as one compiled program
(ntransformer_tpu/models/batched.py: `jax.jit` of batched_decode_step with
the cache donated, and of batched_verify_step), which its BatchServer
dispatches (inference/serve.py). The port's steps (models/batched.py) are
Python loops that launch every kernel of the step from the host, about a
thousand a step at 8B widths; on the H100 that host work, not the kernels,
sets a step's wall. A StepGraphs captures each step once per shape key into
a CUDA graph and replays it: the same kernels, plans and order of sums as
the uncaptured call, so a replay computes bit for bit what the uncaptured
call computes from the same cache state.

A StepGraphs is bound to one BatchedKV and one ModelWeights on one CUDA
device, since its graphs hold their addresses. `run` copies the inputs into
static device tensors (tokens, pos, active), replays, and returns the
graph's static logits. The graphs share one memory pool, so the next replay
of any of them overwrites those logits: the caller reads them first, as the
server does (argmax or sampling right after each step; argmax and sampling
stay outside the graphs, as the JAX jitted steps return logits).

A key is captured in two passes on the StepGraphs' own stream: an
uncaptured warm-up call with every slot inactive (it writes no cache row),
which builds and loads every kernel library the step reaches and sizes
batched flash's split scratch; then the capture. `capture(keys)` warms
every new key before it captures any, so one scratch buffer, sized for the
largest key, serves all of them (replays run in order on one stream). A
capture that fails raises; nothing runs the uncaptured step in its place.
A key seen again replays and is never captured again.

`GRAPH` is the graph class (a torch.cuda.CUDAGraph behind `capture(fn)`).
On the CPU nothing is captured: the server calls the steps directly. Tests
put a double in GRAPH's place to run the server's graph path on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..ops.cuda import batched_attention
from .batched import (BatchedKV, batched_decode_step, batched_verify_step,
                      resolve_impl)
from .llama import Arch, ModelWeights

KINDS = ("decode", "draft", "verify")


class CudaGraph:
    """One captured program on a torch.cuda.CUDAGraph."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn, pool=None):
        """Record the launches of fn() on the current stream (in the global
        capture mode, which refuses a synchronize, a pageable copy or any
        other call that cannot be captured) and return its outputs, the
        graph's static tensors. pool: another graph's pool() to share."""
        self.graph.capture_begin(pool=pool)
        try:
            return fn()
        finally:
            self.graph.capture_end()

    def replay(self) -> None:
        self.graph.replay()

    def pool(self):
        return self.graph.pool()


GRAPH = CudaGraph


class StepKey(NamedTuple):
    """What fixes a captured step's kernels and plans."""
    kind: str               # "decode", "draft" (a layer prefix), "verify"
    batch: int
    t: int                  # tokens a slot: 1, or the verify window
    s_live: int | None
    dot_impl: str
    impl: str
    kv_append: str
    n_layers: int | None    # a draft's layer prefix


class StepGraphs:
    """The captured batched steps of one cache: decode (the full stack),
    draft (the first n_layers layers) and verify, one graph a StepKey."""

    def __init__(self, arch: Arch, weights: ModelWeights, kv: BatchedKV):
        self.arch, self.weights, self.kv = arch, weights, kv
        self.device = kv.k.device
        self.batch = kv.k.shape[1]
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._pos = torch.zeros(self.batch, dtype=torch.long,
                                device=self.device)
        self._active = torch.zeros(self.batch, dtype=torch.bool,
                                   device=self.device)
        self._tokens: dict[tuple, torch.Tensor] = {}  # by shape
        self._graphs: dict[StepKey, tuple] = {}      # (graph, logits)
        self._pool = None
        # batched flash scratch buffers the graphs address (a later, larger
        # key replaces the module's buffer; this keeps the old one alive)
        self._held: list[torch.Tensor] = []
        self.replays: dict[StepKey, int] = {}

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def key(self, kind: str, t: int = 1, s_live=None, n_layers=None,
            dot_impl: str = "f32") -> StepKey:
        """The StepKey of a step as the uncaptured functions run it by
        default (impl and kv_append resolved as they resolve them)."""
        if kind not in KINDS:
            raise ValueError(f"step kind {kind!r}: want one of {KINDS}")
        if (kind == "draft") != (n_layers is not None):
            raise ValueError("a draft step takes n_layers, and only it")
        if kind != "verify" and t != 1:
            raise ValueError(f"a {kind} step takes one token a slot, not {t}")
        impl, kv_append = resolve_impl(
            None, "dus" if kind == "verify" else None, self.batch, self.kv.k)
        return StepKey(kind, self.batch, int(t),
                       None if s_live is None else int(s_live), dot_impl,
                       impl, kv_append,
                       None if n_layers is None else int(n_layers))

    def _static_tokens(self, key: StepKey) -> torch.Tensor:
        """tokens [B] of a decode or draft step, [B, T] of a verify
        window."""
        shape = (self.batch, key.t) if key.kind == "verify" else \
            (self.batch,)
        if shape not in self._tokens:
            self._tokens[shape] = torch.zeros(shape, dtype=torch.long,
                                              device=self.device)
        return self._tokens[shape]

    def _step(self, key: StepKey):
        """The uncaptured step of `key` over the static inputs, returning
        its logits."""
        tokens = self._static_tokens(key)
        if key.kind == "verify":
            return lambda: batched_verify_step(
                self.arch, self.weights, self.kv, tokens, self._pos,
                self._active, impl=key.impl, s_live=key.s_live,
                dot_impl=key.dot_impl)[0]
        return lambda: batched_decode_step(
            self.arch, self.weights, self.kv, tokens, self._pos,
            self._active, impl=key.impl, kv_append=key.kv_append,
            n_layers=key.n_layers, s_live=key.s_live,
            dot_impl=key.dot_impl)[0]

    @contextlib.contextmanager
    def _on_stream(self):
        """Run on the capture stream, ordered after the current stream's
        work and before its later work (the warm-ups write the scratch the
        replays use)."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                yield
            cur.wait_stream(self.stream)

    @torch.inference_mode()
    def capture(self, keys) -> None:
        """Capture every key not captured yet: first one uncaptured warm-up
        call of each with every slot inactive at position 0 (no cache row
        is written), then each capture, all into one memory pool."""
        new = [k for k in dict.fromkeys(keys) if k not in self._graphs]
        if not new:
            return
        with self._on_stream():
            for k in new:
                self._static_tokens(k).zero_()
            self._pos.zero_()
            self._active.zero_()
            for k in new:
                self._step(k)()
            for k in new:
                graph = GRAPH()
                logits = graph.capture(self._step(k), pool=self._pool)
                if self._pool is None:
                    self._pool = graph.pool()
                self._graphs[k] = (graph, logits)
                self.replays[k] = 0
        if self.stream is not None:
            buf = batched_attention.scratch_buffer(self.device, self.stream)
            if buf is not None and all(buf is not h for h in self._held):
                self._held.append(buf)

    @torch.inference_mode()
    def run(self, kv: BatchedKV, kind: str, tokens, pos, active, s_live=None,
            *, n_layers=None, dot_impl: str = "f32") -> torch.Tensor:
        """Replay the step of this key (capturing it first if it is new)
        on these inputs: tokens [B] (decode, draft) or [B, T] (verify),
        pos [B], active [B], s_live, n_layers (a draft's prefix) and
        dot_impl as batched_decode_step / batched_verify_step take them.
        kv must be the bound cache, which the step writes in place. Returns
        the static logits ([B, V] or [B, T, V] f32), valid until the next
        replay."""
        if kv is not self.kv:
            raise ValueError("StepGraphs.run: this BatchedKV is not the one "
                             "the graphs were captured against (they hold "
                             "its addresses)")
        tokens = torch.as_tensor(tokens)
        t = tokens.shape[1] if kind == "verify" else 1
        key = self.key(kind, t, s_live, n_layers, dot_impl)
        if key not in self._graphs:
            self.capture([key])
        graph, logits = self._graphs[key]
        static = self._static_tokens(key)
        static.copy_(tokens.reshape(static.shape))
        self._pos.copy_(torch.as_tensor(pos).reshape(self._pos.shape))
        self._active.copy_(torch.as_tensor(active).reshape(
            self._active.shape))
        graph.replay()
        self.replays[key] += 1
        return logits
