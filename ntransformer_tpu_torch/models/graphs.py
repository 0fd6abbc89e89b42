"""Captured programs: the port's counterpart of the JAX package's `jax.jit`
programs, as CUDA graphs.

The JAX package runs each step as one compiled program; the port's steps are
Python loops that launch every kernel from the host, about a thousand to
fifteen hundred a step at 8B widths, and on the H100 that host work, not the
kernels, sets a step's wall. A captured program is recorded once per key
into a CUDA graph and replayed: the same kernels, plans and order of sums
as the uncaptured call, so a replay computes bit for bit what the
uncaptured call computes from the same state.

  * StepGraphs: the batched decode and verify steps (ntransformer_tpu/
    models/batched.py: `jax.jit` of batched_decode_step with the cache
    donated, and of batched_verify_step), which BatchServer replays;
  * ForwardGraphs: the one-device forward's programs (ntransformer_tpu/
    models/llama.py `forward` with a traced pos and n_valid, inference/
    engine.py `_decode_loop_greedy` and `_spec_iter_greedy`): the T = 1
    step, the all-logits verify window of any length, a bucketed prefill
    chunk, one step of the greedy loop and the fused self-speculative
    iteration. The resident Engine, BatchServer's admissions and the
    perplexity tool replay them.

Both have mesh forms, the JAX package's jitted shard_map programs
(parallel/): StepGraphs over a tp row (a dp group of the sharded server,
parallel/dp.py group_graphs), ForwardGraphs over a tp, cp, (cp, tp) or
ep mesh (the mesh engines, make_tp_decode_loop, the sharded server's
admissions); parallel/pp.py make_pp_decode captures the pipeline step the
same way. A mesh is captured only where it lies on one card of one
process (check_capturable): a row that spans processes all-gathers its
partials over a process group, which gloo stages through host memory, and
a mesh that spans cards would need one capture to span cards, with the
second card's stream joined by events and its memory in the graph's pool.
experiments/mesh_capture.py probes that on two H100s (torch 2.11, CUDA
12.8), each variant in a process of its own: the plain capture, the second
card's stream forked and joined by events, fails ("AcceleratorError: CUDA
error: operation failed due to a previous error during capture",
cudaErrorStreamCaptureInvalidated); routing the second card's
allocations to a torch.cuda.MemPool fails the same way, then aborts in
the pool's destructor ("captures_underway.empty() INTERNAL ASSERT
FAILED"); a pool warmed by an eager run fails at capture ("it->second->
use_count > 0 INTERNAL ASSERT FAILED"). Those meshes keep the host
path, by that explicit check, never by a caught capture failure.

Each is bound to one cache (a mesh's shard list or grid) and one set of
weights on one CUDA device, since its graphs hold their addresses, and
captures on its own stream into one memory pool shared by its graphs.
Inputs are copied into static device tensors before a replay; outputs are
static tensors, valid until the next replay of any graph of the same
object (the caller reads them first, as
the server and the Engine do: argmax or sampling right after each step;
sampling stays outside the graphs, as the JAX jitted steps return logits).

A key is captured in two passes: an uncaptured warm-up call that leaves
nothing behind that a later call reads (it builds and loads every kernel
library the program reaches and sizes any scratch), then the capture.
`capture(keys)` warms every new key before it captures any. A capture that
fails raises; nothing runs the uncaptured program in its place. A key seen
again replays and is never captured again.

`GRAPH` is the graph class (a torch.cuda.CUDAGraph behind `capture(fn)`).
On the CPU nothing is captured: the server and the Engine call their steps
directly. Tests put a double in GRAPH's place to run the graph paths on the
CPU.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..ops import linear
from ..ops.cuda import batched_attention
from .batched import (BatchedKV, batched_decode_step,
                      batched_decode_step_tp, batched_verify_step,
                      batched_verify_step_tp, resolve_impl)
from .llama import Arch, KVCache, ModelWeights, forward

KINDS = ("decode", "draft", "verify")
FORWARD_KINDS = ("step", "verify", "prefill", "loop", "spec")


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


def _first(xs):
    """The first entry of a shard list that this process holds."""
    return next(x for x in xs if x is not None)


def _mesh_devices(mesh) -> list:
    """Every device of a mesh: a tuple of devices, a (cp, tp) grid of them,
    or a parallel/multihost Row."""
    out = []
    for d in mesh:
        out.extend(_mesh_devices(d) if isinstance(d, (tuple, list))
                   else [torch.device(d)])
    return out


def _refusal(*meshes) -> str | None:
    """Why a captured program cannot hold one of these meshes (None: a
    mesh not given), or None."""
    for mesh in meshes:
        if mesh is None:
            continue
        if getattr(mesh, "group", None) is not None:
            return ("a mesh row that spans processes keeps the host path: "
                    "its collectives are not captured")
        if len(set(_mesh_devices(mesh))) > 1:
            return ("a mesh that spans cards keeps the host path: one "
                    "capture does not span cards (the module docstring, "
                    "experiments/mesh_capture.py)")
    return None


def check_capturable(*meshes) -> None:
    """Refuse a mesh that a captured program cannot hold: a row whose
    shards span processes (its partials are all-gathered over a process
    group, which gloo stages through host memory: a capture refuses that;
    those rows keep the host path), and a mesh that spans cards (the
    cross-card capture probe, experiments/mesh_capture.py, and the module
    docstring). ValueError either way."""
    why = _refusal(*meshes)
    if why is not None:
        raise ValueError(why)


def one_card(*meshes) -> bool:
    """Whether every mesh given (None: none) lies on one device of one
    process: what check_capturable takes."""
    return _refusal(*meshes) is None


@contextlib.contextmanager
def _on_stream(device: torch.device, stream):
    """Run on the capture stream, ordered after the current stream's work
    and before its later work (the warm-ups write state the replays
    read)."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream()
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            yield
        cur.wait_stream(stream)


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
    draft (the first n_layers layers) and verify, one graph a StepKey.

    row: a tp row (parallel/dp.py's dp group at tp > 1): weights and kv are
    then the row's shard lists (tp.shard_weights, one BatchedKV of the
    shard's heads each), and the steps batched_decode_step_tp /
    batched_verify_step_tp, which take no s_live. The row lies on one card
    of one process (check_capturable)."""

    def __init__(self, arch: Arch, weights, kv, row=None):
        check_capturable(row)
        self.arch, self.weights, self.kv, self.row = arch, weights, kv, row
        ref = _first(kv) if row is not None else kv
        self._ref = ref
        self.device = ref.k.device
        self.batch = ref.k.shape[1]
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
        if self.row is not None and s_live is not None:
            raise ValueError("a tp row's step takes no s_live")
        impl, kv_append = resolve_impl(
            None, "dus" if kind == "verify" else None, self.batch,
            self._ref.k)
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
        if self.row is not None:
            a, w, kv, row = self.arch, self.weights, self.kv, self.row
            if key.kind == "verify":
                return lambda: batched_verify_step_tp(
                    a, w, kv, tokens, self._pos, self._active, row,
                    dot_impl=key.dot_impl)[0]
            return lambda: batched_decode_step_tp(
                a, w, kv, tokens, self._pos, self._active, row,
                n_layers=key.n_layers, dot_impl=key.dot_impl)[0]
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

    @torch.inference_mode()
    def capture(self, keys) -> None:
        """Capture every key not captured yet: first one uncaptured warm-up
        call of each with every slot inactive at position 0 (no cache row
        is written), then each capture, all into one memory pool. Every
        key is warmed before any is captured, so one batched flash split
        scratch, sized for the largest key, serves all of them (replays
        run in order on one stream)."""
        new = [k for k in dict.fromkeys(keys) if k not in self._graphs]
        if not new:
            return
        with _on_stream(self.device, self.stream):
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
        kv must be the bound cache (a tp row's: its list of shard caches),
        which the step writes in place. Returns
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


class ForwardKey(NamedTuple):
    """What fixes a captured resident program's kernels and plans."""
    kind: str                 # "step", "verify", "prefill", "loop", "spec"
    t: int                    # tokens a forward: 1, or the window
    layers: tuple | None      # the layer list (None: the whole stack)
    k: int | None             # spec: the drafted tokens
    n_draft: int | None       # spec: the draft's layer prefix
    n_steps: int | None       # loop: the token buffer's length
    cache: str                # "bf16" or "int8"
    kernels: str              # ops.linear.KERNEL_MODE at capture


class ForwardGraphs:
    """The one-device forward's captured programs over one KVCache, one
    graph a ForwardKey. The kinds:

      step:   forward at T = 1 of the static token at the static pos
              through `layers` (the engine's layer-skip schedule or a
              draft's prefix), returning logits [1, V];
      verify: forward(all_logits=True) of a static [t] window at pos, any
              t (the flash kernel reads pos on the card from t = 64),
              returning logits [t, V];
      prefill: forward(n_valid=) of a static [t] window (a bucketed chunk,
              padded past its n_valid real tokens) at pos, with the static
              n_valid on the device: the padded rows keep what the cache
              held, and the logits [1, V] are the last valid row's;
      loop:   one step of the greedy loop (_decode_loop_greedy): the step,
              then its argmax written into the static token and at index i
              of a static [n_steps] buffer, pos and i advanced by one, all
              on the device; n replays chain n tokens with no host read
              (the lax.scan), returning the step's logits [1, V];
      spec:   the fused self-speculative iteration (spec_iter_greedy over
              the first n_draft layers, k drafts), the new anchor written
              into the static token and pos advanced by n_acc + 1 on the
              device, returning [k + 2]: emit [k + 1], then n_acc.

    Positions are host ints the caller keeps inside the cache (checked
    here); the static pos and n_valid are device tensors, which the
    captured forward never reads on the host. A prefill or verify window's
    key is its length t, so one graph serves every offset and n_valid.

    The mesh forms (parallel/): one mesh keyword, fixed here, as forward
    takes it: tp= (weights and kv the shard lists of tp.shard_weights and
    tp.make_tp_kv), cp= (kv the list of cp.make_cp_kv's sequence slices),
    cp= with tp= (kv the [tp][cp] grid of cp.make_cp_tp_kv) or ep= (weights
    the shard list of ep.shard_weights_ep). The statics live on the mesh's
    first device, from which the forward hands pos and n_valid to each
    shard; a cache's rows are a CP cache's slices together. The mesh lies
    on one card of one process (check_capturable). spec stays a one-device
    kind: the mesh engines delegate fused self-speculation to the host
    protocol, as the JAX ones do."""

    def __init__(self, arch: Arch, weights, kv, *, tp=None, cp=None,
                 ep=None):
        check_capturable(tp, cp, ep)
        self.arch, self.weights, self.kv = arch, weights, kv
        self.mesh_kw = {k: v for k, v in (("tp", tp), ("cp", cp), ("ep", ep))
                        if v is not None}
        home = weights if isinstance(weights, ModelWeights) \
            else _first(weights)
        self.device = home.output_norm.device
        # every cache this process holds with the global row its row 0
        # stands for (a CP slice's start), and the rows of the whole cache
        cols = [kv] if cp is None or tp is None else kv
        if cp is not None:
            rows = _first(cols[0]).k.shape[2]
            self._shards = [(c, i * rows) for col in cols
                            for i, c in enumerate(col)]
            self.rows = rows * len(cp)
        else:
            self._shards = [(c, 0) for c in (kv if tp is not None else [kv])
                            if c is not None]
            self.rows = self._shards[0][0].k.shape[2]
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

        def zeros(*shape, device=self.device):
            return torch.zeros(shape, dtype=torch.long, device=device)
        self._tok = zeros(1)     # the token fed next (spec: the anchor)
        self._pos = zeros()      # its position
        self._i = zeros()        # loop: the buffer index written next
        self._n_valid = zeros()  # prefill: the window's real tokens
        self._windows: dict[int, torch.Tensor] = {}  # verify, prefill: [t]
        self._bufs: dict[int, torch.Tensor] = {}     # loop: [n] by n_steps
        self._zeros = zeros
        self._graphs: dict[ForwardKey, tuple] = {}  # (graph, output)
        self._pool = None
        self.replays: dict[ForwardKey, int] = {}

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def zero_cache(self) -> None:
        """Zero every tensor of the bound cache this process holds: the
        state of a fresh cache."""
        for c, _ in self._shards:
            for t in (c.k, c.v, c.ks, c.vs):
                if t is not None:
                    t.zero_()

    def key(self, kind: str, t: int = 1, layers=None, k=None, n_draft=None,
            n_steps=None) -> ForwardKey:
        if kind not in FORWARD_KINDS:
            raise ValueError(f"forward kind {kind!r}: want one of "
                             f"{FORWARD_KINDS}")
        if (kind == "spec") != (k is not None and n_draft is not None):
            raise ValueError("a spec iteration takes k and n_draft, and "
                             "only it")
        if (kind == "loop") != (n_steps is not None):
            raise ValueError("a loop step takes n_steps, and only it")
        if kind == "spec" and self.mesh_kw:
            raise ValueError("a spec iteration runs the one-device forward, "
                             "not a mesh's")
        if kind == "spec":
            t = k + 1
        elif kind not in ("verify", "prefill") and t != 1:
            raise ValueError(f"a {kind} forward takes one token, not {t}")
        return ForwardKey(kind, int(t),
                          None if layers is None else
                          tuple(int(i) for i in layers),
                          None if k is None else int(k),
                          None if n_draft is None else int(n_draft),
                          None if n_steps is None else int(n_steps),
                          "int8" if any(c.quantized for c, _ in self._shards)
                          else "bf16",
                          linear.KERNEL_MODE)

    def _inputs(self, key: ForwardKey) -> None:
        """Make the key's static window or buffer."""
        if key.kind in ("verify", "prefill") and key.t not in self._windows:
            self._windows[key.t] = self._zeros(key.t)
        if key.kind == "loop" and key.n_steps not in self._bufs:
            self._bufs[key.n_steps] = self._zeros(key.n_steps)

    def _statics(self) -> list:
        return [self._tok, self._pos, self._i, self._n_valid,
                *self._windows.values(), *self._bufs.values()]

    def _body(self, key: ForwardKey):
        """The uncaptured program of `key` over the static tensors."""
        a, w, kv, mesh = self.arch, self.weights, self.kv, self.mesh_kw
        sel = None if key.layers is None else list(key.layers)
        if key.kind == "step":
            return lambda: forward(a, w, kv, self._tok, self._pos,
                                   layer_sel=sel, **mesh)[0]
        if key.kind == "verify":
            win = self._windows[key.t]
            return lambda: forward(a, w, kv, win, self._pos, layer_sel=sel,
                                   all_logits=True, **mesh)[0]
        if key.kind == "prefill":
            win = self._windows[key.t]
            return lambda: forward(a, w, kv, win, self._pos, layer_sel=sel,
                                   n_valid=self._n_valid, **mesh)[0]
        if key.kind == "loop":
            buf = self._bufs[key.n_steps]

            def loop_step():
                logits = forward(a, w, kv, self._tok, self._pos,
                                 layer_sel=sel, **mesh)[0]
                nxt = torch.argmax(logits[0]).reshape(1)
                self._tok.copy_(nxt)
                buf.index_copy_(0, self._i.reshape(1), nxt)
                self._pos.add_(1)
                self._i.add_(1)
                return logits
            return loop_step
        # imported here: inference/engine.py imports this module
        from ..inference.engine import spec_iter_greedy

        def spec_iter():
            _, emit, n_acc, anchor = spec_iter_greedy(
                a, w, kv, self._tok[0], self._pos, key.k, key.n_draft)
            self._tok.copy_(anchor.reshape(1))
            self._pos.add_(n_acc + 1)
            return torch.cat([emit, n_acc.reshape(1)])
        return spec_iter

    @torch.inference_mode()
    def capture(self, keys) -> None:
        """Capture every key not captured yet: one uncaptured warm-up call
        of each, then each capture, all into one memory pool. Every call
        runs at the cache's last rows from zeroed inputs (n_valid 1), and
        those rows and the static inputs are put back afterwards: nothing a
        warm-up (or a graph double that runs its program at capture) writes
        is left for a later call to read."""
        new = [k for k in dict.fromkeys(keys) if k not in self._graphs]
        if not new:
            return
        for k in new:
            self._inputs(k)
        lo = self.rows - max(k.t for k in new)
        # the rows at or past global row lo of every cache this process
        # holds (of a CP slice, those of its rows that lie there)
        caches = [t[:, :, max(lo - off, 0):] for c, off in self._shards
                  if lo - off < c.k.shape[2]
                  for t in (c.k, c.v, c.ks, c.vs) if t is not None]
        with _on_stream(self.device, self.stream):
            rows = [c.clone() for c in caches]
            statics = [s.clone() for s in self._statics()]

            def park():
                for s in self._statics():
                    s.zero_()
                self._pos.fill_(lo)
                self._n_valid.fill_(1)
            try:
                for k in new:
                    park()
                    self._body(k)()
                for k in new:
                    park()
                    graph = GRAPH()
                    out = graph.capture(self._body(k), pool=self._pool)
                    if self._pool is None:
                        self._pool = graph.pool()
                    self._graphs[k] = (graph, out)
                    self.replays[k] = 0
            finally:
                for c, r in zip(caches, rows):
                    c.copy_(r)
                for s, v in zip(self._statics(), statics):
                    s.copy_(v)

    def _graph(self, kv: KVCache, key: ForwardKey, pos, span: int):
        """The graph of `key` (captured first if new) and its output, after
        the checks: kv is the bound cache (a mesh's: the bound list or
        grid), and rows [pos, pos + span) lie inside it (host ints; pos
        None: the device pos as it stands)."""
        if kv is not self.kv:
            raise ValueError("ForwardGraphs: this KVCache is not the one the "
                             "graphs were captured against (they hold its "
                             "addresses)")
        rows = self.rows
        if pos is not None and not 0 <= pos <= rows - span:
            raise ValueError(f"rows [{pos}, {pos + span}) exceed the "
                             f"{rows}-row cache")
        if key not in self._graphs:
            self.capture([key])
        if pos is not None:
            self._pos.fill_(pos)
        return self._graphs[key]

    @staticmethod
    def _feed(dst: torch.Tensor, value) -> None:
        if isinstance(value, int):
            dst.fill_(value)
        else:
            dst.copy_(torch.as_tensor(value).reshape(dst.shape))

    def _play(self, key: ForwardKey, graph, times: int = 1) -> None:
        for _ in range(times):
            graph.replay()
        self.replays[key] += times

    @torch.inference_mode()
    def step(self, kv: KVCache, token, pos: int, layers=None):
        """Replay forward(kv, [token], pos, layer_sel=layers): logits
        [1, V]. token: an int or a 1-element device tensor."""
        key = self.key("step", layers=layers)
        graph, out = self._graph(kv, key, pos, 1)
        self._feed(self._tok, token)
        self._play(key, graph)
        return out

    @torch.inference_mode()
    def verify(self, kv: KVCache, tokens, pos: int, layers=None):
        """Replay forward(kv, tokens, pos, layer_sel=layers,
        all_logits=True): logits [t, V]."""
        tokens = torch.as_tensor(tokens)
        key = self.key("verify", tokens.numel(), layers=layers)
        graph, out = self._graph(kv, key, pos, key.t)
        self._feed(self._windows[key.t], tokens)
        self._play(key, graph)
        return out

    @torch.inference_mode()
    def prefill(self, kv: KVCache, tokens, pos: int, n_valid: int,
                layers=None):
        """Replay forward(kv, tokens, pos, layer_sel=layers,
        n_valid=n_valid) of a padded [t] window, 1 <= n_valid <= t: the
        last valid row's logits [1, V]."""
        tokens = torch.as_tensor(tokens)
        key = self.key("prefill", tokens.numel(), layers=layers)
        if not 1 <= n_valid <= key.t:
            raise ValueError(f"n_valid {n_valid} of a {key.t}-token window")
        graph, out = self._graph(kv, key, pos, key.t)
        self._feed(self._windows[key.t], tokens)
        self._n_valid.fill_(n_valid)
        self._play(key, graph)
        return out

    @torch.inference_mode()
    def loop(self, kv: KVCache, token, pos: int, n_steps: int, layers=None):
        """n_steps greedy tokens from `token` at pos, the loop step
        replayed n_steps times: (tokens [n_steps], the last step's logits
        [1, V]), both static."""
        key = self.key("loop", layers=layers, n_steps=n_steps)
        graph, out = self._graph(kv, key, pos, n_steps)
        self._feed(self._tok, token)
        self._i.zero_()
        self._play(key, graph, n_steps)
        return self._bufs[n_steps], out

    @torch.inference_mode()
    def spec(self, kv: KVCache, k: int, n_draft: int, anchor=None,
             pos: int | None = None):
        """One fused self-speculative iteration: [k + 2] (emit, then
        n_acc). anchor and pos: the first iteration's; None continues from
        the device state the last iteration left (its new anchor, pos +
        n_acc + 1)."""
        key = self.key("spec", k=k, n_draft=n_draft)
        graph, out = self._graph(kv, key, pos, k + 1)
        if anchor is not None:
            self._feed(self._tok, anchor)
        self._play(key, graph)
        return out
