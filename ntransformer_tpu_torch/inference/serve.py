"""Continuous batching: slot-based serving over the batched decode step
(PyTorch), on one device or over a (dp, tp) mesh.

Port of ntransformer_tpu/inference/serve.py. A fixed pool of B sequence
slots decodes in lock-step through models/batched.py; finished sequences
retire and waiting requests are admitted mid-flight, so the batch stays
full. Over a mesh (parallel/multihost.make_mesh) the slots split over dp
and the weights over tp (parallel/dp.py); a mesh that spans processes runs
the same `run(requests)` in every process, each computing its own
positions.

Admission is chunked and interleaved with decode: each loop iteration runs
one batched decode step, then at most one prefill chunk of the next waiting
request, so an admission stalls decode by at most one chunk. Per-token
streaming callbacks (`Request.on_token`) fire as tokens are sampled, and
`Request.arrival_s` replays an arrival process. `run(requests)` serves a
fixed list; `serve_forever(inbox, stop)` takes Requests from other threads
on a queue.Queue. All device work stays on the serving thread.

Self-speculative serving (spec_k > 0): each loop iteration runs K lock-step
draft steps through the model's first spec_draft_layers layers, then one
verify window of [anchor, drafts] per slot; a greedy slot accepts its
longest argmax-matching prefix and the target's next token, a sampled slot
takes greedy-draft rejection sampling (BatchedSampler.spec_accept). The
draft tokens stay on the device; a round reads drafts and targets (or the
accepted tokens) once. On a mesh the draft and verify steps are the
sharded ones.

On a CUDA device the one-device server replays captured programs
(models/graphs.py, the JAX server's jitted steps and forward): warmup()
captures the decode step at full S and at every s_live rung (with spec_k,
the draft and verify steps too) against the one batched cache the server
serves from for its life, and every prefill chunk length it warms against
the one admission cache it prefills into for its life (one admission is
pending at a time; the cache is zeroed where an admission starts at 0, and
a prefix-cache hit's bytes are copied into it); each loop iteration copies
its inputs in and replays. A chunk length no warm-up reached (after a
prefix hit, min(admit_chunk, S - off) at an offset that admit_chunk does
not divide) is captured at first use. The sharded server replays the same
way where its mesh lies on one card of one process (parallel/dp.captured):
one StepGraphs a dp group (dp.group_graphs), whose decode, draft and verify
steps warmup() captures, and one admission cache of the prefill row with
its ForwardGraphs (tp.make_tp_kv's shards; the row's forward). A mesh that
spans processes or cards, and the CPU, never capture: they call the steps
and the forward directly.
"""
from __future__ import annotations

import queue as _queue
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.batched import (BatchedKV, batched_decode_step,
                              batched_verify_step)
from ..models.graphs import ForwardGraphs, StepGraphs
from ..models.llama import KVCache, forward
from ..models.loader import LoadedModel
from .engine import Engine, _bucket
from .sampler import BatchedSampler, SamplerConfig


def _graphed(device) -> bool:
    """Whether a one-device server on `device` replays captured steps:
    iff the device is CUDA."""
    return torch.device(device).type == "cuda"


def _tensors(kv) -> list:
    """The tensors of a KVCache (codes and scales of an int8 cache), or of
    every cache of a mesh's shard list (None: another process's)."""
    if isinstance(kv, list):
        return [t for c in kv if c is not None for t in _tensors(c)]
    return [t for t in (kv.k, kv.v, kv.ks, kv.vs) if t is not None]


def _clone(kv):
    """A copy of a KVCache or of a mesh's shard list of them."""
    if isinstance(kv, list):
        return [None if c is None else c.clone() for c in kv]
    return kv.clone()


@dataclass
class Request:
    prompt: str
    max_tokens: int = 128
    request_id: int = 0
    # streaming: called once per sampled token with the decoded text piece
    # ('' while a multi-byte character is still incomplete)
    on_token: object = None
    # False (default): special-token strings in the prompt are encoded as
    # plain text, so an untrusted prompt cannot smuggle control ids; True
    # only for trusted, server-side chat-template text
    parse_special: bool = False
    # simulated arrival offset (seconds after the server starts)
    arrival_s: float = 0.0
    # called once with the finished Request (after text is set)
    on_done: object = None
    # cooperative cancellation: any thread may set it; the loop retires the
    # slot at the next step boundary. done() still fires.
    cancelled: bool = False
    # per-request sampling overrides (temperature / top_k / top_p /
    # repeat_penalty / seed), applied at admission on a non-greedy server;
    # a greedy server ignores them
    sampling: dict | None = None
    # filled by the server:
    prompt_ids: list = field(default_factory=list)
    output_ids: list = field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    _text: str = ""
    _dec: object = None  # per-request StreamDecoder (lazy)

    @property
    def text(self):
        return self._text

    def done(self, text: str):
        if self.on_token is not None and self._dec is not None:
            self._dec.flush_to(self.on_token)  # trailing incomplete bytes
        self._text = text
        self.finished_at = time.time()
        if self.on_done is not None:
            self.on_done(self)


@dataclass
class ServeStats:
    requests: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    steps: int = 0           # full-model batched steps (decode + verify)
    prefill_chunks: int = 0
    prefix_hits: int = 0     # admissions that reused a cached prompt prefix
    # speculative serving: draft-prefix steps and the slots' drafted and
    # accepted tokens
    draft_steps: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    ttft_s: list = field(default_factory=list)  # per-request time to first token

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s else 0.0

    @property
    def acceptance(self) -> float:
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)

    def report(self) -> str:
        ttft = (f", ttft p50 {np.median(self.ttft_s)*1e3:.0f} ms"
                if self.ttft_s else "")
        hits = f", {self.prefix_hits} prefix hits" if self.prefix_hits else ""
        spec = (f", {self.draft_steps} draft steps, "
                f"{self.acceptance:.0%} accepted"
                if self.spec_drafted else "")
        return (f"served {self.requests} requests, {self.tokens} tokens in "
                f"{self.wall_s:.2f}s ({self.tokens_per_s:.2f} tok/s, "
                f"{self.steps} batched steps, {self.prefill_chunks} prefill "
                f"chunks{hits}{spec}{ttft})")


class _Admission:
    """A request mid-prefill: its private cache fills one chunk per server
    loop iteration, so in-flight decode never waits on a whole prompt."""

    def __init__(self, r: Request, arch, chunk: int, make_kv, prefill_fn,
                 kv=None, start: int = 0):
        self.r = r
        # kv/start: prefix-cache reuse, positions [0, start) already live
        self.kv = kv if kv is not None else make_kv()
        self.off = self.start = start
        self.chunk = chunk
        self.arch = arch
        self.last_logits = None
        self._prefill = prefill_fn

    @property
    def finished(self) -> bool:
        return self.off >= len(self.r.prompt_ids)

    def step(self, weights):
        """Run one prefill chunk, bucketed as the Engine buckets."""
        ids = self.r.prompt_ids
        chunk = ids[self.off: self.off + self.chunk]
        t = len(chunk)
        S = self.arch.max_seq_len
        p = min(_bucket(t) if self.off == self.start and t <= self.chunk
                else self.chunk, S - self.off)
        padded = np.zeros(p, np.int64)
        padded[:t] = chunk
        logits, self.kv = self._prefill(weights, self.kv, padded, self.off, t)
        self.off += t
        self.last_logits = logits[0]


class BatchServer:
    """Continuous-batching server on the model's device: greedy, or
    sampled through a BatchedSampler.

    attn_buckets: the decode step runs with a live-prefix bound s_live,
    the smallest rung of a ladder of attn_buckets - 1 rungs at S /
    attn_buckets steps (multiples of 128, at least 256) that covers every
    slot's position, so attention reads no row past the batch's fill level.
    prefix_cache > 0 keeps the last N admitted prompts' prefill caches; a
    prompt sharing a prefix of 8 or more tokens with one prefills only the
    rest (one single-sequence cache of device memory per entry). dot_impl:
    the cache-dot form of the batched flash kernel ("f32", "bf16", "int8",
    "int8_s", "int8_v"; the JAX package takes it from NT_ATTN_DOT, which
    the port's CLI reads). spec_k > 0: self-speculative serving with K
    draft tokens a round through the first spec_draft_layers layers
    (default n_layers // 2); greedy output equals spec-off serving's.

    mesh: a (dp, tp) parallel/multihost.Mesh makes this the sharded server
    (parallel/dp.py): the slots split over dp, the weights over tp (fuse:
    the shards' fused q|k|v and gate|up, as TPEngine), admission prefill
    runs the TP forward over this process's first tp row and the slot
    insert writes into the cache of the dp group that owns the slot. The
    model's host weights are dropped once sharded. The mesh path has no
    s_live ladder (attn_buckets is ignored), as in the JAX package."""

    def __init__(self, model: LoadedModel, batch_size: int = 8,
                 sampler_cfg: SamplerConfig | None = None,
                 kv_quant: bool = False, admit_chunk: int | None = None,
                 mesh=None, fuse: bool = False, prefix_cache: int = 0,
                 spec_k: int = 0, spec_draft_layers: int | None = None,
                 attn_buckets: int = 4, dot_impl: str = "f32"):
        self.spec_k = spec_k
        self.spec_draft = (spec_draft_layers if spec_draft_layers is not None
                           else max(1, model.arch.n_layers // 2))
        if spec_k and not (1 <= self.spec_draft <= model.arch.n_layers):
            raise ValueError(
                f"spec_draft_layers must be in [1, {model.arch.n_layers}]")
        self.model = model
        self.arch = model.arch
        self.weights = model.weights
        self.device = model.device
        self.B = batch_size
        self.scfg = sampler_cfg or SamplerConfig(temperature=0.0)
        self.tokenizer = model.tokenizer
        self.kv_quant = kv_quant  # int8 KV for the prefill and batch caches
        self.admit_chunk = (admit_chunk if admit_chunk is not None
                            else Engine.PREFILL_CHUNK)
        self.prefix_cache = prefix_cache
        self._pcache: list[tuple[list[int], KVCache]] = []  # LRU, newest last
        self.attn_buckets = attn_buckets
        self.dot_impl = dot_impl
        S = self.arch.max_seq_len
        n = max(attn_buckets, 1)
        self._attn_ladder = sorted({
            b for b in ((S * i) // n for i in range(1, n))
            if 256 <= b < S and b % 128 == 0}) if attn_buckets else []
        self.mesh = mesh
        # the batched cache the loop serves from, made once (_server_kv),
        # and on a CUDA device the graphs captured against it; there also
        # the admission cache and its prefill graphs (_admission_graphs)
        self._bkv = None
        self._graphs: StepGraphs | None = None
        self._ggraphs: list | None = None   # a mesh's: one a dp group
        self._adm: tuple[KVCache, ForwardGraphs] | None = None
        if mesh is not None:
            self._init_sharded(mesh, fuse)

    def _init_sharded(self, mesh, fuse: bool) -> None:
        """The DP x TP path (parallel/dp.py): shard the weights, swap the
        step, cache and prefill functions for their mesh forms, and drop
        the host copy of the weights."""
        import dataclasses
        from ..parallel import dp
        from ..parallel.multihost import Mesh
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.multihost.Mesh "
                            f"(make_mesh), not {type(mesh).__name__}")
        dp.group_size(mesh, self.B)
        # each process prefills on the first tp row it takes part in and
        # fills its own shards of every group: its rows must hold the same
        # shards
        for p in {r for rs in mesh.ranks for r in rs}:
            mine = {rs for rs in mesh.ranks if p in rs}
            if len(mine) > 1:
                raise ValueError(
                    f"process {p} holds different shards of the tp rows it "
                    f"takes part in ({sorted(mine)}); the sharded server "
                    "needs whole rows in a process or the same split in "
                    "every row")
        self.grid, _ = dp.shard_server_state(mesh, self.arch,
                                             self.model.weights, self.B,
                                             with_kv=False, fuse=fuse)
        self.model = dataclasses.replace(self.model, weights=None)
        g0 = next(g for g in range(mesh.dp) if mesh.touches(g))
        self._row = mesh.row(g0)
        self.weights = self.grid[g0]
        self.device = mesh.home
        self._attn_ladder = []
        self._sharded_steps(None)

    def _sharded_steps(self, graphs) -> None:
        """The mesh's decode (with spec_k, draft and verify) steps; graphs:
        dp.group_graphs' StepGraphs, replayed by them."""
        from ..parallel import dp
        kw = dict(dot_impl=self.dot_impl, graphs=graphs)
        self._sstep = dp.make_batched_decode_sharded(self.mesh, self.arch,
                                                     **kw)
        if self.spec_k:
            self._sdraft = dp.make_batched_draft_sharded(
                self.mesh, self.arch, self.spec_draft, **kw)
            self._sverify = dp.make_batched_verify_sharded(
                self.mesh, self.arch, **kw)

    def _step(self, bkv, tokens, pos, active, s_live=None):
        if self.mesh is not None:
            return self._sstep(self.grid, bkv, tokens, pos, active)
        if self._graphs is not None:
            return self._graphs.run(bkv, "decode", tokens, pos, active,
                                    s_live, dot_impl=self.dot_impl), bkv
        return batched_decode_step(self.arch, self.weights, bkv, tokens, pos,
                                   active, s_live=s_live,
                                   dot_impl=self.dot_impl)

    def _draft(self, bkv, tokens, pos, active, s_live=None):
        if self.mesh is not None:
            return self._sdraft(self.grid, bkv, tokens, pos, active)
        if self._graphs is not None:
            return self._graphs.run(bkv, "draft", tokens, pos, active,
                                    s_live, n_layers=self.spec_draft,
                                    dot_impl=self.dot_impl), bkv
        return batched_decode_step(self.arch, self.weights, bkv, tokens, pos,
                                   active, n_layers=self.spec_draft,
                                   s_live=s_live, dot_impl=self.dot_impl)

    def _verify(self, bkv, tokens, pos, active, s_live=None):
        if self.mesh is not None:
            return self._sverify(self.grid, bkv, tokens, pos, active)
        if self._graphs is not None:
            return self._graphs.run(bkv, "verify", tokens, pos, active,
                                    s_live, dot_impl=self.dot_impl), bkv
        return batched_verify_step(self.arch, self.weights, bkv, tokens, pos,
                                   active, s_live=s_live,
                                   dot_impl=self.dot_impl)

    def _server_kv(self):
        """The batched cache of the server's life (warmup and every run
        serve from it: an admission's insert overwrites its whole slot),
        on a mesh one per (dp, tp) position; on a CUDA device without a
        mesh, the StepGraphs bound to it; on a mesh of one card, the dp
        groups' StepGraphs bound to theirs."""
        if self._bkv is None:
            if self.mesh is not None:
                from ..parallel import dp
                self._bkv = dp.make_server_kv(self.mesh, self.arch, self.B,
                                              self.kv_quant)
                if _graphed(self.device) and dp.captured(self.mesh):
                    self._ggraphs = dp.group_graphs(self.mesh, self.arch,
                                                    self.grid, self._bkv)
                    self._sharded_steps(self._ggraphs)
            else:
                self._bkv = BatchedKV.create(self.arch, self.B,
                                             quant=self.kv_quant,
                                             device=self.device)
                if _graphed(self.device):
                    self._graphs = StepGraphs(self.arch, self.weights,
                                              self._bkv)
        return self._bkv

    def _graph_keys(self, g=None) -> list:
        """The keys warmup captures on StepGraphs g (default the one-device
        server's): the decode step at full S and at every s_live rung, with
        spec_k the draft and verify steps too."""
        g, keys = g if g is not None else self._graphs, []
        for sl in [None] + self._attn_ladder:
            keys.append(g.key("decode", 1, sl, dot_impl=self.dot_impl))
            if self.spec_k:
                keys.append(g.key("draft", 1, sl, self.spec_draft,
                                  dot_impl=self.dot_impl))
                keys.append(g.key("verify", self.spec_k + 1, sl,
                                  dot_impl=self.dot_impl))
        return keys

    def _admission_graphs(self):
        """On a CUDA server (the admission cache of the server's life, the
        ForwardGraphs bound to it), made the first time: one KVCache, or on
        a mesh of one card the prefill row's shard caches, their graphs
        running the row's forward (the one-device forward of its one shard
        at tp = 1); else None."""
        if not _graphed(self.device):
            return None
        if self.mesh is not None:
            from ..parallel import dp
            if not dp.captured(self.mesh):
                return None
        if self._adm is None:
            if self.mesh is None:
                kv = KVCache.create(self.arch, quant=self.kv_quant,
                                    device=self.device)
                g = ForwardGraphs(self.arch, self.weights, kv)
            else:
                from ..parallel.tp import make_tp_kv
                kv = make_tp_kv(self.arch, self._row, self.kv_quant)
                g = (ForwardGraphs(self.arch, self.weights[0], kv[0])
                     if self.mesh.tp == 1 else
                     ForwardGraphs(self.arch, self.weights, kv,
                                   tp=self._row))
            self._adm = (kv, g)
        return self._adm

    def _make_kv(self):
        """An admission's cache from position 0: one KVCache, or on a mesh
        one per shard of the prefill row (None for another process's
        shard); on the graph path the server's own, zeroed."""
        held = self._admission_graphs()
        if held is None:
            if self.mesh is not None:
                from ..parallel.tp import make_tp_kv
                return make_tp_kv(self.arch, self._row, self.kv_quant)
            return KVCache.create(self.arch, quant=self.kv_quant,
                                  device=self.device)
        for t in _tensors(held[0]):
            t.zero_()
        return held[0]

    def _prefill(self, weights, kv, padded, off, n_valid):
        tokens = torch.from_numpy(padded)
        if self._adm is not None and kv is self._adm[0]:
            bound = kv[0] if self.mesh is not None and self.mesh.tp == 1 \
                else kv
            return self._adm[1].prefill(bound, padded, off, n_valid), kv
        if self.mesh is None:
            logits, kv, _ = forward(self.arch, weights, kv, tokens, off,
                                    n_valid=n_valid)
        elif self.mesh.tp == 1:
            # one shard: the one-device forward (the same kernels and bits)
            logits, _, _ = forward(self.arch, weights[0], kv[0], tokens, off,
                                   n_valid=n_valid)
        else:
            logits, kv, _ = forward(self.arch, weights, kv, tokens, off,
                                    n_valid=n_valid, tp=self._row)
        return logits, kv

    def _insert(self, bkv, kv, slot: int):
        if self.mesh is not None:
            from ..parallel.dp import insert_slot
            return insert_slot(self.mesh, bkv, kv, slot, self.B)
        return bkv.insert(slot, kv)

    def _vec(self, x, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype)

    def _bucket_live(self, needed: int):
        """Smallest s_live ladder rung covering `needed` (the largest cache
        position any slot may attend this step, + 1); None = full S."""
        for b in self._attn_ladder:
            if b >= needed:
                return b
        return None

    def _prefix_lookup(self, ids: list[int]):
        """(a copy of the cached cache, start) for the entry sharing the
        longest prefix with `ids` (LRU-refreshed), or (None, 0); on a CUDA
        device the copy is the admission cache the server keeps, the hit's
        bytes copied into it. At least one token always prefills (the
        sampler needs its logits)."""
        best_n, best_i = 0, -1
        for i, (cached, _) in enumerate(self._pcache):
            n = 0
            lim = min(len(cached), len(ids) - 1)
            while n < lim and cached[n] == ids[n]:
                n += 1
            if n > best_n:
                best_n, best_i = n, i
        if best_i < 0 or best_n < 8:  # a tiny shared prefix isn't worth
            return None, 0            # the cache copy
        self._pcache.append(self._pcache.pop(best_i))  # LRU refresh
        kv = self._pcache[-1][1]
        held = self._admission_graphs()
        if held is None:
            return _clone(kv), best_n
        for dst, src in zip(_tensors(held[0]), _tensors(kv)):
            dst.copy_(src)
        return held[0], best_n

    def _prefix_store(self, ids: list[int], kv: KVCache) -> None:
        """Keep a finished admission's prompt cache for prefix reuse (the
        slot insert copies it into the batched cache, so it stays valid; the
        server's own admission cache, which the next admission rewrites, is
        kept as a clone)."""
        if not self.prefix_cache:
            return
        if self._adm is not None and kv is self._adm[0]:
            kv = _clone(kv)
        for i, (cached, _) in enumerate(self._pcache):
            if cached == ids:       # replace an identical-prompt entry
                self._pcache.pop(i)
                break
        self._pcache.append((list(ids), kv))
        if len(self._pcache) > self.prefix_cache:
            self._pcache.pop(0)     # evict the least recently used

    def warmup(self, buckets=None) -> float:
        """Run every program the serving loop dispatches once before the
        first request: the decode step (with spec_k, the draft and verify
        steps and the sampled accept round too) at full S and at every
        s_live rung, the slot insert, every prefill shape _Admission.step
        can produce from position 0 (the first-chunk bucket ladder up to
        admit_chunk, the steady chunk and the tail chunk of a context that
        admit_chunk does not divide) and the sampler. On the card this
        builds the kernels and warms the allocator outside the serve clock,
        and on one device it first captures every step key and every
        prefill length it then runs (the calls below replay). Returns the
        wall seconds."""
        t0 = time.perf_counter()
        arch = self.arch
        bkv = self._server_kv()
        for g in [self._graphs] + (self._ggraphs or []):
            if g is not None:
                g.capture(self._graph_keys(g))
        zeros = self._vec(np.zeros(self.B, np.int64))
        act = self._vec(np.zeros(self.B, bool), torch.bool)
        for sl in [None] + self._attn_ladder:
            logits, bkv = self._step(bkv, zeros, zeros, act, sl)
            torch.argmax(logits, dim=-1).cpu()
            if self.spec_k:
                dl, bkv = self._draft(bkv, zeros, zeros, act, sl)
                torch.argmax(dl, dim=-1).cpu()
                vt = torch.zeros(self.B, self.spec_k + 1, dtype=torch.long,
                                 device=self.device)
                vl, bkv = self._verify(bkv, vt, zeros, act, sl)
                torch.argmax(vl, dim=-1).cpu()
        if self.spec_k and not self.scfg.greedy:
            BatchedSampler(self.scfg, arch.vocab_size, self.B,
                           self.device).spec_accept(vl, vt[:, 1:], act)
        kv = self._make_kv()
        S, chunk = arch.max_seq_len, self.admit_chunk
        if buckets is None:
            buckets = [1, min(chunk, S)] + [
                b for b in (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
                if b <= chunk]
        shapes = {min(_bucket(min(b, chunk, S)), S) for b in buckets}
        off = chunk
        while off < S:
            shapes.add(min(chunk, S - off))
            off += chunk
        held = self._admission_graphs()
        if held is not None:
            held[1].capture([held[1].key("prefill", p)
                             for p in sorted(shapes)])
        for p in sorted(shapes):
            lg, kv = self._prefill(self.weights, kv, np.zeros(p, np.int64), 0,
                                   p)
            lg[0][:1].cpu()
        self._insert(bkv, kv, 0)
        if not self.scfg.greedy:
            bs = BatchedSampler(self.scfg, arch.vocab_size, self.B,
                                self.device)
            bs.admit(0, 0, lg[0])
            bs.sample(logits)
        self._warm = True
        return time.perf_counter() - t0

    @property
    def _multiprocess(self) -> bool:
        return self.mesh is not None and self.mesh.multiprocess

    @property
    def model_name(self) -> str:
        return self.model.config.model_name

    def snapshot(self) -> dict:
        """Point-in-time serving metrics; safe to call from any thread
        while the loop runs."""
        live = getattr(self, "_live", None)
        if live is None:
            return {"running": False, "slots": self.B}
        st = live["stats"]
        end = live["ended"] if live["ended"] is not None \
            else time.perf_counter()
        elapsed = max(end - live["t0"], 1e-9)
        ttft = sorted(st.ttft_s)
        return {
            "running": live["ended"] is None,
            "slots": self.B,
            "slots_active": int(np.count_nonzero(live["active"])),
            "requests": st.requests,
            "tokens": st.tokens,
            "steps": st.steps,
            "prefill_chunks": st.prefill_chunks,
            "elapsed_s": round(elapsed, 3),
            "tokens_per_s": round(st.tokens / elapsed, 2),
            "ttft_p50_ms": (round(ttft[len(ttft) // 2] * 1e3, 1)
                            if ttft else None),
        }

    def _prepare(self, r: Request, rid: int) -> None:
        """Tokenize and clamp a request as it enters the loop; pre-filled
        prompt_ids are kept, clamp included."""
        r.request_id = rid
        if not r.prompt_ids:
            r.prompt_ids = self.tokenizer.encode(
                r.prompt, add_bos=True, parse_special=r.parse_special)
        max_prompt = max(1, self.arch.max_seq_len - 2)
        if len(r.prompt_ids) > max_prompt:
            r.prompt_ids = r.prompt_ids[-max_prompt:]

    def run(self, requests: list[Request]) -> ServeStats:
        """Serve a fixed list of requests to completion (`arrival_s`
        replays an arrival process); returns aggregate stats. On a mesh
        that spans processes every process runs the same list."""
        if self._multiprocess and any(r.arrival_s > 0 for r in requests):
            # the local wall clock gates an arrival: two processes crossing
            # arrival_s on different iterations would issue different
            # collectives
            raise ValueError(
                "arrival_s replay is wall-clock-gated and cannot run on a "
                "multi-process mesh; submit all requests with arrival_s=0")
        stats = ServeStats(requests=len(requests))
        waiting = list(requests)
        for i, r in enumerate(waiting):
            r.submitted_at = time.time()
            self._prepare(r, i)

        def pull(now: float) -> Request | None:
            for i, r in enumerate(waiting):
                if r.arrival_s <= now:
                    return waiting.pop(i)
            return None

        def idle_wait(now: float) -> None:
            nxt = min(r.arrival_s for r in waiting)
            if nxt > now:
                time.sleep(min(nxt - now, 0.05))

        return self._serve(stats, pull, lambda: not waiting, idle_wait)

    def serve_forever(self, inbox, stop) -> ServeStats:
        """Live continuous batching: pull Requests from a queue.Queue until
        `stop` (a threading.Event) is set and every in-flight sequence has
        drained. Submitters wait on Request.on_done / on_token. Not
        reentrant."""
        if self._multiprocess:
            # the inbox is process-local: processes would admit different
            # requests on different iterations
            raise NotImplementedError(
                "serve_forever is single-process; on a torch.distributed "
                "mesh use run() with the same request list on every "
                "process")
        if not getattr(self, "_warm", False):
            self.warmup()  # before the ttft anchor: warmup is start-up cost
        stats = ServeStats()
        counter = iter(range(1 << 62))

        def pull(now: float) -> Request | None:
            try:
                r = inbox.get_nowait()
            except _queue.Empty:
                return None
            if not r.submitted_at:
                r.submitted_at = time.time()
            # ttft counts from submission: anchor the arrival offset to the
            # loop's own start instant
            r.arrival_s = max(0.0, r.submitted_at - self._loop_t0_wall)
            self._prepare(r, next(counter))
            stats.requests += 1
            return r

        def idle_wait(now: float) -> None:
            stop.wait(0.02)

        return self._serve(stats, pull,
                           lambda: stop.is_set() and inbox.empty(),
                           idle_wait)

    def _serve(self, stats: ServeStats, pull, drained, idle_wait
               ) -> ServeStats:
        """The lock-step loop shared by run() and serve_forever().

        pull(now) -> Request | None: next admissible request, if any;
        drained() -> bool: no further request will arrive;
        idle_wait(now): brief block when nothing is active or admissible.
        """
        if not getattr(self, "_warm", False):
            self.warmup()
        B = self.B
        bkv = self._server_kv()
        slot_req: list[Request | None] = [None] * B
        tokens = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int64)
        active = np.zeros(B, bool)
        bsampler = (None if self.scfg.greedy
                    else BatchedSampler(self.scfg, self.arch.vocab_size, B,
                                        self.device))
        stop = self.tokenizer.stop_ids
        pending: _Admission | None = None
        t0 = time.perf_counter()
        self._loop_t0_wall = time.time()  # the same instant as t0
        self._live = {"stats": stats, "active": active, "t0": t0,
                      "ended": None}

        def emit(r: Request, tid: int):
            if r.first_token_at == 0.0:
                r.first_token_at = time.time()
                stats.ttft_s.append(time.perf_counter() - t0 - r.arrival_s)
            r.output_ids.append(tid)
            stats.tokens += 1
            if r.on_token is not None:
                if r._dec is None:
                    r._dec = self.tokenizer.stream_decoder()
                r.on_token(r._dec.push(tid))

        def free_slot() -> int:
            for b in range(B):
                if not active[b]:
                    return b
            return -1

        def finish_admission(adm: _Admission) -> None:
            """Prefill complete: sample the first token, then occupy a slot
            or finish at once on a stop token."""
            r = adm.r
            if r.cancelled:
                r.done(self.tokenizer.decode(r.output_ids))
                return
            slot = free_slot()
            if self.scfg.greedy:
                first = int(torch.argmax(adm.last_logits))
            else:
                first = bsampler.admit(slot, r.request_id, adm.last_logits,
                                       overrides=r.sampling)
            emit(r, first)
            if first in stop or r.max_tokens <= 1:
                r.done(self.tokenizer.decode(r.output_ids))
                return
            self._insert(bkv, adm.kv, slot)
            self._prefix_store(r.prompt_ids, adm.kv)
            slot_req[slot] = r
            tokens[slot] = first
            pos[slot] = len(r.prompt_ids)
            active[slot] = True

        def retire(slot: int):
            r = slot_req[slot]
            r.done(self.tokenizer.decode(r.output_ids))
            slot_req[slot] = None
            active[slot] = False
            # a retired slot's stale pos would pin the s_live bucket high;
            # inactive slots' outputs are discarded, so 0 is safe
            pos[slot] = 0

        def advance(b: int, emitted) -> None:
            """Emit slot b's tokens of this step; retire it on a stop token,
            its request's limit or the end of the cache."""
            r = slot_req[b]
            for nxt in emitted:
                emit(r, nxt)
                pos[b] += 1
                tokens[b] = nxt
                if (nxt in stop or len(r.output_ids) >= r.max_tokens
                        or pos[b] + 1 >= self.arch.max_seq_len):
                    retire(b)
                    return

        def spec_round():
            """K lock-step drafts through the layer prefix, then one verify
            window. Greedy: each slot accepts its longest argmax-matching
            prefix and the target's token after it, the plain step's
            output. Sampled: greedy-draft rejection sampling, whose output
            has the plain step's distribution."""
            nonlocal bkv
            K = self.spec_k
            act = self._vec(active, torch.bool)
            # one s_live rung for the whole round: the verify window's rows
            # reach pos + K
            sl = self._bucket_live(int(pos.max()) + K + 1)
            pos_dev, tok_dev = self._vec(pos), self._vec(tokens)
            dtok, drafts = tok_dev, []
            for j in range(K):
                dl, bkv = self._draft(bkv, dtok, pos_dev + j, act, sl)
                dtok = torch.argmax(dl, dim=-1)  # stays on the device
                drafts.append(dtok)
            stats.draft_steps += K
            drafts = torch.stack(drafts, dim=1)                 # [B, K]
            vt = torch.cat([tok_dev[:, None], drafts], dim=1)
            vlogits, bkv = self._verify(bkv, vt, pos_dev, act, sl)
            stats.steps += 1
            if self.scfg.greedy:
                got = torch.cat([drafts, torch.argmax(vlogits, dim=-1)],
                                dim=1).cpu().numpy()  # one read
                rows = []
                for b in range(B):
                    dr, tg = got[b, :K], got[b, K:]
                    n_acc = 0
                    while n_acc < K and tg[n_acc] == dr[n_acc]:
                        n_acc += 1
                    rows.append(([int(t) for t in dr[:n_acc]]
                                 + [int(tg[n_acc])], n_acc))
            else:
                toks_acc, n_accs = bsampler.spec_accept(vlogits, drafts,
                                                        active)
                rows = [([int(t) for t in toks_acc[b]
                          if t < self.arch.vocab_size], int(n_accs[b]))
                        for b in range(B)]
            for b in range(B):
                if not active[b]:
                    continue
                if slot_req[b].cancelled:
                    retire(b)
                    continue
                emitted, n_acc = rows[b]
                stats.spec_drafted += K
                stats.spec_accepted += n_acc
                advance(b, emitted)

        while any(active) or pending is not None or not drained():
            # 1) one lock-step decode step (or spec round) for the batch
            if any(active) and self.spec_k and all(
                    pos[b] + self.spec_k + 1 < self.arch.max_seq_len
                    for b in range(B) if active[b]):
                spec_round()
            elif any(active):
                # near the end of a slot's cache the verify window has no
                # room: plain steps decode the rest
                logits, bkv = self._step(
                    bkv, self._vec(tokens), self._vec(pos),
                    self._vec(active, torch.bool),
                    self._bucket_live(int(pos.max()) + 1))
                stats.steps += 1
                if self.scfg.greedy:
                    toks_np = torch.argmax(logits, dim=-1).cpu().numpy()
                else:
                    toks_np = bsampler.sample(logits)  # one host read
                for b in range(B):
                    if not active[b]:
                        continue
                    if slot_req[b].cancelled:
                        retire(b)  # the client went away: free the slot
                        continue
                    advance(b, [int(toks_np[b])])

            # 2) advance admission by at most one prefill chunk
            if pending is None and free_slot() >= 0:
                r = pull(time.perf_counter() - t0)
                if r is not None:
                    kv0, start = ((None, 0) if not self.prefix_cache
                                  else self._prefix_lookup(r.prompt_ids))
                    if start:
                        stats.prefix_hits += 1
                    pending = _Admission(r, self.arch, self.admit_chunk,
                                         self._make_kv, self._prefill,
                                         kv=kv0, start=start)
            if pending is not None and pending.r.cancelled:
                # cancelled mid-prefill: skip the remaining chunks
                pending.r.done(self.tokenizer.decode(pending.r.output_ids))
                pending = None
            if pending is not None:
                pending.step(self.weights)
                stats.prefill_chunks += 1
                if pending.finished:
                    finish_admission(pending)
                    pending = None
            elif not any(active) and not drained():
                idle_wait(time.perf_counter() - t0)
        stats.wall_s = time.perf_counter() - t0
        self._live["ended"] = time.perf_counter()
        return stats
