"""Inference engine: generation loops over the functional model (PyTorch).

Port of ntransformer_tpu/inference/engine.py, single-device resident path:
`generate` (bucketed prefill → sample → decode loop, with ChatSession KV
reuse and layer-skip calibration) and `benchmark` (greedy timing). Prefill
lengths stay bucketed exactly as in the JAX package (powers of two,
512-token chunks, valid-length masking), so both packages run the same
shapes; the cache is updated in place by each forward. In `benchmark` a
Python loop of forwards takes the place of the jitted `lax.scan` decode
loop; the argmax stays on the card, so the loop never waits for the host.

Speculative decoding (greedy): `generate_speculative` drafts K tokens
with a separate draft model, `generate_self_speculative` with the model's
first layers; one all-logits verify of [anchor, d0 .. dK-1] then accepts
the longest prefix whose argmax matches and emits the correction or bonus
token. The anchor is fed again at the head of every verify window, so no
cache rollback is ever needed. `generate_self_speculative_fused` runs one
iteration as a function on tensors (`spec_iter_greedy`): the draft argmaxes
stay on the card and the host reads (emit, n_acc) once an iteration.

`chat` is the REPL of the CLI's --chat: with the model's chat template
(inference/chat.py) a ChatSession carries the cache across turns.

On a CUDA device the base Engine replays its programs as CUDA graphs
(models/graphs.ForwardGraphs, the JAX package's jitted forward,
_decode_loop_greedy and _spec_iter_greedy): `_prefill` replays each
bucketed chunk (the main model's and a draft model's), `_decode_step` and
`_verify` the T = 1 step and the verify window, `benchmark` the greedy
loop step (the warm-up run captures it, the timed run replays it) and
`generate_self_speculative_fused` the whole iteration; only the
layer-skip calibration's prefill, which returns cosines, runs uncaptured.
Graphs hold addresses, so that Engine keeps its cache (and a draft
model's) for its life and zeroes it where a generation starts from
position 0, the state of a fresh cache; it serves one call at a time, as a
BatchServer does. A forward on any other cache (a caller's own KVCache)
runs uncaptured, as does every forward on the CPU. The mesh engines below
replay the same way through the mesh forms of ForwardGraphs (the JAX
make_tp_forward, make_cp_forward, make_cp_tp_forward and make_ep_forward,
and TPEngine.benchmark's make_tp_decode_loop) where their mesh lies on one
card of one process; a mesh that spans cards keeps the host path, by an
explicit check (models/graphs.check_capturable), as TieredEngine does.

`TieredEngine` runs the same loops over a TieredModel (models/tiered.py):
per-token layer streaming, layer-skip that drops streamed I/O, early exit,
self-speculation drafting on the resident prefix and a separate resident
draft model (over a TP mesh too). `TPEngine` runs them with tensor
parallelism (parallel/tp.py): the weights and the KV heads split over a
list of shard devices; `CPEngine` with context parallelism
(parallel/cp.py): the cache split along the sequence axis, over a (cp, tp)
mesh also the weights and the KV heads; `EPEngine` with expert parallelism
(parallel/ep.py): a mixture-of-experts model's expert planes split on
their expert axis. One process drives every shard.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.graphs import ForwardGraphs, one_card
from ..models.llama import KVCache, forward
from ..models.loader import LoadedModel, load_model
from ..utils.timing import PROFILER
from .sampler import Sampler, SamplerConfig


@dataclass
class GenerateConfig:
    max_tokens: int = 128
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    repeat_penalty: float = 1.1
    seed: int = 42
    draft_k: int = 4
    skip_threshold: float = 0.0  # >0 enables layer-skip calibration
    early_exit_threshold: float = 0.0  # >0: tiered early exit (cosine)

    def sampler(self) -> SamplerConfig:
        return SamplerConfig(temperature=self.temperature, top_k=self.top_k,
                             top_p=self.top_p,
                             repeat_penalty=self.repeat_penalty,
                             seed=self.seed)


@dataclass
class Stats:
    prefill_tokens: int = 0
    prefill_ms: float = 0.0
    decode_tokens: int = 0
    decode_ms: float = 0.0
    accepted: int = 0
    drafted: int = 0
    skipped_layers: list = field(default_factory=list)

    @property
    def prefill_tps(self) -> float:
        return (self.prefill_tokens / self.prefill_ms * 1e3
                if self.prefill_ms else 0.0)

    @property
    def decode_tps(self) -> float:
        return (self.decode_tokens / self.decode_ms * 1e3
                if self.decode_ms else 0.0)

    def report(self) -> str:
        lines = [f"prefill: {self.prefill_tokens} tok in "
                 f"{self.prefill_ms:.1f} ms ({self.prefill_tps:.2f} tok/s)",
                 f"decode:  {self.decode_tokens} tok in "
                 f"{self.decode_ms:.1f} ms ({self.decode_tps:.2f} tok/s)"]
        if self.drafted:
            lines.append(f"speculative: {self.accepted}/{self.drafted} "
                         f"accepted "
                         f"({100.0 * self.accepted / self.drafted:.1f}%)")
        if self.skipped_layers:
            lines.append(f"layer-skip: {len(self.skipped_layers)} skipped "
                         f"{self.skipped_layers}")
        return "\n".join(lines)


@dataclass
class ChatSession:
    """Multi-turn KV reuse: the cache and the token ids whose rows are live
    in it, carried across generate() calls; only the new tokens prefill.
    On the graph path the cache is the engine's own, and `writes` its
    write count after this session's turn: the session resumes only if no
    other call has written that cache since (else the turn prefills
    whole)."""

    kv: object | None = None
    ids_in_kv: list[int] = field(default_factory=list)
    writes: int = -1

    def reset(self) -> None:
        self.kv = None
        self.ids_in_kv = []
        self.writes = -1


def _bucket(n: int, buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                             4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _graphed(device) -> bool:
    """Whether a resident base Engine on `device` replays captured
    programs (models/graphs.ForwardGraphs): iff the device is CUDA."""
    return torch.device(device).type == "cuda"


class Engine:
    """High-level generation engine over a loaded model; `draft`: a
    separate draft model for generate_speculative, on the same device."""

    PREFILL_CHUNK = 512

    def __init__(self, model: LoadedModel, draft: LoadedModel | None = None,
                 kv_quant: bool = False):
        self.model = model
        self.draft = draft
        self.kv_quant = kv_quant  # int8 KV cache (half the cache memory)
        self.arch = model.arch
        self.tokenizer = model.tokenizer
        self.device = model.device
        self.layer_sel: np.ndarray | None = None  # layer-skip schedule
        # the graph path: "main" and "draft" -> (the cache kept for the
        # engine's life, its ForwardGraphs); the count of calls that wrote
        # the main cache
        self._held: dict[str, tuple[KVCache, ForwardGraphs]] = {}
        self._kv_writes = 0

    @classmethod
    def load(cls, path: str, draft_path: str | None = None,
             kv_quant: bool = False, **kw) -> "Engine":
        """Load `path` resident (load_model keywords: device, fuse, ...);
        draft_path: a draft model, loaded first with the same keywords."""
        draft = load_model(draft_path, **kw) if draft_path else None
        return cls(load_model(path, **kw), draft, kv_quant=kv_quant)

    # --- internals ----------------------------------------------------------
    def _clamp_ids(self, ids: list[int]) -> list[int]:
        limit = max(1, self.arch.max_seq_len - 2)
        return list(ids[-limit:]) if len(ids) > limit else list(ids)

    def _encode(self, prompt: str) -> list[int]:
        return self._clamp_ids(self.tokenizer.encode(prompt, add_bos=True))

    def _make_kv(self) -> KVCache:
        return KVCache.create(self.arch, quant=self.kv_quant,
                              device=self.device)

    def _mesh(self) -> dict:
        """The mesh keyword the engine's model runs under (forward's tp=,
        cp= or ep=): none on one device."""
        return {}

    def _weights_of(self, m):
        """The weights forward takes for model m (a mesh engine's model:
        its shard list)."""
        return m.weights

    def _fw_of(self, m) -> tuple:
        """(weights, mesh keyword) of the forward of model m."""
        return self._weights_of(m), (self._mesh() if m is self.model else {})

    def _graph_path(self) -> bool:
        """Whether this engine replays captured programs: its model resident
        on a CUDA device, on one card of one process under a mesh
        (models/graphs.check_capturable; TieredEngine keeps its host-driven
        path)."""
        return _graphed(self.device) and one_card(*self._mesh().values())

    def _start_kv(self, draft: bool = False) -> KVCache:
        """The cache a generation writes from position 0 (draft: the draft
        model's bf16 cache). On the graph path the one the engine keeps,
        zeroed, with its ForwardGraphs made the first time; else a new
        cache."""
        m = self.draft if draft else self.model
        make = ((lambda: KVCache.create(m.arch, device=m.device)) if draft
                else self._make_kv)
        if not self._graph_path():
            return make()
        name = "draft" if draft else "main"
        if name not in self._held:
            kv = make()
            w, mesh = self._fw_of(m)
            self._held[name] = (kv, ForwardGraphs(m.arch, w, kv, **mesh))
        kv, g = self._held[name]
        g.zero_cache()
        if not draft:
            self._kv_writes += 1
        return kv

    def _graphs_of(self, kv) -> ForwardGraphs | None:
        """The ForwardGraphs bound to kv on the graph path, else None."""
        if not self._graph_path():
            return None
        return next((g for held, g in self._held.values() if held is kv),
                    None)

    def _resumes(self, session: ChatSession) -> bool:
        """Whether session's cache is still its own: on the graph path no
        call has written the engine's cache since the session's turn."""
        return session.kv is not None and (
            not self._graph_path() or (session.writes == self._kv_writes
                                       and self._graphs_of(session.kv)
                                       is not None))

    def _prefill(self, kv: KVCache, tokens: list[int], model=None,
                 with_cosine=False, start: int = 0):
        """Bucketed prefill of tokens[start:] at their true offsets, in
        512-token chunks past one chunk, through `model` (default the
        engine's). Returns (last logits [1, V], kv, cosines of the final
        chunk). On the graph path each chunk replays the prefill graph of
        its length (ForwardGraphs.prefill; the logits are its static
        output); a prefill with cosines (layer-skip calibration, once an
        engine) runs uncaptured, as _decode_step does with them. The
        lengths, so the keys: the buckets 8-512 of a prompt of one chunk,
        the 512-token chunk, and near the cache's end S - off."""
        arch = model.arch if model is not None else self.arch
        t = len(tokens)
        S = arch.max_seq_len
        if t - start <= self.PREFILL_CHUNK:
            # the padded rows must stay inside the cache
            p = min(_bucket(t - start), S - start)
            padded = np.zeros(p, dtype=np.int64)
            padded[: t - start] = tokens[start:]
            return self._prefill_chunk(kv, padded, start, t - start, model,
                                       with_cosine)
        c = self.PREFILL_CHUNK
        logits = cos = None
        for off in range(start, t, c):
            chunk = tokens[off: off + c]
            p = min(c, S - off)  # the last chunk may not pad past the end
            padded = np.zeros(p, dtype=np.int64)
            padded[: len(chunk)] = chunk
            logits, kv, cos = self._prefill_chunk(kv, padded, off, len(chunk),
                                                  model, with_cosine)
        return logits, kv, cos

    def _prefill_chunk(self, kv, padded: np.ndarray, off: int, n_valid: int,
                       model=None, with_cosine=False):
        m = model if model is not None else self.model
        sel = self.layer_sel if m is self.model else None
        g = None if with_cosine else self._graphs_of(kv)
        if g is not None:
            return g.prefill(kv, padded, off, n_valid, sel), kv, None
        w, mesh = self._fw_of(m)
        return forward(m.arch, w, kv, torch.from_numpy(padded), off,
                       layer_sel=sel, n_valid=n_valid,
                       with_cosine=with_cosine, **mesh)

    def _decode_step(self, kv: KVCache, token, pos: int, model=None,
                     with_cosine=False, layer_sel=None):
        """One token through `model` (default the engine's) at pos;
        layer_sel (a draft's layer prefix) replaces the engine's layer-skip
        schedule."""
        m = model if model is not None else self.model
        sel = layer_sel if layer_sel is not None else (
            self.layer_sel if m is self.model else None)
        g = None if with_cosine else self._graphs_of(kv)
        if g is not None:
            return g.step(kv, token, pos, sel), kv, None
        w, mesh = self._fw_of(m)
        tok = torch.as_tensor(token, device=self.device if m is self.model
                              else m.device).reshape(1)
        return forward(m.arch, w, kv, tok, pos, layer_sel=sel,
                       with_cosine=with_cosine, **mesh)

    def _verify(self, kv, tokens, pos: int):
        """All-position logits [T, V] of tokens written at pos through the
        full model (its layer-skip schedule applied). Returns (logits,
        kv)."""
        g = self._graphs_of(kv)
        if g is not None:
            return g.verify(kv, tokens, pos, self.layer_sel), kv
        w, mesh = self._fw_of(self.model)
        logits, kv, _ = forward(self.arch, w, kv, tokens, pos,
                                layer_sel=self.layer_sel, all_logits=True,
                                **mesh)
        return logits, kv

    def _calibrate(self, cosines, threshold: float) -> list[int]:
        """Layer-skip calibration: skip middle-band layers whose cosine is
        above threshold."""
        n = self.arch.n_layers
        lo, hi = n // 4, (3 * n) // 4
        skip = [i for i in range(lo, hi) if float(cosines[i]) > threshold]
        self.layer_sel = np.array([i for i in range(n) if i not in skip],
                                  dtype=np.int64)
        return skip

    # --- public API -----------------------------------------------------------
    def generate(self, prompt: str, cfg: GenerateConfig | None = None,
                 callback=None, *, prompt_ids: list[int] | None = None,
                 session: ChatSession | None = None) -> tuple[str, Stats]:
        """Generate up to cfg.max_tokens tokens after `prompt` (or the
        pre-encoded prompt_ids). session: prefill only the part of the
        prompt that extends the session's cached ids; the session holds the
        cache afterwards."""
        cfg = cfg or GenerateConfig()
        stats = Stats()
        tok = self.tokenizer
        sampler = Sampler(cfg.sampler(), self.arch.vocab_size, self.device)
        ids = (self._clamp_ids(prompt_ids) if prompt_ids is not None
               else self._encode(prompt))
        max_new = min(cfg.max_tokens, self.arch.max_seq_len - len(ids))

        start = 0
        if session is not None and self._resumes(session):
            cached = session.ids_in_kv
            n = 0
            while (n < len(cached) and n < len(ids) - 1
                   and cached[n] == ids[n]):
                n += 1
            if n > 0:
                kv, start = session.kv, n
                session.kv = None
        graphed = self._graph_path()
        if start == 0:
            kv = self._start_kv()
        elif graphed:
            self._kv_writes += 1  # the session's turn writes the cache

        t0 = time.perf_counter()
        calibrate = cfg.skip_threshold > 0 and self.layer_sel is None
        PROFILER.begin("engine/prefill")
        logits, kv, cos = self._prefill(kv, ids, with_cosine=calibrate,
                                        start=start)
        PROFILER.end("engine/prefill")
        next_tok = int(sampler.sample(logits[0]))  # waits for the card
        stats.prefill_tokens = len(ids) - start
        stats.prefill_ms = (time.perf_counter() - t0) * 1e3
        if calibrate:
            stats.skipped_layers = self._calibrate(cos.cpu().numpy(),
                                                   cfg.skip_threshold)

        out_ids: list[int] = []
        dec = tok.stream_decoder() if callback else None
        pos = len(ids)
        fed = 0  # decoded tokens whose KV rows were written
        t0 = time.perf_counter()
        for _ in range(max_new):
            out_ids.append(next_tok)
            sampler.observe(next_tok)
            if callback:
                callback(dec.push(next_tok))
            if next_tok in tok.stop_ids or pos >= self.arch.max_seq_len:
                break
            PROFILER.begin("engine/decode_step")
            logits, kv, _ = self._decode_step(kv, next_tok, pos)
            next_tok = int(sampler.sample(logits[0]))
            PROFILER.end("engine/decode_step")
            pos += 1
            fed += 1
        if callback:
            dec.flush_to(callback)
        _sync(self.device)
        stats.decode_tokens = len(out_ids)
        stats.decode_ms = (time.perf_counter() - t0) * 1e3
        if session is not None:
            session.kv = kv
            session.ids_in_kv = ids + out_ids[:fed]
            if graphed:
                session.writes = self._kv_writes
        return tok.decode(out_ids), stats

    # --- speculative decoding -------------------------------------------------
    def generate_speculative(self, prompt: str,
                             cfg: GenerateConfig | None = None,
                             callback=None) -> tuple[str, Stats]:
        """Greedy speculative decoding with the separate draft model."""
        if self.draft is None:
            raise ValueError("no draft model loaded")
        return self._speculate(prompt, cfg, callback, self_spec=False)

    def generate_self_speculative(self, prompt: str,
                                  cfg: GenerateConfig | None = None,
                                  callback=None,
                                  draft_layers: int | None = None
                                  ) -> tuple[str, Stats]:
        """Self-speculative: the first `draft_layers` layers of the model
        (default half) draft."""
        return self._speculate(prompt, cfg, callback, self_spec=True,
                               draft_layers=draft_layers or max(
                                   1, self.arch.n_layers // 2))

    def _speculate(self, prompt: str, cfg, callback, self_spec: bool,
                   draft_layers: int | None = None) -> tuple[str, Stats]:
        """The host-driven protocol: K greedy draft steps (a host read
        each), one verify of [anchor, d0 .. dK-1] at pos, the longest
        matching prefix accepted and the target's token at the first
        mismatch (or the bonus token after a full accept) emitted."""
        cfg = cfg or GenerateConfig()
        stats = Stats()
        tok = self.tokenizer
        ids = self._encode(prompt)
        K = cfg.draft_k
        kv = self._start_kv()

        if self_spec:
            draft_model = None
            draft_sel = np.arange(draft_layers)
            draft_kv = None  # the draft layers share the main cache
        else:
            draft_model = self.draft
            draft_sel = None
            draft_kv = self._start_kv(draft=True)

        t0 = time.perf_counter()
        logits, kv, _ = self._prefill(kv, ids)
        if not self_spec:
            _, draft_kv, _ = self._prefill(draft_kv, ids, model=draft_model)
        anchor = int(torch.argmax(logits[0]))  # waits for the card
        stats.prefill_tokens = len(ids)
        stats.prefill_ms = (time.perf_counter() - t0) * 1e3

        out_ids = [anchor]
        dec = tok.stream_decoder() if callback else None
        if callback:
            callback(dec.push(anchor))
        pos = len(ids)  # the anchor takes position pos in the verify
        max_new = min(cfg.max_tokens, self.arch.max_seq_len - len(ids) - K - 2)

        t0 = time.perf_counter()
        while len(out_ids) < max_new and out_ids[-1] not in tok.stop_ids:
            drafts = []
            dt = out_ids[-1]
            for j in range(K):
                if self_spec:
                    dl, kv, _ = self._decode_step(kv, dt, pos + j,
                                                  layer_sel=draft_sel)
                else:
                    dl, draft_kv, _ = self._decode_step(
                        draft_kv, dt, pos + j, model=draft_model)
                dt = int(torch.argmax(dl[0]))
                drafts.append(dt)
            # the verify rewrites positions pos .. pos + K in every layer
            vt = torch.tensor([out_ids[-1]] + drafts, device=self.device)
            vlogits, kv = self._verify(kv, vt, pos)
            targets = torch.argmax(vlogits, dim=-1).cpu().numpy()  # [K+1]
            n_acc = 0
            while n_acc < K and targets[n_acc] == drafts[n_acc]:
                n_acc += 1
            emitted = drafts[:n_acc] + [int(targets[n_acc])]
            stats.drafted += K
            stats.accepted += n_acc
            if n_acc == K and not self_spec:
                # full accept: the draft never saw d_{K-1}; write its row
                # at pos + K so the draft cache stays contiguous
                _, draft_kv, _ = self._decode_step(
                    draft_kv, drafts[-1], pos + K, model=draft_model)
            for t in emitted:
                out_ids.append(t)
                if callback:
                    callback(dec.push(t))
                if t in tok.stop_ids:
                    break
            pos += n_acc + 1
        if callback:
            dec.flush_to(callback)
        stats.decode_tokens = len(out_ids)
        stats.decode_ms = (time.perf_counter() - t0) * 1e3
        return tok.decode(out_ids), stats

    def generate_self_speculative_fused(self, prompt: str,
                                        cfg: GenerateConfig | None = None,
                                        callback=None,
                                        draft_layers: int | None = None
                                        ) -> tuple[str, Stats]:
        """Greedy self-speculation with one iteration on the card
        (spec_iter_greedy): one host read per iteration instead of one per
        drafted token. The output is the greedy generation."""
        cfg = cfg or GenerateConfig()
        stats = Stats()
        tok = self.tokenizer
        ids = self._encode(prompt)
        K = cfg.draft_k
        n_draft = draft_layers or max(1, self.arch.n_layers // 2)
        kv = self._start_kv()
        g = self._graphs_of(kv)

        t0 = time.perf_counter()
        logits, kv, _ = self._prefill(kv, ids)
        anchor = torch.argmax(logits[0])
        out_ids = [int(anchor)]  # waits for the card
        dec = tok.stream_decoder() if callback else None
        if callback:
            callback(dec.push(out_ids[0]))
        stats.prefill_tokens = len(ids)
        stats.prefill_ms = (time.perf_counter() - t0) * 1e3

        pos = len(ids)
        max_new = min(cfg.max_tokens, self.arch.max_seq_len - len(ids) - K - 2)
        t0 = time.perf_counter()
        while len(out_ids) < max_new and out_ids[-1] not in tok.stop_ids:
            if g is not None:
                # the first iteration takes the anchor and pos; each later
                # one the new anchor and pos the last left on the device
                first = pos == len(ids)
                got = g.spec(kv, K, n_draft, anchor if first else None,
                             pos if first else None).tolist()  # one read
            else:
                kv, emit, n_acc, anchor = spec_iter_greedy(
                    self.arch, self.model.weights, kv, anchor, pos, K,
                    n_draft)
                got = torch.cat([emit, n_acc.reshape(1)]).tolist()
            en = got[-1] + 1
            stats.drafted += K
            stats.accepted += en - 1
            pos += en
            for t in got[:en]:
                if len(out_ids) >= max_new:
                    break
                out_ids.append(t)
                if callback:
                    callback(dec.push(t))
                if t in tok.stop_ids:
                    break
        if callback:
            dec.flush_to(callback)
        stats.decode_tokens = len(out_ids)
        stats.decode_ms = (time.perf_counter() - t0) * 1e3
        return tok.decode(out_ids), stats

    # --- chat ----------------------------------------------------------------
    def chat(self, cfg: GenerateConfig | None = None, input_fn=input,
             print_fn=print):
        """Chat REPL. With a recognized chat template (the GGUF's
        tokenizer.chat_template, inference/chat.py) each turn renders the
        whole message history through the model's own format, and a
        ChatSession carries the cache across turns, so a turn prefills only
        its new tokens; without a template each line goes to generate()
        alone (the raw stateless loop)."""
        from .chat import detect_format, encode_chat
        mdl = self.model if self.model is not None else getattr(self, "tm",
                                                                None)
        fmt = (detect_format(mdl.config.metadata, self.tokenizer)
               if mdl is not None else None)
        print_fn(f"Chat mode ({fmt.name + ' template' if fmt else 'raw'})."
                 f" Empty line or 'exit' to quit.")
        history: list[dict] = []
        session = ChatSession()
        while True:
            try:
                line = input_fn("> ")
            except EOFError:
                break
            if not line or line.strip() == "exit":
                break
            if fmt is None:
                text, stats = self.generate(line, cfg)
            else:
                history.append({"role": "user", "content": line})
                ids = encode_chat(self.tokenizer, fmt, history)
                text, stats = self.generate("", cfg, prompt_ids=ids,
                                            session=session)
                history.append({"role": "assistant", "content": text})
            print_fn(text)
            print_fn(f"[{stats.decode_tps:.2f} tok/s]")

    def benchmark(self, prompt: str = "The capital of France is",
                  n_tokens: int = 64, *,
                  prompt_ids: list[int] | None = None) -> Stats:
        """Greedy benchmark: prefill, then one warm-up and one timed decode
        run of n_tokens, each token kept on the card (no host round trip
        per token). prompt_ids: a pre-encoded prompt (a model without a
        tokenizer, such as a synthetic one, needs it)."""
        stats = Stats()
        ids = (self._clamp_ids(prompt_ids) if prompt_ids is not None
               else self._encode(prompt))
        # warm-up and timed runs both advance the cache; keep both inside
        n_tokens = min(n_tokens,
                       max(1, (self.arch.max_seq_len - len(ids) - 1) // 2))
        kv = self._start_kv()
        t0 = time.perf_counter()
        logits, kv, _ = self._prefill(kv, ids)
        first = torch.argmax(logits[0])
        _sync(self.device)
        stats.prefill_tokens = len(ids)
        stats.prefill_ms = (time.perf_counter() - t0) * 1e3

        _, kv = decode_loop_greedy(self, kv, first, len(ids), n_tokens)
        _sync(self.device)
        t0 = time.perf_counter()
        _, kv = decode_loop_greedy(self, kv, first, len(ids) + n_tokens,
                                   n_tokens)
        _sync(self.device)
        stats.decode_tokens = n_tokens
        stats.decode_ms = (time.perf_counter() - t0) * 1e3
        return stats


def decode_loop_greedy(engine: Engine, kv: KVCache, token: torch.Tensor,
                       pos0: int, n_steps: int):
    """Greedy decode of n_steps tokens from `token` at pos0 through the
    engine's decode step, the argmax kept on the device. On the graph path
    the loop step is replayed n_steps times (captured on first use).
    Returns (tokens [n_steps] tensor, kv)."""
    g = engine._graphs_of(kv)
    if g is not None:
        toks, _ = g.loop(kv, token, pos0, n_steps, engine.layer_sel)
        return toks.clone(), kv
    toks = []
    for i in range(n_steps):
        logits, kv, _ = engine._decode_step(kv, token, pos0 + i)
        token = torch.argmax(logits[0])
        toks.append(token)
    return torch.stack(toks), kv


@torch.inference_mode()
def spec_iter_greedy(arch, weights, kv: KVCache, anchor: torch.Tensor,
                     pos, k: int, n_draft: int):
    """One fused self-speculative iteration on the card: k greedy draft
    steps through the first n_draft layers (each argmax kept on the card as
    the next token), one all-logits verify of [anchor, drafts] at pos (a
    host int or a 0-d device tensor) through the full stack, and the
    longest-prefix accept. Returns (kv, emit [k+1], n_acc, new anchor), all
    on the card; the first n_acc + 1 entries of emit are the tokens to
    emit. Nothing is read on the host (a 0-d tensor index would be), so
    the iteration can be captured (models/graphs.py)."""
    draft_sel = range(n_draft)
    tok, drafts = anchor, []
    for i in range(k):
        logits, kv, _ = forward(arch, weights, kv, tok.reshape(1), pos + i,
                                layer_sel=draft_sel)
        tok = torch.argmax(logits[0])
        drafts.append(tok)
    drafts = torch.stack(drafts)
    vt = torch.cat([anchor.reshape(1), drafts])
    vlogits, kv, _ = forward(arch, weights, kv, vt, pos, all_logits=True)
    targets = torch.argmax(vlogits, dim=-1)                    # [k+1]
    match = targets[:k] == drafts
    n_acc = torch.where(match.all(), k, torch.argmin(match.to(torch.int32)))
    new_anchor = targets.index_select(0, n_acc.reshape(1))     # [1]
    emit = torch.cat([drafts, targets[-1:]])
    # the correction or bonus token at n_acc (the JAX emit.at[n_acc].set)
    emit = torch.where(torch.arange(k + 1, device=emit.device) == n_acc,
                       new_anchor, emit)
    return kv, emit, n_acc, new_anchor[0]


class TPEngine(Engine):
    """Resident engine with TENSOR parallelism (parallel/tp.py): the weights
    and the KV heads split over the mesh's shards, Megatron-style; one
    process drives every shard, and the replicated work (norms, residuals,
    the sums of the shards' partials) runs on the mesh's first device.
    Generation, the chat session, layer-skip calibration and the int8
    cache run the shared loops through the TP forward, replayed on one
    card as the base Engine replays (Engine._graph_path); `benchmark` runs
    make_tp_decode_loop, the JAX TPEngine's on-device loop. The unsharded
    weights are dropped once the shards exist."""

    def __init__(self, model: LoadedModel, mesh, fuse: bool = False,
                 kv_quant: bool = False):
        import dataclasses
        from ..parallel.tp import shard_weights
        super().__init__(model, None, kv_quant=kv_quant)
        self.mesh = tuple(torch.device(d) for d in mesh)
        self.shards = shard_weights(model.weights, self.mesh, model.arch,
                                    fuse=fuse)
        self.model = dataclasses.replace(model, weights=None)
        self.device = self.mesh[0]

    @classmethod
    def load(cls, path: str, tp: int, *, device="cuda", fuse: bool = False,
             kv_quant: bool = False, **kw) -> "TPEngine":
        """Load `path` on the host, then shard it: device "cuda" puts one
        shard on each of the first `tp` cards (raises if there are fewer);
        a device with an index ("cuda:0") or "cpu" puts every shard on it
        (another shard list: TPEngine(model, make_tp_mesh(n, devices)));
        load_model keywords as Engine.load. No unsharded copy lands on a
        card."""
        from ..parallel.tp import tp_mesh
        return cls(load_model(path, device="cpu", fuse=False, **kw),
                   tp_mesh(tp, device), fuse=fuse, kv_quant=kv_quant)

    def _make_kv(self):
        from ..parallel.tp import make_tp_kv
        return make_tp_kv(self.arch, self.mesh, self.kv_quant)

    def _mesh(self) -> dict:
        return {"tp": self.mesh}

    def _weights_of(self, m):
        return self.shards if m is self.model else m.weights

    def _prefill_chunk(self, kv, padded: np.ndarray, off: int, n_valid: int,
                       model=None, with_cosine=False):
        if model is not None:
            raise ValueError("TPEngine has no separate draft model")
        return super()._prefill_chunk(kv, padded, off, n_valid, None,
                                      with_cosine)

    def _decode_step(self, kv, token, pos: int, model=None, with_cosine=False,
                     layer_sel=None):
        if model is not None:
            raise ValueError("TPEngine has no separate draft model")
        return super()._decode_step(kv, token, pos, None, with_cosine,
                                    layer_sel)

    def benchmark(self, prompt: str = "The capital of France is",
                  n_tokens: int = 64, *,
                  prompt_ids: list[int] | None = None) -> Stats:
        """Greedy benchmark, the JAX TPEngine's: prefill, then
        make_tp_decode_loop's run of n_tokens greedy tokens (clamped as the
        JAX package clamps it, so the warm-up and the timed run both fit)
        from the prefill's token, a warm-up from the prompt's end and the
        timed run n_tokens past it. On one card the loop replays the
        engine's own loop graph with no host read between tokens. The loop
        runs the whole stack, as the JAX loop does."""
        from ..parallel.tp import make_tp_decode_loop
        stats = Stats()
        ids = (self._clamp_ids(prompt_ids) if prompt_ids is not None
               else self._encode(prompt))
        kv = self._start_kv()
        t0 = time.perf_counter()
        logits, kv, _ = self._prefill(kv, ids)
        nxt = torch.argmax(logits[0])
        _sync(self.device)
        stats.prefill_tokens = len(ids)
        stats.prefill_ms = (time.perf_counter() - t0) * 1e3
        pos = len(ids)
        n_tokens = min(n_tokens,
                       max(1, (self.arch.max_seq_len - len(ids) - 1) // 2))
        loop = make_tp_decode_loop(self.mesh, self.arch, n_tokens,
                                   kv_quant=self.kv_quant,
                                   graphs=self._graphs_of)
        # the warm-up captures the loop step and advances the cache; the
        # timed run starts past it
        toks, kv = loop(self.shards, kv, nxt, pos)
        toks.cpu()
        t0 = time.perf_counter()
        toks, kv = loop(self.shards, kv, nxt, pos + n_tokens)
        toks.cpu()
        stats.decode_tokens = n_tokens
        stats.decode_ms = (time.perf_counter() - t0) * 1e3
        return stats

    def generate_self_speculative_fused(self, prompt: str, cfg=None,
                                        callback=None, draft_layers=None):
        """The fused iteration runs the unsharded forward; under TP this
        delegates to the host-driven protocol over the TP forward."""
        return self.generate_self_speculative(prompt, cfg, callback,
                                              draft_layers)


class CPEngine(Engine):
    """Resident engine with CONTEXT parallelism: the cache splits along the
    sequence axis over the mesh's shards (parallel/cp.py), so the longest
    context is bounded by the shards' memory together; one process drives
    every shard. The weights and every replicated step run on the mesh's
    first device; a shard's cache slice and attention partials on its own.
    Over a (cp, tp) mesh (parallel/cp.make_cp_tp_mesh) the weights and the
    KV heads also split over tp, as in TPEngine, and the unsharded weights
    are dropped once the shards exist. Generation and `benchmark` run the
    shared loops through the CP forward, replayed on one card as the base
    Engine replays; layer-skip calibration and the int8 cache are refused,
    as in the JAX package."""

    def __init__(self, model: LoadedModel, mesh):
        import dataclasses
        from ..parallel.cp import shard_rows
        shard_rows(model.arch, len(mesh))  # refuse an uneven split early
        super().__init__(model)
        self.shards = None
        if isinstance(mesh[0], (tuple, list)):
            from ..parallel.tp import shard_weights
            self.mesh = tuple(tuple(torch.device(d) for d in row)
                              for row in mesh)
            self.shards = shard_weights(model.weights, self.mesh[0],
                                        model.arch)
            self.model = dataclasses.replace(model, weights=None)
            self.device = self.mesh[0][0]
        else:
            self.mesh = tuple(mesh)

    @classmethod
    def load(cls, path: str, cp: int, *, tp: int | None = None,
             device="cuda", kv_quant: bool = False, **kw) -> "CPEngine":
        """Load `path` unfused onto the first device of a cp-way mesh, or
        with tp > 1 on the host, then sharded over a (cp, tp) mesh: every
        position on the CPU for device="cpu", on the card for a device with
        an index ("cuda:0"; without tp, one shard on each of the first `cp`
        cards as before), else one position on each of the first cp (* tp)
        cards (another mesh: CPEngine(model, make_cp_mesh(n, devices)) or
        make_cp_tp_mesh); load_model keywords as Engine.load."""
        if kv_quant:
            # fail at load time, not at the first decode step
            raise NotImplementedError(
                "--kv-int8 with context parallelism is not supported "
                "(int8 KV + CP guard, models/llama.py); drop --kv-int8 "
                "or use --tp, where int8 KV composes")
        if tp and tp > 1:
            from ..parallel.cp import cp_tp_mesh
            return cls(load_model(path, device="cpu", fuse=False, **kw),
                       cp_tp_mesh(cp, tp, device))
        from ..parallel.cp import make_cp_mesh
        mesh = make_cp_mesh(cp, [device] * cp
                            if torch.device(device).type == "cpu" else None)
        return cls(load_model(path, device=mesh[0], fuse=False, **kw), mesh)

    def _make_kv(self):
        from ..parallel.cp import make_cp_kv, make_cp_tp_kv
        if self.shards is not None:
            return make_cp_tp_kv(self.arch, self.mesh)
        return make_cp_kv(self.arch, self.mesh)

    def _check_step(self, with_cosine: bool):
        if with_cosine or self.layer_sel is not None:
            raise NotImplementedError(
                "CPEngine: no layer-skip calibration or schedule under "
                "context parallelism")

    def _mesh(self) -> dict:
        if self.shards is not None:
            return {"cp": self.mesh, "tp": self.mesh[0]}
        return {"cp": self.mesh}

    def _weights_of(self, m):
        return (self.shards if self.shards is not None and m is self.model
                else m.weights)

    def _prefill_chunk(self, kv, padded: np.ndarray, off: int, n_valid: int,
                       model=None, with_cosine=False):
        if model is not None:
            raise ValueError("CPEngine: no draft model under context "
                             "parallelism")
        self._check_step(with_cosine)
        return super()._prefill_chunk(kv, padded, off, n_valid)

    def _decode_step(self, kv, token, pos: int, model=None, with_cosine=False,
                     layer_sel=None):
        if model is not None or layer_sel is not None:
            # the JAX CPEngine asserts the same: the CP forward runs the
            # whole stack of the one model
            raise ValueError("CPEngine: no draft model or draft layer "
                             "prefix under context parallelism")
        self._check_step(with_cosine)
        return super()._decode_step(kv, token, pos)

    def _verify(self, kv, tokens, pos: int):
        self._check_step(False)
        return super()._verify(kv, tokens, pos)

    def generate_self_speculative_fused(self, prompt: str, cfg=None,
                                        callback=None, draft_layers=None):
        """The fused iteration runs the unsharded forward; under CP this
        delegates to the host-driven protocol over the CP forward."""
        return self.generate_self_speculative(prompt, cfg, callback,
                                              draft_layers)


class EPEngine(Engine):
    """Resident engine with EXPERT parallelism (parallel/ep.py): a
    mixture-of-experts model's expert planes split on their expert axis
    over the mesh's shards, so the bulk of its bytes divides over the
    shards' memory; the router, attention, the cache and every other step
    run once on the mesh's first device. Generation, the chat session and
    `benchmark` run the shared loops through the EP forward; a draft model,
    a layer prefix and layer-skip calibration are refused, as in the JAX
    package. The unsharded expert planes are dropped one by one as their
    shards are made (ep.shard_weights_ep): a model already on the card is
    split in place. On one card its chunks, steps and verify windows
    replay as the base Engine's do."""

    _REFUSAL = "EPEngine: no draft model / cosine calibration under EP"

    def __init__(self, model: LoadedModel, mesh, kv_quant: bool = False):
        import dataclasses
        from ..parallel.ep import shard_weights_ep
        if not model.arch.n_experts:
            raise ValueError("--ep needs a mixture-of-experts model "
                             "(expert_count metadata)")
        super().__init__(model, None, kv_quant=kv_quant)
        self.mesh = tuple(torch.device(d) for d in mesh)
        self.shards = shard_weights_ep(model.weights, self.mesh, model.arch)
        self.model = dataclasses.replace(model, weights=None)
        self.device = self.mesh[0]

    @classmethod
    def load(cls, path: str, ep: int, *, device="cuda",
             kv_quant: bool = False, **kw) -> "EPEngine":
        """Load `path` on the host, then shard it: device "cuda" puts one
        shard on each of the first `ep` cards (raises if there are fewer);
        a device with an index ("cuda:0") or "cpu" puts every shard on it
        (another shard list: EPEngine(model, make_ep_mesh(n, devices)));
        load_model keywords as Engine.load."""
        from ..parallel.ep import ep_mesh
        return cls(load_model(path, device="cpu", **kw), ep_mesh(ep, device),
                   kv_quant=kv_quant)

    def _mesh(self) -> dict:
        return {"ep": self.mesh}

    def _weights_of(self, m):
        return self.shards if m is self.model else m.weights

    def _prefill_chunk(self, kv, padded: np.ndarray, off: int, n_valid: int,
                       model=None, with_cosine=False):
        if model is not None or with_cosine or self.layer_sel is not None:
            raise ValueError(self._REFUSAL)
        return super()._prefill_chunk(kv, padded, off, n_valid)

    def _decode_step(self, kv, token, pos: int, model=None, with_cosine=False,
                     layer_sel=None):
        if model is not None or with_cosine or layer_sel is not None:
            raise ValueError(self._REFUSAL)
        return super()._decode_step(kv, token, pos)

    def generate_self_speculative_fused(self, prompt: str, cfg=None,
                                        callback=None, draft_layers=None):
        """The fused iteration runs the unsharded forward; under EP this
        delegates to the host-driven protocol over the EP forward."""
        return self.generate_self_speculative(prompt, cfg, callback,
                                              draft_layers)


class TieredEngine(Engine):
    """Engine over a TieredModel: per-token layer streaming, layer-skip
    calibration that drops streamed layers (and their I/O), early exit, and
    speculation: self-speculation drafts on the resident prefix (no
    streaming I/O), a separate draft model stays resident."""

    def __init__(self, tiered, kv_quant: bool = False,
                 draft: LoadedModel | None = None):
        self.tm = tiered
        self.model = None
        self.draft = draft  # a separate resident draft model
        self.arch = tiered.arch
        self.tokenizer = tiered.tokenizer
        self.device = tiered.device
        self.layer_sel = None
        self.skip: frozenset = frozenset()
        self.early_exit_threshold = 0.0  # set per generate() from cfg
        self.kv_quant = kv_quant  # int8 KV cache (half its device memory)

    def _graph_path(self) -> bool:
        """The tiered path stays host-driven (streaming and early exit
        decide on the host), as in the JAX package."""
        return False

    @classmethod
    def load(cls, path: str, kv_quant: bool = False,
             draft_path: str | None = None, **kw) -> "TieredEngine":
        """Load `path` tiered (load_model_tiered keywords: device, mesh,
        max_hbm_layers, requant_ram, ...). draft_path: a draft model loaded
        first, resident on the same device; the tiered loader then sizes
        the resident prefix on what is left, less the draft's bf16 cache."""
        from ..models.tiered import load_model_tiered
        draft = None
        extra = 0
        if draft_path:
            draft = load_model(draft_path,
                               max_seq_len=kw.get("max_seq_len") or None,
                               device=kw.get("device", "cuda"))
            da = draft.arch
            extra = (da.n_layers * da.n_kv_heads * da.max_seq_len
                     * da.head_dim * 2 * 2)  # the draft's bf16 k and v
        tm = load_model_tiered(path, reserve_extra_bytes=extra,
                               kv_quant=kv_quant, **kw)
        return cls(tm, kv_quant=kv_quant, draft=draft)

    def _make_kv(self):
        from ..models.tiered import TieredKV
        from ..models.tiered_moe import TieredMoEModel
        if isinstance(self.tm, TieredMoEModel):
            # MoE tiering streams experts: the whole attention stack is
            # resident, so one full-depth cache
            return KVCache.create(self.arch, quant=self.kv_quant,
                                  device=self.device)
        return TieredKV.create(self.arch, self.tm.tiers, quant=self.kv_quant,
                               device=self.device, mesh=self.tm.mesh)

    def _prefill_chunk(self, kv, padded: np.ndarray, off: int, n_valid: int,
                       model=None, with_cosine=False):
        from ..models.tiered import forward_tiered
        if model is not None:  # the resident draft model's prefill
            return super()._prefill_chunk(kv, padded, off, n_valid, model,
                                          with_cosine)
        return forward_tiered(self.tm, kv, torch.from_numpy(padded), off,
                              n_valid=n_valid, with_cosine=with_cosine,
                              skip=self.skip)

    def _decode_step(self, kv, token, pos: int, model=None, with_cosine=False,
                     layer_sel=None):
        from ..models.tiered import forward_tiered
        if model is not None:  # the draft model: resident, no streaming
            return super()._decode_step(kv, token, pos, model, with_cosine,
                                        layer_sel)
        tok = torch.as_tensor(token, device=self.device).reshape(1)
        # any layer_sel (the draft prefix of _speculate) is the resident
        # prefix alone: no streaming I/O
        return forward_tiered(self.tm, kv, tok, pos, with_cosine=with_cosine,
                              skip=self.skip,
                              draft_only=layer_sel is not None,
                              early_exit_threshold=self.early_exit_threshold)

    def _verify(self, kv, tokens, pos: int):
        from ..models.tiered import forward_tiered
        logits, kv, _ = forward_tiered(self.tm, kv, tokens, pos,
                                       all_logits=True, skip=self.skip)
        return logits, kv

    def _calibrate(self, cosines, threshold: float) -> list[int]:
        n = self.arch.n_layers
        lo, hi = n // 4, (3 * n) // 4
        skip = [i for i in range(lo, hi) if float(cosines[i]) > threshold]
        self.skip = frozenset(skip)
        return skip

    def generate(self, prompt: str, cfg: GenerateConfig | None = None,
                 callback=None, *, prompt_ids: list[int] | None = None,
                 session: ChatSession | None = None) -> tuple[str, Stats]:
        if cfg is not None:
            # early exit pays only on the tiered path: breaking the streamed
            # loop skips the remaining layers' transfers
            self.early_exit_threshold = cfg.early_exit_threshold
        return super().generate(prompt, cfg, callback,
                                prompt_ids=prompt_ids, session=session)

    def generate_self_speculative(self, prompt: str, cfg=None,
                                  callback=None, draft_layers=None):
        """The resident prefix drafts; draft_layers is implied by it."""
        return self._speculate(prompt, cfg, callback, self_spec=True,
                               draft_layers=self.tm.n_resident or 1)

    def generate_self_speculative_fused(self, prompt: str, cfg=None,
                                        callback=None, draft_layers=None):
        """The fused iteration needs the whole stack resident; on the
        tiered path this delegates to the host-driven protocol (draft = the
        resident prefix, verify = one streamed pass)."""
        return self.generate_self_speculative(prompt, cfg, callback,
                                              draft_layers)

    def benchmark(self, prompt: str = "The capital of France is",
                  n_tokens: int = 64, *,
                  prompt_ids: list[int] | None = None) -> Stats:
        """Greedy benchmark: prefill, then n_tokens decode steps with the
        argmax kept on the card between steps; one synchronize at the end
        times the run."""
        stats = Stats()
        ids = (self._clamp_ids(prompt_ids) if prompt_ids is not None
               else self._encode(prompt))
        n_tokens = min(n_tokens, max(1, self.arch.max_seq_len - len(ids)))
        kv = self._make_kv()
        t0 = time.perf_counter()
        logits, kv, _ = self._prefill(kv, ids)
        nxt = torch.argmax(logits[0])
        _sync(self.device)
        stats.prefill_tokens = len(ids)
        stats.prefill_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for i in range(n_tokens):
            logits, kv, _ = self._decode_step(kv, nxt, len(ids) + i)
            nxt = torch.argmax(logits[0])
        _sync(self.device)
        stats.decode_tokens = n_tokens
        stats.decode_ms = (time.perf_counter() - t0) * 1e3
        return stats
