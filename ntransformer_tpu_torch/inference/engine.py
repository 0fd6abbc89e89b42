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

`TieredEngine` runs the same loops over a TieredModel (models/tiered.py):
per-token layer streaming, layer-skip that drops streamed I/O, early exit,
self-speculation drafting on the resident prefix and a separate resident
draft model. `CPEngine` runs them with context parallelism
(parallel/cp.py): the cache split along the sequence axis over a list of
shard devices, one process driving every shard. The tensor- and
expert-parallel engines wait for ROADMAP queue 1 item 14.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

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
    in it, carried across generate() calls; only the new tokens prefill."""

    kv: object | None = None
    ids_in_kv: list[int] = field(default_factory=list)


def _bucket(n: int, buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                             4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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

    def _prefill(self, kv: KVCache, tokens: list[int], model=None,
                 with_cosine=False, start: int = 0):
        """Bucketed prefill of tokens[start:] at their true offsets, in
        512-token chunks past one chunk, through `model` (default the
        engine's). Returns (last logits [1, V], kv, cosines of the final
        chunk)."""
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
        return forward(m.arch, m.weights, kv, torch.from_numpy(padded), off,
                       layer_sel=sel, n_valid=n_valid,
                       with_cosine=with_cosine)

    def _decode_step(self, kv: KVCache, token, pos: int, model=None,
                     with_cosine=False, layer_sel=None):
        """One token through `model` (default the engine's) at pos;
        layer_sel (a draft's layer prefix) replaces the engine's layer-skip
        schedule."""
        m = model if model is not None else self.model
        tok = torch.as_tensor(token, device=m.device).reshape(1)
        sel = layer_sel if layer_sel is not None else (
            self.layer_sel if m is self.model else None)
        return forward(m.arch, m.weights, kv, tok, pos, layer_sel=sel,
                       with_cosine=with_cosine)

    def _verify(self, kv, tokens, pos: int):
        """All-position logits [T, V] of tokens written at pos through the
        full model (its layer-skip schedule applied). Returns (logits,
        kv)."""
        logits, kv, _ = forward(self.arch, self.model.weights, kv, tokens,
                                pos, layer_sel=self.layer_sel,
                                all_logits=True)
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
        if session is not None and session.kv is not None:
            cached = session.ids_in_kv
            n = 0
            while (n < len(cached) and n < len(ids) - 1
                   and cached[n] == ids[n]):
                n += 1
            if n > 0:
                kv, start = session.kv, n
                session.kv = None
        if start == 0:
            kv = self._make_kv()

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
        kv = self._make_kv()

        if self_spec:
            draft_model = None
            draft_sel = np.arange(draft_layers)
            draft_kv = None  # the draft layers share the main cache
        else:
            draft_model = self.draft
            draft_sel = None
            draft_kv = KVCache.create(draft_model.arch,
                                      device=draft_model.device)

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
        kv = self._make_kv()

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
            kv, emit, n_acc, anchor = spec_iter_greedy(
                self.arch, self.model.weights, kv, anchor, pos, K, n_draft)
            got = torch.cat([emit, n_acc.reshape(1)]).tolist()  # one read
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
        kv = self._make_kv()
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
    engine's decode step, the argmax kept on the device. Returns (tokens
    [n_steps] tensor, kv)."""
    toks = []
    for i in range(n_steps):
        logits, kv, _ = engine._decode_step(kv, token, pos0 + i)
        token = torch.argmax(logits[0])
        toks.append(token)
    return torch.stack(toks), kv


@torch.inference_mode()
def spec_iter_greedy(arch, weights, kv: KVCache, anchor: torch.Tensor,
                     pos: int, k: int, n_draft: int):
    """One fused self-speculative iteration on the card: k greedy draft
    steps through the first n_draft layers (each argmax kept on the card as
    the next token), one all-logits verify of [anchor, drafts] at pos
    through the full stack, and the longest-prefix accept. Returns (kv,
    emit [k+1], n_acc, new anchor), all on the card; the first n_acc + 1
    entries of emit are the tokens to emit."""
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
    emit = torch.cat([drafts, targets[-1:]])
    emit[n_acc] = targets[n_acc]  # the correction or bonus token
    return kv, emit, n_acc, targets[n_acc]


class CPEngine(Engine):
    """Resident engine with CONTEXT parallelism: the cache splits along the
    sequence axis over the mesh's shards (parallel/cp.py), so the longest
    context is bounded by the shards' memory together; one process drives
    every shard. The weights and every replicated step run on the mesh's
    first device; a shard's cache slice and attention partials on its own.
    Generation and `benchmark` run the shared loops through the CP forward;
    layer-skip calibration and the int8 cache are refused, as in the JAX
    package."""

    def __init__(self, model: LoadedModel, mesh):
        from ..parallel.cp import shard_rows
        shard_rows(model.arch, len(mesh))  # refuse an uneven split early
        super().__init__(model)
        self.mesh = tuple(mesh)

    @classmethod
    def load(cls, path: str, cp: int, *, device="cuda",
             kv_quant: bool = False, **kw) -> "CPEngine":
        """Load `path` unfused onto the first device of a cp-way mesh: every
        shard on the CPU for device="cpu", else one shard on each of the
        first `cp` cards (another shard list: CPEngine(model,
        make_cp_mesh(n, devices))); load_model keywords as Engine.load."""
        if kv_quant:
            # fail at load time, not at the first decode step
            raise NotImplementedError(
                "--kv-int8 with context parallelism is not supported "
                "(int8 KV + CP guard, models/llama.py); drop --kv-int8 "
                "or use --tp, where int8 KV composes")
        from ..parallel.cp import make_cp_mesh
        mesh = make_cp_mesh(cp, [device] * cp
                            if torch.device(device).type == "cpu" else None)
        return cls(load_model(path, device=mesh[0], fuse=False, **kw), mesh)

    def _make_kv(self):
        from ..parallel.cp import make_cp_kv
        return make_cp_kv(self.arch, self.mesh)

    def _check_step(self, with_cosine: bool):
        if with_cosine or self.layer_sel is not None:
            raise NotImplementedError(
                "CPEngine: no layer-skip calibration or schedule under "
                "context parallelism")

    def _prefill_chunk(self, kv, padded: np.ndarray, off: int, n_valid: int,
                       model=None, with_cosine=False):
        if model is not None:
            raise ValueError("CPEngine: no draft model under context "
                             "parallelism")
        self._check_step(with_cosine)
        return forward(self.arch, self.model.weights, kv,
                       torch.from_numpy(padded), off, n_valid=n_valid,
                       cp=self.mesh)

    def _decode_step(self, kv, token, pos: int, model=None, with_cosine=False,
                     layer_sel=None):
        if model is not None or layer_sel is not None:
            # the JAX CPEngine asserts the same: the CP forward runs the
            # whole stack of the one model
            raise ValueError("CPEngine: no draft model or draft layer "
                             "prefix under context parallelism")
        self._check_step(with_cosine)
        tok = torch.as_tensor(token, device=self.device).reshape(1)
        return forward(self.arch, self.model.weights, kv, tok, pos,
                       cp=self.mesh)

    def _verify(self, kv, tokens, pos: int):
        self._check_step(False)
        logits, kv, _ = forward(self.arch, self.model.weights, kv, tokens,
                                pos, all_logits=True, cp=self.mesh)
        return logits, kv

    def generate_self_speculative_fused(self, prompt: str, cfg=None,
                                        callback=None, draft_layers=None):
        """The fused iteration runs the unsharded forward; under CP this
        delegates to the host-driven protocol over the CP forward."""
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

    @classmethod
    def load(cls, path: str, kv_quant: bool = False,
             draft_path: str | None = None, **kw) -> "TieredEngine":
        """Load `path` tiered (load_model_tiered keywords: device,
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
                               device=self.device)

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
