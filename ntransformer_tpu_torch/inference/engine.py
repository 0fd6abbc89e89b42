"""Inference engine: generation loops over the functional model (PyTorch).

Port of ntransformer_tpu/inference/engine.py, single-device resident path:
`generate` (bucketed prefill → sample → decode loop, with ChatSession KV
reuse and layer-skip calibration) and `benchmark` (greedy timing). Prefill
lengths stay bucketed exactly as in the JAX package (powers of two,
512-token chunks, valid-length masking), so both packages run the same
shapes; the cache is updated in place by each forward. In `benchmark` a
Python loop of forwards takes the place of the jitted `lax.scan` decode
loop; the argmax stays on the card, so the loop never waits for the host.

`TieredEngine` runs the same loops over a TieredModel (models/tiered.py):
per-token layer streaming, layer-skip that drops streamed I/O, and early
exit. Speculative generation (the tiered self-speculation and the separate
draft model among it) and the tensor-, context- and expert-parallel engines
wait for their ROADMAP items (queue 1 items 13 and 14).
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
    """High-level generation engine over a loaded model."""

    PREFILL_CHUNK = 512

    def __init__(self, model: LoadedModel, kv_quant: bool = False):
        self.model = model
        self.kv_quant = kv_quant  # int8 KV cache (half the cache memory)
        self.arch = model.arch
        self.tokenizer = model.tokenizer
        self.device = model.device
        self.layer_sel: np.ndarray | None = None  # layer-skip schedule

    @classmethod
    def load(cls, path: str, kv_quant: bool = False, **kw) -> "Engine":
        """Load `path` resident (load_model keywords: device, fuse, ...)."""
        return cls(load_model(path, **kw), kv_quant=kv_quant)

    # --- internals ----------------------------------------------------------
    def _clamp_ids(self, ids: list[int]) -> list[int]:
        limit = max(1, self.arch.max_seq_len - 2)
        return list(ids[-limit:]) if len(ids) > limit else list(ids)

    def _encode(self, prompt: str) -> list[int]:
        return self._clamp_ids(self.tokenizer.encode(prompt, add_bos=True))

    def _make_kv(self) -> KVCache:
        return KVCache.create(self.arch, quant=self.kv_quant,
                              device=self.device)

    def _prefill(self, kv: KVCache, tokens: list[int], with_cosine=False,
                 start: int = 0):
        """Bucketed prefill of tokens[start:] at their true offsets, in
        512-token chunks past one chunk. Returns (last logits [1, V], kv,
        cosines of the final chunk)."""
        t = len(tokens)
        S = self.arch.max_seq_len
        if t - start <= self.PREFILL_CHUNK:
            # the padded rows must stay inside the cache
            p = min(_bucket(t - start), S - start)
            padded = np.zeros(p, dtype=np.int64)
            padded[: t - start] = tokens[start:]
            return self._prefill_chunk(kv, padded, start, t - start,
                                       with_cosine)
        c = self.PREFILL_CHUNK
        logits = cos = None
        for off in range(start, t, c):
            chunk = tokens[off: off + c]
            p = min(c, S - off)  # the last chunk may not pad past the end
            padded = np.zeros(p, dtype=np.int64)
            padded[: len(chunk)] = chunk
            logits, kv, cos = self._prefill_chunk(kv, padded, off, len(chunk),
                                                  with_cosine)
        return logits, kv, cos

    def _prefill_chunk(self, kv, padded: np.ndarray, off: int, n_valid: int,
                       with_cosine=False):
        return forward(self.arch, self.model.weights, kv,
                       torch.from_numpy(padded), off, layer_sel=self.layer_sel,
                       n_valid=n_valid, with_cosine=with_cosine)

    def _decode_step(self, kv: KVCache, token, pos: int, with_cosine=False):
        tok = torch.as_tensor(token, device=self.device).reshape(1)
        return forward(self.arch, self.model.weights, kv, tok, pos,
                       layer_sel=self.layer_sel, with_cosine=with_cosine)

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
    """Greedy decode of n_steps tokens from `token` at pos0, the argmax kept
    on the device. Returns (tokens [n_steps] tensor, kv)."""
    toks = []
    for i in range(n_steps):
        logits, kv, _ = forward(engine.arch, engine.model.weights, kv,
                                token.reshape(1), pos0 + i)
        token = torch.argmax(logits[0])
        toks.append(token)
    return torch.stack(toks), kv


class TieredEngine(Engine):
    """Engine over a TieredModel: per-token layer streaming, layer-skip
    calibration that drops streamed layers (and their I/O), early exit."""

    def __init__(self, tiered, kv_quant: bool = False):
        self.tm = tiered
        self.model = None
        self.arch = tiered.arch
        self.tokenizer = tiered.tokenizer
        self.device = tiered.device
        self.layer_sel = None
        self.skip: frozenset = frozenset()
        self.early_exit_threshold = 0.0  # set per generate() from cfg
        self.kv_quant = kv_quant  # int8 KV cache (half its device memory)

    @classmethod
    def load(cls, path: str, kv_quant: bool = False, **kw) -> "TieredEngine":
        """Load `path` tiered (load_model_tiered keywords: device,
        max_hbm_layers, requant_ram, ...)."""
        from ..models.tiered import load_model_tiered
        return cls(load_model_tiered(path, kv_quant=kv_quant, **kw),
                   kv_quant=kv_quant)

    def _make_kv(self):
        from ..models.tiered import TieredKV
        return TieredKV.create(self.arch, self.tm.tiers, quant=self.kv_quant,
                               device=self.device)

    def _prefill_chunk(self, kv, padded: np.ndarray, off: int, n_valid: int,
                       with_cosine=False):
        from ..models.tiered import forward_tiered
        return forward_tiered(self.tm, kv, torch.from_numpy(padded), off,
                              n_valid=n_valid, with_cosine=with_cosine,
                              skip=self.skip)

    def _decode_step(self, kv, token, pos: int, with_cosine=False):
        from ..models.tiered import forward_tiered
        tok = torch.as_tensor(token, device=self.device).reshape(1)
        return forward_tiered(self.tm, kv, tok, pos, with_cosine=with_cosine,
                              skip=self.skip,
                              early_exit_threshold=self.early_exit_threshold)

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
