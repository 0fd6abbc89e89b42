"""Token sampler — on the logits' device, with a numpy reference twin.

Port of ntransformer_tpu/inference/sampler.py (single stream): temperature,
top-k, top-p renormalization, a categorical draw and the repeat penalty over
a trailing window; greedy when temperature <= 0, and greedy still applies
the penalty when it is not 1.0. Randomness comes from an explicit
torch.Generator on the logits' device; its stream differs from jax.random's,
so tests compare distributions, not draws. The batched serving sampler
arrives with the serving slice (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    repeat_penalty: float = 1.1
    repeat_window: int = 64
    seed: int = 42

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def apply_repeat_penalty_np(logits: np.ndarray, recent: np.ndarray,
                            penalty: float) -> np.ndarray:
    """Penalize tokens seen in the trailing window: positive logits are
    divided by the penalty, negative multiplied; once per unique token."""
    if penalty == 1.0 or len(recent) == 0:
        return logits
    out = logits.copy()
    for t in np.unique(recent):
        if 0 <= t < len(out):
            out[t] = out[t] / penalty if out[t] > 0 else out[t] * penalty
    return out


def sample_np(logits: np.ndarray, cfg: SamplerConfig,
              rng: np.random.Generator) -> int:
    """Numpy reference: temperature → top-k → softmax → top-p → draw."""
    if cfg.greedy:
        return int(np.argmax(logits))
    x = logits.astype(np.float64) / cfg.temperature
    k = min(cfg.top_k if cfg.top_k > 0 else len(x), len(x))
    idx = np.argpartition(-x, k - 1)[:k]
    idx = idx[np.argsort(-x[idx], kind="stable")]
    p = np.exp(x[idx] - x[idx[0]])
    p /= p.sum()
    if cfg.top_p < 1.0:
        cum = np.cumsum(p)
        cut = int(np.searchsorted(cum, cfg.top_p) + 1)
        idx, p = idx[:cut], p[:cut]
        p /= p.sum()
    return int(rng.choice(idx, p=p))


def sample_device(logits: torch.Tensor, generator: torch.Generator,
                  recent: torch.Tensor, cfg: SamplerConfig,
                  vocab_size: int) -> torch.Tensor:
    """Sample on the logits' device; returns a 0-d int64 tensor. `recent`
    is an int window padded with vocab_size (out-of-range ids drop)."""
    logits = logits.to(torch.float32)
    if cfg.repeat_penalty != 1.0:
        seen = torch.zeros(vocab_size + 1, dtype=torch.bool,
                           device=logits.device)
        seen[recent.clamp(0, vocab_size)] = True
        seen = seen[:vocab_size]
        penalized = torch.where(logits > 0, logits / cfg.repeat_penalty,
                                logits * cfg.repeat_penalty)
        logits = torch.where(seen, penalized, logits)
    if cfg.greedy:
        return torch.argmax(logits)
    x = logits / cfg.temperature
    k = min(cfg.top_k if cfg.top_k > 0 else vocab_size, vocab_size)
    vals, idx = torch.topk(x, k)
    logp = torch.log_softmax(vals, dim=-1)
    if cfg.top_p < 1.0:
        probs = torch.exp(logp)
        cum = torch.cumsum(probs, dim=-1)
        # keep the minimal prefix whose cumulative probability reaches top_p
        logp = torch.where((cum - probs) < cfg.top_p, logp,
                           torch.full_like(logp, float("-inf")))
    choice = torch.multinomial(torch.softmax(logp, dim=-1), 1,
                               generator=generator)
    return idx[choice[0]]


class Sampler:
    """Stateful wrapper holding the generator and the recent-token window."""

    def __init__(self, cfg: SamplerConfig, vocab_size: int, device="cpu"):
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        w = max(cfg.repeat_window, 1)
        self._recent = np.full((w,), vocab_size, dtype=np.int64)
        self._recent_dev = torch.from_numpy(self._recent.copy()).to(
            self.device)
        self._n = 0

    def observe(self, token: int):
        """Record a generated token into the repeat-penalty window."""
        w = len(self._recent)
        self._recent[self._n % w] = token
        self._n += 1
        self._recent_dev = torch.from_numpy(self._recent.copy()).to(
            self.device)

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_device(logits, self.generator, self._recent_dev,
                             self.cfg, self.vocab_size)
