"""Token sampler — on the logits' device, with a numpy reference twin.

Port of ntransformer_tpu/inference/sampler.py (single stream): temperature,
top-k, top-p renormalization, a categorical draw and the repeat penalty over
a trailing window; greedy when temperature <= 0, and greedy still applies
the penalty when it is not 1.0. Randomness comes from an explicit
torch.Generator on the logits' device; its stream differs from jax.random's,
so tests compare distributions, not draws.

`BatchedSampler` is the serving loop's sampler: per-slot state (parameters,
repeat windows, one generator per slot) stays on the device and a step
costs one host read for the whole batch. A slot's random stream is fixed by
its request: its generator is seeded from (seed, request_id). Its
`spec_accept` is the accept round of speculative serving: greedy-draft
rejection sampling (`spec_accept_rows`), one host read a round.
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

    def __init__(self, cfg: SamplerConfig, vocab_size: int, device):
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


def slot_seed(seed: int, *stream: int) -> int:
    """A generator seed for the random stream named by the non-negative
    ints `stream` under `seed`: numpy's SeedSequence mixes them, so
    neighbouring ids give unrelated streams."""
    return int(np.random.SeedSequence([seed, *stream]).generate_state(
        1, np.uint64)[0])


def sample_rows(logits: torch.Tensor, u: torch.Tensor, recent: torch.Tensor,
                temps: torch.Tensor, top_ps: torch.Tensor,
                penalties: torch.Tensor, k_limits: torch.Tensor, k_cap: int,
                vocab_size: int) -> torch.Tensor:
    """One token per row with per-row parameters (the JAX package's
    _sample_row, batched): repeat penalty over the row's window, then greedy
    where temperature <= 0, else temperature, top-k (the row's limit within
    the static width k_cap), top-p and an inverse-CDF draw at the uniform
    u. logits [B, V]; u, temps, top_ps, penalties, k_limits [B]; recent
    [B, W] padded with vocab_size. Returns [B] int64."""
    idx, probs, gmax = _target_dist(logits, recent, temps, top_ps, penalties,
                                    k_limits, k_cap, vocab_size)
    cdf = torch.cumsum(probs, -1)
    choice = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    sampled = idx.gather(1, choice.clamp(max=k_cap - 1))[:, 0]
    return torch.where(temps <= 0.0, gmax, sampled)


def _target_dist(lg: torch.Tensor, recent: torch.Tensor, temps, top_ps,
                 penalties, k_limits, k_cap: int, vocab_size: int):
    """Each row's sampling distribution as sample_rows builds it: (top-k
    token ids [B, k_cap], their probabilities with the ranks past the row's
    top-k and top-p masked to 0 (not renormalised), the penalized argmax
    [B])."""
    lg = lg.to(torch.float32)
    seen = torch.zeros(lg.shape[0], vocab_size + 1, dtype=torch.bool,
                       device=lg.device)
    seen.scatter_(1, recent.clamp(0, vocab_size), True)
    pen = penalties[:, None]
    penalized = torch.where(lg > 0, lg / pen, lg * pen)
    lg = torch.where(seen[:, :vocab_size] & (pen != 1.0), penalized, lg)
    x = lg / temps.clamp(min=1e-6)[:, None]
    vals, idx = torch.topk(x, k_cap, dim=-1)
    keep = torch.arange(k_cap, device=lg.device)[None] < k_limits[:, None]
    probs = torch.softmax(vals.masked_fill(~keep, float("-inf")), dim=-1)
    keep = keep & ((torch.cumsum(probs, -1) - probs) < top_ps[:, None])
    return idx, probs.masked_fill(~keep, 0.0), torch.argmax(lg, dim=-1)


def spec_accept_rows(vlogits: torch.Tensor, drafts: torch.Tensor,
                     u_acc: torch.Tensor, u_corr: torch.Tensor,
                     recent: torch.Tensor, n: torch.Tensor,
                     temps: torch.Tensor, top_ps: torch.Tensor,
                     penalties: torch.Tensor, k_limits: torch.Tensor,
                     active: torch.Tensor, k_cap: int, vocab_size: int):
    """The accept round of speculative serving (the JAX package's
    _spec_accept_batched): greedy-draft rejection sampling, position by
    position over the K + 1 verify rows. The draft's distribution is the
    point mass at its argmax d_j, so d_j is accepted with probability
    p_j(d_j) (the row's penalized, tempered, top-k / top-p target
    distribution) at the uniform u_acc[:, j]; on a rejection the correction
    is drawn from p_j with d_j masked out, by inverse CDF at u_corr[:, j].
    Row K (the bonus) draws from the full p_K. The repeat-penalty window
    advances inside the round, so position j + 1 sees position j's token. A
    greedy row (temperature <= 0) accepts iff its argmax equals d_j, the
    argmax being the correction.

    vlogits [B, K+1, V]; drafts [B, K]; u_acc, u_corr [B, K+1]; recent
    [B, W] and n [B] (updated in place). Returns (tokens [B, K+1] with
    vocab_size past each row's emitted prefix, n_acc [B])."""
    b_n, k1, _ = vlogits.shape
    dev = vlogits.device
    rows = torch.arange(b_n, device=dev)
    w = recent.shape[1]
    alive = active.to(torch.bool).clone()
    n_acc = torch.zeros(b_n, dtype=torch.long, device=dev)
    drafts = torch.cat([drafts.to(dev, torch.long),
                        torch.full((b_n, 1), -1, dtype=torch.long,
                                   device=dev)], dim=1)
    greedy = temps <= 0.0
    out = []
    for j in range(k1):
        bonus = j == k1 - 1
        d = drafts[:, j]
        idx, probs, gmax = _target_dist(vlogits[:, j], recent, temps, top_ps,
                                        penalties, k_limits, k_cap,
                                        vocab_size)
        is_d = idx == d[:, None]
        p_d = torch.where(is_d, probs, torch.zeros_like(probs)).sum(-1)
        accept = torch.where(greedy, gmax == d, u_acc[:, j] < p_d)
        accept = accept & (not bonus)
        cdf = torch.cumsum(probs.masked_fill(is_d, 0.0), -1)
        choice = torch.searchsorted(cdf, (u_corr[:, j] * cdf[:, -1])[:, None],
                                    right=True)
        corr = idx.gather(1, choice.clamp(max=k_cap - 1))[:, 0]
        corr = torch.where(greedy, gmax, corr)
        tok = torch.where(accept, d, corr)
        out.append(torch.where(alive, tok, torch.full_like(tok, vocab_size)))
        slot = n % w
        recent[rows, slot] = torch.where(alive, tok, recent[rows, slot])
        n += alive.to(n.dtype)
        n_acc += (alive & accept).to(torch.long)
        alive = alive & accept  # a rejection or the bonus ends the round
    return torch.stack(out, dim=1), n_acc


class BatchedSampler:
    """Per-slot sampling state kept on the device for the serving loop: one
    host read per step. Per-request overrides of temperature / top_p /
    repeat_penalty / top_k / seed apply at admission; only the top-k width
    is static (k_cap = the config's top_k) and a request asking for more
    clamps to it. temperature <= 0 makes that slot greedy. `device` is the
    logits' device, which holds the state and the generators."""

    def __init__(self, cfg: SamplerConfig, vocab_size: int, batch: int,
                 device):
        self.cfg = cfg
        self.V = vocab_size
        self.B = batch
        self.device = torch.device(device)
        self.k_cap = min(cfg.top_k if cfg.top_k > 0 else vocab_size,
                         vocab_size)
        # a slot's stream before its first admission (its draws are
        # discarded): (0, slot), apart from every request's (1, request_id)
        self.gens = [self._generator(cfg.seed, 0, b) for b in range(batch)]
        w = max(cfg.repeat_window, 1)
        dev = self.device
        self.recent = torch.full((batch, w), vocab_size, dtype=torch.long,
                                 device=dev)
        self.n = torch.zeros(batch, dtype=torch.long, device=dev)
        self.temps = torch.full((batch,), cfg.temperature,
                                dtype=torch.float32, device=dev)
        self.top_ps = torch.full((batch,), cfg.top_p, dtype=torch.float32,
                                 device=dev)
        self.penalties = torch.full((batch,), cfg.repeat_penalty,
                                    dtype=torch.float32, device=dev)
        self.k_limits = torch.full((batch,), self.k_cap, dtype=torch.long,
                                   device=dev)

    def _generator(self, seed: int, *stream: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(slot_seed(seed, *stream))
        return g

    def _slot_params(self, overrides: dict | None):
        o = overrides or {}
        temp = float(o.get("temperature", self.cfg.temperature))
        top_p = float(o.get("top_p", self.cfg.top_p))
        pen = float(o.get("repeat_penalty", self.cfg.repeat_penalty))
        k = o.get("top_k", self.cfg.top_k)
        k = self.k_cap if not k or k <= 0 else min(int(k), self.k_cap)
        seed = int(o.get("seed", self.cfg.seed))
        return temp, top_p, pen, k, seed

    def admit(self, slot: int, request_id: int, first_logits,
              overrides: dict | None = None) -> int:
        """Set a slot up for a newly admitted request (with its sampling
        overrides) and sample its first token (one host read)."""
        temp, top_p, pen, k, seed = self._slot_params(overrides)
        g = self._generator(seed, 1, request_id)
        dev = self.device
        blank = torch.full((1, self.recent.shape[1]), self.V,
                           dtype=torch.long, device=dev)
        u = torch.rand(1, generator=g, device=dev)
        vec = lambda v, dt: torch.tensor([v], dtype=dt, device=dev)
        tok = sample_rows(first_logits.reshape(1, -1).to(dev), u, blank,
                          vec(temp, torch.float32), vec(top_p, torch.float32),
                          vec(pen, torch.float32), vec(k, torch.long),
                          self.k_cap, self.V)
        t = int(tok[0])
        self.gens[slot] = g
        self.recent[slot] = self.V
        self.recent[slot, 0] = t
        self.n[slot] = 1
        self.temps[slot] = temp
        self.top_ps[slot] = top_p
        self.penalties[slot] = pen
        self.k_limits[slot] = k
        return t

    def sample(self, logits: torch.Tensor) -> np.ndarray:
        """Sample the whole batch; returns host int64 [B] (one read)."""
        u = torch.cat([torch.rand(1, generator=g, device=self.device)
                       for g in self.gens])
        toks = sample_rows(logits, u, self.recent, self.temps, self.top_ps,
                           self.penalties, self.k_limits, self.k_cap, self.V)
        w = self.recent.shape[1]
        rows = torch.arange(self.B, device=self.device)
        self.recent[rows, self.n % w] = toks
        self.n += 1
        return toks.cpu().numpy()

    def spec_accept(self, vlogits: torch.Tensor, drafts, active):
        """A speculative accept round (spec_accept_rows) over verify logits
        [B, K+1, V] and drafts [B, K]; active [B] bool. Every active slot
        draws from its own generator, in this order: its K+1 accept
        uniforms, then its K+1 correction uniforms (slots in order). The
        slots' windows advance by their emitted tokens. Returns host (tokens
        [B, K+1] with vocab_size past each emitted prefix, n_acc [B]), read
        in one copy."""
        dev = self.device
        k1 = vlogits.shape[1]
        live = np.asarray(torch.as_tensor(active).cpu(), dtype=bool)
        act = torch.from_numpy(live).to(dev)
        u = torch.zeros(self.B, 2, k1, dtype=torch.float32, device=dev)
        for b in np.flatnonzero(live):
            u[b, 0] = torch.rand(k1, generator=self.gens[b], device=dev)
            u[b, 1] = torch.rand(k1, generator=self.gens[b], device=dev)
        toks, n_acc = spec_accept_rows(
            vlogits, torch.as_tensor(drafts), u[:, 0], u[:, 1], self.recent,
            self.n, self.temps, self.top_ps, self.penalties, self.k_limits,
            act, self.k_cap, self.V)
        got = torch.cat([toks, n_acc[:, None]], dim=1).cpu().numpy()
        return got[:, :-1], got[:, -1]
