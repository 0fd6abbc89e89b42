"""Port sampler: greedy and the repeat penalty exactly as the JAX package;
temperature / top-k / top-p sampling as a distribution (torch.Generator
and jax.random draw different streams), against the distribution that
`sample_np` defines."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.inference import sampler as jsampler
from ntransformer_tpu_torch.inference import sampler as psampler

V = 32


def _logits(seed=0):
    return (np.random.default_rng(seed).standard_normal(V) * 2.0) \
        .astype(np.float32)


def _target(logits, cfg) -> np.ndarray:
    """The exact distribution sample_np draws from."""
    x = logits.astype(np.float64) / cfg.temperature
    k = min(cfg.top_k if cfg.top_k > 0 else V, V)
    idx = np.argsort(-x, kind="stable")[:k]
    p = np.exp(x[idx] - x[idx[0]])
    p /= p.sum()
    if cfg.top_p < 1.0:
        cut = int(np.searchsorted(np.cumsum(p), cfg.top_p) + 1)
        idx, p = idx[:cut], p[:cut] / p[:cut].sum()
    out = np.zeros(V)
    out[idx] = p
    return out


@pytest.mark.parametrize("temp,top_k,top_p", [(0.7, 10, 0.9), (1.0, 0, 1.0),
                                              (1.3, 5, 1.0), (0.9, 0, 0.8)])
def test_sampling_distribution(temp, top_k, top_p):
    cfg = psampler.SamplerConfig(temperature=temp, top_k=top_k, top_p=top_p,
                                 repeat_penalty=1.0)
    logits = _logits(1)
    want = _target(logits, cfg)
    gen = torch.Generator().manual_seed(3)
    recent = torch.full((8,), V, dtype=torch.long)
    n = 6000
    lt = torch.from_numpy(logits)
    draws = np.array([int(psampler.sample_device(lt, gen, recent, cfg, V))
                      for _ in range(n)])
    freq = np.bincount(draws, minlength=V) / n
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(want))
    # 5 standard errors of a multinomial frequency, per token
    se = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(freq - want) <= 5 * se + 1e-9)
    # and sample_np draws from that same distribution
    rng = np.random.default_rng(4)
    ref = np.bincount([psampler.sample_np(logits, cfg, rng)
                       for _ in range(n)], minlength=V) / n
    assert np.all(np.abs(ref - want) <= 5 * se + 1e-9)


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_greedy_with_repeat_penalty_matches_jax(penalty):
    logits = _logits(2)
    top = np.argsort(-logits)[:3]
    recent = np.full(8, V, np.int32)
    recent[:2] = top[:2]  # penalize the two best tokens
    jcfg = jsampler.SamplerConfig(temperature=0.0, repeat_penalty=penalty)
    want = int(jsampler.sample_device(jnp.asarray(logits),
                                      jax.random.PRNGKey(0),
                                      jnp.asarray(recent), jcfg, V))
    pcfg = psampler.SamplerConfig(temperature=0.0, repeat_penalty=penalty)
    got = int(psampler.sample_device(torch.from_numpy(logits),
                                     torch.Generator().manual_seed(0),
                                     torch.from_numpy(recent.astype(np.int64)),
                                     pcfg, V))
    assert got == want
    np_pen = psampler.apply_repeat_penalty_np(logits, recent[:2], penalty)
    assert got == int(np.argmax(np_pen))


def test_sampler_window_and_seed():
    cfg = psampler.SamplerConfig(temperature=0.8, top_k=8, seed=5)
    a = psampler.Sampler(cfg, V, "cpu")
    b = psampler.Sampler(cfg, V, "cpu")
    lt = torch.from_numpy(_logits(3))
    assert [int(a.sample(lt)) for _ in range(20)] == \
        [int(b.sample(lt)) for _ in range(20)]
    for t in range(70):
        a.observe(t % V)
    assert len(a._recent) == cfg.repeat_window
