"""Port parity for continuous batching (inference/serve.py) and the batched
sampler, on the CPU: the port's BatchServer gives the JAX BatchServer's
greedy texts on the same GGUF, and the serving loop's behaviours mirror
tests/test_batched.py (chunked admission and streaming, the prefix cache,
first-token EOS, arrival replay, unparsed specials, warmup), plus
cancellation, the live inbox and BatchedSampler determinism. torch cannot
reproduce jax.random's bits, so sampled serving is held to determinism and
to the distribution that sample_np defines."""
import os
import queue
import threading

import numpy as np
import pytest
import torch

from ntransformer_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from ntransformer_tpu.inference.serve import BatchServer as JBatchServer
from ntransformer_tpu.inference.serve import Request as JRequest
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu_torch.inference import sampler as psampler
from ntransformer_tpu_torch.inference import serve as pserve
from ntransformer_tpu_torch.inference.engine import Engine, GenerateConfig
from ntransformer_tpu_torch.inference.sampler import (BatchedSampler,
                                                      SamplerConfig)
from ntransformer_tpu_torch.inference.serve import BatchServer, Request
from ntransformer_tpu_torch.models.loader import load_model
from tools.make_test_gguf import write_model
from test_torch_model import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(REPO, "models", "repolm512_q8.gguf")
GREEDY = SamplerConfig(temperature=0.0)
PROMPTS = ["alpha beta", "gamma", "delta epsilon zeta", "eta"]
# repolm512 prompts whose 8 greedy tokens each lead the runner-up by at
# least 5% of the largest logit in the JAX package's run, ten times the
# logit tolerance: where two tokens tie that closely (0.17% for one code
# prompt), the summation order picks the winner and no path is wrong
CODE = ["def forward(arch, weights, kv, tokens, pos):\n",
        "class Engine:\n    def __init__(self",
        "import jax\nimport jax.numpy as jnp\n", "from .ops import "]


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("m") / "tiny_q8.gguf"),
                       "tiny", "q8_0", seed=8)


@pytest.fixture(scope="module")
def model(tiny_path):
    return load_model(tiny_path, device="cpu")


@pytest.mark.parametrize("which,kv_quant", [
    ("tiny", False), ("repolm512", False), ("repolm512", True)],
    ids=["tiny-bf16", "repolm512-bf16", "repolm512-int8"])
def test_greedy_serving_matches_jax_server(tiny_path, which, kv_quant):
    """Batch 2 over 4 requests (slots retire and refill mid-flight), 16-token
    admission chunks: the same greedy texts as the JAX package's server.
    int8 on the trained model only: the tiny model's random logits have
    near-ties that an int8 code flip reorders (its int8 logits agree to
    2e-2, tests/test_torch_batched.py)."""
    path = tiny_path if which == "tiny" else REPOLM
    prompts = PROMPTS if which == "tiny" else CODE
    kw = dict(batch_size=2, admit_chunk=16, kv_quant=kv_quant)
    ref = JBatchServer(jax_load_model(path, max_seq_len=512, fuse=True),
                       sampler_cfg=JSamplerConfig(temperature=0.0), **kw)
    want = [JRequest(prompt=p, max_tokens=8) for p in prompts]
    ref.run(want)
    srv = BatchServer(load_model(path, max_seq_len=512, fuse=True,
                                 device="cpu"), sampler_cfg=GREEDY, **kw)
    got = [Request(prompt=p, max_tokens=8) for p in prompts]
    stats = srv.run(got)
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert stats.requests == 4 and stats.steps > 0
    assert stats.tokens == sum(len(r.output_ids) for r in got)


def test_chunked_admission_matches_engine_and_streams(model):
    """Admission in 2-token chunks gives the single-stream engine's greedy
    text at the same chunk width, and on_token fires for every token."""
    eng = Engine(model)
    eng.PREFILL_CHUNK = 2
    cfg = GenerateConfig(max_tokens=6, temperature=0.0, repeat_penalty=1.0)
    prompts = ["alpha beta gamma delta", "epsilon zeta"]
    expected = [eng.generate(p, cfg)[0] for p in prompts]
    pieces = {0: [], 1: []}
    srv = BatchServer(model, batch_size=2, admit_chunk=2, sampler_cfg=GREEDY)
    reqs = [Request(prompt=p, max_tokens=6,
                    on_token=lambda s, i=i: pieces[i].append(s))
            for i, p in enumerate(prompts)]
    stats = srv.run(reqs)
    for i, (r, want) in enumerate(zip(reqs, expected)):
        assert r.text == want
        assert len(pieces[i]) == len(r.output_ids)
    assert stats.prefill_chunks > len(prompts)
    assert stats.ttft_s and all(t >= 0 for t in stats.ttft_s)


def test_prefix_cache_reuse_matches_uncached(model):
    shared = list(range(5, 45))
    prompts = (shared + [60, 61, 62], shared + [70, 71], shared[:10] + [90])
    reqs = lambda: [Request(prompt="", max_tokens=5, prompt_ids=list(p))
                    for p in prompts]
    plain = BatchServer(model, batch_size=2, admit_chunk=16,
                        sampler_cfg=GREEDY)
    r_plain = reqs()
    s_plain = plain.run(r_plain)
    cached = BatchServer(model, batch_size=2, admit_chunk=16, prefix_cache=2,
                         sampler_cfg=GREEDY)
    r_cached = reqs()
    s_cached = cached.run(r_cached)
    assert [r.text for r in r_cached] == [r.text for r in r_plain]
    assert s_plain.prefix_hits == 0 and s_cached.prefix_hits >= 2
    assert s_cached.prefill_chunks < s_plain.prefill_chunks


def test_prefix_cache_lru_eviction(model):
    srv = BatchServer(model, batch_size=2, prefix_cache=1, sampler_cfg=GREEDY)
    mk = lambda ids: Request(prompt="", max_tokens=3, prompt_ids=list(ids))
    srv.run([mk(range(5, 30))])
    srv.run([mk(range(100, 130))])
    assert [list(c) for c, _ in srv._pcache] == [list(range(100, 130))]
    srv.run([mk(range(100, 130))])  # identical: replaced, not added
    assert len(srv._pcache) == 1


def test_first_token_eos_frees_the_slot(model, monkeypatch):
    eos = model.tokenizer.eos_id
    real = pserve.forward

    def fake_forward(arch, w, kv, tokens, pos, **kw):
        logits, kv, cos = real(arch, w, kv, tokens, pos, **kw)
        if kw.get("n_valid") == 2:  # the 2-token prompt: BOS + "x"
            logits = logits.clone()
            logits[:, eos] = 1e9
        return logits, kv, cos

    monkeypatch.setattr(pserve, "forward", fake_forward)
    srv = BatchServer(model, batch_size=2, sampler_cfg=GREEDY)
    reqs = [Request(prompt="x", max_tokens=5),
            Request(prompt="alpha beta", max_tokens=5)]
    stats = srv.run(reqs)
    assert reqs[0].output_ids == [eos] and reqs[0].finished_at > 0
    assert len(reqs[1].output_ids) > 1 and stats.requests == 2


def test_arrival_replay(model):
    srv = BatchServer(model, batch_size=2, sampler_cfg=GREEDY)
    reqs = [Request(prompt="alpha", max_tokens=3, arrival_s=0.0),
            Request(prompt="beta", max_tokens=3, arrival_s=0.3)]
    stats = srv.run(reqs)
    assert all(r.finished_at > 0 for r in reqs)
    assert stats.wall_s >= 0.3
    assert reqs[1].first_token_at >= reqs[0].first_token_at


def test_prompt_specials_are_not_parsed(model):
    srv = BatchServer(model, batch_size=2, sampler_cfg=GREEDY)
    reqs = [Request(prompt="hi </s> there", max_tokens=2)]
    srv.run(reqs)
    assert model.tokenizer.eos_id not in reqs[0].prompt_ids
    trusted = [Request(prompt="hi </s> there", max_tokens=2,
                       parse_special=True)]
    srv.run(trusted)
    assert model.tokenizer.eos_id in trusted[0].prompt_ids


def test_warmup_covers_every_admission_shape(model):
    """Every padded prefill shape admission produces is run by warmup,
    including the tail chunk of a context the chunk does not divide."""
    srv = BatchServer(model, batch_size=2, admit_chunk=300,
                      sampler_cfg=GREEDY)
    seen = []
    inner = srv._prefill
    srv._prefill = (lambda w, kv, padded, off, n:
                    (seen.append(len(padded)) or inner(w, kv, padded, off,
                                                       n)))
    srv.warmup()
    warmed = set(seen)
    seen.clear()
    srv.run([Request(prompt=" ".join(["tok"] * 600), max_tokens=1)])
    assert seen and set(seen) <= warmed
    assert (model.arch.max_seq_len - 300) in seen


def test_cancellation_and_snapshot(model):
    """A request cancelled from its own stream callback retires at the next
    step boundary; snapshot() reports the finished run."""
    srv = BatchServer(model, batch_size=2, sampler_cfg=GREEDY)
    assert srv.snapshot() == {"running": False, "slots": 2}
    reqs = [Request(prompt="alpha beta", max_tokens=20),
            Request(prompt="gamma", max_tokens=4)]
    reqs[0].on_token = lambda s: setattr(reqs[0], "cancelled",
                                         len(reqs[0].output_ids) >= 2)
    srv.run(reqs)
    assert len(reqs[0].output_ids) == 2 and reqs[0].finished_at > 0
    assert len(reqs[1].output_ids) == 4
    snap = srv.snapshot()
    assert not snap["running"] and snap["requests"] == 2
    assert snap["tokens"] == 6


def test_serve_forever_drains_the_inbox(model):
    srv = BatchServer(model, batch_size=2, sampler_cfg=GREEDY)
    inbox, stop = queue.Queue(), threading.Event()
    done = []
    for p in ("alpha", "beta gamma", "delta"):
        inbox.put(Request(prompt=p, max_tokens=3, on_done=done.append))
    stop.set()  # drain what was submitted, then return
    stats = srv.serve_forever(inbox, stop)
    assert stats.requests == 3 and len(done) == 3
    assert all(len(r.output_ids) == 3 for r in done)


def test_unported_options_raise(model):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 14"):
        BatchServer(model, mesh=object())


def test_sampled_serving_is_deterministic(model):
    """Temperature > 0: each request's stream is fixed by (seed, request
    id), so two runs give the same texts; a per-request greedy override
    (without the repeat penalty) gives that request the greedy server's
    text."""
    cfg = SamplerConfig(temperature=0.9, top_k=20, top_p=0.9, seed=3)
    runs = []
    for _ in range(2):
        srv = BatchServer(model, batch_size=2, sampler_cfg=cfg)
        reqs = [Request(prompt=p, max_tokens=6) for p in PROMPTS]
        reqs[2].sampling = {"temperature": 0.0, "repeat_penalty": 1.0}
        srv.run(reqs)
        runs.append(reqs)
    assert [r.output_ids for r in runs[0]] == [r.output_ids for r in runs[1]]
    greedy = [Request(prompt=PROMPTS[2], max_tokens=6)]
    BatchServer(model, batch_size=2, sampler_cfg=GREEDY).run(greedy)
    assert runs[0][2].output_ids == greedy[0].output_ids


def test_batched_sampler_streams_follow_the_request():
    """A slot's draws depend on its request id and seed, not on its slot or
    its neighbours; greedy slots take the (penalized) argmax."""
    V = 32
    cfg = SamplerConfig(temperature=1.0, top_k=0, top_p=1.0,
                        repeat_penalty=1.0, seed=7)
    logits = torch.zeros(3, V)
    a = BatchedSampler(cfg, V, 3, "cpu")
    b = BatchedSampler(cfg, V, 3, "cpu")
    a.admit(0, 11, logits[0])
    b.admit(2, 11, logits[0])
    a.admit(1, 12, logits[0])
    b.admit(0, 99, logits[0])
    draws_a = np.stack([a.sample(logits) for _ in range(20)])
    draws_b = np.stack([b.sample(logits) for _ in range(20)])
    assert (draws_a[:, 0] == draws_b[:, 2]).all()      # request 11
    assert not (draws_a[:, 1] == draws_a[:, 0]).all()  # 12 differs from 11
    g = BatchedSampler(SamplerConfig(temperature=0.0, repeat_penalty=1.3), V,
                       2, "cpu")
    lg = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, V)).astype(np.float32))
    first = g.admit(0, 1, lg[0])
    assert first == int(lg[0].argmax())
    g.admit(1, 2, lg[1])
    toks = g.sample(lg)
    pen = psampler.apply_repeat_penalty_np(lg[0].numpy(), np.array([first]),
                                           1.3)
    assert toks[0] == int(np.argmax(pen))


@pytest.mark.parametrize("temp,top_k,top_p", [(0.7, 10, 0.9), (1.3, 5, 1.0)])
def test_batched_sampler_distribution(temp, top_k, top_p):
    """Each row's draws follow the distribution sample_np defines (5
    standard errors per token)."""
    V, n = 32, 4000
    cfg = SamplerConfig(temperature=temp, top_k=top_k, top_p=top_p,
                        repeat_penalty=1.0, seed=5)
    logits = np.random.default_rng(1).standard_normal(V).astype(
        np.float32) * 2.0
    x = logits.astype(np.float64) / temp
    idx = np.argsort(-x, kind="stable")[:top_k]
    p = np.exp(x[idx] - x[idx[0]])
    p /= p.sum()
    if top_p < 1.0:
        cut = int(np.searchsorted(np.cumsum(p), top_p) + 1)
        idx, p = idx[:cut], p[:cut] / p[:cut].sum()
    want = np.zeros(V)
    want[idx] = p
    bs = BatchedSampler(cfg, V, 2, "cpu")
    lt = torch.from_numpy(np.stack([logits, logits]))
    draws = np.concatenate([bs.sample(lt) for _ in range(n // 2)])
    freq = np.bincount(draws, minlength=V) / len(draws)
    se = np.sqrt(want * (1 - want) / len(draws))
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(want))
    assert np.all(np.abs(freq - want) <= 5 * se + 1e-9)
