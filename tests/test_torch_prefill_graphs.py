"""Prefill as captured programs (models/graphs.ForwardGraphs' prefill kind)
and the forward with a device pos and n_valid at any T, on the CPU, against
the JAX package.

On the card the base Engine replays each bucketed prefill chunk, the
one-device BatchServer each admission chunk and the perplexity tool its
windows (an all-logits verify at pos 0, or the T = 1 step), all as CUDA
graphs keyed by the window's length; on the CPU they call the forward
directly. Here tests/test_torch_graphs.py's recording double takes the
graph class's place and the device tests are patched, so those graph
paths run on the CPU: the device pos and n_valid, the static window, the
cache each keeps for its life.

Tolerances are tests/test_torch_model.py's (logits within 5e-3 of the
largest JAX logit, 2e-2 with the int8 cache; layer 0's new cache rows
equal to the JAX package's in at least CACHE_EQUAL of their elements) and
greedy texts equal. Within the port the device-pos forward and the
host-int forward, and each graph path and its uncaptured run, compute the
same thing and are held bit for bit: logits, nll and every cache byte."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.inference.engine import ChatSession as JChatSession
from ntransformer_tpu.inference.engine import Engine as JEngine
from ntransformer_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from ntransformer_tpu.inference.serve import BatchServer as JBatchServer
from ntransformer_tpu.inference.serve import Request as JRequest
from ntransformer_tpu.models import llama as jl
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu_torch.inference import engine as pe
from ntransformer_tpu_torch.inference import serve as pserve
from ntransformer_tpu_torch.inference.engine import ChatSession, Engine
from ntransformer_tpu_torch.inference.sampler import SamplerConfig
from ntransformer_tpu_torch.inference.serve import BatchServer, Request
from ntransformer_tpu_torch.models import graphs
from ntransformer_tpu_torch.models import llama as pl
from ntransformer_tpu_torch.models.convert import weights_from_numpy
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.ops import linear
from ntransformer_tpu_torch.tools import perplexity as ppl
from test_torch_engine_graphs import (GuardedGraph, _greedy, _rel,
                                      _same_cache)
from test_torch_graphs import RecordingGraph
from test_torch_model import (CACHE_EQUAL, INT8_LOGIT_RTOL, LOGIT_RTOL,
                              _equal_share, jax_tree,
                              one_torch_thread)  # noqa: F401
from tools.make_test_gguf import write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(REPO, "models", "repolm512_q8.gguf")
CTX = 256       # the forward tests' cache rows
HEAD = 12       # the host-int prefill ahead of the device windows (bucket 16)
# (T, n_valid) of the device-pos windows, from pos HEAD: n_valid below T
# at a nonzero offset, T at and past the flash kernel's 64
WINDOWS = ((64, 50), (128, 100))
FILL = 150      # rows [FILL, CTX) hold seeded values before the windows
CHUNK = 64      # the Engine tests' prefill chunk (the Engine's is 512)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pg")
    return {"llama_q8_0": write_model(str(d / "q8.gguf"), "tiny", "q8_0",
                                      seed=3),
            "llama_q4_k_m": write_model(str(d / "q4km.gguf"), "tiny",
                                        "q4_k_m", seed=2),
            "qwen2": write_model(str(d / "qwen2.gguf"), "tiny", "q8_0",
                                 seed=5, arch="qwen2"),
            "gemma3": write_model(str(d / "gemma3.gguf"), "tiny", "q8_0",
                                  seed=6, arch="gemma3"),
            "mixtral": write_model(str(d / "moe.gguf"), "moe", "q8_0",
                                   seed=7),
            "qwen3moe": write_model(str(d / "q3moe.gguf"), "moe", "q8_0",
                                    seed=8, arch="qwen3moe"),
            "repolm512": REPOLM}


@pytest.fixture
def recorded(monkeypatch):
    """The graph double in GRAPH's place and every consumer's device test
    true: the Engine, the server and the perplexity tool take their graph
    paths on the CPU. Yields the graphs made."""
    made = []
    monkeypatch.setattr(RecordingGraph, "made", made)
    monkeypatch.setattr(graphs, "GRAPH", RecordingGraph)
    for mod in (pe, pserve, ppl):
        monkeypatch.setattr(mod, "_graphed", lambda device: True)
    return made


def _uncaptured(monkeypatch):
    """Every consumer's device test false: the direct calls."""
    for mod in (pe, pserve, ppl):
        monkeypatch.setattr(mod, "_graphed", lambda device: False)


def _fill_tail(kv: pl.KVCache, seed: int) -> None:
    """Seeded values in rows [FILL, CTX) of every cache tensor: the padded
    rows of the last window must keep them."""
    g = torch.Generator().manual_seed(seed)
    for t in (kv.k, kv.v, kv.ks, kv.vs):
        if t is None:
            continue
        tail = t[:, :, FILL:]
        if t.dtype == torch.int8:
            tail.copy_(torch.randint(-127, 128, tail.shape, generator=g))
        else:
            tail.copy_(torch.rand(tail.shape, generator=g).to(t.dtype))


def _window(toks, pos: int, t: int, nv: int) -> np.ndarray:
    w = np.zeros(t, np.int64)
    w[:nv] = toks[pos:pos + nv]
    return w


def _repolm_ids(n: int) -> list[int]:
    """repolm512's ids of the README's first n tokens (BOS first)."""
    tok = load_model(REPOLM, device="cpu", n_layers=1).tokenizer
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        return tok.encode(f.read(), add_bos=True)[:n]


# ------------------------------------------- forward, device pos and n_valid
@pytest.mark.parametrize("which,quant", [
    ("llama_q8_0", False), ("llama_q8_0", True), ("llama_q4_k_m", False),
    ("qwen2", False), ("gemma3", False), ("gemma3", True),
    ("mixtral", False), ("qwen3moe", True), ("repolm512", False),
    ("repolm512", True)], ids=lambda v: str(v))
def test_device_prefill_matches_jax_and_host_pos(files, which, quant):
    """A 12-token prefill (host ints), then WINDOWS' chunks (T = 64 with 50
    valid tokens at pos 12, T = 128 with 100 at pos 62), each with a 0-d
    device pos and n_valid: the JAX forward with traced pos and n_valid
    within the stated tolerance, the port's host-int forward on a twin
    cache bit for bit (the last valid row's logits, every cache byte); the
    padded rows keep the seeded values they held; layer 0's new rows agree
    with the JAX package's."""
    ref = jax_load_model(files[which], max_seq_len=CTX, fuse=True)
    arch = pl.Arch(**dataclasses.asdict(ref.arch))
    w = weights_from_numpy(jax_tree(ref.weights), arch, "cpu")
    tol = INT8_LOGIT_RTOL if quant else LOGIT_RTOL
    toks = np.random.default_rng(14).integers(3, arch.vocab_size, CTX)
    head = _window(toks, 0, 16, HEAD)
    jkv = jl.KVCache.create(ref.arch, quant=quant)
    _, jkv, _ = jl.forward(ref.arch, ref.weights, jkv,
                           jnp.asarray(head, jnp.int32), 0, n_valid=HEAD)
    dev = pl.KVCache.create(arch, quant=quant, device="cpu")
    pl.forward(arch, w, dev, torch.from_numpy(head), 0, n_valid=HEAD)
    _fill_tail(dev, seed=len(which))
    host = dev.clone()
    tail = dev.clone()
    pos = HEAD
    for t, nv in WINDOWS:
        win = _window(toks, pos, t, nv)
        jlog, jkv, _ = jl.forward(ref.arch, ref.weights, jkv,
                                  jnp.asarray(win, jnp.int32), jnp.int32(pos),
                                  n_valid=jnp.int32(nv))
        x = torch.from_numpy(win)
        got, _, _ = pl.forward(arch, w, dev, x, torch.tensor(pos),
                               n_valid=torch.tensor(nv))
        want, _, _ = pl.forward(arch, w, host, x, pos, n_valid=nv)
        assert tuple(got.shape) == (1, arch.vocab_size)
        assert torch.equal(got, want)
        assert _same_cache(dev, host)
        assert _rel(got.numpy(), jlog) <= tol, (pos, _rel(got.numpy(), jlog))
        pos += nv
    for a, b in zip((dev.k, dev.v, dev.ks, dev.vs),
                    (tail.k, tail.v, tail.ks, tail.vs)):
        if a is not None:
            assert torch.equal(a[:, :, pos:], b[:, :, pos:])
    rows = slice(HEAD, pos)
    for got, want in ((dev.k, jkv.k), (dev.v, jkv.v)):
        if quant:
            share = float((got[0, :, rows].numpy()
                           == np.asarray(want[0, :, rows])).mean())
        else:
            share = _equal_share(got[0, :, rows], want[0, :, rows])
        assert share >= CACHE_EQUAL, share


# ------------------------------------------------- no host read in a capture
@pytest.mark.parametrize("which,quant,impl,fmt", [
    ("llama_q8_0", False, "plain", None), ("llama_q8_0", True, "plain", None),
    ("llama_q8_0", False, "kernel", None), ("llama_q8_0", True, "kernel", None),
    ("llama_q4_k_m", False, "kernel", None), ("gemma3", True, "plain", None),
    ("gemma3", False, "kernel", None), ("qwen2", False, "kernel", None),
    ("mixtral", False, "plain", None), ("qwen3moe", True, "plain", None),
    ("llama_q8_0", False, "kernel", "w8a8"),
    ("llama_q8_0", False, "kernel", "w4a8")], ids=lambda v: str(v))
def test_no_prefill_capture_reads_the_device_on_the_host(
        monkeypatch, files, which, quant, impl, fmt):
    """The prefill keys of WINDOWS' lengths and an all-logits verify window
    of 64 tokens are captured under NoHostReads, on the plain path and on
    the kernel path (the wrappers' host code, the flash wrapper with a
    device pos included; their plain twins on CPU tensors; the MoE
    presets' head dim of 32 is not the flash kernel's; W8A8 and W4A8
    requantized at load), then replayed
    at nonzero offsets to the host-int forward's values on a twin cache;
    one capture a key."""
    monkeypatch.setattr(graphs, "GRAPH", GuardedGraph)
    monkeypatch.setattr(linear, "kernels_enabled",
                        lambda t: impl == "kernel")
    m = load_model(files[which], device="cpu", max_seq_len=320,
                   **({fmt: True} if fmt else {}))
    toks = np.random.default_rng(15).integers(3, m.arch.vocab_size, 320)
    kv = pl.KVCache.create(m.arch, quant=quant, device="cpu")
    pl.forward(m.arch, m.weights, kv, _window(toks, 0, 16, HEAD), 0,
               n_valid=HEAD)
    g = graphs.ForwardGraphs(m.arch, m.weights, kv)
    direct = kv.clone()
    pos = HEAD
    for t, nv in WINDOWS + ((64, 64), (64, 1)):
        win = _window(toks, pos, t, nv)
        got = g.prefill(kv, win, pos, nv)
        want, _, _ = pl.forward(m.arch, m.weights, direct, win, pos,
                                n_valid=nv)
        assert torch.equal(got, want) and _same_cache(kv, direct)
        pos += nv
    got = g.verify(kv, torch.from_numpy(toks[pos:pos + 64]), pos)
    want, _, _ = pl.forward(m.arch, m.weights, direct, toks[pos:pos + 64],
                            pos, all_logits=True)
    assert torch.equal(got, want) and _same_cache(kv, direct)
    assert g.captures == 3
    assert {k.t: n for k, n in g.replays.items() if k.kind == "prefill"} \
        == {64: 3, 128: 1}


def test_prefill_refusals(files):
    """The prefill graph refuses an n_valid outside its window, rows past
    the cache and a cache it was not captured against, and captures
    nothing for them."""
    m = load_model(files["llama_q8_0"], device="cpu", max_seq_len=128)
    kv = pl.KVCache.create(m.arch, device="cpu")
    g = graphs.ForwardGraphs(m.arch, m.weights, kv)
    win = np.zeros(64, np.int64)
    for nv in (0, 65):
        with pytest.raises(ValueError, match="n_valid"):
            g.prefill(kv, win, 0, nv)
    with pytest.raises(ValueError, match="exceed"):
        g.prefill(kv, win, 65, 3)
    with pytest.raises(ValueError, match="not the one"):
        g.prefill(kv.clone(), win, 0, 3)
    assert g.captures == 0 and float(kv.k.abs().max()) == 0.0


# ------------------------------------------------------- Engine, graph path
@pytest.mark.parametrize("which,quant", [
    ("repolm512", False), ("repolm512", True), ("llama_q8_0", False)],
    ids=["repolm512-bf16", "repolm512-int8", "tiny-bf16"])
def test_graphed_engine_prefill_matches_direct_and_jax(recorded, monkeypatch,
                                                       files, which, quant):
    """A 200-token prompt in 64-token chunks (three whole, a tail of 8 at
    pos 192) replayed on the Engine's cache, then a chat resume at
    start 200 (a 20-token bucket of 32): the last logits and every cache
    byte bit-equal to the uncaptured prefill on a twin cache; generate and
    a two-turn ChatSession give the uncaptured Engine's texts and a live
    JAX Engine's (chunked the same way), the second turn prefilling only
    its new tokens."""
    kw = dict(max_seq_len=CTX if which != "repolm512" else 512)
    m = load_model(files[which], device="cpu", **kw)
    if which == "repolm512":
        ids = _repolm_ids(220)
    else:
        ids = [1] + np.random.default_rng(16).integers(
            3, m.arch.vocab_size, 219).tolist()
    first, extra = ids[:200], ids[200:]
    eng = Engine(m, kv_quant=quant)
    eng.PREFILL_CHUNK = CHUNK
    kv = eng._start_kv()
    got, kv, _ = eng._prefill(kv, first)
    got = got.clone()
    direct = eng._make_kv()
    want, direct, _ = eng._prefill(direct, first)
    assert torch.equal(got, want) and _same_cache(kv, direct)
    g = eng._held["main"][1]
    assert g.replays == {g.key("prefill", CHUNK): 4}
    got, kv, _ = eng._prefill(kv, ids, start=200)
    want, direct, _ = eng._prefill(direct, ids, start=200)
    assert torch.equal(got, want) and _same_cache(kv, direct)
    assert g.replays[g.key("prefill", 32)] == 1 and g.captures == 2

    cfg, jcfg = _greedy(8)
    jeng = JEngine(jax_load_model(files[which], **kw), kv_quant=quant)
    jeng.PREFILL_CHUNK = CHUNK

    def turns(e, c, session):
        out = [e.generate("", c, prompt_ids=first)[0]]
        for part in (first, extra):
            text, st = e.generate("", c, prompt_ids=session.ids_in_kv + part,
                                  session=session)
            out.append((text, st.prefill_tokens))
        return out
    texts = turns(eng, cfg, ChatSession())
    assert texts[2][1] == len(extra)   # the resume prefilled its new tokens
    want = turns(jeng, jcfg, JChatSession())
    with pytest.MonkeyPatch.context() as mp:
        _uncaptured(mp)
        plain = Engine(m, kv_quant=quant)
        plain.PREFILL_CHUNK = CHUNK
        assert turns(plain, cfg, ChatSession()) == texts
        assert plain._held == {}
    assert texts == want


# --------------------------------------------------------- server, admission
@pytest.mark.parametrize("prefix_cache,kv_quant", [(0, False), (2, False),
                                                   (2, True)],
                         ids=["plain", "prefix", "prefix-int8"])
def test_graphed_admission_matches_direct_and_jax(recorded, monkeypatch,
                                                  files, prefix_cache,
                                                  kv_quant):
    """BatchServer(B = 2, 16-token chunks) over prompts sharing a 40-token
    prefix, each admission prefilled into the server's one admission
    cache by replayed prefill graphs (a prefix hit's bytes copied into it,
    the prefix cache keeping clones): the texts of the same server calling
    the forward directly and of the JAX BatchServer; every chunk a replay
    of a key warmup captured."""
    path = files["llama_q8_0"]
    shared = list(range(5, 45))
    prompts = (shared + [60, 61, 62], shared + [70, 71], shared[:10] + [90],
               list(range(100, 130)), shared + [80])
    kw = dict(batch_size=2, admit_chunk=16, prefix_cache=prefix_cache,
              kv_quant=kv_quant)

    def serve(cls, req_cls, model, **extra):
        srv = cls(model, **kw, **extra)
        reqs = [req_cls(prompt="", max_tokens=6, prompt_ids=list(p))
                for p in prompts]
        stats = srv.run(reqs)
        return srv, [list(r.output_ids) for r in reqs], stats
    pm = load_model(path, device="cpu", max_seq_len=CTX)
    srv, got, st = serve(BatchServer, Request, pm,
                         sampler_cfg=SamplerConfig(temperature=0.0))
    kv, adm = srv._adm
    assert {k.kind for k in adm.replays} == {"prefill"}
    assert sum(adm.replays.values()) == adm.captures + st.prefill_chunks
    assert len(recorded) == srv._graphs.captures + adm.captures
    assert (st.prefix_hits >= 2) == bool(prefix_cache)
    assert all(c is not kv for _, c in srv._pcache)
    with pytest.MonkeyPatch.context() as mp:
        _uncaptured(mp)
        direct, plain, pst = serve(BatchServer, Request, pm,
                                   sampler_cfg=SamplerConfig(
                                       temperature=0.0))
        assert direct._adm is None and direct._graphs is None
    assert plain == got and pst.prefix_hits == st.prefix_hits
    _, want, _ = serve(JBatchServer, JRequest,
                       jax_load_model(path, max_seq_len=CTX),
                       sampler_cfg=JSamplerConfig(temperature=0.0))
    assert got == want


# ----------------------------------------------------------------- perplexity
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_graphed_perplexity_matches_direct(recorded, monkeypatch, files,
                                           mode):
    """The perplexity tool over two 64-token windows on one held cache:
    prefill mode replays the all-logits verify window at pos 0, decode
    mode the T = 1 step; the nll equal to the uncaptured run's."""
    m = load_model(files["llama_q8_0"], device="cpu", max_seq_len=CTX)
    ids = np.random.default_rng(17).integers(3, m.arch.vocab_size,
                                             150).tolist()
    got = ppl.perplexity(m, ids, ctx=64, mode=mode)
    assert len(recorded) == 1
    want_replays = 2 if mode == "prefill" else 2 * 63
    assert sum(g.replayed for g in recorded) == want_replays
    _uncaptured(monkeypatch)
    want = ppl.perplexity(m, ids, ctx=64, mode=mode)
    assert got == want and got["windows"] == 2
