"""The resident Engine's captured programs (models/graphs.ForwardGraphs) and
the forward with a device position, on the CPU, against the JAX package.

On the card the base Engine replays CUDA graphs of its T = 1 step, its
verify window, its greedy loop step and the fused self-speculative
iteration; on the CPU it calls them directly. Here models/graphs.py's graph
class is replaced by tests/test_torch_graphs.py's recording double (it runs
the captured callable again at each replay, over the same static tensors)
and the Engine's device test is patched, so the Engine's graph path runs on
the CPU: the device pos, the static inputs and outputs, the cache kept for
the engine's life, one capture a key.

Tolerances are those of tests/test_torch_model.py (logits within 5e-3 of
the largest JAX logit, 2e-2 with the int8 cache) and
tests/test_torch_spec.py (greedy tokens and drafted/accepted counts equal).
Within the port the device-pos forward and the host-int forward, and the
graph path and the direct path, compute the same thing and are held bit
for bit. A dispatch-mode guard shows that no captured program reads a
device value on the host."""
import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ntransformer_tpu.inference.engine import ChatSession as JChatSession
from ntransformer_tpu.inference.engine import Engine as JEngine
from ntransformer_tpu.inference.engine import GenerateConfig as JGenConfig
from ntransformer_tpu.inference.engine import (_decode_loop_greedy,
                                               _spec_iter_greedy)
from ntransformer_tpu.models import llama as jl
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu_torch.inference import engine as pe
from ntransformer_tpu_torch.inference.engine import (ChatSession, CPEngine,
                                                     EPEngine, Engine,
                                                     GenerateConfig,
                                                     TieredEngine, TPEngine)
from ntransformer_tpu_torch.models import graphs
from ntransformer_tpu_torch.models import llama as pl
from ntransformer_tpu_torch.models.convert import weights_from_numpy
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.ops import linear
from ntransformer_tpu_torch.parallel.cp import make_cp_mesh
from test_torch_graphs import RecordingGraph
from test_torch_model import (CACHE_EQUAL, INT8_LOGIT_RTOL, LOGIT_RTOL,
                              _equal_share, jax_tree,
                              one_torch_thread)  # noqa: F401
from test_torch_spec import _run
from tools.make_test_gguf import write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(REPO, "models", "repolm512_q8.gguf")
PROMPT = {"repolm512": "def forward(arch, weights, kv, tokens, pos):\n",
          "tiny": "hello world"}
PREFILL = 12    # the prefill ahead of the device-pos forwards (bucket 16)
K = 3           # drafted tokens: the verify window is K + 1


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("eg")
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
            "draft": write_model(str(d / "draft.gguf"), "tiny", "q8_0",
                                 seed=99),
            "llama3": write_model(str(d / "chat.gguf"), "tiny", "q8_0",
                                  seed=44, chat="llama3"),
            "repolm512": REPOLM}


@pytest.fixture
def recorded(monkeypatch):
    """The graph double in GRAPH's place and the Engine's device test
    true: the base Engine takes its graph path on the CPU. Yields the
    graphs made."""
    made = []
    monkeypatch.setattr(RecordingGraph, "made", made)
    monkeypatch.setattr(graphs, "GRAPH", RecordingGraph)
    monkeypatch.setattr(pe, "_graphed", lambda device: True)
    return made


def _greedy(n: int, k: int = K):
    kw = dict(max_tokens=n, temperature=0.0, repeat_penalty=1.0, draft_k=k)
    return GenerateConfig(**kw), JGenConfig(**kw)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _same_cache(a: pl.KVCache, b: pl.KVCache) -> bool:
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip((a.k, a.v, a.ks, a.vs), (b.k, b.v, b.ks, b.vs)))


def _held(eng: Engine, name: str = "main"):
    """(kv, ForwardGraphs) the graph-path engine keeps."""
    return eng._held[name]


# ------------------------------------------------- forward, device position
@pytest.mark.parametrize("which,quant", [
    ("llama_q8_0", False), ("llama_q8_0", True), ("llama_q4_k_m", False),
    ("qwen2", False), ("gemma3", False), ("gemma3", True),
    ("mixtral", False), ("qwen3moe", True), ("repolm512", False),
    ("repolm512", True)], ids=lambda v: str(v))
def test_device_pos_forward_matches_jax_and_host_pos(files, which, quant):
    """A 12-token prefill (host pos), then the T = 1 step at pos 12 and the
    T = K + 1 all-logits verify window at pos 13, each with a 0-d device
    pos: the JAX forward with its traced pos within the stated tolerance,
    the port's host-int forward on a twin cache bit for bit (logits and
    every cache row); layer 0's new rows agree with the JAX package's."""
    ref = jax_load_model(files[which], max_seq_len=128, fuse=True)
    arch = pl.Arch(**dataclasses.asdict(ref.arch))
    w = weights_from_numpy(jax_tree(ref.weights), arch, "cpu")
    tol = INT8_LOGIT_RTOL if quant else LOGIT_RTOL
    toks = np.random.default_rng(4).integers(3, arch.vocab_size, 20)
    padded = np.zeros(16, np.int64)
    padded[:PREFILL] = toks[:PREFILL]
    jkv = jl.KVCache.create(ref.arch, quant=quant)
    _, jkv, _ = jl.forward(ref.arch, ref.weights, jkv,
                           jnp.asarray(padded, jnp.int32), 0,
                           n_valid=PREFILL)
    dev = pl.KVCache.create(arch, quant=quant, device="cpu")
    pl.forward(arch, w, dev, torch.from_numpy(padded), 0, n_valid=PREFILL)
    host = dev.clone()
    for pos, window, all_logits in ((PREFILL, toks[PREFILL:PREFILL + 1],
                                     False),
                                    (PREFILL + 1, toks[PREFILL + 1:
                                                       PREFILL + 2 + K],
                                     True)):
        jlog, jkv, _ = jl.forward(ref.arch, ref.weights, jkv,
                                  jnp.asarray(window, jnp.int32),
                                  jnp.int32(pos), all_logits=all_logits)
        t = torch.from_numpy(window.astype(np.int64))
        got, _, _ = pl.forward(arch, w, dev, t, torch.tensor(pos),
                               all_logits=all_logits)
        want, _, _ = pl.forward(arch, w, host, t, pos, all_logits=all_logits)
        assert tuple(got.shape) == (len(window) if all_logits else 1,
                                    arch.vocab_size)
        assert torch.equal(got, want)
        assert _same_cache(dev, host)
        assert _rel(got.numpy(), jlog) <= tol, (pos, _rel(got.numpy(), jlog))
    rows = slice(PREFILL, PREFILL + 2 + K)
    for got, want in ((dev.k, jkv.k), (dev.v, jkv.v)):
        if quant:
            share = float((got[0, :, rows].numpy()
                           == np.asarray(want[0, :, rows])).mean())
        else:
            share = _equal_share(got[0, :, rows], want[0, :, rows])
        assert share >= CACHE_EQUAL, share


def test_device_pos_refusals(files):
    """A device pos runs every forward at any T, a mesh's too, with
    n_valid as a device tensor beside it: a host n_valid with it (or a
    device n_valid with a host pos) raises, on one device and on a mesh,
    and writes nothing."""
    m = load_model(files["llama_q8_0"], device="cpu", max_seq_len=128)
    kv = pl.KVCache.create(m.arch, device="cpu")
    pos = torch.tensor(0)
    with pytest.raises(ValueError, match="not a host int"):
        pl.forward(m.arch, m.weights, kv, [1, 2], pos, n_valid=1)
    with pytest.raises(ValueError, match="device n_valid goes with"):
        pl.forward(m.arch, m.weights, kv, [1, 2], 0,
                   n_valid=torch.tensor(1))
    with pytest.raises(ValueError, match="not a host int"):
        pl.forward(m.arch, [m.weights], [kv], [1, 2], pos, n_valid=1,
                   tp=(torch.device("cpu"),))
    assert float(kv.k.abs().max()) == 0.0


# ------------------------------------------------------- Engine, graph path
@pytest.mark.parametrize("which,quant,sampled", [
    ("llama_q8_0", False, False), ("repolm512", False, False),
    ("repolm512", True, False), ("repolm512", False, True)],
    ids=["tiny-greedy", "repolm512-greedy", "repolm512-int8-greedy",
         "repolm512-sampled"])
def test_graphed_generate_matches_jax_and_direct(recorded, files, which,
                                                 quant, sampled):
    """Engine.generate through the graph path: the JAX package's greedy
    text, and the direct path's tokens (greedy, or sampled with one seed)
    bit for bit; the prefill one replay of its chunk's key, every decode
    step a replay of the one step key."""
    path = files[which]
    prompt = PROMPT["repolm512" if which == "repolm512" else "tiny"]
    m = load_model(path, device="cpu", max_seq_len=256)
    cfg, jcfg = _greedy(10)
    if sampled:
        cfg = GenerateConfig(max_tokens=10, temperature=0.8, top_k=40,
                             seed=7)
    eng = Engine(m, kv_quant=quant)
    got, st = _run(eng, "generate", prompt, cfg)
    g = _held(eng)[1]
    pre = g.key("prefill", pe._bucket(st.prefill_tokens))
    assert set(g.replays) == {pre, g.key("step")} and g.captures == 2
    assert g.replays[pre] == 1
    assert g.replays[g.key("step")] == st.decode_tokens > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pe, "_graphed", lambda device: False)
        direct = Engine(m, kv_quant=quant)
        plain, _ = _run(direct, "generate", prompt, cfg)
        assert direct._held == {}
    assert got == plain
    if not sampled:
        jeng = JEngine(jax_load_model(path, max_seq_len=256),
                       kv_quant=quant)
        want, _ = _run(jeng, "generate", prompt, jcfg)
        assert got == want


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_graphed_loop_matches_jax_decode_loop(recorded, files, quant):
    """decode_loop_greedy on the graph path (the loop step replayed n
    times from one prefilled cache): the JAX _decode_loop_greedy's tokens,
    the direct loop's tokens and cache bit for bit; Engine.benchmark
    captures the loop key once in its warm-up run and replays it in both
    runs (and the prefill chunk's key, captured at the first prefill, in
    its prefill)."""
    n = 8
    m = load_model(REPOLM, device="cpu", max_seq_len=256)
    jm = jax_load_model(REPOLM, max_seq_len=256)
    jeng = JEngine(jm, kv_quant=quant)
    ids = jeng._encode(PROMPT["repolm512"])
    jlog, jkv, _ = jeng._prefill(jeng._make_kv(), ids)
    jtoks, _ = _decode_loop_greedy(jm.arch, jm.weights, jkv,
                                   jnp.argmax(jlog[0]).astype(jnp.int32),
                                   jnp.int32(len(ids)), n)
    eng = Engine(m, kv_quant=quant)
    kv = eng._start_kv()
    logits, kv, _ = eng._prefill(kv, ids)
    first = torch.argmax(logits[0])
    toks, _ = pe.decode_loop_greedy(eng, kv, first, len(ids), n)
    direct = eng._make_kv()
    eng._prefill(direct, ids)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pe, "_graphed", lambda device: False)
        plain, direct = pe.decode_loop_greedy(eng, direct, first, len(ids),
                                              n)
    assert toks.tolist() == plain.tolist() == np.asarray(jtoks).tolist()
    assert _same_cache(kv, direct)
    g = _held(eng)[1]
    loop = g.key("loop", n_steps=n)
    pre = g.key("prefill", pe._bucket(len(ids)))
    assert g.replays == {pre: 1, loop: n}
    st = eng.benchmark(prompt_ids=ids, n_tokens=n)
    assert st.decode_tokens == n and g.captures == 2
    assert g.replays == {pre: 2, loop: 3 * n}


@pytest.mark.parametrize("n_draft", [6, 1], ids=["full-accept", "mismatch"])
def test_graphed_spec_iter_matches_jax(recorded, files, n_draft):
    """Four chained spec iterations replayed (anchor and pos carried on the
    device) from one prefilled repolm512 cache: each iteration's emit,
    n_acc, new anchor and pos equal to the JAX _spec_iter_greedy's, and
    emit, n_acc and the cache bit-equal to the direct spec_iter_greedy's.
    Drafting on all six layers accepts every draft; on one it mismatches."""
    m = load_model(REPOLM, device="cpu", max_seq_len=256)
    jm = jax_load_model(REPOLM, max_seq_len=256)
    jeng = JEngine(jm)
    ids = jeng._encode(PROMPT["repolm512"])
    jlog, jkv, _ = jeng._prefill(jeng._make_kv(), ids)
    janchor = jnp.argmax(jlog[0]).astype(jnp.int32)
    jpos = jnp.int32(len(ids))
    eng = Engine(m)
    kv = eng._start_kv()
    logits, kv, _ = eng._prefill(kv, ids)
    g = _held(eng)[1]
    direct = kv.clone()
    anchor, pos, accepted = torch.argmax(logits[0]), len(ids), []
    for it in range(4):
        jkv, jemit, jn, janchor, jpos = _spec_iter_greedy(
            jm.arch, jm.weights, jkv, janchor, jpos, K, n_draft)
        out = g.spec(kv, K, n_draft, anchor if it == 0 else None,
                     pos if it == 0 else None)
        direct, emit, n_acc, anchor = pe.spec_iter_greedy(
            m.arch, m.weights, direct, anchor, pos, K, n_draft)
        pos += int(n_acc) + 1
        assert out.tolist() == emit.tolist() + [int(n_acc)]
        assert out.tolist() == np.asarray(jemit).tolist() + [int(jn)]
        assert int(g._tok[0]) == int(anchor) == int(janchor)
        assert int(g._pos) == pos == int(jpos)
        assert _same_cache(kv, direct)
        accepted.append(int(n_acc))
    assert (accepted == [K] * 4) == (n_draft == m.arch.n_layers)
    assert g.captures == 2 and g.replays == {
        g.key("prefill", pe._bucket(len(ids))): 1,
        g.key("spec", k=K, n_draft=n_draft): 4}


@pytest.mark.parametrize("which,method", [
    ("repolm512", "generate_self_speculative_fused"),
    ("llama_q4_k_m", "generate_self_speculative_fused"),
    ("llama_q8_0", "generate_speculative"),
    ("repolm512", "generate_speculative"),
    ("repolm512", "generate_self_speculative")], ids=lambda v: str(v))
def test_graphed_speculation_matches_jax_and_direct(recorded, files, which,
                                                    method):
    """The Engine's speculation through the graph path: the JAX package's
    tokens and drafted/accepted counts, and the direct path's. The tiny
    target's draft is a tiny model of another seed (the correction path),
    repolm512's draft repolm512 itself (every round a full accept and the
    draft cache's backfill step)."""
    path = files[which]
    prompt = PROMPT["repolm512" if which == "repolm512" else "tiny"]
    spec = method == "generate_speculative"
    draft = files["draft"] if which != "repolm512" else path
    kw = dict(max_seq_len=256)
    cfg, jcfg = _greedy(12)
    eng = Engine(load_model(path, device="cpu", **kw),
                 load_model(draft, device="cpu", **kw) if spec else None)
    got, st = _run(eng, method, prompt, cfg)
    kinds = {k.kind for k in _held(eng)[1].replays}
    assert kinds == {"prefill"} | ({"spec"} if method.endswith("fused") else
                                   {"verify"} if spec else {"step", "verify"})
    if spec:
        dg = _held(eng, "draft")[1]
        assert set(dg.replays) == {dg.key("step"), dg.key(
            "prefill", pe._bucket(st.prefill_tokens))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pe, "_graphed", lambda device: False)
        plain, pst = _run(Engine(eng.model, eng.draft), method, prompt, cfg)
    jeng = JEngine(jax_load_model(path, **kw),
                   jax_load_model(draft, **kw) if spec else None)
    want, jst = _run(jeng, method, prompt, jcfg)
    assert got == plain == want
    assert (st.drafted, st.accepted) == (pst.drafted, pst.accepted) == \
        (jst.drafted, jst.accepted)
    if which == "repolm512" and spec:
        assert st.accepted == st.drafted > 0


def test_graphed_chat_matches_jax_chat_session(recorded):
    """Two turns through one ChatSession on repolm512: the JAX
    ChatSession's texts and prefill counts (turn 2 prefills only its new
    tokens, from the engine's own cache, replaying its chunk's key); a
    generate between the turns writes that cache, so the next turn
    prefills whole and equals a fresh prefill's text."""
    m = load_model(REPOLM, device="cpu", max_seq_len=256)
    cfg, jcfg = _greedy(6)
    eng, jeng = Engine(m), JEngine(jax_load_model(REPOLM, max_seq_len=256))
    tok = m.tokenizer
    turns = [tok.encode(PROMPT["repolm512"], add_bos=True),
             tok.encode("    return", add_bos=False)]
    got, jgot = [], []
    session, jsession = ChatSession(), JChatSession()
    ids, jids = [], []
    for extra in turns:
        ids = session.ids_in_kv + extra
        jids = jsession.ids_in_kv + extra
        assert ids == jids
        text, st = eng.generate("", cfg, prompt_ids=ids, session=session)
        jtext, jst = jeng.generate("", jcfg, prompt_ids=jids,
                                   session=jsession)
        got.append((text, st.prefill_tokens))
        jgot.append((jtext, jst.prefill_tokens))
    assert got == jgot and got[1][1] < len(ids)
    assert session.kv is _held(eng)[0]
    # another call writes the engine's cache: the session's next turn
    # prefills whole
    eng.generate("", cfg, prompt_ids=turns[0])
    ids3 = session.ids_in_kv + turns[1]
    again, st3 = eng.generate("", cfg, prompt_ids=ids3, session=session)
    fresh, st_fresh = eng.generate("", cfg, prompt_ids=ids3)
    assert st3.prefill_tokens == st_fresh.prefill_tokens == len(ids3)
    assert again == fresh
    kinds = [k.kind for k in _held(eng)[1]._graphs]
    assert kinds.count("step") == 1 and set(kinds) == {"prefill", "step"}


# ------------------------------------------------- no host read in a capture
class HostRead(RuntimeError):
    pass


class NoHostReads(TorchDispatchMode):
    """Raises on an op a CUDA graph cannot capture because it needs the
    host: a device value read on the host (`_local_scalar_dense`, behind
    int(), .item(), bool() and .tolist()), a tensor made from host data
    (`lift_fresh`), and a copy from a card-resident tensor to the CPU."""

    BANNED = (torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.lift_fresh.default,
              torch.ops.aten.lift_fresh_copy.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.BANNED:
            raise HostRead(str(func))
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if (func is torch.ops.aten._to_copy.default and src is not None
                and src.device.type != "cpu"
                and torch.device(kwargs.get("device") or src.device).type
                == "cpu"):
            raise HostRead(f"{func} to the CPU")
        if (func is torch.ops.aten.copy_.default and src is not None
                and src.device.type == "cpu"
                and args[1].device.type != "cpu"):
            raise HostRead(f"{func} to the CPU")
        return func(*args, **kwargs)


class GuardedGraph(RecordingGraph):
    """The recording double with NoHostReads active while it captures."""

    def capture(self, fn, pool=None):
        with NoHostReads():
            return super().capture(fn, pool)


def test_guard_catches_a_host_read():
    """The guard fires on the forms a capture cannot take, among them the
    0-d tensor index the fused iteration used to write its emit with."""
    t, n = torch.arange(4), torch.tensor(2)
    for fn in (lambda: int(n), lambda: bool(n > 1), lambda: t[n],
               lambda: t.__setitem__(n, 0), lambda: torch.tensor([1, 2])):
        with pytest.raises(HostRead):
            with NoHostReads():
                fn()


@pytest.mark.parametrize("which,quant,impl", [
    ("llama_q8_0", False, "plain"), ("llama_q8_0", True, "plain"),
    ("llama_q8_0", False, "kernel"), ("llama_q4_k_m", False, "kernel"),
    ("gemma3", True, "plain"), ("mixtral", False, "kernel"),
    ("qwen3moe", False, "plain")], ids=lambda v: str(v))
def test_no_captured_program_reads_the_device_on_the_host(
        monkeypatch, files, which, quant, impl):
    """Every kind (step, a draft prefix's step, verify, loop, spec) is
    captured under NoHostReads, on the plain path and on the kernel path
    (the wrappers' host code, their plain twins on CPU tensors), and then
    replayed to the direct path's values."""
    monkeypatch.setattr(graphs, "GRAPH", GuardedGraph)
    monkeypatch.setattr(linear, "kernels_enabled",
                        lambda t: impl == "kernel")
    m = load_model(files[which], device="cpu", max_seq_len=64)
    kv = pl.KVCache.create(m.arch, quant=quant, device="cpu")
    pl.forward(m.arch, m.weights, kv, list(range(3, 15)), 0)
    g = graphs.ForwardGraphs(m.arch, m.weights, kv)
    direct = kv.clone()
    a = m.arch
    logits = g.step(kv, 7, PREFILL)
    want, _, _ = pl.forward(a, m.weights, direct, [7], PREFILL)
    assert torch.equal(logits, want)
    logits = g.step(kv, 8, PREFILL + 1, layers=range(2))
    want, _, _ = pl.forward(a, m.weights, direct, [8], PREFILL + 1,
                            layer_sel=range(2))
    assert torch.equal(logits, want)
    logits = g.verify(kv, torch.tensor([9, 10, 11, 12]), PREFILL + 2)
    want, _, _ = pl.forward(a, m.weights, direct, [9, 10, 11, 12],
                            PREFILL + 2, all_logits=True)
    assert torch.equal(logits, want)
    toks, _ = g.loop(kv, 13, PREFILL + 6, 3)
    plain, direct = pe.decode_loop_greedy(Engine(m), direct,
                                          torch.tensor(13), PREFILL + 6, 3)
    assert torch.equal(toks, plain)
    out = g.spec(kv, 2, 1, torch.tensor(14), PREFILL + 9)
    direct, emit, n_acc, _ = pe.spec_iter_greedy(a, m.weights, direct,
                                                 torch.tensor(14),
                                                 PREFILL + 9, 2, 1)
    assert out.tolist() == emit.tolist() + [int(n_acc)]
    assert _same_cache(kv, direct)
    assert g.captures == 5


# --------------------------------------------------------------- structure
def test_repeated_key_replays_without_a_new_capture(recorded, files):
    """Two generate calls and two benchmarks: one capture a key (the cache
    kept across calls, zeroed at each start); a layer-skip schedule is a
    new key, for the prefill and the step."""
    eng = Engine(load_model(files["llama_q8_0"], device="cpu",
                            max_seq_len=128))
    cfg, _ = _greedy(5)
    first, _ = eng.generate(PROMPT["tiny"], cfg)
    kv, g = _held(eng)
    second, _ = eng.generate(PROMPT["tiny"], cfg)
    assert first == second and _held(eng)[0] is kv
    eng.benchmark(PROMPT["tiny"], n_tokens=4)
    eng.benchmark(PROMPT["tiny"], n_tokens=4)
    t = pe._bucket(len(eng._encode(PROMPT["tiny"])))
    assert g.captures == len(recorded) == 3
    assert g.replays == {g.key("prefill", t): 4, g.key("step"): 10,
                         g.key("loop", n_steps=4): 16}
    eng.layer_sel = np.array([0, 1, 3])
    eng.generate(PROMPT["tiny"], cfg)
    assert g.captures == 5 and g.key("step", layers=(0, 1, 3)) in g.replays
    assert g.key("prefill", t, layers=(0, 1, 3)) in g.replays


def test_foreign_cache_raises_and_runs_uncaptured_in_the_engine(recorded,
                                                                files):
    """ForwardGraphs refuses a cache it was not captured against; the
    Engine runs a step on a caller's own cache uncaptured."""
    m = load_model(files["llama_q8_0"], device="cpu", max_seq_len=64)
    kv = pl.KVCache.create(m.arch, device="cpu")
    g = graphs.ForwardGraphs(m.arch, m.weights, kv)
    with pytest.raises(ValueError, match="not the one"):
        g.step(kv.clone(), 3, 0)
    with pytest.raises(ValueError, match="exceed"):
        g.step(kv, 3, 64)
    with pytest.raises(ValueError, match="forward kind"):
        g.key("decode")
    assert g.captures == 0
    eng = Engine(m)
    own = eng._make_kv()
    logits, own, _ = eng._decode_step(own, 3, 0)
    assert eng._held == {} and tuple(logits.shape) == (1, m.arch.vocab_size)


def test_failed_capture_raises_and_runs_nothing(monkeypatch, files):
    """A capture that fails raises out of the Engine's prefill and step:
    no uncaptured forward runs in its place, and the cache and the static
    inputs keep what they held."""
    class Refusing(RecordingGraph):
        def capture(self, fn, pool=None):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    monkeypatch.setattr(graphs, "GRAPH", Refusing)
    monkeypatch.setattr(pe, "_graphed", lambda device: True)
    eng = Engine(load_model(files["llama_q8_0"], device="cpu",
                            max_seq_len=64))
    kv = eng._start_kv()
    kv.k.fill_(0.5)
    before = kv.clone()
    with pytest.raises(RuntimeError, match="capturing"):
        eng._prefill(kv, [3, 4, 5])
    with pytest.raises(RuntimeError, match="capturing"):
        eng._decode_step(kv, 6, 3)
    g = _held(eng)[1]
    assert g.captures == 0 and _same_cache(kv, before)
    assert int(g._pos) == 0 and int(g._tok[0]) == 0


def test_subclasses_take_no_graph_path(recorded, files, tmp_path):
    """The tiered engine keeps its host-driven path, and so does a mesh
    engine whose mesh spans devices (models/graphs.check_capturable; the
    mesh engines on one device replay, tests/test_torch_mesh_graphs.py):
    with the device test patched they hold no cache and capture nothing."""
    path = files["llama_q8_0"]
    m = load_model(path, device="cpu", max_seq_len=128)
    cfg, _ = _greedy(4)
    cpu, meta = torch.device("cpu"), torch.device("meta")
    engines = [TPEngine(m, (cpu, meta)),
               CPEngine(load_model(path, device="cpu", max_seq_len=128),
                        make_cp_mesh(2, [cpu, meta])),
               EPEngine(load_model(files["mixtral"], device="cpu",
                                   max_seq_len=128), (cpu, meta))]
    for eng in engines:
        assert not eng._graph_path()
        assert eng._graphs_of(eng._start_kv()) is None
        assert eng._held == {}
    copy = str(tmp_path / "tiered.gguf")
    shutil.copy(path, copy)
    tiered = TieredEngine.load(copy, device="cpu", max_hbm_layers=1,
                               max_ram_layers=1)
    try:
        assert not tiered._graph_path()
        tiered.generate(PROMPT["tiny"], cfg)
        tiered.generate_self_speculative_fused(PROMPT["tiny"], cfg)
    finally:
        tiered.tm.close()
    assert recorded == []
    base = Engine(m)
    assert base._graph_path()
    base.generate(PROMPT["tiny"], cfg)
    assert len(recorded) == 2  # its prefill chunk and its step
