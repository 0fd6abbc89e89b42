"""The captured batched steps (models/graphs.py) and the server's graph path
on the CPU, against the JAX package.

On the card BatchServer replays CUDA graphs of its steps; on the CPU it
calls them directly. Here models/graphs.py's graph class is replaced by a
double that records the captured callable at capture and re-runs it over
the same static tensors at replay (writing its outputs in place, as a
graph's static outputs are), and the server's device test is patched, so
the server's graph path runs on the CPU: the static inputs, the key per
shape, the shared cache written in place, the one capture a key.

Tolerances are those of tests/test_torch_batched.py (the JAX steps) and
tests/test_torch_serve.py (greedy texts equal); within the port the graph
path and the direct call run the same function and are held bit for
bit."""
import dataclasses
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from ntransformer_tpu.inference.serve import BatchServer as JBatchServer
from ntransformer_tpu.inference.serve import Request as JRequest
from ntransformer_tpu.models import batched as jb
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu_torch.inference import serve as pserve
from ntransformer_tpu_torch.inference.sampler import SamplerConfig
from ntransformer_tpu_torch.inference.serve import BatchServer, Request
from ntransformer_tpu_torch.models import batched as pb
from ntransformer_tpu_torch.models import graphs
from ntransformer_tpu_torch.models import llama as pl
from ntransformer_tpu_torch.models.convert import weights_from_numpy
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.ops.cuda import batched_attention, build
from test_torch_batched import (JIMPL, LOGIT_RTOL, _check_caches,
                                _check_logits, _mark, _mid_context, _rel)
from test_torch_model import jax_tree, one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(REPO, "models", "repolm512_q8.gguf")
PROMPTS = {"tiny": ["alpha beta", "gamma", "delta epsilon zeta", "eta"],
           "repolm512": ["def forward(arch, weights, kv, tokens, pos):\n",
                         "class Engine:\n    def __init__(self",
                         "import jax\nimport jax.numpy as jnp\n",
                         "from .ops import "]}


class RecordingGraph:
    """The graph double: capture records fn and its outputs; replay runs fn
    again over the same static inputs and writes the outputs in place."""

    made: list = []

    def __init__(self):
        self.made.append(self)
        self.fn = self.out = None
        self.replayed = 0

    def capture(self, fn, pool=None):
        self.fn, self.out = fn, fn()
        return self.out

    def replay(self):
        self.out.copy_(self.fn())
        self.replayed += 1

    def pool(self):
        return None


@pytest.fixture
def recorded(monkeypatch):
    """The graph double in GRAPH's place and the server's device test
    true: the server takes its graph path on the CPU. Yields the graphs
    made."""
    made = []
    monkeypatch.setattr(RecordingGraph, "made", made)
    monkeypatch.setattr(graphs, "GRAPH", RecordingGraph)
    monkeypatch.setattr(pserve, "_graphed", lambda device: True)
    return made


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("m") / "tiny_q8.gguf"),
                       "tiny", "q8_0", seed=8)


@pytest.fixture(scope="module")
def models(tiny_path):
    ref = jax_load_model(tiny_path, fuse=True)
    arch = pl.Arch(**dataclasses.asdict(ref.arch))
    return {"tiny": (ref, arch, weights_from_numpy(jax_tree(ref.weights),
                                                   arch, "cpu"))}


def _serve(server_cls, request_cls, model, prompts, **kw):
    srv = server_cls(model, batch_size=2, admit_chunk=16, **kw)
    reqs = [request_cls(prompt=p, max_tokens=8) for p in prompts]
    stats = srv.run(reqs)
    return srv, [list(r.output_ids) for r in reqs], stats


def _clone(kv: pb.BatchedKV) -> pb.BatchedKV:
    return pb.BatchedKV(*(None if t is None else t.clone()
                          for t in (kv.k, kv.v, kv.ks, kv.vs)))


# ----------------------------------------------------------------- server
@pytest.mark.parametrize("which,kv_quant,spec", [
    ("tiny", False, 0), ("repolm512", False, 0), ("repolm512", True, 0),
    ("tiny", False, 2), ("repolm512", True, 2)],
    ids=["tiny-bf16", "repolm512-bf16", "repolm512-int8", "tiny-bf16-spec",
         "repolm512-int8-spec"])
def test_graphed_server_matches_jax_server(recorded, monkeypatch, tiny_path,
                                           which, kv_quant, spec):
    """Batch 2 over 4 requests through the server's graph path: the JAX
    server's greedy texts (and its speculative counts), the direct-call
    server's tokens, every step and every admission's prefill chunk a
    replay of a key warmup captured. int8 on the trained model only
    (tests/test_torch_serve.py says why)."""
    path = tiny_path if which == "tiny" else REPOLM
    kw = dict(kv_quant=kv_quant)
    if spec:
        kw.update(spec_k=spec, spec_draft_layers=2)
    jm = jax_load_model(path, max_seq_len=512, fuse=True)
    _, want, jst = _serve(JBatchServer, JRequest, jm, PROMPTS[which],
                          sampler_cfg=JSamplerConfig(temperature=0.0), **kw)
    pm = load_model(path, max_seq_len=512, fuse=True, device="cpu")
    srv, got, st = _serve(BatchServer, Request, pm, PROMPTS[which],
                          sampler_cfg=SamplerConfig(temperature=0.0), **kw)
    assert got == want
    assert (st.steps, st.draft_steps, st.spec_accepted) == \
        (jst.steps, jst.draft_steps, jst.spec_accepted)
    g = srv._graphs
    keys = srv._graph_keys()
    # decode at full S and the 256 and 384 rungs, and with spec the draft
    # and verify steps at each: captured once, in warmup
    assert g is not None and len(keys) == (9 if spec else 3)
    assert set(g.replays) == set(keys) and g.captures == len(keys)
    served = sum(g.replays.values()) - len(keys)  # warmup replays each once
    assert served == st.steps + st.draft_steps > 0
    adm = srv._adm[1]
    assert {k.kind for k in adm.replays} == {"prefill"}
    assert len(recorded) == len(keys) + adm.captures
    assert sum(adm.replays.values()) - adm.captures == st.prefill_chunks > 0
    assert sum(r.replayed for r in recorded) == sum(g.replays.values()) + \
        sum(adm.replays.values())
    monkeypatch.setattr(pserve, "_graphed", lambda device: False)
    direct, plain, _ = _serve(BatchServer, Request, pm, PROMPTS[which],
                              sampler_cfg=SamplerConfig(temperature=0.0),
                              **kw)
    assert direct._graphs is None and direct._adm is None and plain == got


@pytest.mark.parametrize("dot", ["f32", "int8"])
def test_graphed_kernel_path_server_matches_direct(recorded, tiny_path,
                                                   monkeypatch, dot):
    """The kernel path (the kernels' plain twins on CPU tensors: deferred
    writes, the bulk append, the s_live rungs) through the graph path gives
    the direct calls' tokens, plain and speculative."""
    monkeypatch.setattr(pb, "kernels_enabled", lambda t: True)
    pm = load_model(tiny_path, max_seq_len=512, fuse=True, device="cpu")
    kw = dict(sampler_cfg=SamplerConfig(temperature=0.0), dot_impl=dot,
              kv_quant=dot == "int8")
    runs = {}
    for graphed in (True, False):
        monkeypatch.setattr(pserve, "_graphed", lambda device: graphed)
        for spec in (0, 2):
            srv, toks, _ = _serve(BatchServer, Request, pm, PROMPTS["tiny"],
                                  spec_k=spec, spec_draft_layers=2, **kw)
            assert (srv._graphs is not None) == graphed
            if graphed:
                assert all(k.impl == "kernel" for k in srv._graphs.replays)
            runs[graphed, spec] = toks
    assert runs[True, 0] == runs[False, 0] == runs[True, 2] == \
        runs[False, 2]


# ------------------------------------------------------------------ steps
def _impl(monkeypatch, impl: str) -> None:
    """The step path the graphs capture: "kernel" as on the card (its
    wrappers' plain twins on CPU tensors), else "plain"."""
    monkeypatch.setattr(pb, "kernels_enabled", lambda t: impl == "kernel")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_replayed_decode_step_matches_jax(recorded, monkeypatch, models,
                                          impl, quant):
    """Three chained replayed decode steps from a mid-context cache, B = 3
    with slot 1 inactive: the JAX step within test_torch_batched's
    tolerances, and the direct call on a clone of the cache bit for bit
    (logits and caches). One capture serves the three steps."""
    _impl(monkeypatch, impl)
    ref, arch, w = models["tiny"]
    jkv, pkv, lens = _mid_context(ref, 3, quant, seed=1)
    direct = _clone(pkv)
    sg = graphs.StepGraphs(arch, w, pkv)
    active = np.array([True, False, True])
    toks = np.random.default_rng(2).integers(3, arch.vocab_size, (3, 3))
    written = np.zeros(pkv.k.shape[:4], bool)[:, :, :1]
    for step in range(3):
        pos = lens + step
        jlog, jkv = jb.batched_decode_step(
            ref.arch, ref.weights, jkv, jnp.asarray(toks[step], jnp.int32),
            jnp.asarray(pos), jnp.asarray(active), impl=JIMPL[impl])
        plog = sg.run(pkv, "decode", toks[step], pos, active)
        dlog, direct = pb.batched_decode_step(arch, w, direct, toks[step],
                                              pos, active, impl=impl)
        assert tuple(plog.shape) == (3, arch.vocab_size)
        _check_logits(plog.numpy(), np.asarray(jlog), active, quant)
        assert torch.equal(plog, dlog)
        _check_caches(pkv, jkv, _mark(written, pos, active))
    for a, b in zip(pkv.caches, direct.caches):
        assert torch.equal(a, b)
    assert sg.captures == len(recorded) == 1
    assert list(sg.replays.values()) == [3]
    assert next(iter(sg.replays)).impl == impl


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_replayed_verify_step_matches_jax(recorded, monkeypatch, models, impl,
                                          quant):
    """A replayed T = 4 verify window, one slot inactive: the JAX verify
    step within test_torch_batched's tolerances, the direct call bit for
    bit."""
    _impl(monkeypatch, impl)
    ref, arch, w = models["tiny"]
    jkv, pkv, lens = _mid_context(ref, 3, quant, seed=3)
    direct = _clone(pkv)
    active = np.array([True, True, False])
    toks = np.random.default_rng(4).integers(3, arch.vocab_size, (3, 4))
    jlog, jkv = jb.batched_verify_step(
        ref.arch, ref.weights, jkv, jnp.asarray(toks, jnp.int32),
        jnp.asarray(lens), jnp.asarray(active), impl=JIMPL[impl])
    sg = graphs.StepGraphs(arch, w, pkv)
    plog = sg.run(pkv, "verify", toks, lens, active)
    dlog, direct = pb.batched_verify_step(arch, w, direct, toks, lens, active,
                                          impl=impl)
    assert tuple(plog.shape) == (3, 4, arch.vocab_size)
    _check_logits(plog.numpy(), np.asarray(jlog), active, quant)
    assert torch.equal(plog, dlog)
    written = np.zeros(pkv.k.shape[:4], bool)[:, :, :1]
    _check_caches(pkv, jkv, _mark(written, lens, active, t=4))
    for a, b in zip(pkv.caches, direct.caches):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_replayed_draft_step_matches_jax(recorded, monkeypatch, models, impl):
    """The draft key (n_layers = 2, a speculative draft's layer prefix):
    the JAX layer-prefix step, the deeper layers' caches untouched."""
    _impl(monkeypatch, impl)
    ref, arch, w = models["tiny"]
    jkv, pkv, lens = _mid_context(ref, 2, False, seed=5)
    active = np.array([True, True])
    deep = pkv.k[2:].clone()
    jlog, jkv = jb.batched_decode_step(
        ref.arch, ref.weights, jkv, jnp.asarray([5, 9], jnp.int32),
        jnp.asarray(lens), jnp.asarray(active), impl=JIMPL[impl], n_layers=2)
    sg = graphs.StepGraphs(arch, w, pkv)
    plog = sg.run(pkv, "draft", [5, 9], lens, active, n_layers=2)
    assert _rel(plog.numpy(), np.asarray(jlog)) <= LOGIT_RTOL[False]
    assert torch.equal(pkv.k[2:], deep)
    written = np.zeros(pkv.k.shape[:4], bool)[:, :, :1]
    _check_caches(pkv, jkv, _mark(written, lens, active, n_layers=2))
    assert next(iter(sg.replays)).n_layers == 2


def test_admission_mid_run_is_seen_by_the_next_replay(recorded, models):
    """A slot inserted between two replays (the cache written in place at
    the captured addresses) is attended by the next replay: its logits
    equal the direct call's on a cache built the same way."""
    ref, arch, w = models["tiny"]
    _, pkv, lens = _mid_context(ref, 2, False, seed=7)
    _, fresh, _ = _mid_context(ref, 2, False, seed=8)
    direct = _clone(pkv)
    sg = graphs.StepGraphs(arch, w, pkv)
    active = np.array([True, False])
    pos = lens.copy()
    sg.run(pkv, "decode", [4, 0], pos, active)
    pb.batched_decode_step(arch, w, direct, [4, 0], pos, active)
    # admit a new sequence into slot 1: seed 8's slot 1 prefill
    one = pl.KVCache(fresh.k[:, 1].clone(), fresh.v[:, 1].clone())
    for kv in (pkv, direct):
        kv.insert(1, one)
    pos = np.array([lens[0] + 1, 30])
    active = np.array([True, True])
    plog = sg.run(pkv, "decode", [6, 8], pos, active)
    dlog, direct = pb.batched_decode_step(arch, w, direct, [6, 8], pos,
                                          active)
    assert torch.equal(plog, dlog)
    assert sg.captures == 1 and sum(sg.replays.values()) == 2


def test_repeated_key_replays_without_a_new_capture(recorded, models):
    """A key seen again replays; a new key (another s_live rung) captures
    once; inputs of the wrong shape are refused."""
    ref, arch, w = models["tiny"]
    _, pkv, lens = _mid_context(ref, 2, False, seed=9)
    sg = graphs.StepGraphs(arch, w, pkv)
    active = np.array([True, True])
    for i in range(3):
        sg.run(pkv, "decode", [3, 4], lens + i, active)
    assert sg.captures == len(recorded) == 1
    sg.run(pkv, "decode", [3, 4], lens + 3, active, s_live=256)
    sg.run(pkv, "decode", [3, 4], lens + 4, active, s_live=256)
    assert sg.captures == len(recorded) == 2
    assert sorted(sg.replays.values()) == [2, 3]
    assert [g.replayed for g in recorded] == [3, 2]
    with pytest.raises(RuntimeError):
        sg.run(pkv, "decode", [3, 4, 5], lens, active)


def test_foreign_cache_and_bad_keys_raise(recorded, models):
    ref, arch, w = models["tiny"]
    _, pkv, lens = _mid_context(ref, 2, False, seed=10)
    sg = graphs.StepGraphs(arch, w, pkv)
    active = np.array([True, True])
    with pytest.raises(ValueError, match="not the one"):
        sg.run(_clone(pkv), "decode", [3, 4], lens, active)
    with pytest.raises(ValueError, match="n_layers"):
        sg.run(pkv, "draft", [3, 4], lens, active)
    with pytest.raises(ValueError, match="step kind"):
        sg.key("prefill")
    assert sg.captures == 0


def test_failed_capture_raises_and_runs_nothing(monkeypatch, models):
    """A capture that fails raises out of run: no uncaptured step runs in
    its place and the cache is not written."""
    class Refusing(RecordingGraph):
        def capture(self, fn, pool=None):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    monkeypatch.setattr(graphs, "GRAPH", Refusing)
    ref, arch, w = models["tiny"]
    _, pkv, lens = _mid_context(ref, 2, False, seed=11)
    before = _clone(pkv)
    sg = graphs.StepGraphs(arch, w, pkv)
    with pytest.raises(RuntimeError, match="capturing"):
        sg.run(pkv, "decode", [3, 4], lens, np.array([True, True]))
    assert sg.captures == 0
    for a, b in zip(pkv.caches, before.caches):
        assert torch.equal(a, b)


# ------------------------------------------------ capture-time refusals
def test_build_refuses_a_first_load_inside_a_capture(monkeypatch):
    """A kernel library reached for the first time inside a capture is not
    built or loaded there: load raises and names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(build, "build", lambda name: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="q8_0_matmul.*capture"):
        build.load("q8_0_matmul", {})
    assert "q8_0_matmul" not in build._LIBS


def test_scratch_never_grows_inside_a_capture(monkeypatch):
    """batched flash's split scratch grows outside a capture, is reused
    when big enough inside one, and refuses to grow there."""
    dev, stream = torch.device("cpu"), types.SimpleNamespace(cuda_stream=-7)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    try:
        buf = batched_attention._scratch(dev, -7, 64)
        assert batched_attention.scratch_buffer(dev, stream) is buf
        capturing[0] = True
        assert batched_attention._scratch(dev, -7, 32) is buf
        with pytest.raises(RuntimeError, match="cannot grow inside a CUDA "
                                               "graph capture"):
            batched_attention._scratch(dev, -7, 65)
        assert batched_attention.scratch_buffer(dev, stream) is buf
    finally:
        batched_attention._SCRATCH.pop((None, -7), None)


def test_captured_step_refuses_host_inputs(monkeypatch):
    """Inside a capture the step's tokens, pos and active must already be
    device tensors of its dtypes (a host array would be a pageable copy,
    and the graph would keep its values)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(ValueError, match="captured step"):
        pb._vec(np.zeros(2, np.int64), torch.device("cuda"), torch.long)
    # on the CPU nothing is captured: host inputs convert as before
    got = pb._vec(np.zeros(2, np.int64), torch.device("cpu"), torch.long)
    assert got.dtype == torch.long and got.shape == (2,)
