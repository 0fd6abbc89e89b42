"""The mesh programs as captured programs, on the CPU, against the JAX
package: the TP, CP, CP x TP and EP forwards with a device pos and n_valid
(the JAX make_tp_forward, make_cp_forward, make_cp_tp_forward and
make_ep_forward trace both), ForwardGraphs over those meshes, the mesh
engines' graph paths, make_tp_decode_loop, the sharded server's group
steps and admissions, and make_pp_decode.

On the card these replay CUDA graphs where the mesh lies on one card of
one process; on the CPU they call the forwards directly. Here
tests/test_torch_graphs.py's recording double takes the graph class's
place and the device tests are patched, so the graph paths run on the CPU
over meshes of CPU positions (the conftest's 8-device CPU mesh on the JAX
side).

Tolerances: the TP forward within LOGIT_RTOL (5e-3 of the largest JAX
logit, tests/test_torch_tp.py), the CP forward the same
(tests/test_torch_cp.py's last check), the EP forward at 2e-2
(tests/test_torch_ep.py). The CP x TP forward is held to LOGIT_RTOL too,
not to tests/test_torch_cp_tp.py's rtol 1e-4, atol 3e-4: that limit holds
for that file's token ids (1-9), but on these seeded ids (3-511) the two
packages' forwards differ by up to 2e-3 at the first 8-token prefill,
resident, TP and CP x TP alike (1.9e-3 on ids 395, 189, ...; 1.2e-7 on ids
1-9), the cross-package gap tests/test_torch_model.py's LOGIT_RTOL
documents. Layer 0's new cache rows equal the JAX package's in at least
CACHE_EQUAL of their elements (tests/test_torch_prefill_graphs.py);
greedy texts and tokens equal.
Within the port the device-pos forward and the host-int forward, and each
graph path and its uncaptured run, compute the same thing and are held bit
for bit: logits and every cache byte."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from ntransformer_tpu.inference.engine import CPEngine as JCPEngine
from ntransformer_tpu.inference.engine import EPEngine as JEPEngine
from ntransformer_tpu.inference.engine import TPEngine as JTPEngine
from ntransformer_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from ntransformer_tpu.inference.serve import BatchServer as JBatchServer
from ntransformer_tpu.inference.serve import Request as JRequest
from ntransformer_tpu.models import llama as jl
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.parallel import cp as jcp
from ntransformer_tpu.parallel import ep as jep
from ntransformer_tpu.parallel import tp as jtp
from ntransformer_tpu.parallel.multihost import make_mesh as jmake_mesh
from ntransformer_tpu_torch.inference import engine as pe
from ntransformer_tpu_torch.inference import serve as pserve
from ntransformer_tpu_torch.inference.engine import (CPEngine, EPEngine,
                                                     TPEngine)
from ntransformer_tpu_torch.inference.sampler import SamplerConfig
from ntransformer_tpu_torch.inference.serve import BatchServer, Request
from ntransformer_tpu_torch.models import batched as pb
from ntransformer_tpu_torch.models import graphs
from ntransformer_tpu_torch.models import llama as pl
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.ops import linear
from ntransformer_tpu_torch.parallel import cp as pcp
from ntransformer_tpu_torch.parallel import dp as pdp
from ntransformer_tpu_torch.parallel import ep as pep
from ntransformer_tpu_torch.parallel import pp as ppp
from ntransformer_tpu_torch.parallel import tp as ptp
from ntransformer_tpu_torch.parallel.multihost import Row, make_mesh
from test_torch_engine_graphs import GuardedGraph, _greedy
from test_torch_graphs import RecordingGraph
from test_torch_model import (CACHE_EQUAL, LOGIT_RTOL, _equal_share,
                              one_torch_thread)  # noqa: F401
from tools.make_test_gguf import write_model

# (T, n_valid, pos, kind) after a 12-token host prefill: a padded 64-token
# chunk, one across the CP shard 0/1 boundary at 128 (4 shards of 128
# rows), a verify window and the T = 1 step; every pos a device tensor
HEAD = 12
WINDOWS = ((64, 60, HEAD, "prefill"), (64, 60, 72, "prefill"),
           (4, 4, 132, "verify"), (1, 1, 136, "step"))
PROMPTS = ["alpha beta", "gamma", "delta epsilon zeta", "eta", "theta iota"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mg")
    return {"tiny": write_model(str(d / "tiny.gguf"), "tiny", "q8_0",
                                seed=13),
            "moe": write_model(str(d / "moe.gguf"), "moe", "q8_0", seed=122)}


@pytest.fixture
def recorded(monkeypatch):
    """The graph double in GRAPH's place and every device test true: the
    engines, make_tp_decode_loop, the server and make_pp_decode take their
    graph paths on the CPU. Yields the graphs made."""
    made = []
    monkeypatch.setattr(RecordingGraph, "made", made)
    monkeypatch.setattr(graphs, "GRAPH", RecordingGraph)
    for mod in (pe, pserve, ptp, ppp):
        monkeypatch.setattr(mod, "_graphed", lambda device: True)
    return made


def _cpu(n):
    return ("cpu",) * n


def _clone(kv):
    if isinstance(kv, list):
        return [_clone(c) for c in kv]
    return kv.clone()


def _same(a, b) -> bool:
    """Two caches (a KVCache, a shard list or a grid) equal byte for
    byte."""
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip((a.k, a.v, a.ks, a.vs), (b.k, b.v, b.ks, b.vs)))


def _window(toks, pos: int, t: int, nv: int) -> np.ndarray:
    w = np.zeros(t, np.int64)
    w[:nv] = toks[pos:pos + nv]
    return w


# ---------------------------------------------------------- the four meshes
def _port(kind: str, path: str, quant: bool = False):
    """(arch, weights, fresh cache maker, mesh keyword) of the port's
    forward over `kind`'s mesh of CPU positions."""
    m = load_model(path, device="cpu")
    a = m.arch
    if kind == "tp":
        mesh = ptp.make_tp_mesh(2, _cpu(2))
        return (a, ptp.shard_weights(m.weights, mesh, a),
                lambda: ptp.make_tp_kv(a, mesh, quant), {"tp": mesh})
    if kind == "cp":
        mesh = pcp.make_cp_mesh(4, _cpu(4))
        return a, m.weights, lambda: pcp.make_cp_kv(a, mesh), {"cp": mesh}
    if kind == "cptp":
        mesh = pcp.make_cp_tp_mesh(4, 2, _cpu(8))
        return (a, ptp.shard_weights(m.weights, mesh[0], a),
                lambda: pcp.make_cp_tp_kv(a, mesh),
                {"cp": mesh, "tp": mesh[0]})
    mesh = pep.make_ep_mesh(2, _cpu(2))
    return (a, pep.shard_weights_ep(m.weights, mesh, a),
            lambda: pl.KVCache.create(a, quant=quant, device="cpu"),
            {"ep": mesh})


def _jax(kind: str, path: str):
    """(weights, cache, forward(all_logits, has_n_valid)) of the JAX
    package's jitted mesh forward of `kind`."""
    jm = jax_load_model(path, device=False)
    kv0 = jl.KVCache.create(jm.arch)
    if kind == "tp":
        mesh = Mesh(np.asarray(jax.devices()[:2]), (jtp.TP_AXIS,))
        w, kv = jtp.shard_model(jm.weights, kv0, mesh, jm.arch)
        make = jtp.make_tp_forward
    elif kind == "cp":
        mesh = jcp.make_cp_mesh(4)
        w, kv = jcp.replicate_weights(jm.weights, mesh), jcp.shard_kv(kv0,
                                                                       mesh)
        make = jcp.make_cp_forward
    elif kind == "cptp":
        mesh = jcp.make_cp_tp_mesh(cp=4, tp=2)
        w, kv = jcp.shard_cp_tp(jm.weights, kv0, mesh, jm.arch)
        make = jcp.make_cp_tp_forward
    else:
        mesh = Mesh(np.asarray(jax.devices("cpu")[:2]), (jep.EP_AXIS,))
        w, kv = jep.shard_model_ep(jm.weights, kv0, mesh, jm.arch)
        make = jep.make_ep_forward
    fwds = {}

    def fwd(all_logits: bool, has_n_valid: bool):
        key = (all_logits, has_n_valid)
        if key not in fwds:
            fwds[key] = make(mesh, jm.arch, weights_template=jm.weights,
                             all_logits=all_logits, has_n_valid=has_n_valid)
        return fwds[key]
    return w, kv, fwd


def _global_k(kind: str, kv) -> np.ndarray:
    """The port's cache k as the whole [L, Hkv, S, D] array."""
    if kind == "tp":
        k = torch.cat([c.k for c in kv], dim=1)
    elif kind == "cp":
        k = torch.cat([c.k for c in kv], dim=2)
    elif kind == "cptp":
        k = torch.cat([torch.cat([c.k for c in col], dim=2) for col in kv],
                      dim=1)
    else:
        k = kv.k
    return k


def _check_jax(kind: str, got: torch.Tensor, want) -> None:
    """got (the port's mesh forward) against want (the JAX one's) at the
    module docstring's tolerance."""
    got, want = got.numpy(), np.asarray(want)
    if kind == "ep":
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    else:
        assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()


@pytest.mark.parametrize("kind", ["tp", "cp", "cptp", "ep"])
def test_mesh_device_pos_forward_matches_jax_and_host_pos(files, kind):
    """A 12-token host prefill, then WINDOWS with a 0-d device pos (and
    n_valid with the chunks): the JAX mesh forward with traced pos and
    n_valid within its tolerance, the port's host-int forward on a twin
    cache bit for bit (logits, every cache byte); the padded rows are not
    written; layer 0's new rows agree with the JAX package's."""
    path = files["moe" if kind == "ep" else "tiny"]
    a, w, make_kv, mesh = _port(kind, path)
    jw, jkv, jfwd = _jax(kind, path)
    toks = np.random.default_rng(22).integers(3, a.vocab_size, 256)
    head = _window(toks, 0, 16, HEAD)
    _, jkv, _ = jfwd(False, True)(jw, jkv, jnp.asarray(head, jnp.int32),
                                  jnp.int32(0), jnp.int32(HEAD))
    dev = make_kv()
    pl.forward(a, w, dev, torch.from_numpy(head), 0, n_valid=HEAD, **mesh)
    host = _clone(dev)
    for t, nv, pos, what in WINDOWS:
        win = _window(toks, pos, t, nv)
        x, jx = torch.from_numpy(win), jnp.asarray(win, jnp.int32)
        kw, hkw, jargs = {}, {}, ()
        if what == "prefill":
            kw, hkw = {"n_valid": torch.tensor(nv)}, {"n_valid": nv}
            jargs = (jnp.int32(nv),)
        full = what == "verify"
        want, jkv, _ = jfwd(full, what == "prefill")(
            jw, jkv, jx, jnp.int32(pos), *jargs)
        got, _, _ = pl.forward(a, w, dev, x, torch.tensor(pos),
                               all_logits=full, **kw, **mesh)
        ref, _, _ = pl.forward(a, w, host, x, pos, all_logits=full, **hkw,
                               **mesh)
        assert got.shape == (t if full else 1, a.vocab_size)
        assert torch.equal(got, ref) and _same(dev, host), (what, pos)
        _check_jax(kind, got, want)
    end = WINDOWS[-1][2] + 1
    k = _global_k(kind, dev)
    assert not k[:, :, end:].any()
    rows = slice(HEAD, end)
    share = _equal_share(k[0, :, rows], np.asarray(jkv.k)[0, :, rows])
    assert share >= CACHE_EQUAL, share


# ------------------------------------------------- no host read in a capture
@pytest.mark.parametrize("kind,quant,impl", [
    ("tp", False, "plain"), ("tp", True, "plain"), ("tp", False, "kernel"),
    ("cp", False, "plain"), ("cp", False, "kernel"),
    ("cptp", False, "plain"), ("cptp", False, "kernel"),
    ("ep", False, "plain"), ("ep", False, "kernel")], ids=lambda v: str(v))
def test_no_mesh_capture_reads_the_device_on_the_host(monkeypatch, files,
                                                      kind, quant, impl):
    """Every kind of a mesh's ForwardGraphs (a prefill chunk, a verify
    window, the T = 1 step, a layer prefix's step where the mesh takes one,
    the loop step) is captured under NoHostReads, on the plain path and on
    the kernel path (the wrappers' host code, the partials wrapper with a
    device pos included; their plain twins on CPU tensors), then replayed
    to the host-int forward's values on a twin cache, bit for bit; one
    capture a key."""
    monkeypatch.setattr(graphs, "GRAPH", GuardedGraph)
    monkeypatch.setattr(linear, "kernels_enabled",
                        lambda t: impl == "kernel")
    a, w, make_kv, mesh = _port(kind, files["moe" if kind == "ep"
                                            else "tiny"], quant)
    toks = np.random.default_rng(23).integers(3, a.vocab_size, 256)
    kv = make_kv()
    pl.forward(a, w, kv, _window(toks, 0, 16, HEAD), 0, n_valid=HEAD, **mesh)
    g = graphs.ForwardGraphs(a, w, kv, **mesh)
    direct = _clone(kv)
    pos = HEAD
    # the MoE preset's head dim (32) is not the flash kernel's: its chunks
    # stay below the kernel's 64 rows
    t = 32 if kind == "ep" else 64
    for t, nv in ((t, t - 4), (t, t)):
        win = _window(toks, pos, t, nv)
        got = g.prefill(kv, win, pos, nv)
        want, _, _ = pl.forward(a, w, direct, win, pos, n_valid=nv, **mesh)
        assert torch.equal(got, want) and _same(kv, direct)
        pos += nv
    got = g.verify(kv, toks[pos:pos + 4], pos)
    want, _, _ = pl.forward(a, w, direct, toks[pos:pos + 4], pos,
                            all_logits=True, **mesh)
    assert torch.equal(got, want) and _same(kv, direct)
    pos += 4
    got = g.step(kv, 7, pos)
    want, _, _ = pl.forward(a, w, direct, [7], pos, **mesh)
    assert torch.equal(got, want) and _same(kv, direct)
    pos += 1
    if kind == "tp":
        got = g.step(kv, 8, pos, layers=range(2))
        want, _, _ = pl.forward(a, w, direct, [8], pos, layer_sel=range(2),
                                **mesh)
        assert torch.equal(got, want) and _same(kv, direct)
    toks_g, last = g.loop(kv, 9, pos, 5)
    tok, want_toks = torch.tensor([9]), []
    for i in range(5):
        lg, _, _ = pl.forward(a, w, direct, tok, pos + i, **mesh)
        tok = torch.argmax(lg[0]).reshape(1)
        want_toks.append(int(tok))
    assert toks_g.tolist() == want_toks and torch.equal(last, lg)
    assert _same(kv, direct)
    assert g.captures == (5 if kind == "tp" else 4)
    assert sum(n for k, n in g.replays.items() if k.kind == "loop") == 5


# ------------------------------------------------------------- the engines
def _texts(eng, prompts, cfg):
    return [eng.generate(p, cfg)[0] for p in prompts]


@pytest.mark.parametrize("kind", ["tp", "tp_int8", "cp", "cptp", "ep"])
def test_mesh_engines_replay_to_their_uncaptured_and_jax_texts(
        recorded, monkeypatch, files, kind):
    """TPEngine (bf16 and int8), CPEngine (with and without tp) and
    EPEngine on their graph paths: generate over prompts whose chunks run
    at 64 tokens, speculation through the verify window (TP), the
    texts equal to the same engine's uncaptured run and to a live JAX
    engine's over the same mesh; the engine's cache kept for its life,
    every program replayed from one capture a key. (Self-speculation
    drafts through a layer prefix, which only TPEngine takes.)"""
    monkeypatch.setattr(pe.Engine, "PREFILL_CHUNK", 64)
    path = files["moe" if kind == "ep" else "tiny"]
    quant = kind == "tp_int8"
    cfg, jcfg = _greedy(6)
    prompts = ["mesh replay", " ".join(["alpha beta gamma"] * 30)]

    def port():
        m = load_model(path, device="cpu")
        if kind.startswith("tp"):
            return TPEngine(m, ptp.make_tp_mesh(2, _cpu(2)), kv_quant=quant)
        if kind == "cp":
            return CPEngine(m, pcp.make_cp_mesh(4, _cpu(4)))
        if kind == "cptp":
            return CPEngine(m, pcp.make_cp_tp_mesh(2, 2, _cpu(4)))
        return EPEngine(m, pep.make_ep_mesh(2, _cpu(2)))
    eng = port()
    assert eng._graph_path()
    got = _texts(eng, prompts, cfg)
    spec = None
    if kind == "tp":
        spec = eng.generate_self_speculative(prompts[0], cfg,
                                             draft_layers=2)[0]
    kv, g = eng._held["main"]
    assert {k.kind for k in g.replays} >= {"prefill", "step"}
    assert len(recorded) == sum(x.captures for _, x in eng._held.values())
    assert all(n >= 1 for n in g.replays.values())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pe, "_graphed", lambda device: False)
        plain = port()
        assert _texts(plain, prompts, cfg) == got and plain._held == {}
        if spec is not None:
            assert plain.generate_self_speculative(
                prompts[0], cfg, draft_layers=2)[0] == spec
    jm = jax_load_model(path)
    if kind.startswith("tp"):
        jeng = JTPEngine(jm, Mesh(np.asarray(jax.devices()[:2]),
                                  (jtp.TP_AXIS,)), kv_quant=quant)
    elif kind == "cp":
        jeng = JCPEngine(jm, jcp.make_cp_mesh(4))
    elif kind == "cptp":
        jeng = JCPEngine(jm, jcp.make_cp_tp_mesh(cp=2, tp=2))
    else:
        jeng = JEPEngine(jm, Mesh(np.asarray(jax.devices("cpu")[:2]),
                                  (jep.EP_AXIS,)))
    jeng.PREFILL_CHUNK = 64
    want = [jeng.generate(p, jcfg)[0] for p in prompts]
    if quant:
        assert got[0] == want[0]   # int8 ties move later tokens (test_tp)
    else:
        assert got == want


def test_engine_refusals_keep_their_behaviour(recorded, files):
    """On the graph path the mesh engines refuse what they refused: a CP
    layer-skip schedule, an EP draft prefix, a TP draft model; fused
    self-speculation delegates to the host protocol (no spec graph)."""
    m = load_model(files["tiny"], device="cpu")
    cp = CPEngine(m, pcp.make_cp_mesh(2, _cpu(2)))
    with pytest.raises(NotImplementedError, match="layer-skip"):
        cp.generate("x", pe.GenerateConfig(max_tokens=2,
                                           skip_threshold=0.5))
    tp = TPEngine(load_model(files["tiny"], device="cpu"),
                  ptp.make_tp_mesh(2, _cpu(2)))
    with pytest.raises(ValueError, match="no separate draft"):
        tp._decode_step(tp._start_kv(), 1, 0, model=tp.model)
    tp.generate_self_speculative_fused("fused", _greedy(4)[0])
    assert "spec" not in {k.kind for k in tp._held["main"][1]._graphs}
    ep = EPEngine(load_model(files["moe"], device="cpu"),
                  pep.make_ep_mesh(2, _cpu(2)))
    with pytest.raises(ValueError, match="EPEngine"):
        ep._decode_step(ep._start_kv(), 1, 0, layer_sel=[0])
    g = tp._held["main"][1]
    with pytest.raises(ValueError, match="one-device forward"):
        g.key("spec", k=3, n_draft=2)


# ---------------------------------------------------- make_tp_decode_loop
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tp_decode_loop_matches_jax(recorded, files, quant):
    """make_tp_decode_loop's tokens from a 12-token prefill: a replayed
    loop step (the graph double), the same loop uncaptured, and the JAX
    make_tp_decode_loop's, all equal; two runs chain on one cache; then
    TPEngine.benchmark runs it with the JAX clamp of n_tokens."""
    n = 6
    m = load_model(files["tiny"], device="cpu")
    a = m.arch
    mesh = ptp.make_tp_mesh(2, _cpu(2))
    shards = ptp.shard_weights(m.weights, mesh, a)
    ids = list(range(3, 3 + HEAD))

    def run(graphed: bool):
        kv = ptp.make_tp_kv(a, mesh, quant)
        lg, _, _ = pl.forward(a, shards, kv, ids, 0, tp=mesh)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ptp, "_graphed", lambda device: graphed)
            loop = ptp.make_tp_decode_loop(mesh, a, n, kv_quant=quant)
            t1, kv = loop(shards, kv, torch.argmax(lg[0]), HEAD)
            t2, kv = loop(shards, kv, t1[-1], HEAD + n)
        return t1.tolist() + t2.tolist(), kv
    got, kv = run(True)
    plain, kv_plain = run(False)
    assert got == plain and _same(kv, kv_plain)
    jm = jax_load_model(files["tiny"], device=False)
    jmesh = Mesh(np.asarray(jax.devices()[:2]), (jtp.TP_AXIS,))
    jw = jtp.shard_weights(jm.weights, jmesh, jm.arch)
    jkv = jax.tree.map(lambda x, sp: jax.device_put(x, NamedSharding(
        jmesh, sp)), jl.KVCache.create(jm.arch, quant=quant),
        jtp.kv_spec(quant))
    fwd = jtp.make_tp_forward(jmesh, jm.arch, weights_template=jm.weights,
                              kv_quant=quant)
    lg, jkv, _ = fwd(jw, jkv, jnp.asarray(ids, jnp.int32), jnp.int32(0))
    jloop = jtp.make_tp_decode_loop(jmesh, jm.arch, n,
                                    weights_template=jm.weights,
                                    kv_quant=quant)
    j1, jkv = jloop(jw, jkv, jnp.argmax(lg[0]).astype(jnp.int32),
                    jnp.int32(HEAD))
    j2, jkv = jloop(jw, jkv, j1[-1], jnp.int32(HEAD + n))
    assert got == np.asarray(j1).tolist() + np.asarray(j2).tolist()
    with pytest.raises(ValueError, match="made for a"):
        ptp.make_tp_decode_loop(mesh, a, n, kv_quant=not quant)(
            shards, kv, 1, 0)
    eng = TPEngine(load_model(files["tiny"], device="cpu"), mesh,
                   kv_quant=quant)
    st = eng.benchmark(prompt_ids=list(range(3, 500)), n_tokens=64)
    assert st.decode_tokens == (a.max_seq_len - 497 - 1) // 2
    g = eng._held["main"][1]
    loops = [k for k in g.replays if k.kind == "loop"]
    assert len(loops) == 1 and g.replays[loops[0]] == 2 * st.decode_tokens


# ------------------------------------------------------ the sharded server
def _serve(path, mesh, spec_k=0, batch=2, **kw):
    srv = BatchServer(load_model(path, device="cpu"), batch_size=batch,
                      mesh=mesh, sampler_cfg=SamplerConfig(temperature=0.0),
                      admit_chunk=16, spec_k=spec_k,
                      spec_draft_layers=2 if spec_k else None, **kw)
    reqs = [Request(prompt=p, max_tokens=6) for p in PROMPTS]
    stats = srv.run(reqs)
    return [r.text for r in reqs], stats, srv


@pytest.mark.parametrize("dp,tp,spec_k", [(2, 1, 0), (2, 2, 0), (2, 2, 2),
                                          (2, 1, 2)],
                         ids=["dp2", "dp2tp2", "dp2tp2-spec", "dp2-spec"])
def test_sharded_server_replays_its_group_steps(recorded, monkeypatch,
                                                files, dp, tp, spec_k):
    """BatchServer over a one-process (dp, tp) mesh of CPU positions on its
    graph path: one StepGraphs a dp group (the unsharded step at tp = 1,
    the row's TP step past it) whose decode (with spec_k draft and verify)
    keys warmup captured, every admission chunk a replay of the prefill
    row's ForwardGraphs; the texts equal the same server's uncaptured run
    and the JAX sharded server's."""
    path = files["tiny"]
    mesh = make_mesh(tp=tp, dp=dp, devices=["cpu"] * (dp * tp))
    got, st, srv = _serve(path, mesh, spec_k)
    assert srv._ggraphs is not None and len(srv._ggraphs) == dp
    kinds = {"decode"} | ({"draft", "verify"} if spec_k else set())
    for g in srv._ggraphs:
        assert (g.row is None) == (tp == 1)
        assert {k.kind for k in g.replays} == kinds
        assert g.captures == len(kinds)
        # one replay of each in warmup, then one a loop step: each round
        # of speculation is a verify step after its drafts
        by_kind = {k.kind: n for k, n in g.replays.items()}
        assert by_kind == ({"decode": 1, "draft": st.draft_steps + 1,
                            "verify": st.steps + 1} if spec_k
                           else {"decode": st.steps + 1})
    kv, adm = srv._adm
    assert {k.kind for k in adm.replays} == {"prefill"}
    assert sum(adm.replays.values()) == adm.captures + st.prefill_chunks
    assert len(recorded) == adm.captures + sum(g.captures
                                               for g in srv._ggraphs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pserve, "_graphed", lambda device: False)
        plain, pst, psrv = _serve(path, mesh, spec_k)
        assert psrv._ggraphs is None and psrv._adm is None
    assert plain == got and pst.steps == st.steps
    if spec_k:
        return
    jsrv = JBatchServer(jax_load_model(path, device=False), batch_size=2,
                        mesh=jmake_mesh(tp=tp, dp=dp),
                        sampler_cfg=JSamplerConfig(temperature=0.0),
                        admit_chunk=16)
    reqs = [JRequest(prompt=p, max_tokens=6) for p in PROMPTS]
    jsrv.run(reqs)
    assert got == [r.text for r in reqs]


def test_sharded_server_prefix_cache_on_the_graph_path(recorded, files):
    """The prefix cache on a replayed (2, 2) server: a hit's per-shard
    bytes are copied into the admission cache the graphs are bound to, and
    the cached entries are clones of it; the texts equal the one-device
    server's."""
    prompts = [PROMPTS[2] * 3 + p for p in PROMPTS[:3]]
    mesh = make_mesh(tp=2, dp=2, devices=["cpu"] * 4)
    srv = BatchServer(load_model(files["tiny"], device="cpu"), batch_size=2,
                      mesh=mesh, prefix_cache=4,
                      sampler_cfg=SamplerConfig(temperature=0.0))
    reqs = [Request(prompt=p, max_tokens=6) for p in prompts]
    st = srv.run(reqs)
    one = BatchServer(load_model(files["tiny"], device="cpu"), batch_size=2,
                      sampler_cfg=SamplerConfig(temperature=0.0))
    want = [Request(prompt=p, max_tokens=6) for p in prompts]
    one.run(want)
    assert [r.text for r in reqs] == [r.text for r in want]
    assert st.prefix_hits >= 1
    assert all(c is not srv._adm[0] for _, c in srv._pcache)


def test_tp_row_step_graphs_read_nothing_on_the_host(monkeypatch, files):
    """StepGraphs' TP row form: decode, draft and verify captured under
    NoHostReads (kernel path), each replay bit-equal to the uncaptured
    batched_*_step_tp on a twin cache; s_live refused."""
    monkeypatch.setattr(graphs, "GRAPH", GuardedGraph)
    monkeypatch.setattr(linear, "kernels_enabled", lambda t: True)
    m = load_model(files["tiny"], device="cpu")
    a = m.arch
    row = Row(_cpu(2))
    shards = ptp.shard_weights(m.weights, row, a)
    kvs = [pb.BatchedKV.create(a.local_arch(2), 4, device="cpu")
           for _ in row]
    ref = [pb.BatchedKV(*(None if t is None else t.clone()
                          for t in (c.k, c.v, c.ks, c.vs))) for c in kvs]
    sg = graphs.StepGraphs(a, shards, kvs, row)
    pos = torch.tensor([0, 3, 5, 9])
    act = torch.tensor([True, True, False, True])
    for kind, tok, extra in (("decode", torch.tensor([4, 5, 6, 7]), {}),
                             ("draft", torch.tensor([8, 9, 1, 2]),
                              {"n_layers": 2}),
                             ("verify", torch.arange(12).reshape(4, 3) + 3,
                              {})):
        got = sg.run(kvs, kind, tok, pos, act, **extra)
        if kind == "verify":
            want, _ = pb.batched_verify_step_tp(a, shards, ref, tok, pos,
                                                act, row)
        else:
            want, _ = pb.batched_decode_step_tp(a, shards, ref, tok, pos,
                                                act, row, **extra)
        assert torch.equal(got, want)
        assert all(torch.equal(x.k, y.k) and torch.equal(x.v, y.v)
                   for x, y in zip(kvs, ref))
        pos = pos + act
    assert sg.captures == 3
    with pytest.raises(ValueError, match="no s_live"):
        sg.run(kvs, "decode", tok[:, 0], pos, act, s_live=256)


# ------------------------------------------------------------------ the PP
@pytest.mark.parametrize("stages,n_micro,quant", [(2, 2, False),
                                                  (4, 2, True)])
def test_pp_decode_replays_pp_decode_step(recorded, files, stages, n_micro,
                                          quant):
    """make_pp_decode on its graph path: one capture at the first call,
    then every step a replay, each step's logits and every cache byte
    bit-equal to pp_decode_step on a twin state; the capture runs under
    NoHostReads."""
    graphs.GRAPH = GuardedGraph   # the fixture restores it
    m = load_model(files["tiny"], device="cpu")
    a = m.arch
    mesh = ppp.make_pp_mesh(stages, _cpu(stages))
    state = ppp.shard_pp_state(mesh, a, m.weights, 4, n_micro, quant)
    twin = ppp.shard_pp_state(mesh, a, m.weights, 4, n_micro, quant)
    step = ppp.make_pp_decode(mesh, a, state, n_micro)
    rng = np.random.default_rng(24)
    pos = np.array([0, 4, 9, 2])
    act = np.array([True, True, False, True])
    for i in range(5):
        tok = rng.integers(3, a.vocab_size, 4)
        got = step(tok, pos, act)
        want, _ = ppp.pp_decode_step(mesh, a, twin, tok, pos, act, n_micro)
        assert torch.equal(got, want), i
        for r1, r2 in zip(state.kv, twin.kv):
            for c1, c2 in zip(r1, r2):
                assert all((x is None and y is None) or torch.equal(x, y)
                           for x, y in zip((c1.k, c1.v, c1.ks, c1.vs),
                                           (c2.k, c2.v, c2.ks, c2.vs)))
        pos = pos + act
    assert step.replays == 5 and len(recorded) == 1


def test_pp_decode_off_the_card_runs_the_step(files):
    """Without a CUDA card make_pp_decode returns the uncaptured step."""
    m = load_model(files["tiny"], device="cpu")
    mesh = ppp.make_pp_mesh(2, _cpu(2))
    state = ppp.shard_pp_state(mesh, m.arch, m.weights, 2, 2)
    step = ppp.make_pp_decode(mesh, m.arch, state, 2)
    assert not hasattr(step, "replays")
    assert step([5, 6], [0, 0], [True, True]).shape == (2, m.arch.vocab_size)


# ----------------------------------------------------------------- refusals
def test_refusals(files):
    """A row that spans processes keeps the host path: ForwardGraphs and
    StepGraphs refuse it, and so does dp.group_graphs for a multi-process
    mesh; a mesh that spans cards is refused alike. A graph refuses a cache
    it was not captured against (a foreign shard list) and rows past the
    CP cache's end, and captures nothing for them."""
    m = load_model(files["tiny"], device="cpu")
    a = m.arch
    row = Row(_cpu(2), ranks=(0, 1), rank=0, group=object())
    shards = ptp.shard_weights(m.weights, Row(_cpu(2)), a)
    with pytest.raises(ValueError, match="spans processes"):
        graphs.ForwardGraphs(a, shards, ptp.make_tp_kv(a, _cpu(2)), tp=row)
    with pytest.raises(ValueError, match="spans processes"):
        graphs.StepGraphs(a, shards, [None, None], row)
    with pytest.raises(ValueError, match="spans cards"):
        graphs.ForwardGraphs(a, shards, ptp.make_tp_kv(a, _cpu(2)),
                             tp=("cpu", "meta"))
    assert not graphs.one_card(("cuda:0", "cuda:1"))
    assert graphs.one_card(("cuda:0", "cuda:0"), None)
    mp = make_mesh(tp=1, dp=2, devices=["cpu"] * 2)
    mp = pdp.Mesh(mp.devices, ((0,), (1,)), 0, (None, None))
    assert mp.multiprocess and not pdp.captured(mp)
    with pytest.raises(ValueError, match="host path"):
        pdp.group_graphs(mp, a, [[None]] * 2, [[None]] * 2)
    mesh = pcp.make_cp_mesh(4, _cpu(4))
    kv = pcp.make_cp_kv(a, mesh)
    g = graphs.ForwardGraphs(a, m.weights, kv, cp=mesh)
    assert g.rows == a.max_seq_len
    with pytest.raises(ValueError, match="not the one"):
        g.step(pcp.make_cp_kv(a, mesh), 1, 0)
    with pytest.raises(ValueError, match="exceed"):
        g.prefill(kv, np.zeros(64, np.int64), a.max_seq_len - 32, 3)
    assert g.captures == 0 and not any(c.k.any() for c in kv)
