"""Port parity for tensor parallelism (parallel/tp.py, forward(tp=),
TPEngine) on the CPU, against the live JAX package on the conftest's
8-device CPU mesh, on the same GGUFs.

Tolerances, and why:
  * shard planes: byte-equal to the JAX package's per-shard arrays
    (`jax.device_put` with the plan's NamedSharding, `addressable_shards`):
    the same bytes moved, nothing computed;
  * TP logits and the gathered cache against the port's unsharded forward:
    rtol 2e-2, atol 2e-2, the JAX suite's own limit (tests/test_tp.py:46-51):
    the shards' f32 partials are summed in another order than one product's
    K loop, and where that moves an activation across a bf16 rounding edge
    the next product sees a whole bf16 step;
  * against the JAX TP forward: LOGIT_RTOL (5e-3 of the largest logit), the
    resident suite's cross-package limit (tests/test_torch_model.py): both
    TP forwards add their partials in f32 over the same planes;
  * greedy tokens: identical (text equality), as the JAX suite holds
    TPEngine to the resident Engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ntransformer_tpu.core.dtypes import DType as JDType
from ntransformer_tpu.inference.engine import GenerateConfig as JGenConfig
from ntransformer_tpu.inference.engine import TPEngine as JTPEngine
from ntransformer_tpu.models import llama as jllama
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.models.synth import synth_qlinear as jax_synth_qlinear
from ntransformer_tpu.parallel import tp as jtp
from ntransformer_tpu_torch.core.dtypes import DType
from ntransformer_tpu_torch.inference.engine import (Engine, GenerateConfig,
                                                     TPEngine)
from ntransformer_tpu_torch.models import llama as pllama
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.models.synth import synth_model, synth_qlinear
from ntransformer_tpu_torch.parallel import tp as ptp
from test_torch_model import LOGIT_RTOL, one_torch_thread  # noqa: F401
from tools import make_test_gguf
from tools.make_test_gguf import write_model

# a Q4_K_M shape whose K-quant row splits survive tp = 4 (K/4 >= 256)
TP4K = dict(vocab=256, hidden=1024, inter=1024, layers=2, heads=8,
            kv_heads=4, ctx=256, rope_theta=10000.0)
CFG = dict(max_tokens=6, temperature=0.0, repeat_penalty=1.0)


def _cpu_mesh(tp):
    return ptp.make_tp_mesh(tp, ["cpu"] * tp)


def _jax_mesh(tp):
    return Mesh(np.asarray(jax.devices()[:tp]), (jtp.TP_AXIS,))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    policy = make_test_gguf.q4_k_m_policy
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(make_test_gguf.PRESETS, "tp4k", TP4K)
        # a Q6_K attn_v, as llama.cpp's Q4_K_M gives some layers: the
        # triple then fuses q|k alone
        mp.setattr(make_test_gguf, "q4_k_m_policy",
                   lambda name: (JDType.Q6_K if "attn_v" in name
                                 else policy(name)))
        q4km = write_model(str(d / "tp4k_q4km.gguf"), "tp4k", "q4_k_m",
                           seed=31)
    return {
        "q8_0": write_model(str(d / "t512_q8.gguf"), "tiny512", "q8_0",
                            seed=30),
        "q4_k_m": q4km,
        "tied": write_model(str(d / "g2_q8.gguf"), "tiny512", "q8_0",
                            seed=32, arch="gemma2"),
        "tiny": write_model(str(d / "tiny_q8.gguf"), "tiny", "q8_0", seed=5),
    }


# --- shard planes -------------------------------------------------------------
def _bytes(a) -> tuple:
    a = a.view(torch.int16) if isinstance(a, torch.Tensor) and \
        a.dtype == torch.bfloat16 else a
    a = np.ascontiguousarray(a.numpy() if isinstance(a, torch.Tensor)
                             else np.asarray(a))
    return a.shape, a.tobytes()


def _jax_shard(arr, s: int, mesh) -> np.ndarray:
    dev = mesh.devices.flat[s]
    return next(np.asarray(sh.data) for sh in arr.addressable_shards
                if sh.device == dev)


def _assert_shard_equal(pw, jw, s: int, mesh, what: str):
    def same(p, j, name):
        j = _jax_shard(j, s, mesh)
        if name.startswith("lm_head"):
            # the JAX loader pads a K-quant head to 2048 lanes (zeros), the
            # port keeps the file's columns (models/loader.py)
            j = j[..., :p.shape[-1]]
        assert _bytes(p) == _bytes(j), f"{what} shard {s}: {name}"

    def ql(p, j, name):
        assert (p is None) == (j is None), f"{what}: {name}"
        if p is None:
            return
        assert p.dtype.value == j.dtype.value and set(p.planes) == \
            set(j.planes), f"{what}: {name}"
        for nm in j.planes:
            same(p.planes[nm], j.planes[nm], f"{name}.{nm}")

    ql(pw.embed, jw.embed, "embed")
    ql(pw.lm_head, jw.lm_head, "lm_head")
    same(pw.output_norm, jw.output_norm, "output_norm")
    for f in dataclasses.fields(pw.layers):
        p, j = getattr(pw.layers, f.name), getattr(jw.layers, f.name)
        if isinstance(j, jllama.QLinear) or isinstance(p, pllama.QLinear):
            ql(p, j, f.name)
        else:
            assert (p is None) == (j is None), f"{what}: {f.name}"
            if j is not None:
                same(p, j, f.name)


@pytest.mark.parametrize("form", ["unfused", "fuse", "fused_in"])
@pytest.mark.parametrize("which,tp", [("q8_0", 2), ("q8_0", 4),
                                      ("q4_k_m", 2), ("q4_k_m", 4),
                                      ("tied", 2), ("tied", 4)])
def test_shard_planes_byte_equal_to_jax(files, which, tp, form):
    """Each shard's planes are the JAX package's shard of the same leaf:
    unfused, fused per shard from unfused weights (TPEngine(fuse=True)),
    and from weights fused in tp = 1 order (load_model(fuse=True)). Q4_K_M
    fuses q|k alone (attn_v is Q6_K), and a tied head stays the
    embedding's object on every shard."""
    path = files[which]
    pm = load_model(path, device="cpu", fuse=form == "fused_in")
    jm = jax_load_model(path, device=False)
    jw = jm.weights
    if form != "unfused":
        jw = dataclasses.replace(
            jw, layers=jllama.fuse_layer_weights(jw.layers, tp))
    mesh = _jax_mesh(tp)
    jsh = jtp.shard_weights(jw, mesh, jm.arch)
    shards = ptp.shard_weights(pm.weights, _cpu_mesh(tp), pm.arch,
                               fuse=form == "fuse")
    assert len(shards) == tp
    if which == "q4_k_m" and form != "unfused":
        assert shards[0].layers.wqk is not None \
            and shards[0].layers.wv is not None
    for s, sw in enumerate(shards):
        _assert_shard_equal(sw, jsh, s, mesh, f"{which} tp={tp} {form}")
        if which == "tied":
            assert sw.lm_head is sw.embed
        assert sw.layers.wo.k == pm.weights.layers.wo.k // tp


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_fuse_layer_weights_tp_matches_jax(files, tp):
    pm = load_model(files["q8_0"], device="cpu")
    jm = jax_load_model(files["q8_0"])
    got = pllama.fuse_layer_weights(pm.weights.layers, tp)
    want = jllama.fuse_layer_weights(jm.weights.layers, tp)
    for name in ("wqkv", "w_gate_up"):
        p, j = getattr(got, name), getattr(want, name)
        assert (p.k, p.n) == (j.k, j.n)
        for nm in j.planes:
            assert _bytes(p.planes[nm]) == _bytes(j.planes[nm]), name
    assert got.wq is None and got.w_gate is None


def test_interleaved_concat_is_shard_permutation():
    """_concat_qlinear(tp=2)'s lane order equals [q_0|k_0|v_0|q_1|k_1|v_1]
    built by hand from the plain concat's column blocks (the JAX suite's
    test, tests/test_tp.py:195), and the JAX function's bytes."""
    rng = np.random.default_rng(3)
    parts, jparts = [], []
    for n in (512, 256, 256):
        codes = rng.integers(-100, 100, (512, n)).astype(np.int8)
        ql = synth_qlinear(n, 512, DType.Q8_0, device="cpu")
        ql.planes["qs"] = torch.from_numpy(codes)
        parts.append(ql)
        jq = jax_synth_qlinear(n, 512, JDType.Q8_0)
        jq.planes["qs"] = jnp.asarray(codes)
        jparts.append(jq)
    plain = pllama._concat_qlinear(parts)
    inter = pllama._concat_qlinear(parts, tp=2)
    widths = [512, 256, 256]
    offs = np.cumsum([0] + widths)
    cols = []
    for s in range(2):
        for p, w in enumerate(widths):
            cols.extend(range(offs[p] + s * w // 2,
                              offs[p] + (s + 1) * w // 2))
    np.testing.assert_array_equal(inter.planes["qs"].numpy(),
                                  plain.planes["qs"].numpy()[:, cols])
    want = jllama._concat_qlinear(jparts, tp=2)
    assert _bytes(inter.planes["qs"]) == _bytes(want.planes["qs"])
    assert pllama._concat_qlinear(parts, tp=3) is None  # 256 % 3


# --- the TP forward -------------------------------------------------------------
def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def _gathered(kv: list) -> np.ndarray:
    return torch.cat([c.k for c in kv], dim=1).float().numpy()


def _jax_tp(path, tp, tokens, steps=()):
    """The JAX TP forward's prefill and decode logits and its cache."""
    m = jax_load_model(path, device=False)
    mesh = _jax_mesh(tp)
    w, kv = jtp.shard_model(m.weights, jllama.KVCache.create(m.arch), mesh,
                            m.arch)
    fwd = jtp.make_tp_forward(mesh, m.arch, weights_template=m.weights)
    lg, kv, _ = fwd(w, kv, jnp.asarray(tokens, jnp.int32), jnp.int32(0))
    out = [np.asarray(lg)]
    for i, t in enumerate(steps):
        lg, kv, _ = fwd(w, kv, jnp.asarray([t], jnp.int32),
                        jnp.int32(len(tokens) + i))
        out.append(np.asarray(lg))
    return out, np.asarray(kv.k).astype(np.float32)


def _port_tp(path, tp, tokens, steps=(), fuse=False, quant=False):
    m = load_model(path, device="cpu")
    mesh = _cpu_mesh(tp)
    shards = ptp.shard_weights(m.weights, mesh, m.arch, fuse=fuse)
    kv = ptp.make_tp_kv(m.arch, mesh, quant)
    lg, kv, _ = pllama.forward(m.arch, shards, kv, tokens, 0, tp=mesh)
    out = [lg]
    for i, t in enumerate(steps):
        lg, kv, _ = pllama.forward(m.arch, shards, kv, [t], len(tokens) + i,
                                   tp=mesh)
        out.append(lg)
    return out, kv


def _port_resident(path, tokens, steps=(), quant=False):
    m = load_model(path, device="cpu")
    kv = pllama.KVCache.create(m.arch, quant=quant, device="cpu")
    lg, kv, _ = pllama.forward(m.arch, m.weights, kv, tokens, 0)
    out = [lg]
    for i, t in enumerate(steps):
        lg, kv, _ = pllama.forward(m.arch, m.weights, kv, [t],
                                   len(tokens) + i)
        out.append(lg)
    return out, kv


TOKENS = [1, 9, 4]
STEPS = [7, 3, 11]


@pytest.mark.parametrize("which", ["tiny", "q4_k_m"])
def test_tp_forward_matches_jax_and_resident(files, which):
    """Prefill and three decode steps at tp = 2: logits and the gathered
    cache against the port's unsharded forward (the JAX suite's rtol 2e-2)
    and the logits against the JAX TP forward (LOGIT_RTOL)."""
    path = files[which]
    got, kv = _port_tp(path, 2, TOKENS, STEPS)
    res, rkv = _port_resident(path, TOKENS, STEPS)
    want, jk = _jax_tp(path, 2, TOKENS, STEPS)
    for g, r, w in zip(got, res, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-2,
                                   atol=2e-2)
        assert _rel(g, w) <= LOGIT_RTOL
    np.testing.assert_allclose(_gathered(kv), rkv.k.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_gathered(kv), jk, rtol=2e-2, atol=2e-2)


def test_tp_forward_fused_and_tp4(files):
    """The fused per-shard planes give the unfused TP forward's logits bit
    for bit (the same products, concatenated lanes), and tp = 4 holds to
    the resident forward as tp = 2 does."""
    path = files["q8_0"]
    a, _ = _port_tp(path, 2, TOKENS, STEPS[:1])
    b, _ = _port_tp(path, 2, TOKENS, STEPS[:1], fuse=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c, kv = _port_tp(path, 4, TOKENS, STEPS[:1])
    res, rkv = _port_resident(path, TOKENS, STEPS[:1])
    for g, r in zip(c, res):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-2,
                                   atol=2e-2)
    assert kv[0].k.shape[1] == 1  # 4 KV heads over 4 shards


FAMILIES = ["qwen2", "qwen3", "gemma2", "gemma3"]


@pytest.fixture(scope="module")
def family_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fam")
    return {a: write_model(str(d / f"{a}.gguf"), "deep", "q8_0", seed=33,
                           arch=a) for a in FAMILIES}


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp_forward_families(family_files, arch):
    """qwen2 (lane-sharded biases), qwen3 (replicated q/k norms), gemma2
    (post norms after the sums, softcaps, the sliding window) and gemma3
    (dual rope tables) at tp = 2, 24 tokens (past the 16-token window):
    against the port's unsharded forward and the JAX TP forward at the
    JAX families' TP limit (rtol 2e-2, atol 2e-2, tests/test_qwen2.py:
    215). Not at LOGIT_RTOL: the gemma softcaps and post norms amplify a
    partial sum's bf16 flip, so the port's own TP forward is 5.6e-3 of the
    largest logit from its resident one on gemma2 (4.5e-3 on gemma3), and
    5.7e-3 from the JAX TP forward."""
    path = family_files[arch]
    toks = list(np.arange(24) % 64)
    got, _ = _port_tp(path, 2, toks, STEPS[:1])
    res, _ = _port_resident(path, toks, STEPS[:1])
    want, _ = _jax_tp(path, 2, toks, STEPS[:1])
    for g, r, w in zip(got, res, want):
        for ref in (r.numpy(), w):
            np.testing.assert_allclose(g.numpy(), ref, rtol=2e-2, atol=2e-2)


def test_tp_int8_cache_shards_heads(files):
    """The int8 cache shards its codes and scales on the head axis; the
    TP forward over it holds to the resident int8 forward."""
    path = files["tiny"]
    got, kv = _port_tp(path, 2, TOKENS, STEPS, quant=True)
    assert kv[0].k.dtype == torch.int8 and kv[0].ks.shape[1] == 1
    res, rkv = _port_resident(path, TOKENS, STEPS, quant=True)
    for g, r in zip(got, res):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-2,
                                   atol=2e-2)
    codes = torch.cat([c.k for c in kv], dim=1).float()
    assert float((codes - rkv.k.float()).abs().max()) <= 1.0


# --- TPEngine ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines(files):
    path = files["tiny"]
    jm = jax_load_model(path)
    pm = load_model(path, device="cpu")
    return path, pm, jm


def test_tp_engine_greedy_matches_jax_and_resident(engines):
    path, pm, jm = engines
    want, _ = JTPEngine(jm, _jax_mesh(2)).generate("hello tp",
                                                   JGenConfig(**CFG))
    res, _ = Engine(pm).generate("hello tp", GenerateConfig(**CFG))
    eng = TPEngine(pm, _cpu_mesh(2))
    got, st = eng.generate("hello tp", GenerateConfig(**CFG))
    assert got == want == res and st.decode_tokens == 6
    assert eng.model.weights is None and eng.device == torch.device("cpu")
    # self-speculation through the TP verify (the fused form delegates)
    for fn in (eng.generate_self_speculative,
               eng.generate_self_speculative_fused):
        spec, st = fn("hello tp", GenerateConfig(**CFG))
        assert st.drafted > 0 and spec == got


def test_tp_engine_int8_chunked_and_benchmark(engines):
    path, pm, jm = engines
    want, _ = JTPEngine(jm, _jax_mesh(2), kv_quant=True).generate(
        "hello int8 tp", JGenConfig(**CFG))
    eng = TPEngine(pm, _cpu_mesh(2), kv_quant=True)
    assert eng._make_kv()[0].k.dtype == torch.int8
    got, _ = eng.generate("hello int8 tp", GenerateConfig(**CFG))
    assert got == want
    # a prompt longer than the chunk prefills in chunks at their offsets
    eng = TPEngine(pm, _cpu_mesh(2))
    eng.PREFILL_CHUNK = 8
    ids = [(i * 5 + 2) % 50 for i in range(20)]
    logits, _, _ = eng._prefill(eng._make_kv(), ids)
    ref, _, _ = pllama.forward(pm.arch, pm.weights,
                               pllama.KVCache.create(pm.arch, device="cpu"),
                               ids, 0)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=2e-2,
                               atol=2e-2)
    st = eng.benchmark(prompt_ids=ids, n_tokens=4)
    assert st.decode_tokens == 4 and st.prefill_tokens == 20


def test_tp_engine_fused_host_load_matches_jax(engines):
    """TPEngine.load on the CPU: loaded on the host, fused per shard; its
    greedy text equals the JAX TPEngine's over a host load (fuse=True)."""
    path, _, _ = engines
    jm = jax_load_model(path, device=False)
    want, _ = JTPEngine(jm, _jax_mesh(2), fuse=True).generate(
        "hello fused tp", JGenConfig(**CFG))
    eng = TPEngine.load(path, tp=2, device="cpu", fuse=True)
    assert eng.shards[0].layers.wqkv is not None
    assert eng.mesh == (torch.device("cpu"),) * 2
    got, _ = eng.generate("hello fused tp", GenerateConfig(**CFG))
    assert got == want


def test_tp_engine_layer_skip_and_no_draft(engines):
    path, pm, _ = engines
    eng, ref = TPEngine(pm, _cpu_mesh(2)), Engine(pm)
    cfg = GenerateConfig(**CFG, skip_threshold=0.5)
    got, st = eng.generate("hello", cfg)
    want, st_ref = ref.generate("hello", cfg)
    assert st.skipped_layers == st_ref.skipped_layers and got == want
    with pytest.raises(ValueError, match="no separate draft model"):
        eng._decode_step(eng._make_kv(), 1, 0, model=pm)
    with pytest.raises(ValueError, match="no draft model loaded"):
        eng.generate_speculative("hello")


# --- the plan and its refusals --------------------------------------------------
def test_make_tp_mesh_and_specs(files):
    assert ptp.make_tp_mesh(2, ["cpu"] * 3) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="a 4-way TP mesh needs 4"):
        ptp.make_tp_mesh(4, ["cpu"] * 2)
    pm = load_model(files["q4_k_m"], device="cpu", fuse=True)
    specs = ptp.weight_specs(pm.weights)
    assert specs["layers.wqk"] == specs["layers.wv"] == "column"
    assert specs["layers.w_gate_up"] == "column"
    assert specs["layers.wo"] == specs["layers.w_down"] == "row"
    assert specs["embed"] == specs["lm_head"] == "row"
    assert specs["layers.attn_norm"] == specs["rope_cos"] == "replicate"
    q2 = load_model(write_model(str(files["tiny"]) + ".q2.gguf", "tiny",
                                "q8_0", seed=2, arch="qwen2"), device="cpu")
    assert ptp.weight_specs(q2.weights)["layers.bq"] == "column"


def _jax_refusal(path, tp) -> str:
    m = jax_load_model(path, device=False)
    with pytest.raises(AssertionError) as e:
        jtp.check_shardable(m.arch, m.weights, tp, kernel_alignment=False)
    return str(e.value)


@pytest.mark.parametrize("which,tp", [("tiny", 4), ("q4_k_m", 8)],
                         ids=["kv_heads", "k_quant_block"])
def test_check_shardable_refusals_match_jax(files, which, tp):
    m = load_model(files[which], device="cpu")
    with pytest.raises(ValueError) as e:
        ptp.shard_weights(m.weights, _cpu_mesh(tp), m.arch)
    assert str(e.value) == _jax_refusal(files[which], tp)


def test_kernel_alignment_at_the_8b_shard_shapes():
    """The 8B's shard shapes at tp 2, 4 and 8 (Q8_0, Q4_K_M; the Q6_K down
    at K 14336/8 = 7 superblocks) pass with the kernels' limits on, as they
    are on a CUDA mesh; tp 16 leaves no KV head a shard. Built on the meta
    device: shapes only."""
    for dtype in ("q8_0", "q4_k_m"):
        _, arch, w = synth_model("8b", dtype, max_seq_len=64, device="meta")
        for tp in (2, 4, 8):
            ptp.check_shardable(arch, w, tp, kernel_alignment=True)
        with pytest.raises(ValueError, match="n_kv_heads 8 not divisible"):
            ptp.check_shardable(arch, w, 16, kernel_alignment=True)


def test_moe_and_engine_native_formats_refused(tmp_path):
    moe = write_model(str(tmp_path / "moe.gguf"), "moe", "q8_0", seed=4)
    m = load_model(moe, device="cpu")
    with pytest.raises(NotImplementedError, match="shard the experts"):
        ptp.shard_weights(m.weights, _cpu_mesh(2), m.arch)
    jm = jax_load_model(moe, device=False)
    with pytest.raises(NotImplementedError, match="shard the experts"):
        jtp.shard_weights(jm.weights, _jax_mesh(2), jm.arch)
    t = write_model(str(tmp_path / "t512.gguf"), "tiny512", "q8_0", seed=4)
    w = load_model(t, device="cpu", w8a8=True)
    with pytest.raises(ValueError, match="do not shard yet"):
        ptp.shard_weights(w.weights, _cpu_mesh(2), w.arch)
