"""Port parity for mixture-of-experts on the CPU: models/llama.moe_ffn (the
T = 1 select strategy and the T > 1 dense loop), the loader's stacked
expert planes, the select's plain twin, Engine, the batched step,
BatchServer and the CLI, against the JAX package on the same seeded inputs.
Mirrors tests/test_moe.py case for case, except expert parallelism, which
the port leaves to ROADMAP item 14.

Tolerances. Each layer, fed the JAX package's own input and cache and the
same weights (the JAX package's, converted with weights_from_numpy), is
held to the resident suite's layer limits (tests/test_torch_model.py
LAYER_RTOL: decode 1e-5, prefill 1e-3 of the largest output). moe_ffn
alone, on the same bf16 rows, must route every row to the same experts and
is held to MOE_FFN_RTOL (no residual dilutes a bf16 flip of one
activation), and one routed expert's product through the select to
PRODUCT_RTOL (1e-4). The engine-native formats quantize each product's
activations, so a bf16 flip upstream can move an int8 code a whole step:
their layers and moe_ffn are held to WFORMAT_RTOL, their single products
to PRODUCT_RTOL. Whole forwards use LOGIT_RTOL, decode against prefill
inside the port the JAX test's 2e-2. The select's plain twin gathers the
same planes the host-int view reads, so it is held bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu import cli as jcli
from ntransformer_tpu.inference.engine import Engine as JEngine
from ntransformer_tpu.inference.engine import GenerateConfig as JGenerateConfig
from ntransformer_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from ntransformer_tpu.inference.serve import BatchServer as JBatchServer
from ntransformer_tpu.inference.serve import Request as JRequest
from ntransformer_tpu.models import batched as jb
from ntransformer_tpu.models import llama as jl
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.models.presets import PRESETS
from ntransformer_tpu_torch import cli
from ntransformer_tpu_torch.core.dtypes import DType
from ntransformer_tpu_torch.core.layout import relayout
from ntransformer_tpu_torch.core.quant import quantize
from ntransformer_tpu_torch.core.w4a8 import requant_w4a8
from ntransformer_tpu_torch.core.w8a8 import requant_w8a8
from ntransformer_tpu_torch.inference.engine import Engine, GenerateConfig
from ntransformer_tpu_torch.inference.sampler import SamplerConfig
from ntransformer_tpu_torch.inference.serve import BatchServer, Request
from ntransformer_tpu_torch.models import batched as pb
from ntransformer_tpu_torch.models import llama as pl
from ntransformer_tpu_torch.models.config import ModelConfig
from ntransformer_tpu_torch.models.convert import weights_from_numpy
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.ops.linear import QLinear, qmatmul
from test_moe import _numpy_reference
from test_torch_model import (LAYER_RTOL, LOGIT_RTOL, _assert_same_qlinear,
                              jax_tree, one_torch_thread)  # noqa: F401
from tools.make_test_gguf import write_model

# moe_ffn alone has no residual to dilute a bf16 flip of one SwiGLU
# activation (the packages' f32 sums run in other orders): measured up to
# 1.1e-4 of the largest output (f32, prefill)
MOE_FFN_RTOL = 1e-3
# the engine-native formats quantize each product's activations: a bf16
# flip upstream can move an int8 code, and with it the product, a whole
# step (measured 3.1e-3 of a W4A8 layer's output, 2.4e-3 of moe_ffn's)
WFORMAT_RTOL = 1e-2
# one routed expert's product through the select, the same bf16 rows
PRODUCT_RTOL = 1e-4
GREEDY = dict(max_tokens=6, temperature=0.0, repeat_penalty=1.0)
# shapes the moe preset cannot take: Q4_K superblocks want K % 256, the
# engine-native formats K % 512 and N % 128
SHAPES = {"moe256": dict(PRESETS["moe"], hidden=256, inter=512),
          "moe512": dict(PRESETS["moe"], hidden=512, inter=1024, layers=2,
                         heads=8, kv_heads=4)}


def _write(path, preset, fmt, seed, arch="llama"):
    with pytest.MonkeyPatch.context() as mp:
        for name, shape in SHAPES.items():
            mp.setitem(PRESETS, name, shape)
        return write_model(str(path), preset, fmt, seed=seed, arch=arch)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    return {"f32": _write(d / "moe_f32.gguf", "moe", "f32", 121),
            "q8_0": _write(d / "moe_q8.gguf", "moe", "q8_0", 122),
            "qwen3moe": _write(d / "q3moe_q8.gguf", "moe", "q8_0", 123,
                               "qwen3moe"),
            "q4_k_m": _write(d / "moe256_q4km.gguf", "moe256", "q4_k_m",
                             124),
            "moe512": _write(d / "moe512_q8.gguf", "moe512", "q8_0", 125)}


@pytest.fixture(scope="module")
def port_f32(paths):
    return load_model(paths["f32"], device="cpu")


def _pair(path, **kw):
    """The JAX package's model and the port's ModelWeights of the same
    arrays."""
    ref = jax_load_model(path, **kw)
    arch = pl.Arch(**dataclasses.asdict(ref.arch))
    return ref, arch, weights_from_numpy(jax_tree(ref.weights), arch, "cpu")


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


# ------------------------------------------------------------ loading
@pytest.mark.parametrize("fmt", ["f32", "q8_0", "q4_k_m"])
def test_moe_config_and_load(paths, fmt):
    """The port's loader: pure-MoE layers with no dense FFN, a router, and
    stacked expert planes [L, E, rows, N] bit-equal to the JAX loader's."""
    port = load_model(paths[fmt], device="cpu")
    ref = jax_load_model(paths[fmt])
    cfg, lw = port.config, port.weights.layers
    assert cfg.n_experts == 4 and cfg.n_experts_used == 2
    assert cfg.moe_inter == ref.config.moe_inter
    assert lw.w_gate is None and lw.w_down is None
    first = next(iter(lw.w_gate_exps.planes.values()))
    assert tuple(first.shape[:2]) == (cfg.n_layers, cfg.n_experts)
    for name in ("ffn_gate_inp", "w_gate_exps", "w_up_exps", "w_down_exps",
                 "wq", "wo"):
        _assert_same_qlinear(getattr(lw, name), getattr(ref.weights.layers,
                                                        name), name)


def test_qwen3moe_config_parses():
    cfg = ModelConfig.from_gguf_metadata({
        "general.architecture": "qwen3moe",
        "qwen3moe.expert_count": 128,
        "qwen3moe.expert_used_count": 8,
        "qwen3moe.expert_feed_forward_length": 768,
    })
    assert cfg.qk_norm and cfg.n_experts == 128
    assert cfg.n_experts_used == 8 and cfg.moe_inter == 768


# ------------------------------------------------------------ moe_ffn
@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("fmt", ["f32", "q8_0", "q4_k_m", "w4a8", "w8a8"])
def test_moe_layer_matches_jax(paths, fmt, phase):
    """Each layer fed the JAX package's own input and cache (a 7-token
    prefill, or the decode step after it): layer_step's output within the
    layer limits. Then moe_ffn alone on the same random bf16 rows: the same
    experts routed per row, the outputs within MOE_FFN_RTOL. W4A8/W8A8 are
    the moe512 file requantized at load by each package (the expert planes
    held equal first, the router keeping its format)."""
    if fmt in ("w4a8", "w8a8"):
        ref, arch, w = _pair(paths["moe512"], **{fmt: True})
        own = load_model(paths["moe512"], device="cpu", **{fmt: True})
        lw = own.weights.layers
        assert lw.w_gate_exps.dtype.value == fmt
        assert lw.ffn_gate_inp.dtype == DType.BF16
        for name in ("w_gate_exps", "w_up_exps", "w_down_exps"):
            _assert_same_qlinear(getattr(lw, name),
                                 getattr(ref.weights.layers, name), name)
        lim = ffn_lim = WFORMAT_RTOL
    else:
        ref, arch, w = _pair(paths[fmt])
        lim, ffn_lim = LAYER_RTOL[phase], MOE_FFN_RTOL
    rng = np.random.default_rng(7)
    toks = rng.integers(3, arch.vocab_size, 8).astype(np.int32)
    jkv = jl.KVCache.create(ref.arch)
    if phase == "decode":
        _, jkv, _ = jl.forward(ref.arch, ref.weights, jkv,
                               jnp.asarray(toks[:7]), 0)
    pos, tk = (7, toks[7:]) if phase == "decode" else (0, toks[:7])
    jx, jcos, jsin = jl.embed_positions(ref.arch, ref.weights,
                                        jnp.asarray(tk), pos)
    _, cos_t, sin_t = pl.embed_positions(
        arch, w, torch.from_numpy(tk.astype(np.int64)), pos)
    kv = pl.KVCache.create(arch, device="cpu")
    for li in range(arch.n_layers):
        x = torch.from_numpy(np.array(jx, np.float32))
        for got, want in ((kv.k, jkv.k), (kv.v, jkv.v)):
            got[li].copy_(torch.from_numpy(np.asarray(want[li], np.float32)))
        y = pl.layer_step(arch, x, w.layers, kv.k[li], kv.v[li], pos, cos_t,
                          sin_t, layer=li)
        jx, _, _ = jl.layer_step(ref.arch, jx, ref.weights.layers, jkv.k[li],
                                 jkv.v[li], pos, jcos, jsin, layer=li)
        assert _rel(y, jx) <= lim, (li, _rel(y, jx))
    t = 1 if phase == "decode" else 7
    x = rng.standard_normal((t, arch.hidden_size)).astype(np.float32)
    hj = jnp.asarray(x).astype(jnp.bfloat16)
    hp = torch.from_numpy(x).to(torch.bfloat16)
    for li in range(arch.n_layers):
        want = jl.moe_ffn(ref.arch, hj, ref.weights.layers, li)
        got = pl.moe_ffn(arch, hp, w.layers, li)
        assert _rel(got, want) <= ffn_lim, (li, _rel(got, want))
        router = np.asarray(
            jl.qmatmul(hj, ref.weights.layers.ffn_gate_inp, layer=li))
        jtop = np.argsort(-router, axis=-1, kind="stable")[:, :2]
        _, ptop = pl.route(arch, hp, w.layers.ffn_gate_inp, li)
        np.testing.assert_array_equal(np.sort(ptop.numpy(), -1),
                                      np.sort(jtop, -1))
        # each routed expert's gate product: the port's select (an int32
        # tensor index) against the JAX package's stacked select
        flat = li * arch.n_experts + int(ptop[0, 0])
        pg = qmatmul(hp[:1], pl._flatten_experts(w.layers.w_gate_exps),
                     sel=torch.tensor([flat], dtype=torch.int32))
        jg = jl.qmatmul(hj[:1], jl._flatten_experts(
            ref.weights.layers.w_gate_exps), layer=jnp.int32(flat))
        assert _rel(pg, jg) <= PRODUCT_RTOL, (li, _rel(pg, jg))


def test_moe_decode_select_equals_dense_loop_row(port_f32):
    """At T = 1 the select strategy equals the dense loop's arithmetic on
    the same row in the port: the routed experts' weighted sum, the
    unrouted experts weighted by exact zeros."""
    m = port_f32
    lw = m.weights.layers
    h = torch.randn(1, m.arch.hidden_size, generator=torch.Generator()
                    .manual_seed(3)).to(torch.bfloat16)
    one = pl.moe_ffn(m.arch, h, lw, 1)
    two = pl.moe_ffn(m.arch, torch.cat([h, h]), lw, 1)
    assert torch.allclose(one[0], two[0], rtol=0, atol=1e-6)


def test_moe_forward_matches_jax_and_numpy_oracle(paths, port_f32):
    tokens = np.array([3, 17, 5, 42, 9, 11, 7, 30], np.int32)
    oracle = _numpy_reference(paths["f32"], tokens)
    ref = jax_load_model(paths["f32"])
    want, _, _ = jl.forward(ref.arch, ref.weights,
                            jl.KVCache.create(ref.arch), jnp.asarray(tokens),
                            0, all_logits=True)
    kv = pl.KVCache.create(port_f32.arch, device="cpu")
    got, _, _ = pl.forward(port_f32.arch, port_f32.weights, kv,
                           torch.from_numpy(tokens), 0, all_logits=True)
    assert _rel(got, want) <= LOGIT_RTOL
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0.08, atol=0.08)
    assert (got.numpy().argmax(-1) == oracle.argmax(-1)).mean() > 0.85


def test_moe_decode_matches_prefill(port_f32):
    """The decode path (T = 1: the k routed experts through the select)
    against the prefill path (the dense loop) at every position."""
    m = port_f32
    toks = np.random.default_rng(31).integers(3, 200, size=12)
    full, _, _ = pl.forward(m.arch, m.weights,
                            pl.KVCache.create(m.arch, device="cpu"),
                            torch.from_numpy(toks), 0, all_logits=True)
    kv = pl.KVCache.create(m.arch, device="cpu")
    steps = []
    for i, tk in enumerate(toks):
        lg, kv, _ = pl.forward(m.arch, m.weights, kv, [int(tk)], i)
        steps.append(lg[0])
    np.testing.assert_allclose(torch.stack(steps).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_moe_routing_is_selective(port_f32):
    """Zeroing an expert's down planes changes a token's logits only when
    the token routes to it somewhere: some experts matter, some do not."""
    m = port_f32
    lw = m.weights.layers
    base, _, _ = pl.forward(m.arch, m.weights,
                            pl.KVCache.create(m.arch, device="cpu"), [5], 0)
    changed = []
    for e in range(m.arch.n_experts):
        planes = {nm: a.clone() for nm, a in lw.w_down_exps.planes.items()}
        for a in planes.values():
            a[:, e] = 0
        w2 = dataclasses.replace(m.weights, layers=dataclasses.replace(
            lw, w_down_exps=QLinear(lw.w_down_exps.dtype, lw.w_down_exps.k,
                                    lw.w_down_exps.n, planes)))
        lg, _, _ = pl.forward(m.arch, w2,
                              pl.KVCache.create(m.arch, device="cpu"), [5],
                              0)
        changed.append(not torch.allclose(lg, base, atol=1e-5))
    assert any(changed) and not all(changed)


# ------------------------------------------------------------ the select
def _stack(fmt: str, k: int, n: int, n_exp: int, seed: int) -> QLinear:
    """A [n_exp, rows, N] plane stack of random matrices in `fmt`."""
    rng = np.random.default_rng(seed)
    mats = [(rng.standard_normal((n, k)) * 0.02).astype(np.float32)
            for _ in range(n_exp)]
    if fmt == "w4a8":
        parts = [requant_w4a8(np.ascontiguousarray(m.T)) for m in mats]
    elif fmt == "w8a8":
        parts = [requant_w8a8(np.ascontiguousarray(m.T)) for m in mats]
    else:
        dt = DType(fmt)
        parts = [relayout(np.frombuffer(quantize(m, dt), np.uint8), dt, n, k)
                 for m in mats]

    def tensor(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                                else a)
    return QLinear(DType(fmt), k, n, {nm: tensor(np.stack([p[nm] for p in
                                                           parts]))
                                      for nm in parts[0]})


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_k", "q5_k", "q6_k",
                                 "w8a8", "w4a8"])
def test_select_plain_twin_matches_host_view(fmt):
    """qmatmul with the index as a tensor (sel=, the plain twin's gather)
    is bit-equal to the host-int view (layer=) of the same matrix."""
    k, n = 512, 256
    ql = _stack(fmt, k, n, 5, seed=len(fmt))
    x = torch.randn(1, k, generator=torch.Generator().manual_seed(2)) \
        .to(torch.bfloat16)
    for e in range(5):
        sel = torch.tensor([e], dtype=torch.int32)
        assert torch.equal(qmatmul(x, ql, sel=sel), qmatmul(x, ql, layer=e))


def test_select_and_layer_are_exclusive():
    ql = _stack("q8_0", 64, 32, 2, seed=1)
    x = torch.zeros(1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not both"):
        qmatmul(x, ql, layer=0, sel=torch.tensor([1], dtype=torch.int32))


# ------------------------------------------------------------ engine
@pytest.mark.parametrize("which", ["q8_0", "qwen3moe", "q4_k_m"])
def test_moe_engine_generate_matches_jax(paths, which):
    """Greedy Engine.generate: the JAX Engine's text, deterministic."""
    port = Engine.load(paths[which], device="cpu", fuse=True)
    ref = JEngine.load(paths[which], fuse=True)
    t1, s1 = port.generate("hello world", GenerateConfig(**GREEDY))
    t2, _ = port.generate("hello world", GenerateConfig(**GREEDY))
    want, _ = ref.generate("hello world", JGenerateConfig(**GREEDY))
    assert t1 == t2 == want and s1.decode_tokens > 0
    if which == "qwen3moe":
        assert port.model.config.qk_norm
        assert port.model.weights.layers.q_norm is not None


@pytest.mark.parametrize("b_n", [1, 3])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_moe_batched_step_matches_jax(paths, impl, b_n):
    """The batched decode step (the routed FFN in the shared tail: the
    select at one row, the dense loop with each row's routing past it)
    against the JAX package's, from a zero cache with one inactive slot."""
    ref, arch, w = _pair(paths["f32"])
    pos = np.array([4, 0, 11][:b_n], np.int32)
    toks = np.random.default_rng(41).integers(3, 200, size=b_n)
    active = np.array([True, True, False][:b_n])
    want, _ = jb.batched_decode_step(
        ref.arch, ref.weights, jb.BatchedKV.create(ref.arch, b_n),
        jnp.asarray(toks, jnp.int32), jnp.asarray(pos), jnp.asarray(active),
        impl={"kernel": "kernel", "plain": "jnp"}[impl],
        kv_append="dus" if impl == "kernel" else None)
    got, _ = pb.batched_decode_step(
        arch, w, pb.BatchedKV.create(arch, b_n, device="cpu"),
        torch.from_numpy(toks), torch.from_numpy(pos).long(),
        torch.from_numpy(active), impl=impl)
    want = np.asarray(want, np.float32)
    for b in range(b_n):
        if active[b]:
            assert _rel(got[b], want[b]) <= LOGIT_RTOL, b


def test_moe_batched_server_matches_engine_and_jax(paths):
    """Two concurrent routed requests: greedy outputs equal to the port's
    Engine.generate and to the JAX package's server."""
    path = paths["q8_0"]
    eng = Engine.load(path, device="cpu")
    prompts = ["hello world", "the capital of france"]
    want = [eng.generate(p, GenerateConfig(**GREEDY))[0] for p in prompts]
    srv = BatchServer(load_model(path, device="cpu"), batch_size=2,
                      sampler_cfg=SamplerConfig(temperature=0.0))
    reqs = [Request(prompt=p, max_tokens=6) for p in prompts]
    srv.run(reqs)
    assert [r.text for r in reqs] == want
    jsrv = JBatchServer(jax_load_model(path), batch_size=2,
                        sampler_cfg=JSamplerConfig(temperature=0.0))
    jreqs = [JRequest(prompt=p, max_tokens=6) for p in prompts]
    jsrv.run(jreqs)
    assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]


# ------------------------------------------------------------ the CLI
@pytest.mark.parametrize("flags", [[], ["--kv-int8"]], ids=["bf16", "int8"])
def test_cli_moe_prints_the_jax_cli_text(paths, flags, capsys):
    args = ["-m", paths["q8_0"], "-p", "hello world", "-n", "6", "-t", "0"]
    assert jcli.main(args + flags) == 0
    want = capsys.readouterr().out
    assert cli.main(args + flags + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and want.strip()


@pytest.mark.parametrize("flags", [[], ["--spec-k", "3"]],
                         ids=["serve", "serve-spec"])
def test_cli_moe_serves(paths, flags, tmp_path, capsys):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("hello world\nthe capital of france\n")
    assert cli.main(["-m", paths["q8_0"], "--serve", str(prompts),
                     "--batch-size", "2", "-n", "4", "-t", "0", "--device",
                     "cpu"] + flags) == 0
    out = capsys.readouterr()
    assert out.out.count("### ") == 2
    assert "served 2 requests, 8 tokens" in out.err


def test_cli_moe_ep_stays_refused(paths, capsys):
    assert cli.main(["-m", paths["q8_0"], "--ep", "2", "-p", "x",
                     "--device", "cpu"]) == 2
    assert "item 14" in capsys.readouterr().err
