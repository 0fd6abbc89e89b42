"""Port parity for the nibble formats at model level: tiny synthetic GGUFs in
Q4_K_M (Q4_K with ffn_down and the head in Q6_K), Q4_0, Q5_K, Q6_K and a
Q4_K_M whose attn_v is Q6_K (as llama.cpp's Q4_K_M gives some layers, so the
fused q|k product runs beside a separate v product), and models/
repolm512_q8.gguf requantized to Q4_K_M with the JAX package's tools,
against the JAX package on the CPU: loader planes, synthetic planes,
`forward` logits, greedy `Engine.generate` and the batched decode step.

Tolerances are test_torch_model.py's and test_torch_batched.py's: the
nibble formats change the weights, not the arithmetic around them (bf16
dequant, bf16 activations, f32 sums), so LOGIT_RTOL (5e-3 of the largest
logit) and the batched limits hold as they are.

The JAX loader pads a K-quant LM head to 2048 lanes (a Mosaic tiling
reason); the port keeps the file's width. Planes are compared on the
file's columns, and a padded head (as weights_from_numpy brings the JAX
weights over) gives the same logits."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.make_test_gguf as make_test_gguf
from ntransformer_tpu.core import GGUFReader as JGGUFReader
from ntransformer_tpu.core import GGUFWriter as JGGUFWriter
from ntransformer_tpu.core import quantize as jquantize
from ntransformer_tpu.core.dequant import dequantize as jdequantize
from ntransformer_tpu.core.dtypes import DType as JDType
from ntransformer_tpu.inference.engine import Engine as JEngine
from ntransformer_tpu.inference.engine import GenerateConfig as JGenerateConfig
from ntransformer_tpu.models import batched as jb
from ntransformer_tpu.models import llama as jllama
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.models.presets import q4_k_m_policy as jq4km_policy
from ntransformer_tpu.models.synth import synth_model as jax_synth_model
from ntransformer_tpu.ops.linear import QLinear as JQLinear
from ntransformer_tpu_torch.inference.engine import Engine, GenerateConfig
from ntransformer_tpu_torch.models import batched as pb
from ntransformer_tpu_torch.models import llama as pllama
from ntransformer_tpu_torch.models.convert import weights_from_numpy
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.models.synth import synth_model
from test_torch_batched import (JIMPL, _check_caches, _check_logits, _mark,
                                _mid_context)
from test_torch_model import (LOGIT_RTOL, _np, _t, jax_tree,  # noqa: F401
                              one_torch_thread)
from tools.make_test_gguf import write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(REPO, "models", "repolm512_q8.gguf")
FORMATS = ["q4_k_m", "q4_0", "q5_k", "q6_k", "q4_k_m_v6"]
PROMPT = "the capital of france is"


def _v6_policy(name: str):
    return JDType.Q6_K if "attn_v" in name else jq4km_policy(name)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("q")
    out = {}
    for fmt in FORMATS:
        path = str(d / f"tiny_{fmt}.gguf")
        if fmt == "q4_k_m_v6":
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(make_test_gguf, "q4_k_m_policy", _v6_policy)
                out[fmt] = write_model(path, "tiny", "q4_k_m", seed=23)
        else:
            out[fmt] = write_model(path, "tiny", fmt, seed=23)
    return out


@pytest.fixture(scope="module")
def refs(paths):
    """The JAX package's loaded model of each tiny file, fused."""
    return {fmt: jax_load_model(p, fuse=True) for fmt, p in paths.items()}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _assert_same_qlinear(port, jq: JQLinear, what: str):
    """Bit-equal planes on the port's columns; a JAX head padded beyond
    them holds zeros there."""
    assert port.dtype.value == jq.dtype.value, what
    assert port.k == jq.k and port.n <= jq.n, what
    assert set(port.planes) == set(jq.planes), what
    for nm, v in jq.planes.items():
        want = _np(v)
        np.testing.assert_array_equal(_t(port.planes[nm]),
                                      want[..., :port.n],
                                      err_msg=f"{what}.{nm}")
        assert not want[..., port.n:].any(), what


def test_dtypes_of_the_q4_k_m_files(paths, refs):
    """The files carry the mixes they name: Q4_K_M fuses one Q4_K q|k|v
    product; with a Q6_K attn_v the q|k product fuses alone."""
    port = load_model(paths["q4_k_m_v6"], device="cpu", fuse=True)
    lw = port.weights.layers
    assert lw.wqkv is None and lw.wqk.dtype.value == "q4_k"
    assert lw.wv.dtype.value == "q6_k" and lw.w_down.dtype.value == "q6_k"
    assert lw.w_gate_up.dtype.value == "q4_k"
    assert port.weights.lm_head.dtype.value == "q6_k"
    lw = load_model(paths["q4_k_m"], device="cpu", fuse=True).weights.layers
    assert lw.wqkv.dtype.value == "q4_k" and lw.wqk is None
    assert refs["q4_k_m_v6"].weights.layers.wqk is not None


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_model_planes_bit_equal(paths, refs, fmt):
    port = load_model(paths[fmt], device="cpu", fuse=True)
    ref = refs[fmt]
    assert port.arch == pllama.Arch(**dataclasses.asdict(ref.arch))
    pw, jw = port.weights, ref.weights
    _assert_same_qlinear(pw.embed, jw.embed, "embed")
    _assert_same_qlinear(pw.lm_head, jw.lm_head, "lm_head")
    for f in dataclasses.fields(pw.layers):
        pv, jv = getattr(pw.layers, f.name), getattr(jw.layers, f.name)
        assert (pv is None) == (jv is None), f.name
        if isinstance(jv, JQLinear):
            _assert_same_qlinear(pv, jv, f.name)
        elif jv is not None:
            np.testing.assert_array_equal(_t(pv), _np(jv), err_msg=f.name)


@pytest.mark.parametrize("fmt", ["q4_k_m", "q4_0", "q5_k", "q6_k"])
def test_synth_model_planes_match_jax(fmt):
    """synth_model's plane fills (zero codes, f16-small d/dmin, sc/mn 8) and
    its Q4_K_M policy are the JAX package's."""
    cfg, arch, pw = synth_model("tiny", fmt, fuse=True, device="cpu")
    _, jarch, jw = jax_synth_model("tiny", fmt, fuse=True)
    assert arch == pllama.Arch(**dataclasses.asdict(jarch))
    _assert_same_qlinear(pw.embed, jw.embed, "embed")
    _assert_same_qlinear(pw.lm_head, jw.lm_head, "lm_head")
    for f in dataclasses.fields(pw.layers):
        jv = getattr(jw.layers, f.name)
        if isinstance(jv, JQLinear):
            _assert_same_qlinear(getattr(pw.layers, f.name), jv, f.name)


@pytest.mark.parametrize("fmt", FORMATS)
def test_forward_logits_match_jax(paths, refs, fmt):
    """The port's own load (the head at the file's width) against the JAX
    model: a T=70 prefill in a 128 bucket, then teacher-forced decode
    steps."""
    ref = refs[fmt]
    port = load_model(paths[fmt], device="cpu", fuse=True)
    arch, weights = port.arch, port.weights
    toks = np.random.default_rng(0).integers(3, arch.vocab_size, 73)
    padded = np.zeros(128, np.int32)
    padded[:70] = toks[:70]
    jkv = jllama.KVCache.create(ref.arch)
    jl, jkv, _ = jllama.forward(ref.arch, ref.weights, jkv,
                                jnp.asarray(padded), 0, n_valid=70)
    pkv = pllama.KVCache.create(arch, device="cpu")
    pl, pkv, _ = pllama.forward(arch, weights, pkv,
                                torch.from_numpy(padded.astype(np.int64)), 0,
                                n_valid=70)
    assert tuple(pl.shape) == (1, arch.vocab_size)
    assert _rel(pl.numpy(), np.asarray(jl)) <= LOGIT_RTOL
    for i in range(70, 73):
        jl, jkv, _ = jllama.forward(ref.arch, ref.weights, jkv,
                                    jnp.asarray([toks[i]], jnp.int32), i)
        pl, pkv, _ = pllama.forward(arch, weights, pkv, [int(toks[i])], i)
        assert _rel(pl.numpy(), np.asarray(jl)) <= LOGIT_RTOL, i


def test_padded_head_gives_the_same_logits(paths, refs):
    """The JAX weights (a Q6_K head padded to 2048 lanes) brought over by
    weights_from_numpy give the port's unpadded model's logits."""
    ref = refs["q4_k_m"]
    port = load_model(paths["q4_k_m"], device="cpu", fuse=True)
    padded = weights_from_numpy(jax_tree(ref.weights), port.arch, "cpu")
    assert padded.lm_head.n == 2048 > port.weights.lm_head.n
    toks = np.random.default_rng(1).integers(3, port.arch.vocab_size, 9)
    outs = []
    for w in (port.weights, padded):
        kv = pllama.KVCache.create(port.arch, device="cpu")
        outs.append(pllama.forward(port.arch, w, kv, toks, 0,
                                   all_logits=True)[0].numpy())
    assert outs[0].shape == outs[1].shape == (9, port.arch.vocab_size)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt", FORMATS)
def test_generate_greedy_matches_jax(paths, fmt):
    port = Engine.load(paths[fmt], device="cpu", fuse=True)
    ref = JEngine.load(paths[fmt], fuse=True)
    text, stats = port.generate(PROMPT, GenerateConfig(
        max_tokens=12, temperature=0.0, repeat_penalty=1.0))
    want, _ = ref.generate(PROMPT, JGenerateConfig(
        max_tokens=12, temperature=0.0, repeat_penalty=1.0))
    assert stats.decode_tokens == 12
    assert text == want


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("fmt", ["q4_k_m", "q4_k_m_v6"])
def test_batched_decode_step_matches_jax(paths, refs, fmt, impl, quant):
    """Three chained batched steps from a mid-context cache, B = 3 with
    slot 1 inactive, on both of each package's paths (as
    test_torch_batched.py)."""
    ref = refs[fmt]
    arch = pllama.Arch(**dataclasses.asdict(ref.arch))
    w = weights_from_numpy(jax_tree(ref.weights), arch, "cpu")
    jkv, pkv, lens = _mid_context(ref, 3, quant, seed=1)
    active = np.array([True, False, True])
    toks = np.random.default_rng(2).integers(3, arch.vocab_size, (3, 3))
    written = np.zeros(pkv.k.shape[:4], bool)[:, :, :1]
    for step in range(3):
        pos = lens + step
        jlog, jkv = jb.batched_decode_step(
            ref.arch, ref.weights, jkv, jnp.asarray(toks[step], jnp.int32),
            jnp.asarray(pos), jnp.asarray(active), impl=JIMPL[impl])
        plog, pkv = pb.batched_decode_step(arch, w, pkv, toks[step], pos,
                                           active, impl=impl)
        assert tuple(plog.shape) == (3, arch.vocab_size)
        _check_logits(plog.numpy(), np.asarray(jlog), active, quant)
        _check_caches(pkv, jkv, _mark(written, pos, active))


@pytest.fixture(scope="module")
def repolm_q4km(tmp_path_factory):
    """models/repolm512_q8.gguf requantized to Q4_K_M by the JAX package's
    quantizer and writer (every matrix dequantized, then requantized by
    q4_k_m_policy; metadata and vectors copied)."""
    path = str(tmp_path_factory.mktemp("r") / "repolm512_q4_k_m.gguf")
    r = JGGUFReader(REPOLM)
    w = JGGUFWriter(path)
    for key, value in r.metadata.items():
        w.add_meta(key, value)
    for name in r.tensor_order:
        info = r.info(name)
        raw = r.raw_bytes(name)
        if len(info.shape) == 2 and name.endswith(".weight"):
            dt = jq4km_policy(name)
            x = jdequantize(raw, info.dtype, *info.shape)
            w.add_tensor(name, raw=jquantize(x, dt), shape=info.shape,
                         dtype=dt)
        else:
            w.add_tensor(name, raw=bytes(raw), shape=info.shape,
                         dtype=info.dtype)
    w.write()
    return path


def test_repolm512_q4_k_m_forward_matches_jax(repolm_q4km):
    """Trained weights in Q4_K_M: a T=70 prefill then decode steps, the
    port's own load against the JAX model."""
    ref = jax_load_model(repolm_q4km, fuse=True)
    port = load_model(repolm_q4km, device="cpu", fuse=True)
    assert port.weights.layers.w_down.dtype.value == "q6_k"
    arch = port.arch
    toks = np.random.default_rng(3).integers(3, arch.vocab_size, 73)
    padded = np.zeros(128, np.int32)
    padded[:70] = toks[:70]
    jkv = jllama.KVCache.create(ref.arch)
    jl, jkv, _ = jllama.forward(ref.arch, ref.weights, jkv,
                                jnp.asarray(padded), 0, n_valid=70)
    pkv = pllama.KVCache.create(arch, device="cpu")
    pl, pkv, _ = pllama.forward(arch, port.weights, pkv,
                                torch.from_numpy(padded.astype(np.int64)), 0,
                                n_valid=70)
    assert _rel(pl.numpy(), np.asarray(jl)) <= LOGIT_RTOL
    for i in range(70, 73):
        jl, jkv, _ = jllama.forward(ref.arch, ref.weights, jkv,
                                    jnp.asarray([toks[i]], jnp.int32), i)
        pl, pkv, _ = pllama.forward(arch, port.weights, pkv, [int(toks[i])],
                                    i)
        assert _rel(pl.numpy(), np.asarray(jl)) <= LOGIT_RTOL, i
