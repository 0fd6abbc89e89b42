"""Port parity for the slice as a whole: loader planes, the numpy weight
converter, `forward` logits and greedy `Engine.generate`, against the JAX
package on the CPU, for a synthetic tiny Q8_0 GGUF and the trained
models/repolm512_q8.gguf.

Tolerances. The two packages run the same arithmetic with the same cast
points, but their f32 sums (matmuls, attention einsums) go in other orders
and their rsqrt, exp and sigmoid differ in the last ulp, so an activation
now and then rounds to the neighbouring bf16 value before a matmul.
- One layer at a time, fed the JAX package's own input and cache: outputs
  agree to 2e-7 of their largest value at decode and 4.4e-4 at a T=128
  prefill, and at least 99.97% of the bf16 cache rows written agree bit for
  bit. Moving one cast point (k to bf16 before RoPE, or the SwiGLU gate to
  bf16 before silu) gives 2.2e-4 to 1.5e-2 and 96% equal cache bits, so
  LAYER_RTOL (decode 1e-5, prefill 1e-3) and CACHE_EQUAL (99%) hold the
  cast points.
- Through the whole stack those few flips grow: the logits of a full
  forward differ by up to 3.9e-3 of the largest logit (repolm512, T=70
  prefill then decode), and the deeper cache rows of the tiny model's
  random weights agree only 63-82% bit for bit. LOGIT_RTOL is 5e-3 of the
  largest logit, and the cache is held bit for bit at layer 0 only.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.inference.engine import Engine as JEngine
from ntransformer_tpu.inference.engine import GenerateConfig as JGenerateConfig
from ntransformer_tpu.models import llama as jllama
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.ops.linear import QLinear as JQLinear
from ntransformer_tpu_torch.inference.engine import ChatSession, Engine, \
    GenerateConfig
from ntransformer_tpu_torch.models import llama as pllama
from ntransformer_tpu_torch.models.convert import weights_from_numpy
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.ops.linear import QLinear
from tools.make_test_gguf import write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(REPO, "models", "repolm512_q8.gguf")
LOGIT_RTOL = 5e-3
LAYER_RTOL = {"prefill": 1e-3, "decode": 1e-5}
CACHE_EQUAL = 0.99
PROMPT = ("def rms_norm(x, weight, eps):\n"
          "    xf = x.astype(jnp.float32)\n"
          "    return xf * weight\n")


@pytest.fixture(scope="module")
def tiny_path(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("m") / "tiny_q8.gguf"),
                       "tiny", "q8_0", seed=11)


@pytest.fixture(scope="module")
def paths(tiny_path):
    return {"tiny": tiny_path, "repolm512": REPOLM}


def _np(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return a.view(np.int16)
    return a


def _t(t):
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def jax_tree(w) -> dict:
    """The JAX ModelWeights as the numpy tree weights_from_numpy takes."""
    def ql(q):
        return {"dtype": q.dtype.value, "k": q.k, "n": q.n,
                "planes": {nm: np.asarray(v) for nm, v in q.planes.items()}}

    def leaf(v):
        if v is None:
            return None
        return ql(v) if isinstance(v, JQLinear) else np.asarray(v)
    return {"embed": ql(w.embed), "lm_head": ql(w.lm_head),
            "output_norm": np.asarray(w.output_norm),
            "rope_cos": np.asarray(w.rope_cos),
            "rope_sin": np.asarray(w.rope_sin),
            "layers": {f.name: leaf(getattr(w.layers, f.name))
                       for f in dataclasses.fields(w.layers)}}


def _assert_same_qlinear(port: QLinear, jq: JQLinear, what: str):
    assert port.dtype.value == jq.dtype.value, what
    assert (port.k, port.n) == (jq.k, jq.n), what
    assert set(port.planes) == set(jq.planes), what
    for nm, v in jq.planes.items():
        np.testing.assert_array_equal(_t(port.planes[nm]), _np(v),
                                      err_msg=f"{what}.{nm}")


def _assert_same_weights(pw, jw, rope_atol=0.0):
    _assert_same_qlinear(pw.embed, jw.embed, "embed")
    _assert_same_qlinear(pw.lm_head, jw.lm_head, "lm_head")
    np.testing.assert_array_equal(_t(pw.output_norm), _np(jw.output_norm))
    for f in dataclasses.fields(pw.layers):
        pv, jv = getattr(pw.layers, f.name), getattr(jw.layers, f.name)
        assert (pv is None) == (jv is None), f.name
        if isinstance(jv, JQLinear):
            _assert_same_qlinear(pv, jv, f.name)
        elif jv is not None:
            np.testing.assert_array_equal(_t(pv), _np(jv), err_msg=f.name)
    for pv, jv in ((pw.rope_cos, jw.rope_cos), (pw.rope_sin, jw.rope_sin)):
        np.testing.assert_allclose(_t(pv), np.asarray(jv), atol=rope_atol)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("which", ["tiny", "repolm512"])
def test_load_model_planes_bit_equal(paths, which, fuse):
    port = load_model(paths[which], device="cpu", fuse=fuse)
    ref = jax_load_model(paths[which], fuse=fuse)
    assert port.arch == pllama.Arch(**dataclasses.asdict(ref.arch))
    _assert_same_weights(port.weights, ref.weights, rope_atol=2e-6)


@pytest.mark.parametrize("which", ["tiny", "repolm512"])
def test_weights_from_numpy_gives_the_same_tensors(paths, which):
    ref = jax_load_model(paths[which], fuse=True)
    arch = pllama.Arch(**dataclasses.asdict(ref.arch))
    got = weights_from_numpy(jax_tree(ref.weights), arch, "cpu")
    _assert_same_weights(got, ref.weights)


def test_tokenizer_and_config_copies_agree(paths):
    port = load_model(REPOLM, device="cpu")
    ref = jax_load_model(REPOLM)
    assert port.config.describe() == ref.config.describe()
    ids = port.tokenizer.encode(PROMPT, add_bos=True)
    assert ids == ref.tokenizer.encode(PROMPT, add_bos=True)
    assert port.tokenizer.decode(ids) == ref.tokenizer.decode(ids)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _equal_share(port: torch.Tensor, ref) -> float:
    """Share of the bf16 entries that agree bit for bit."""
    return float((_t(port) == _np(ref)).mean())


@pytest.mark.parametrize("which", ["tiny", "repolm512"])
def test_forward_logits_match_jax(paths, which):
    """Bucketed prefill (T=70 in a 128 bucket, n_valid) then teacher-forced
    decode steps, on identical parameters."""
    ref = jax_load_model(paths[which], fuse=True)
    arch = pllama.Arch(**dataclasses.asdict(ref.arch))
    weights = weights_from_numpy(jax_tree(ref.weights), arch, "cpu")
    toks = np.random.default_rng(0).integers(3, arch.vocab_size, 74)
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
    for i in range(70, 74):
        jl, jkv, _ = jllama.forward(ref.arch, ref.weights, jkv,
                                    jnp.asarray([toks[i]], jnp.int32), i)
        pl, pkv, _ = pllama.forward(arch, weights, pkv, [int(toks[i])], i)
        assert _rel(pl.numpy(), np.asarray(jl)) <= LOGIT_RTOL, i
    # layer 0's cache rows agree bit for bit but for a rare flip (deeper
    # layers see the flips of the layers before them); padding rows beyond
    # n_valid stay unwritten
    for got, want in ((pkv.k, jkv.k), (pkv.v, jkv.v)):
        assert _equal_share(got[0, :, :74], want[0, :, :74]) >= 0.999
    assert float(pkv.k[:, :, 74:].abs().max()) == 0.0


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("which", ["tiny", "repolm512"])
def test_layer_step_matches_jax_layer_by_layer(paths, which, phase):
    """Each layer fed the JAX package's own input and cache (a T=70 prefill
    in a 128 bucket, or the decode step after it): the port's layer output
    and the cache rows it writes agree to rounding."""
    ref = jax_load_model(paths[which], fuse=True)
    arch = pllama.Arch(**dataclasses.asdict(ref.arch))
    weights = weights_from_numpy(jax_tree(ref.weights), arch, "cpu")
    toks = np.random.default_rng(2).integers(3, arch.vocab_size, 71)
    padded = np.zeros(128, np.int32)
    padded[:70] = toks[:70]
    jkv = jllama.KVCache.create(ref.arch)
    if phase == "decode":
        _, jkv, _ = jllama.forward(ref.arch, ref.weights, jkv,
                                   jnp.asarray(padded), 0, n_valid=70)
    pos, tk, n_valid, rows = ((0, padded, 70, slice(0, 70))
                              if phase == "prefill" else
                              (70, toks[70:], None, slice(70, 71)))
    jx, jcos, jsin = jllama.embed_positions(ref.arch, ref.weights,
                                            jnp.asarray(tk), pos)
    _, cos_t, sin_t = pllama.embed_positions(
        arch, weights, torch.from_numpy(tk.astype(np.int64)), pos)
    kv = pllama.KVCache.create(arch, device="cpu")
    for li in range(arch.n_layers):
        x = torch.from_numpy(np.array(jx, np.float32))
        for got, want in ((kv.k, jkv.k), (kv.v, jkv.v)):
            got[li].copy_(torch.from_numpy(np.asarray(want[li], np.float32)))
        y = pllama.layer_step(arch, x, weights.layers, kv.k[li], kv.v[li],
                              pos, cos_t, sin_t, n_valid, layer=li)
        jx, jk, jv = jllama.layer_step(
            ref.arch, jx, ref.weights.layers, jkv.k[li], jkv.v[li], pos,
            jcos, jsin, None if n_valid is None else jnp.int32(n_valid),
            layer=li)
        assert _rel(y.numpy(), np.asarray(jx)) <= LAYER_RTOL[phase], li
        for got, want in ((kv.k, jk), (kv.v, jv)):
            assert _equal_share(got[li][:, rows], want[:, rows]) \
                >= CACHE_EQUAL, li


def test_forward_all_logits_and_layer_sel_match_jax(paths):
    ref = jax_load_model(REPOLM)
    arch = pllama.Arch(**dataclasses.asdict(ref.arch))
    weights = weights_from_numpy(jax_tree(ref.weights), arch, "cpu")
    toks = np.random.default_rng(1).integers(3, arch.vocab_size, 16)
    sel = np.array([0, 1, 4, 5], np.int32)
    jl, _, jcos = jllama.forward(ref.arch, ref.weights,
                                 jllama.KVCache.create(ref.arch),
                                 jnp.asarray(toks, jnp.int32), 0,
                                 layer_sel=jnp.asarray(sel), all_logits=True,
                                 with_cosine=True)
    pl, _, pcos = pllama.forward(arch, weights,
                                 pllama.KVCache.create(arch, device="cpu"),
                                 toks, 0, layer_sel=sel, all_logits=True,
                                 with_cosine=True)
    assert tuple(pl.shape) == (16, arch.vocab_size)
    assert _rel(pl.numpy(), np.asarray(jl)) <= LOGIT_RTOL
    np.testing.assert_allclose(pcos.numpy(), np.asarray(jcos), atol=1e-4)


@pytest.fixture(scope="module")
def repolm_engines():
    return Engine.load(REPOLM, device="cpu", fuse=True), \
        JEngine.load(REPOLM, fuse=True)


def test_generate_greedy_matches_jax(repolm_engines):
    port, ref = repolm_engines
    text, stats = port.generate(PROMPT, GenerateConfig(
        max_tokens=16, temperature=0.0, repeat_penalty=1.0))
    want, _ = ref.generate(PROMPT, JGenerateConfig(
        max_tokens=16, temperature=0.0, repeat_penalty=1.0))
    assert stats.decode_tokens == 16
    assert text == want


def test_generate_chat_session_prefills_only_the_delta(repolm_engines):
    port, _ = repolm_engines
    cfg = GenerateConfig(max_tokens=6, temperature=0.0, repeat_penalty=1.0)
    session = ChatSession()
    first, _ = port.generate(PROMPT, cfg, session=session)
    ids = session.ids_in_kv + port.tokenizer.encode("    return", add_bos=False)
    again, st = port.generate("", cfg, prompt_ids=ids, session=session)
    fresh, st_fresh = port.generate("", cfg, prompt_ids=ids)
    assert again == fresh
    assert st.prefill_tokens < st_fresh.prefill_tokens


def test_layer_skip_calibration_matches_jax():
    """--skip-threshold: the first prefill's cosines pick the same skipped
    middle-band layers, and generation then runs the reduced stack."""
    port = Engine.load(REPOLM, device="cpu", fuse=True)
    ref = JEngine.load(REPOLM, fuse=True)
    kw = dict(max_tokens=4, temperature=0.0, repeat_penalty=1.0,
              skip_threshold=0.5)
    _, st = port.generate(PROMPT, GenerateConfig(**kw))
    _, jst = ref.generate(PROMPT, JGenerateConfig(**kw))
    assert st.skipped_layers == jst.skipped_layers
    assert st.skipped_layers and st.decode_tokens == 4
    assert list(port.layer_sel) == list(ref.layer_sel)


def test_benchmark_runs_greedy(repolm_engines):
    port, _ = repolm_engines
    st = port.benchmark(PROMPT, n_tokens=4)
    assert st.decode_tokens == 4 and st.prefill_tokens > 0


def test_unsupported_weights_refused_at_load(tmp_path):
    path = write_model(str(tmp_path / "tiny_q4km.gguf"), "tiny", "q4_k_m",
                       seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 row 1b"):
        load_model(path, device="cpu")
    moe = write_model(str(tmp_path / "moe.gguf"), "moe", "q8_0", seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_model(moe, device="cpu")
    ref = jax_load_model(REPOLM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pllama.KVCache.create(pllama.Arch(**dataclasses.asdict(ref.arch)),
                              quant=True, device="cpu")
    assert jax.default_backend() == "cpu"
