"""Port parity for models requantized at load to W4A8 (--w4a8) and W8A8
(--w8a8), against the JAX package on the CPU: the loader's planes (tiny512
in Q8_0 with its own head, tiny512 with float matrices, and models/
repolm512_q8.gguf, whose head is tied to the embedding), the synthetic
planes, weights_from_numpy, `forward` logits, the batched decode step (bf16
and int8 caches), greedy `Engine.generate` and the CLI's two flags.

Tolerances. Planes are bit-equal. Each layer, fed the JAX package's own
input and cache, is held to test_torch_model.py's LAYER_RTOL (measured on
repolm512: W8A8 bit-equal, W4A8 5.5e-5 in prefill and 7.6e-7 in decode).
End to end the formats quantize every product's activations to int8, and
both packages do it with the same IEEE operations, so a code differs only
where an f32 summation order elsewhere (the norms, attention) moves a value
across a rounding edge; but such a flip moves a whole product by one int8
step of its row (W8A8: a 512-wide row's max over 127, and repolm512's rows
carry outliers) or group (W4A8), and the steps after it inherit it. On
repolm512 that reads up to 7.2e-2 of the largest logit (W4A8, the second
teacher-forced decode step) and 5.8e-2 in the batched step (W8A8), where a
fault in a format's arithmetic reads O(1) (a transposed activation layout
read 1.39 on the card). So end-to-end logits are held to
WFORMAT_LOGIT_RTOL = 0.1, the cache rows a step does not write stay
bit-equal, and layer 0's written rows agree but for the flips a step
carries (WRITTEN_EQUAL; measured 95.7%)."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.inference.engine import Engine as JEngine
from ntransformer_tpu.inference.engine import GenerateConfig as JGenerateConfig
from ntransformer_tpu.models import batched as jb
from ntransformer_tpu.models import llama as jllama
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.models.synth import synth_model as jax_synth_model
from ntransformer_tpu.ops.linear import QLinear as JQLinear
from ntransformer_tpu_torch import cli
from ntransformer_tpu_torch.inference.engine import Engine, GenerateConfig
from ntransformer_tpu_torch.models import batched as pb
from ntransformer_tpu_torch.models import llama as pllama
from ntransformer_tpu_torch.models.convert import weights_from_numpy
from ntransformer_tpu_torch.models.loader import (convert_weights_w4a8,
                                                  convert_weights_w8a8,
                                                  load_model)
from ntransformer_tpu_torch.models.synth import synth_model
from test_torch_batched import JIMPL, _mark, _mid_context
from test_torch_batched import _bits, _pbits
from test_torch_model import (CACHE_EQUAL, LAYER_RTOL, _assert_same_qlinear,
                              _equal_share, _np, _t, jax_tree,
                              one_torch_thread)  # noqa: F401
from tools.make_test_gguf import write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(REPO, "models", "repolm512_q8.gguf")
FMTS = ["w4a8", "w8a8"]
FILES = ["tiny512_q8", "tiny512_f32", "repolm512"]
WFORMAT_LOGIT_RTOL = 0.1
WRITTEN_EQUAL = 0.9


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("w")
    return {"tiny512_q8": write_model(str(d / "tiny512_q8.gguf"), "tiny512",
                                      "q8_0", seed=31),
            "tiny512_f32": write_model(str(d / "tiny512_f32.gguf"),
                                       "tiny512", "f32", seed=32),
            "repolm512": REPOLM}


@pytest.fixture(scope="module")
def refs(paths):
    """The JAX package's model of each (file, format), fused."""
    cache = {}

    def get(which, fmt):
        if (which, fmt) not in cache:
            cache[which, fmt] = jax_load_model(paths[which], fuse=True,
                                               **{fmt: True})
        return cache[which, fmt]
    return get


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _assert_same_weights(pw, jw):
    _assert_same_qlinear(pw.embed, jw.embed, "embed")
    _assert_same_qlinear(pw.lm_head, jw.lm_head, "lm_head")
    for f in dataclasses.fields(pw.layers):
        pv, jv = getattr(pw.layers, f.name), getattr(jw.layers, f.name)
        assert (pv is None) == (jv is None), f.name
        if isinstance(jv, JQLinear):
            _assert_same_qlinear(pv, jv, f.name)
        elif jv is not None:
            np.testing.assert_array_equal(_t(pv), _np(jv), err_msg=f.name)


@pytest.mark.parametrize("which", FILES)
@pytest.mark.parametrize("fmt", FMTS)
def test_load_model_planes_bit_equal(paths, refs, fmt, which):
    """Every eligible matrix requantized on the host as the JAX loader
    does it, bit for bit; the gather table keeps its source format and a
    tied head gets its own converted copy."""
    port = load_model(paths[which], device="cpu", fuse=True, **{fmt: True})
    ref = refs(which, fmt)
    _assert_same_weights(port.weights, ref.weights)
    assert port.weights.layers.wqkv.dtype.value == fmt
    assert port.weights.lm_head.dtype.value == fmt
    assert port.weights.embed.dtype.value == ("bf16" if "f32" in which
                                              else "q8_0")


def test_load_model_refuses_both_formats(paths):
    with pytest.raises(ValueError, match="mutually exclusive"):
        load_model(paths["tiny512_q8"], device="cpu", w4a8=True, w8a8=True)


@pytest.mark.parametrize("fmt", FMTS)
def test_synth_model_planes_match_jax(fmt):
    """synth_model builds the formats as the JAX synth does (zero codes,
    f32 planes of 0.004, W8A8's one-row scale plane); convert_weights_*
    of a synthetic Q8_0 model converts on the card's side (torch planes)
    as the JAX package does on its device."""
    _, arch, pw = synth_model("tiny512", fmt, fuse=True, device="cpu")
    _, jarch, jw = jax_synth_model("tiny512", fmt, fuse=True)
    assert arch == pllama.Arch(**dataclasses.asdict(jarch))
    _assert_same_weights(pw, jw)
    from ntransformer_tpu.models import loader as jloader
    convert = {"w4a8": convert_weights_w4a8, "w8a8": convert_weights_w8a8}
    _, _, pq = synth_model("tiny512", "q8_0", device="cpu")
    _, _, jq = jax_synth_model("tiny512", "q8_0")
    rng = np.random.default_rng(5)
    for ql, jql in ((pq.layers.wq, jq.layers.wq), (pq.lm_head, jq.lm_head)):
        qs = rng.integers(-100, 100, tuple(ql.planes["qs"].shape), np.int8)
        ql.planes["qs"] = torch.from_numpy(qs)
        jql.planes["qs"] = jnp.asarray(qs)
    got = convert[fmt](pq)
    want = getattr(jloader, f"convert_weights_{fmt}")(jq)
    _assert_same_qlinear(got.layers.wq, want.layers.wq, "wq")
    _assert_same_qlinear(got.lm_head, want.lm_head, "lm_head")
    assert got.embed is pq.embed


@pytest.mark.parametrize("fmt", FMTS)
def test_weights_from_numpy_carries_the_formats(paths, refs, fmt):
    """The JAX weights as a numpy tree come over bit for bit, f32 planes
    included, through DType(tree["dtype"])."""
    ref = refs("tiny512_q8", fmt)
    arch = pllama.Arch(**dataclasses.asdict(ref.arch))
    w = weights_from_numpy(jax_tree(ref.weights), arch, "cpu")
    _assert_same_weights(w, ref.weights)
    assert w.lm_head.planes[{"w4a8": "s_lo", "w8a8": "s"}[fmt]].dtype \
        == torch.float32


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("fmt", FMTS)
def test_layer_step_matches_jax_layer_by_layer(paths, refs, fmt, phase):
    """Each layer of repolm512 fed the JAX package's own input and cache (a
    T=70 prefill in a 128 bucket, or the decode step after it): the port's
    layer output and the cache rows it writes agree to rounding."""
    ref = refs("repolm512", fmt)
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
        n = rows.stop - rows.start  # the valid rows of the layer output
        assert _rel(y.numpy()[:n], np.asarray(jx)[:n]) \
            <= LAYER_RTOL[phase], li
        for got, want in ((kv.k, jk), (kv.v, jv)):
            assert _equal_share(got[li][:, rows], want[:, rows]) \
                >= CACHE_EQUAL, li


@pytest.mark.parametrize("fmt", FMTS)
def test_forward_logits_match_jax(paths, refs, fmt):
    """repolm512 by the port's own load against the JAX model: a T=70
    prefill in a 128 bucket (the T > 1 products), then teacher-forced decode
    steps (W4A8's T = 1 decode product)."""
    ref = refs("repolm512", fmt)
    port = load_model(paths["repolm512"], device="cpu", fuse=True,
                      **{fmt: True})
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
    assert _rel(pl.numpy(), np.asarray(jl)) <= WFORMAT_LOGIT_RTOL
    for i in range(70, 73):
        jl, jkv, _ = jllama.forward(ref.arch, ref.weights, jkv,
                                    jnp.asarray([toks[i]], jnp.int32), i)
        pl, pkv, _ = pllama.forward(arch, weights, pkv, [int(toks[i])], i)
        assert _rel(pl.numpy(), np.asarray(jl)) <= WFORMAT_LOGIT_RTOL, i


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("fmt", FMTS)
def test_batched_decode_step_matches_jax(paths, refs, fmt, impl, quant):
    """Three chained batched steps of repolm512 from a mid-context cache,
    B = 3 with slot 1 inactive, on both of each package's paths (as
    test_torch_batched.py): W8A8's one int8 product at T = 3, W4A8's T > 1
    tile."""
    ref = refs("repolm512", fmt)
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
        for b in range(3):
            assert _rel(plog.numpy()[b], np.asarray(jlog)[b]) \
                <= WFORMAT_LOGIT_RTOL, (step, b)
        written = _mark(written, pos, active)
    for got, want in zip((pkv.k, pkv.v, pkv.ks, pkv.vs),
                         (jkv.k, jkv.v, jkv.ks, jkv.vs)):
        if want is None:
            continue
        g, w_ = _pbits(got), _bits(want)
        mask = np.broadcast_to(written if g.ndim == 4 else written[..., None],
                               g.shape)
        np.testing.assert_array_equal(g[~mask], w_[~mask])
        g0, w0 = g[0][mask[0]], w_[0][mask[0]]
        if g.ndim == 4:  # f32 scales: a flipped code moves them a little
            np.testing.assert_allclose(g0, w0, rtol=1e-3)
        else:
            assert (g0 == w0).mean() >= WRITTEN_EQUAL


@pytest.mark.parametrize("fmt", FMTS)
def test_generate_greedy_matches_jax(fmt):
    port = Engine.load(REPOLM, device="cpu", fuse=True, **{fmt: True})
    ref = JEngine.load(REPOLM, fuse=True, **{fmt: True})
    prompt = "def rms_norm(x, weight, eps):\n    xf = "
    text, stats = port.generate(prompt, GenerateConfig(
        max_tokens=12, temperature=0.0, repeat_penalty=1.0))
    want, _ = ref.generate(prompt, JGenerateConfig(
        max_tokens=12, temperature=0.0, repeat_penalty=1.0))
    assert stats.decode_tokens == 12
    assert text == want


BASE = ["-m", REPOLM, "--device", "cpu", "-n", "4", "-t", "0"]


@pytest.mark.parametrize("fmt", FMTS)
def test_cli_generate_and_benchmark_on_cpu(fmt, capsys):
    assert cli.main(BASE + ["-p", "def f(x):", f"--{fmt}"]) == 0
    assert "decode:  4 tok" in capsys.readouterr().err
    assert cli.main(BASE + ["--benchmark", "--bench-tokens", "3",
                            f"--{fmt}"]) == 0
    assert "decode:  3 tok" in capsys.readouterr().err


@pytest.mark.parametrize("fmt", FMTS)
def test_cli_serve_on_cpu(fmt, tmp_path, capsys):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("def f(x):\nimport numpy\n")
    assert cli.main(BASE + ["--serve", str(prompts), "--batch-size", "2",
                            "--kv-int8", f"--{fmt}"]) == 0
    out = capsys.readouterr()
    assert out.out.count("### ") == 2
    assert "served 2 requests, 8 tokens" in out.err


@pytest.mark.parametrize("extra", [[], ["--serve", "p.txt"]],
                         ids=["generate", "serve"])
def test_cli_refuses_both_formats(extra, capsys):
    assert cli.main(BASE + ["--w4a8", "--w8a8"] + extra) == 2
    assert "mutually exclusive" in capsys.readouterr().err
