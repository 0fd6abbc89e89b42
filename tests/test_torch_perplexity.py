"""Port parity for the perplexity tool (ntransformer_tpu_torch/tools/
perplexity.py) on the CPU: the summed-window mechanics, and the nll per
token of prefill mode, decode mode (T = 1 steps), compute="bf16" and the
engine-native formats against tools/perplexity.py on the same GGUF and
ids.

Tolerances, on the nll per token (a mean of ~128 log-probabilities): 2e-3
for the Q8_0 and bf16 paths, whose logits differ from the JAX package's
CPU run only by rounding (a bf16 cache here, the interpret-mode kernels'
f32 dots there; measured up to 4e-4); 5e-3 for W8A8 and W4A8, whose
activation quantization turns an f32 order difference into a whole int8
step (measured up to 1.3e-3). The smallest budget of the quality gate is
0.02, ten times the first."""
import math
import os

import pytest

from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.tools import perplexity as ppl
from tools.make_test_gguf import write_model
from tools.perplexity import perplexity as jax_perplexity
from test_torch_model import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(REPO, "models", "repolm_q8.gguf")
TOL = {"plain": 2e-3, "act-quant": 5e-3}


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("ppl") / "ppl_q8.gguf"),
                       "tiny", "q8_0", seed=9)


def corpus_ids(path, n=128):
    tok = load_model(path, device="cpu", n_layers=1).tokenizer
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        return tok.encode(f.read(), add_bos=True)[:n]


def test_perplexity_mechanics(gguf):
    m = load_model(gguf, device="cpu")
    r = ppl.perplexity(m, list(range(5, 133)), ctx=64)
    assert r["windows"] == 2 and r["tokens"] == 126
    assert r["mode"] == "prefill"
    assert math.isfinite(r["ppl"]) and r["ppl"] > 1.0
    assert math.isclose(r["ppl"], math.exp(r["nll_per_token"]))
    with pytest.raises(ValueError):
        ppl.perplexity(m, list(range(5, 133)), ctx=64, mode="scan")


@pytest.mark.parametrize("which,compute,mode,fmt", [
    ("tiny", "quant", "prefill", None), ("tiny", "quant", "decode", None),
    ("tiny", "bf16", "prefill", None), ("tiny", "quant", "prefill", "w8a8"),
    ("tiny", "quant", "decode", "w4a8"),
    ("repolm", "quant", "prefill", None), ("repolm", "quant", "decode", None),
    ("repolm", "bf16", "prefill", None),
    ("repolm", "quant", "prefill", "w8a8")],
    ids=lambda v: str(v))
def test_nll_matches_jax(gguf, which, compute, mode, fmt):
    path = gguf if which == "tiny" else REPOLM
    ids = corpus_ids(path)
    kw = {fmt: True} if fmt else {}
    want = jax_perplexity(jax_load_model(path, compute=compute, **kw), ids,
                          64, mode=mode)
    got = ppl.perplexity(load_model(path, compute=compute, device="cpu",
                                    **kw), ids, 64, mode=mode)
    assert (got["tokens"], got["windows"]) == (want["tokens"],
                                               want["windows"])
    tol = TOL["act-quant" if fmt else "plain"]
    assert abs(got["nll_per_token"] - want["nll_per_token"]) < tol, \
        (got, want)


def test_bf16_compute_loads_float_matrices(gguf):
    """compute="bf16" dequantizes every matrix to a bf16 float matrix;
    n_layers cuts the stack; with_tokenizer=False loads none."""
    from ntransformer_tpu_torch.core.dtypes import DType
    m = load_model(gguf, device="cpu", compute="bf16", n_layers=2,
                   with_tokenizer=False)
    assert m.arch.n_layers == 2 and m.tokenizer is None
    assert m.weights.layers.wq.dtype == DType.BF16
    assert m.weights.lm_head.dtype == DType.BF16
    assert m.weights.embed.dtype == DType.BF16
    with pytest.raises(ValueError):
        load_model(gguf, device="cpu", compute="f8")


def test_main_on_cpu(gguf, tmp_path, capsys):
    corpus = tmp_path / "c.txt"
    corpus.write_text("def f(x):\n    return x * 2\n" * 20)
    assert ppl.main(["-m", gguf, "-f", str(corpus), "--ctx", "32",
                     "--windows", "2", "--mode", "decode",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "perplexity:" in out.out and "nll/token" in out.out
    assert "window 2/2" in out.err
