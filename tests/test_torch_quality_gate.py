"""Port parity for the quality tools on the CPU: the port's requant
(ntransformer_tpu_torch/tools/requant_gguf.py) writes the JAX tool's
tensors byte for byte, its per-name policy form converts as the policy
says, and the port's gate (tools/quality_gate.py there) run on the
committed repolm artifact at ctx 128, 2 windows with the q6_k, q4_0 and
w8a8 rows passes, reads the JAX gate's fixture format, detects tampered
goldens and tokenizer fixtures (naming the failed sub-check), and gives
the JAX gate's deltas: within 2e-3 per token for the requant rows and 5e-3
for w8a8 (the perplexity tolerances of tests/test_torch_perplexity.py; the
smallest budget is 0.02), its greedy goldens equal to the JAX gate's."""
import json
import os
import shutil

import pytest

from ntransformer_tpu.core.dtypes import DType as JDType
from ntransformer_tpu.core.gguf import GGUFReader as JGGUFReader
from ntransformer_tpu_torch.core.dtypes import DType
from ntransformer_tpu_torch.core.gguf import GGUFReader
from ntransformer_tpu_torch.models.presets import q4_k_m_policy
from ntransformer_tpu_torch.tools import quality_gate as gate
from ntransformer_tpu_torch.tools.requant_gguf import main as requant_main
from ntransformer_tpu_torch.tools.requant_gguf import requant
from tools import quality_gate as jgate
from tools.make_test_gguf import write_model
from tools.requant_gguf import requant as jax_requant
from test_torch_model import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "models", "repolm_q8.gguf")
CORPUS = os.path.join(REPO, "README.md")
DTYPES = ["q6_k", "q4_0", "w8a8"]
GATE = dict(ctx=128, windows=2, golden_tokens=12)
DELTA_TOL = {"q6_k": 2e-3, "q4_0": 2e-3, "w8a8": 5e-3}

pytestmark = pytest.mark.skipif(not os.path.exists(ART),
                                reason="trained artifact not present")


def tensors(path, reader):
    r = reader(path)
    order = r.tensor_order if hasattr(r, "tensor_order") else list(r.tensors)
    return {n: (tuple(r.info(n).shape), r.info(n).dtype.value,
                bytes(r.raw_bytes(n))) for n in order}


def meta(reader):
    return {k: v.tolist() if hasattr(v, "tolist") else v
            for k, v in reader.metadata.items()}


@pytest.fixture(scope="module")
def f32_gguf(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("rq") / "tiny_f32.gguf"),
                       "tiny", "f32", seed=5)


@pytest.mark.parametrize("target", ["q4_k", "q4_0", "q6_k", "q5_k", "q8_0"])
@pytest.mark.parametrize("src", ["repolm_q8", "tiny_f32"])
def test_requant_tensors_equal_jax(src, target, f32_gguf, tmp_path):
    path = ART if src == "repolm_q8" else f32_gguf
    got, want = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    stats = requant(path, got, DType(target), progress=lambda _m: None)
    jstats = jax_requant(path, want, JDType(target), progress=lambda _m: None)
    assert stats == jstats
    g, w = tensors(got, GGUFReader), tensors(want, JGGUFReader)
    assert list(g) == list(w)
    assert g == w
    assert meta(GGUFReader(got)) == meta(JGGUFReader(want))


def test_requant_policy_and_main(tmp_path):
    """A per-name policy (Q4_K_M's) converts each matrix to its own
    format; the module's main writes the --to format."""
    out = str(tmp_path / "q4km.gguf")
    requant(ART, out, q4_k_m_policy, progress=lambda _m: None)
    r = GGUFReader(out)
    for n in r.tensor_order:
        if len(r.info(n).shape) == 2:
            assert r.info(n).dtype == q4_k_m_policy(n), n
    assert requant_main(["-m", ART, "-o", str(tmp_path / "q40.gguf"),
                         "--to", "q4_0"]) == 0
    r = GGUFReader(str(tmp_path / "q40.gguf"))
    assert r.info("blk.0.attn_q.weight").dtype == DType.Q4_0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX gate and one port gate on copies of the artifact, each
    writing a fresh fixture."""
    d = tmp_path_factory.mktemp("qgate")
    out = {}
    for who, run in (("jax", jgate.run_gate), ("port", gate.run_gate)):
        model = str(d / f"{who}_repolm_q8.gguf")
        shutil.copy(ART, model)
        fx = str(d / f"{who}_fixtures.json")
        kw = {"device": "cpu"} if who == "port" else {}
        out[who] = (model, fx, run(model, CORPUS, DTYPES, fx, True,
                                   **GATE, **kw))
    return out


def test_gate_passes_on_repolm(runs):
    res = runs["port"][2]
    assert res["pass"] and res["failed"] == [], res
    checks = res["checks"]
    assert checks["tokenizer"]["ok"] and checks["goldens"]["ok"]
    assert checks["goldens"]["logit_rel_err"] < 2e-2
    for dt in DTYPES:
        assert abs(checks["ppl"]["deltas"][dt]) < gate.PPL_BUDGET[dt]


def test_gate_matches_jax(runs):
    got, want = runs["port"][2]["checks"], runs["jax"][2]["checks"]
    assert got["tokenizer"] == want["tokenizer"]
    assert got["goldens"]["outputs"] == want["goldens"]["outputs"]
    assert abs(got["ppl"]["base_nll"] - want["ppl"]["base_nll"]) < 2e-3
    for dt in DTYPES:
        assert abs(got["ppl"]["deltas"][dt]
                   - want["ppl"]["deltas"][dt]) < DELTA_TOL[dt], dt
    assert (gate.TOKENIZER_SUITE, gate.GOLDEN_PROMPTS, gate.PPL_BUDGET) == \
        (jgate.TOKENIZER_SUITE, jgate.GOLDEN_PROMPTS, jgate.PPL_BUDGET)


def rerun(model, fx):
    return gate.run_gate(model, CORPUS, [], fx, False, device="cpu", **GATE)


def test_gate_reads_the_jax_fixture(runs):
    """The JAX gate's fixture is the port's format: a port run against it
    passes."""
    model = runs["port"][0]
    res = rerun(model, runs["jax"][1])
    assert res["pass"], res["failed"]


def tampered(runs, tmp_path, edit):
    _, fx, _ = runs["port"]
    with open(fx) as f:
        fixture = json.load(f)
    edit(fixture)
    path = str(tmp_path / "tampered.json")
    with open(path, "w") as f:
        json.dump(fixture, f)
    return rerun(runs["port"][0], path)


def test_gate_detects_golden_drift(runs, tmp_path):
    def edit(fx):
        prompt = next(iter(fx["checks"]["goldens"]["outputs"]))
        fx["checks"]["goldens"]["outputs"][prompt]["text"] = "DRIFTED"
    res = tampered(runs, tmp_path, edit)
    assert not res["pass"] and res["failed"] == ["goldens"]
    assert not res["checks"]["goldens"]["ok"]
    assert "drifted" in res["checks"]["goldens"]["errors"][0]


def test_gate_detects_tokenizer_drift(runs, tmp_path):
    def edit(fx):
        s = next(iter(fx["checks"]["tokenizer"]["suite"]))
        fx["checks"]["tokenizer"]["suite"][s]["ids_sha"] = "0" * 16
    res = tampered(runs, tmp_path, edit)
    assert not res["pass"] and res["failed"] == ["tokenizer"]
    assert not res["checks"]["tokenizer"]["ok"]


def test_gate_skips_w4a8_on_ineligible_shapes(runs, tmp_path, capsys):
    """repolm's widths (256, 512) are not 512-divisible: the w4a8 rows are
    skipped and said so, not passed measuring nothing."""
    res = gate.run_gate(runs["port"][0], CORPUS, ["w4a8"],
                        str(tmp_path / "fx.json"), True, device="cpu",
                        ctx=64, windows=1, golden_tokens=2)
    assert res["checks"]["ppl_skipped"] == {"w4a8": "shapes not "
                                                    "512-divisible"}
    assert res["checks"]["ppl"]["deltas"] == {}


def test_gate_main_on_cpu(runs, tmp_path, capsys):
    rc = gate.main(["-m", runs["port"][0], "--dtypes", "q8_0",
                    "--fixtures", str(tmp_path / "fx.json"), "--ctx", "64",
                    "--windows", "1", "--golden-tokens", "2",
                    "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["pass"] and out["failed"] == []
    assert "q8_0" in out["ppl"]["deltas"]
