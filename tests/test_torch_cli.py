"""Port CLI on the CPU: resident generation (bf16 and --kv-int8 caches),
--benchmark, --serve and tiered streaming run; every mode the port does not
run yet exits with 2 and names its ROADMAP item; the refusals the JAX CLI
makes of the ported modes are the port's too."""
import os
import shutil

import pytest

from ntransformer_tpu import cli as jcli
from ntransformer_tpu_torch import cli
from test_torch_model import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "models", "repolm512_q8.gguf")
BASE = ["-m", MODEL, "--device", "cpu", "-n", "4"]


def test_generate_on_cpu(capsys):
    assert cli.main(BASE + ["-p", "def f(x):", "-t", "0"]) == 0
    err = capsys.readouterr().err
    assert "decode:  4 tok" in err


def test_sampled_generate_and_verbose_on_cpu(capsys):
    assert cli.main(BASE + ["-p", "import ", "-v"]) == 0
    err = capsys.readouterr().err
    assert "engine/prefill" in err and "cuda" in err


def test_kv_int8_generate_on_cpu(capsys):
    assert cli.main(BASE + ["-p", "def f(x):", "-t", "0", "--kv-int8"]) == 0
    assert "decode:  4 tok" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [[], ["--kv-int8", "--prefix-cache", "2"]],
                         ids=["bf16", "int8-prefix-cache"])
def test_serve_on_cpu(flags, tmp_path, capsys):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("def f(x):\nimport numpy\n\nclass A:\n")
    assert cli.main(BASE + ["--serve", str(prompts), "-t", "0",
                            "--batch-size", "2"] + flags) == 0
    out = capsys.readouterr()
    assert out.out.count("### ") == 3
    assert "served 3 requests, 12 tokens" in out.err


def test_benchmark_on_cpu(capsys):
    assert cli.main(BASE + ["--benchmark", "--bench-tokens", "3"]) == 0
    assert "decode:  3 tok" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--http", "8080"], ["--chat"],
    ["--tp", "2"], ["--cp", "2", "--tp", "2"], ["--ep", "2"], ["--dp", "2"],
    ["--self-spec"], ["--draft-model", "d.gguf"], ["--spec-k", "2"],
], ids=lambda f: f[0])
def test_unported_modes_exit_2_naming_the_roadmap(flags, capsys):
    assert cli.main(BASE + flags) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP" in err


def test_delta_model_refused(capsys):
    assert cli.main(BASE + ["--delta-model", "x.ntd"]) == 2


@pytest.fixture(scope="module")
def model_copy(tmp_path_factory):
    """repolm512 in a directory of its own: the tiered loader writes its
    pack beside the model."""
    path = tmp_path_factory.mktemp("cli") / "repolm512_q8.gguf"
    shutil.copy(MODEL, path)
    return str(path)


@pytest.mark.parametrize("flags,env,tiers", [
    (["--streaming"], {}, None),
    (["--max-hbm-layers", "2", "--max-ram-layers", "3"], {},
     "tiers: 2 HBM + 3 RAM + 1 disk"),
    (["--requant-q4k", "--max-hbm-layers", "1"], {}, "tiers: 1 HBM"),
    (["--streaming", "--kv-int8", "--requant-ram", "--early-exit", "0.99"],
     {"NT_MAX_HBM_LAYERS": "4", "NT_MAX_RAM_LAYERS": "2"},
     "tiers: 4 HBM + 2 RAM + 0 disk"),
    (["--streaming"], {"NT_H2D": "planes", "NT_DIRECT_IO": "0",
                       "NT_REQUANT_RAM": "q4_k", "NT_MAX_HBM_LAYERS": "0"},
     "tiers: 0 HBM"),
], ids=["streaming", "tier_caps", "requant_q4k", "int8_env_caps",
        "env_switches"])
def test_streaming_on_cpu(model_copy, flags, env, tiers, monkeypatch,
                          capsys):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    base = ["-m", model_copy, "--device", "cpu", "-n", "4"]
    assert cli.main(base + ["-p", "def f(x):", "-t", "0"] + flags) == 0
    err = capsys.readouterr().err
    assert "decode:  4 tok" in err and "tiered streaming" in err
    if tiers:
        assert tiers in err


def test_streaming_benchmark_on_cpu(model_copy, capsys):
    base = ["-m", model_copy, "--device", "cpu"]
    assert cli.main(base + ["--streaming", "--max-hbm-layers", "1",
                            "--benchmark", "--bench-tokens", "3"]) == 0
    assert "decode:  3 tok" in capsys.readouterr().err


@pytest.mark.parametrize("flags,says", [
    (["--serve", "p.txt", "--streaming"], "do not compose"),
    (["--w4a8", "--streaming"], "resident single-chip modes"),
    (["--w8a8", "--max-hbm-layers", "2"], "resident single-chip modes"),
], ids=["serve", "w4a8", "w8a8"])
def test_streaming_refusals_match_jax(flags, says, capsys):
    """The JAX CLI's refusals of streaming with --serve and with the
    engine-native formats: the same exit code and message."""
    assert cli.main(BASE + flags) == 2
    port_err = capsys.readouterr().err
    assert jcli.main(["-m", MODEL, "-n", "4"] + flags) == 2
    jax_err = capsys.readouterr().err
    assert says in port_err and says in jax_err
    tail = lambda e: e.strip().splitlines()[-1].split(": ", 1)[-1]
    assert tail(port_err).endswith(tail(jax_err)[-60:])


def test_self_spec_stays_refused(capsys):
    """The JAX CLI streams for --self-spec; the port refuses it until
    speculation is ported."""
    assert cli.main(BASE + ["--self-spec"]) == 2
    assert "item 13" in capsys.readouterr().err


@pytest.mark.parametrize("dot", ["int8", "int8_s", "int8_v", "bf16"])
def test_serve_attn_dot_env(dot, tmp_path, monkeypatch, capsys):
    """NT_ATTN_DOT picks the batched flash cache-dot form of --serve."""
    monkeypatch.setenv("NT_ATTN_DOT", dot)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("def f(x):\nimport numpy\n")
    assert cli.main(BASE + ["--serve", str(prompts), "-t", "0",
                            "--batch-size", "2", "--kv-int8"]) == 0
    assert "served 2 requests, 8 tokens" in capsys.readouterr().err


def test_serve_attn_dot_env_refuses_unknown(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("NT_ATTN_DOT", "fp8")
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("def f(x):\n")
    assert cli.main(BASE + ["--serve", str(prompts)]) == 2
    assert "NT_ATTN_DOT" in capsys.readouterr().err


@pytest.mark.parametrize("buckets", [None, "0", "2"], ids=["unset", "0", "2"])
def test_serve_attn_buckets_env_matches_jax(buckets, tmp_path, monkeypatch,
                                            capsys):
    """NT_ATTN_BUCKETS sets --serve's s_live ladder as it sets the JAX
    BatchServer's (unset: 4 rungs; "0": none)."""
    from ntransformer_tpu.inference.serve import BatchServer as JBatchServer
    from ntransformer_tpu.models.loader import load_model as jax_load_model
    from ntransformer_tpu_torch.inference import serve as pserve
    from tools.make_test_gguf import write_model
    if buckets is None:
        monkeypatch.delenv("NT_ATTN_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("NT_ATTN_BUCKETS", buckets)
    path = write_model(str(tmp_path / "tiny.gguf"), "tiny", "q8_0", seed=3)
    servers = []

    class Recording(pserve.BatchServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)
    monkeypatch.setattr(pserve, "BatchServer", Recording)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("alpha beta\n")
    assert cli.main(["-m", path, "--device", "cpu", "-n", "2", "-t", "0",
                     "--serve", str(prompts), "--batch-size", "2"]) == 0
    capsys.readouterr()
    want = JBatchServer(jax_load_model(path), batch_size=2)._attn_ladder
    assert servers[0]._attn_ladder == want
    assert bool(want) == (buckets != "0")
