"""Port CLI on the CPU: resident generation (bf16 and --kv-int8 caches),
--benchmark and --serve run; every mode the port does not run yet exits
with 2 and names its ROADMAP item."""
import os

import pytest

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
    ["--streaming"], ["--max-hbm-layers", "2"], ["--requant-q4k"],
    ["--tp", "2"], ["--cp", "2"], ["--ep", "2"], ["--dp", "2"],
    ["--self-spec"], ["--draft-model", "d.gguf"], ["--spec-k", "2"],
], ids=lambda f: f[0])
def test_unported_modes_exit_2_naming_the_roadmap(flags, capsys):
    assert cli.main(BASE + flags) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP" in err


def test_delta_model_refused(capsys):
    assert cli.main(BASE + ["--delta-model", "x.ntd"]) == 2
