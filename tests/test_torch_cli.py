"""Port CLI on the CPU: resident generation and --benchmark run; every mode
this slice does not port exits with 2 and names its ROADMAP item."""
import os

import pytest

from ntransformer_tpu_torch import cli

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


def test_benchmark_on_cpu(capsys):
    assert cli.main(BASE + ["--benchmark", "--bench-tokens", "3"]) == 0
    assert "decode:  3 tok" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--serve", "prompts.txt"], ["--http", "8080"], ["--chat"],
    ["--streaming"], ["--max-hbm-layers", "2"], ["--requant-q4k"],
    ["--tp", "2"], ["--cp", "2"], ["--ep", "2"], ["--dp", "2"],
    ["--self-spec"], ["--draft-model", "d.gguf"], ["--spec-k", "2"],
    ["--w4a8"], ["--w8a8"], ["--kv-int8"],
], ids=lambda f: f[0])
def test_unported_modes_exit_2_naming_the_roadmap(flags, capsys):
    assert cli.main(BASE + flags) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP" in err


def test_delta_model_refused(capsys):
    assert cli.main(BASE + ["--delta-model", "x.ntd"]) == 2
