"""Port CLI on the CPU: resident generation (bf16 and --kv-int8 caches),
--benchmark, --serve, --chat, --http, tiered streaming, speculation
(--self-spec, --draft-model, --serve --spec-k) and --serve / --http over
--tp / --dp run; every mode the port does not run yet exits with 2 and
names its ROADMAP item; the refusals the JAX CLI makes of the ported modes
are the port's too."""
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import urllib.request

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


@pytest.mark.parametrize("flags,item", [
    (["--tp", "2", "--cp", "2"], "14d"), (["--cp", "2", "--tp", "2"], "14d"),
    (["--ep", "2"], "14c"), (["--dp", "2", "--serve", "p.txt", "--ep", "2"],
                             "14c"),
], ids=lambda f: f[0] if isinstance(f, list) else "")
def test_unported_modes_exit_2_naming_the_roadmap(flags, item, capsys):
    """--tp runs alone and the sharded server runs over --tp/--dp
    (test_sharded_serve_*); CP x TP (in either flag order) is item 14d,
    --ep 14c, also under a --dp server."""
    assert cli.main(BASE + flags) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP" in err
    assert f"item {item}" in err


@pytest.mark.parametrize("flags,says", [
    (["--tp", "2", "--cp", "2"], "does not compose with the batch server"),
    (["--dp", "2", "--ep", "2"], "item 14c"),
], ids=["--tp", "--dp"])
def test_http_over_multi_gpu_axes_stays_refused(flags, says, capsys):
    """--http over --tp/--dp runs (test_http_over_tp_dp_answers); with
    --cp it stays refused with the JAX message, with --ep as item 14c."""
    assert cli.main(BASE + ["--http", "0"] + flags) == 2
    assert says in capsys.readouterr().err


def test_dp_without_a_server_is_refused_as_jax(capsys):
    """--dp shards the server's slots: without --serve/--http the JAX
    refusal, exit 2."""
    assert cli.main(BASE + ["--dp", "2"]) == 2
    port_err = capsys.readouterr().err
    assert jcli.main(["-m", MODEL, "-n", "4", "--dp", "2"]) == 2
    jax_err = capsys.readouterr().err
    tail = lambda e: e.strip().splitlines()[-1].split(": ", 1)[-1]
    assert "requires --serve or --http" in port_err
    assert tail(port_err) == tail(jax_err)


@pytest.mark.parametrize("flags,dp,tp", [(["--dp", "2"], 2, 1),
                                         (["--tp", "2", "--dp", "2"], 2, 2)],
                         ids=["dp", "tp-dp"])
def test_sharded_serve_prints_batchserver_texts(flags, dp, tp, tmp_path,
                                                capsys):
    """--serve over a mesh of CPU positions prints the texts of
    BatchServer.run over the same mesh, with the CLI's sampler settings."""
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.parallel.multihost import make_mesh
    lines = ["def f(x):", "import numpy", "class A:"]
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(lines) + "\n")
    assert cli.main(BASE + ["--serve", str(prompts), "-t", "0",
                            "--batch-size", "2"] + flags) == 0
    got = capsys.readouterr()
    assert "serving over mesh" in got.err
    assert "served 3 requests, 12 tokens" in got.err
    mesh = make_mesh(tp=tp, dp=dp, devices=["cpu"] * (dp * tp))
    srv = BatchServer(load_model(MODEL, device="cpu"), batch_size=2,
                      mesh=mesh, fuse=True, sampler_cfg=SamplerConfig(
                          temperature=0.0, top_k=40, top_p=0.95,
                          repeat_penalty=1.1, seed=42))
    reqs = [Request(prompt=p, max_tokens=4, parse_special=True)
            for p in lines]
    srv.run(reqs)
    for r in reqs:
        assert f"### {r.prompt!r}\n{r.text}\n" in got.out


@pytest.mark.parametrize("flags", [[], ["--kv-int8", "--no-fuse"]],
                         ids=["fused", "int8-unfused"])
def test_tp_generate_prints_the_jax_text(flags, capsys):
    """--tp 2 on the CPU (two shards, one process): the JAX CLI's --tp 2
    text (its 8-device CPU mesh), and the resident port CLI's."""
    args = ["-p", "def f(x):", "-t", "0", "--tp", "2"] + flags
    assert cli.main(BASE + args) == 0
    got = capsys.readouterr()
    assert "2-way TP" in got.err and "decode:  4 tok" in got.err
    assert jcli.main(["-m", MODEL, "-n", "4"] + args) == 0
    assert capsys.readouterr().out == got.out
    assert cli.main(BASE + args[:-2] + flags) == 0
    assert capsys.readouterr().out == got.out


def test_tp_benchmark_and_streaming_on_cpu(model_copy, capsys):
    base = ["-m", model_copy, "--device", "cpu", "--tp", "2"]
    assert cli.main(base + ["--benchmark", "--bench-tokens", "3"]) == 0
    assert "decode:  3 tok" in capsys.readouterr().err
    assert cli.main(base + ["-n", "4", "-p", "def f(x):", "-t", "0"]) == 0
    resident = capsys.readouterr().out
    assert cli.main(base + ["-n", "4", "-p", "def f(x):", "-t", "0",
                            "--streaming", "--max-hbm-layers", "2",
                            "--max-ram-layers", "2"]) == 0
    got = capsys.readouterr()
    assert "tiered streaming, cpu, 2-way TP" in got.err
    assert "tiers: 2 HBM + 2 RAM + 2 disk" in got.err
    assert got.out == resident


@pytest.mark.parametrize("flags,says", [
    (["--w4a8", "--tp", "2"], "resident single-chip modes"),
    (["--w8a8", "--tp", "2"], "resident single-chip modes"),
    (["--ep", "2", "--tp", "2"], "its own mesh"),
], ids=["w4a8", "w8a8", "ep"])
def test_tp_refusals_match_jax(flags, says, capsys):
    """The JAX CLI's refusals of --tp with the engine-native formats and
    with --ep: exit code 2 and the same message."""
    assert cli.main(BASE + flags) == 2
    port_err = capsys.readouterr().err
    assert jcli.main(["-m", MODEL, "-n", "4"] + flags) == 2
    jax_err = capsys.readouterr().err
    assert says in port_err and says in jax_err
    tail = lambda e: e.strip().splitlines()[-1].split(": ", 1)[-1]
    assert tail(port_err).endswith(tail(jax_err)[-60:])


def test_tp_beyond_the_cards_refused_as_jax(model_copy, monkeypatch,
                                           capsys):
    """--tp larger than the devices: the port counts the cards (one, as
    the CLI would see on a one-card host), the JAX CLI its devices (8 on
    the CPU mesh)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cli, "should_stream", lambda path, args: False)
    assert cli.main(["-m", MODEL, "-n", "4", "--tp", "2"]) == 2
    port_err = capsys.readouterr().err
    monkeypatch.undo()
    assert jcli.main(["-m", model_copy, "-n", "4", "--streaming",
                      "--tp", "16"]) == 2
    jax_err = capsys.readouterr().err
    assert "--tp 2: only 1 devices" in port_err
    assert "--tp 16: only 8 devices" in jax_err


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


@pytest.fixture(scope="module")
def spec_files(tmp_path_factory):
    """A tiny target, a tiny draft of another seed, and two copies of
    repolm512 (each tiered run writes its pack beside its model)."""
    from tools.make_test_gguf import write_model
    d = tmp_path_factory.mktemp("spec")
    out = {"tiny": write_model(str(d / "tiny.gguf"), "tiny", "q8_0", seed=3),
           "draft": write_model(str(d / "draft.gguf"), "tiny", "q8_0",
                                seed=99)}
    for who in ("port", "jax"):
        out[who] = str(d / f"repolm512_{who}.gguf")
        shutil.copy(MODEL, out[who])
    return out


@pytest.mark.parametrize("mode", ["--self-spec", "--draft-model",
                                  "--spec-k"])
def test_speculation_modes_print_the_jax_text(mode, spec_files, tmp_path,
                                              capsys):
    """--self-spec (it streams; the resident prefix drafts), --draft-model
    with --draft-k and --serve --spec-k print the JAX CLI's text, and the
    report's speculation line."""
    greedy = ["-n", "8", "-t", "0", "--repeat-penalty", "1.0"]
    if mode == "--self-spec":
        port = ["-m", spec_files["port"]]
        ref = ["-m", spec_files["jax"]]
        flags = ["--self-spec", "--max-hbm-layers", "3",
                 "--max-ram-layers", "2", "-p", "def forward(",
                 "--draft-k", "3"]
        says = "speculative: "
    elif mode == "--draft-model":
        port = ref = ["-m", spec_files["tiny"]]
        flags = ["--draft-model", spec_files["draft"], "--draft-k", "3",
                 "-p", "hello world"]
        says = "speculative: 0/"
    else:
        prompts = tmp_path / "prompts.txt"
        prompts.write_text("def f(x):\nimport numpy\nclass A:\n")
        port = ref = ["-m", MODEL]
        flags = ["--serve", str(prompts), "--batch-size", "2", "--spec-k",
                 "2", "--spec-draft-layers", "3"]
        says = " draft steps, "
    assert cli.main(port + greedy + flags + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert jcli.main(ref + greedy + flags) == 0
    want = capsys.readouterr()
    assert got.out == want.out and got.out.strip()
    assert says in got.err and says in want.err
    if mode == "--self-spec":
        assert "tiered streaming" in got.err


@pytest.mark.parametrize("flags,says", [
    (["--serve", "p.txt", "--draft-model", "d.gguf"], "do not compose"),
    (["--serve", "p.txt", "--self-spec"], "do not compose"),
    (["--draft-model", "d.gguf", "--cp", "2"], "not supported under"),
    (["--draft-model", "d.gguf", "--tp", "2"], "not supported under"),
    (["--draft-model", "d.gguf", "--ep", "2"], "not supported under"),
], ids=["serve-draft", "serve-self-spec", "draft-cp", "draft-tp",
        "draft-ep"])
def test_speculation_refusals_match_jax(flags, says, capsys):
    """The JAX CLI's refusals of the speculation modes: --serve with a draft
    or self-speculation, and a draft model with --cp/--tp/--ep; the same
    exit code 2 and message."""
    assert cli.main(BASE + flags) == 2
    port_err = capsys.readouterr().err
    assert jcli.main(["-m", MODEL, "-n", "4"] + flags) == 2
    jax_err = capsys.readouterr().err
    assert says in port_err and says in jax_err
    tail = lambda e: e.strip().splitlines()[-1].split(": ", 1)[-1]
    assert tail(port_err).endswith(tail(jax_err)[-60:])


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


@pytest.mark.parametrize("flags,says", [
    (["--serve", "p.txt", "--http", "0"], "pick one"),
    (["--http", "0", "--cp", "2"], "does not compose with the batch server"),
    (["--http", "0", "--draft-model", "d.gguf"], "do not compose"),
    (["--http", "0", "--self-spec"], "do not compose"),
    (["--http", "0", "--streaming"], "do not compose"),
], ids=["serve-http", "http-cp", "http-draft", "http-self-spec",
        "http-streaming"])
def test_http_refusals_match_jax(flags, says, capsys):
    """The JAX CLI's refusals of --http: with --serve, and with --cp,
    --draft-model, --self-spec or --streaming; exit 2, the JAX message."""
    assert cli.main(BASE + flags) == 2
    port_err = capsys.readouterr().err
    assert jcli.main(["-m", MODEL, "-n", "4"] + flags) == 2
    jax_err = capsys.readouterr().err
    assert says in port_err and says in jax_err
    tail = lambda e: e.strip().splitlines()[-1].split(": ", 1)[-1]
    assert tail(port_err) == tail(jax_err)


@pytest.fixture(scope="module")
def chat_gguf(tmp_path_factory):
    from tools.make_test_gguf import write_model
    d = tmp_path_factory.mktemp("chat")
    return write_model(str(d / "chat.gguf"), "tiny", "q8_0", seed=44,
                       chat="llama3")


@pytest.mark.parametrize("which", ["template", "raw", "tiered", "tp"])
def test_chat_prints_the_jax_text(which, chat_gguf, tmp_path, monkeypatch,
                                  capsys):
    """--chat reads turns from stdin until an empty line: the template
    (llama3 vocabulary), the raw loop (repolm512, no template), the tiered
    engine and the 2-shard TPEngine print the JAX CLI's texts (the tok/s
    lines aside)."""
    path = MODEL if which == "raw" else chat_gguf
    flags = ["-n", "5", "-t", "0", "--chat"]
    if which == "tp":
        flags += ["--tp", "2"]
    if which == "tiered":
        path = str(tmp_path / "chat.gguf")
        shutil.copy(chat_gguf, path)
        flags += ["--streaming", "--max-hbm-layers", "1"]
    lines = "def f(x):\nreturn\n\n"
    texts = lambda out: [ln for ln in out.splitlines()
                         if not ln.endswith("tok/s]")]
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    assert cli.main(["-m", path, "--device", "cpu"] + flags) == 0
    got = texts(capsys.readouterr().out)
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    assert jcli.main(["-m", path] + flags) == 0
    want = texts(capsys.readouterr().out)
    assert got == want and len(got) >= 3
    assert ("raw" if which == "raw" else "llama3 template") in got[0]


def _http_once(gguf: str, flags=()):
    """--http 0 in its own process: the bound port from its first line,
    one POST, SIGINT. Returns (response body, exit code, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ntransformer_tpu_torch", "-m", gguf,
         "--device", "cpu", "-t", "0", "--http", "0", "--batch-size", "2"]
        + list(flags),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("listening on http://127.0.0.1:"), line
        port = int(line.split(":")[2].split(" ")[0])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions",
            data=json.dumps({"prompt": "alpha beta", "max_tokens": 4}
                            ).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return body, proc.returncode, out, err


def test_http_subprocess_serves_and_drains_on_sigint(chat_gguf):
    """--http 0 in its own process: it prints the bound port, answers a
    POST with the greedy text of --serve on the same prompt, and on SIGINT
    drains and exits 0."""
    body, rc, out, err = _http_once(chat_gguf)
    assert rc == 0, err
    assert "draining" in out
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import load_model
    r = Request(prompt="alpha beta", max_tokens=4)
    BatchServer(load_model(chat_gguf, device="cpu"), batch_size=2).run([r])
    assert body["choices"][0]["text"] == r.text


@pytest.mark.parametrize("flags,dp,tp", [(["--tp", "2"], 1, 2),
                                         (["--dp", "2"], 2, 1)],
                         ids=["tp", "dp"])
def test_http_over_tp_dp_answers(chat_gguf, flags, dp, tp):
    """--http over a mesh of CPU positions answers a request with the text
    of BatchServer.run over the same mesh, and drains on SIGINT."""
    body, rc, out, err = _http_once(chat_gguf, flags)
    assert rc == 0, err
    assert "serving over mesh" in err and "draining" in out
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.parallel.multihost import make_mesh
    r = Request(prompt="alpha beta", max_tokens=4)
    BatchServer(load_model(chat_gguf, device="cpu"), batch_size=2, fuse=True,
                mesh=make_mesh(tp=tp, dp=dp, devices=["cpu"] * (dp * tp))
                ).run([r])
    assert body["choices"][0]["text"] == r.text
