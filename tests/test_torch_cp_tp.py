"""Port parity for the CP x TP compose (parallel/cp.py make_cp_tp_mesh,
forward(cp=, tp=), CPEngine over a (cp, tp) mesh, --cp N --tp M) on the
CPU, against the live JAX package on the conftest's 8-device CPU mesh, on
the same tiny GGUF (Hkv = 2 caps tp at 2).

Tolerances, and why: the CP x TP forward against the JAX
make_cp_tp_forward at rtol 1e-4, atol 3e-4, the JAX suite's limit for the
compose against the resident forward (tests/test_cp.py:126-143; the port
and JAX forwards of the compose run the same shard plan, their logits
measured within 2e-7 of each other); greedy text identical to the JAX
resident Engine's and CPEngine's (tests/test_cp.py:109-123) and to the
port's resident Engine's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu import cli as jcli
from ntransformer_tpu.inference.engine import CPEngine as JCPEngine
from ntransformer_tpu.inference.engine import Engine as JEngine
from ntransformer_tpu.inference.engine import GenerateConfig as JGenConfig
from ntransformer_tpu.models.llama import KVCache as JKVCache
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.parallel import cp as jcp
from ntransformer_tpu_torch import cli
from ntransformer_tpu_torch.inference.engine import (CPEngine, Engine,
                                                     GenerateConfig)
from ntransformer_tpu_torch.models.llama import forward
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.parallel import cp as pcp
from ntransformer_tpu_torch.parallel import tp as ptp
from test_torch_model import one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

GREEDY = dict(max_tokens=6, temperature=0.0, repeat_penalty=1.0)
# a prefill at 0, one that straddles CP shard boundaries, a decode step
STEPS = [([1, 5, 9, 2, 7, 3, 8, 4], 0), ([6, 6, 2, 9], 124), ([3], 128)]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("cptp") / "cp_q8.gguf"),
                       "tiny", "q8_0", seed=13)


def _cpu_mesh(cp, tp):
    return pcp.make_cp_tp_mesh(cp, tp, ["cpu"] * (cp * tp))


@pytest.mark.parametrize("cp,tp", [(4, 2), (2, 2), (1, 2)])
def test_cp_tp_forward_matches_jax(tiny, cp, tp):
    jm = jax_load_model(tiny)
    jmesh = jcp.make_cp_tp_mesh(cp=cp, tp=tp)
    jw, jkv = jcp.shard_cp_tp(jm.weights, JKVCache.create(jm.arch), jmesh,
                              jm.arch)
    fwd = jcp.make_cp_tp_forward(jmesh, jm.arch, weights_template=jm.weights)
    m = load_model(tiny, device="cpu")
    mesh = _cpu_mesh(cp, tp)
    shards = ptp.shard_weights(m.weights, mesh[0], m.arch)
    kv = pcp.make_cp_tp_kv(m.arch, mesh)
    for toks, pos in STEPS:
        want, jkv, _ = fwd(jw, jkv, jnp.asarray(toks, jnp.int32),
                           jnp.int32(pos))
        got, kv, _ = forward(m.arch, shards, kv, torch.tensor(toks), pos,
                             cp=mesh, tp=mesh[0])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=3e-4)


def test_cp_tp_cache_grid_and_weights(tiny):
    """The [tp][cp] cache grid: TP shard s's heads and CP slice c's rows,
    [L, Hkv/tp, S/cp, D] each, bf16, on mesh[c][s]; CPEngine's weights are
    tp.shard_weights over the mesh's first row, and its cache is the
    grid."""
    m = load_model(tiny, device="cpu")
    a = m.arch
    mesh = pcp.make_cp_tp_mesh(2, 2, ["cpu", "meta", "cpu", "meta"])
    assert mesh == ((torch.device("cpu"), torch.device("meta")),) * 2
    grid = pcp.make_cp_tp_kv(a, mesh)
    assert len(grid) == 2 and all(len(col) == 2 for col in grid)
    for s, col in enumerate(grid):
        for c, kv in enumerate(col):
            assert tuple(kv.k.shape) == (a.n_layers, a.n_kv_heads // 2,
                                         a.max_seq_len // 2, a.head_dim)
            assert kv.k.dtype == torch.bfloat16 and not kv.quantized
            assert kv.k.device == mesh[c][s]
    cpu = _cpu_mesh(2, 2)
    eng = CPEngine(m, cpu)
    assert eng.model.weights is None and eng.device == cpu[0][0]
    want = ptp.shard_weights(load_model(tiny, device="cpu").weights,
                             cpu[0], a)
    for got, ref in zip(eng.shards, want):
        for nm, t in got.layers.wo.planes.items():
            assert torch.equal(t, ref.layers.wo.planes[nm])
    got = eng._make_kv()
    assert [[tuple(kv.k.shape) for kv in col] for col in got] == [
        [(a.n_layers, a.n_kv_heads // 2, a.max_seq_len // 2,
          a.head_dim)] * 2] * 2


@pytest.mark.parametrize("cp,tp", [(4, 2), (2, 2)])
def test_cp_tp_engine_greedy_text_equals_jax(tiny, cp, tp):
    """CPEngine over a (cp, tp) mesh: the JAX resident Engine's and JAX
    CPEngine's greedy text on the same mesh, and the port's resident
    Engine's."""
    cfg = GenerateConfig(**GREEDY)
    got, stats = CPEngine(load_model(tiny, device="cpu"),
                          _cpu_mesh(cp, tp)).generate("compose cp tp", cfg)
    want, _ = JEngine(jax_load_model(tiny)).generate("compose cp tp",
                                                     JGenConfig(**GREEDY))
    jcpe = JCPEngine(jax_load_model(tiny), jcp.make_cp_tp_mesh(cp=cp, tp=tp))
    jgot, _ = jcpe.generate("compose cp tp", JGenConfig(**GREEDY))
    res, _ = Engine(load_model(tiny, device="cpu")).generate("compose cp tp",
                                                             cfg)
    assert got == want == jgot == res and stats.decode_tokens > 0


def test_cp_tp_engine_long_prompt_chunks(tiny, monkeypatch):
    """A prompt past PREFILL_CHUNK runs the shared chunk loop with writes
    that cross the CP slices of every TP shard (tests/test_cp.py's case)."""
    monkeypatch.setattr(Engine, "PREFILL_CHUNK", 64)
    cfg = GenerateConfig(max_tokens=4, temperature=0.0, repeat_penalty=1.0)
    prompt = " ".join(["alpha beta gamma delta"] * 40)
    want, _ = Engine(load_model(tiny, device="cpu")).generate(prompt, cfg)
    eng = CPEngine.load(tiny, cp=4, tp=2, device="cpu")
    got, _ = eng.generate(prompt, cfg)
    assert got == want
    assert eng.model.weights is None and len(eng.shards) == 2


def test_cp_tp_engine_benchmark_and_refusals(tiny):
    eng = CPEngine.load(tiny, cp=2, tp=2, device="cpu")
    assert eng.benchmark(n_tokens=3).decode_tokens == 3
    with pytest.raises(NotImplementedError, match="--kv-int8 with context"):
        CPEngine.load(tiny, cp=2, tp=2, device="cpu", kv_quant=True)
    with pytest.raises(NotImplementedError, match="layer-skip"):
        eng.generate("x", GenerateConfig(max_tokens=2, skip_threshold=0.5))
    with pytest.raises(ValueError, match="a 4-way CP x TP mesh needs 4"):
        pcp.make_cp_tp_mesh(2, 2, ["cpu"] * 3)
    assert pcp.cp_tp_mesh(2, 2, "cpu") == _cpu_mesh(2, 2)


@pytest.mark.parametrize("order", ["cp-tp", "tp-cp"])
def test_cli_cp_tp_prints_the_jax_text(tiny, order, capsys):
    """--cp 2 --tp 2 in either flag order: the JAX CLI's text (its CPU
    mesh) and the resident port CLI's."""
    flags = (["--cp", "2", "--tp", "2"] if order == "cp-tp"
             else ["--tp", "2", "--cp", "2"])
    base = ["-m", tiny, "-n", "6", "-t", "0", "-p", "alpha beta gamma"]
    assert cli.main(base + flags + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert "2x2 context x tensor parallel" in got.err
    assert "decode:  6 tok" in got.err
    assert jcli.main(base + flags) == 0
    assert capsys.readouterr().out == got.out
    assert cli.main(base + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == got.out


@pytest.mark.parametrize("flags,says", [
    (["--kv-int8"], "--kv-int8 with context parallelism"),
    (["--http", "0"], "does not compose with the batch server"),
    (["--streaming"], "does not compose with tiered streaming"),
    (["--w8a8"], "resident single-chip modes"),
], ids=["kv-int8", "http", "streaming", "w8a8"])
def test_cli_cp_tp_refusals_match_jax(tiny, flags, says, capsys):
    args = ["-m", tiny, "-n", "2", "--cp", "2", "--tp", "2"] + flags
    assert cli.main(args + ["--device", "cpu"]) == 2
    port_err = capsys.readouterr().err
    try:
        code = jcli.main(args)
    except NotImplementedError as e:   # the JAX CLI raises the int8 guard
        code, jax_err = 2, str(e)
    else:
        jax_err = capsys.readouterr().err
    assert code == 2
    assert says in port_err and says in jax_err
