"""Port parity for expert parallelism (parallel/ep.py, forward(ep=),
EPEngine, --ep) on the CPU, against the live JAX package on the conftest's
8-device CPU mesh, on the same tiny MoE GGUFs (4 experts, k = 2).

Tolerances, and why:
  * shard planes: byte-equal to the JAX package's per-shard arrays (the
    same bytes moved, nothing computed);
  * the EP forward against the JAX make_ep_forward, prefill and one decode
    step: rtol 2e-2, atol 2e-2, the JAX suite's own limit for EP against
    one device (tests/test_moe.py:210-235);
  * the T = 1 EP step against the port's one-device step on the same cache:
    bit for bit. With k = 2 a shard's term for a selection another shard
    holds is an exact zero (weight 0 times a finite product), and a sum of
    two f32 terms has the same bits in either order;
  * greedy text: identical to the JAX EPEngine's and the port's resident
    Engine's, as the JAX suite holds EPEngine (tests/test_moe.py:316-326).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ntransformer_tpu import cli as jcli
from ntransformer_tpu.inference.engine import EPEngine as JEPEngine
from ntransformer_tpu.inference.engine import GenerateConfig as JGenConfig
from ntransformer_tpu.models.llama import KVCache as JKVCache
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.parallel import ep as jep
from ntransformer_tpu_torch import cli
from ntransformer_tpu_torch.inference.engine import (EPEngine, Engine,
                                                     GenerateConfig)
from ntransformer_tpu_torch.models.llama import KVCache, forward
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.parallel import ep as pep
from test_torch_model import one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

GREEDY = dict(max_tokens=6, temperature=0.0, repeat_penalty=1.0)
PROMPT = [3, 7, 12, 9]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    return {"q8_0": write_model(str(d / "moe_q8.gguf"), "moe", "q8_0",
                                seed=122),
            "f32": write_model(str(d / "moe_f32.gguf"), "moe", "f32",
                               seed=121),
            "qwen3moe": write_model(str(d / "q3moe_q8.gguf"), "moe", "q8_0",
                                    seed=123, arch="qwen3moe"),
            "dense": write_model(str(d / "dense.gguf"), "tiny", "q8_0",
                                 seed=1)}


def _cpu_mesh(n):
    return pep.make_ep_mesh(n, ["cpu"] * n)


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices("cpu")[:n]), (jep.EP_AXIS,))


def _sharded(path, ep):
    m = load_model(path, device="cpu")
    shards = pep.shard_weights_ep(m.weights, _cpu_mesh(ep), m.arch)
    return m.arch, shards


@pytest.mark.parametrize("ep", [2, 4])
def test_shard_planes_equal_the_jax_shards(paths, ep):
    """Each shard's expert planes are the JAX package's addressable shard
    of the E axis, byte for byte; the replicated tensors are the whole
    arrays on the first device, once."""
    jm = jax_load_model(paths["q8_0"], device=False)
    jmesh = _jax_mesh(ep)
    jw = jep.shard_weights_ep(jm.weights, jmesh, jm.arch)
    arch, shards = _sharded(paths["q8_0"], ep)
    for f in pep.EXPERT_FIELDS:
        jql = getattr(jw.layers, f)
        for nm, arr in jql.planes.items():
            by_dev = {s.device: np.asarray(s.data)
                      for s in arr.addressable_shards}
            for s, dev in enumerate(jmesh.devices):
                got = getattr(shards[s].layers, f).planes[nm]
                assert got.is_contiguous()
                np.testing.assert_array_equal(got.numpy(), by_dev[dev],
                                              err_msg=f"{f}.{nm} shard {s}")
    for s in shards[1:]:
        assert s.layers.wo is shards[0].layers.wo
        assert s.embed is shards[0].embed
    specs = pep.weight_specs_ep(load_model(paths["q8_0"],
                                           device="cpu").weights)
    assert {k for k, v in specs.items() if v == "expert"} == {
        "layers." + f for f in pep.EXPERT_FIELDS}


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_forward_matches_jax_ep_forward(paths, ep):
    """A 4-token prefill and one decode step through forward(ep=) against
    the JAX make_ep_forward over the same mesh size (2e-2)."""
    jm = jax_load_model(paths["q8_0"], device=False)
    jmesh = _jax_mesh(ep)
    jw, jkv = jep.shard_model_ep(jm.weights, JKVCache.create(jm.arch),
                                 jmesh, jm.arch)
    fwd = jep.make_ep_forward(jmesh, jm.arch, weights_template=jm.weights)
    arch, shards = _sharded(paths["q8_0"], ep)
    kv = KVCache.create(arch, device="cpu")
    for toks, pos in [(PROMPT, 0), ([5], 4)]:
        want, jkv, _ = fwd(jw, jkv, jnp.asarray(toks, jnp.int32),
                           jnp.int32(pos))
        got, kv, _ = forward(arch, shards, kv, torch.tensor(toks), pos,
                             ep=_cpu_mesh(ep))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("fmt,ep,quant", [
    ("q8_0", 2, False), ("q8_0", 4, False), ("f32", 2, False),
    ("q8_0", 2, True), ("qwen3moe", 2, False)])
def test_ep_decode_step_bit_equal_to_one_device(paths, fmt, ep, quant):
    """Eight T = 1 steps through forward(ep=) on a copy of the one-device
    cache after the same prefill: logits and cache bit-equal to the port's
    one-device step (k = 2)."""
    one = load_model(paths[fmt], device="cpu")
    arch, shards = _sharded(paths[fmt], ep)
    kv1 = KVCache.create(arch, quant=quant, device="cpu")
    logits, kv1, _ = forward(arch, one.weights, kv1, torch.tensor(PROMPT), 0)
    kv2 = kv1.clone()
    tok = int(logits[0].argmax())
    for i in range(8):
        a, kv1, _ = forward(arch, one.weights, kv1, torch.tensor([tok]),
                            len(PROMPT) + i)
        b, kv2, _ = forward(arch, shards, kv2, torch.tensor([tok]),
                            len(PROMPT) + i, ep=_cpu_mesh(ep))
        assert torch.equal(a, b), f"step {i}"
        tok = int(a[0].argmax())
    assert torch.equal(kv1.k, kv2.k) and torch.equal(kv1.v, kv2.v)


@pytest.mark.parametrize("fmt,kv_quant", [("q8_0", False), ("q8_0", True),
                                          ("qwen3moe", False)])
def test_ep_engine_greedy_text_equals_jax_and_resident(paths, fmt,
                                                       kv_quant):
    """EPEngine.load(ep=2) on the CPU: the JAX EPEngine's greedy text (its
    2-device CPU mesh) and the port's resident Engine's."""
    cfg = GenerateConfig(**GREEDY)
    got, stats = EPEngine.load(paths[fmt], ep=2, device="cpu",
                               kv_quant=kv_quant).generate("hello world",
                                                           cfg)
    jeng = JEPEngine.load(paths[fmt], ep=2, kv_quant=kv_quant)
    want, _ = jeng.generate("hello world", JGenConfig(**GREEDY))
    res, _ = Engine.load(paths[fmt], device="cpu",
                         kv_quant=kv_quant).generate("hello world", cfg)
    assert got == want == res and stats.decode_tokens > 0


def test_ep_engine_benchmark_and_chat_run(paths):
    eng = EPEngine.load(paths["q8_0"], ep=2, device="cpu")
    stats = eng.benchmark(n_tokens=3)
    assert stats.decode_tokens == 3 and stats.prefill_tokens > 0
    lines = iter(["hello", ""])
    out = []
    eng.chat(GenerateConfig(**GREEDY), input_fn=lambda _: next(lines),
             print_fn=out.append)
    assert len(out) == 3 and out[1]


def test_ep_refuses_a_dense_model_and_uneven_experts(paths):
    """The JAX refusals: a dense model ("mixture-of-experts", as
    EPEngine's and weight_specs_ep's asserts say) and E % ep ("do not
    divide")."""
    dense = load_model(paths["dense"], device="cpu")
    with pytest.raises(ValueError, match="mixture-of-experts"):
        EPEngine(dense, _cpu_mesh(2))
    with pytest.raises(ValueError, match="mixture-of-experts"):
        pep.weight_specs_ep(dense.weights)
    with pytest.raises(ValueError, match="mixture-of-experts"):
        pep.shard_weights_ep(dense.weights, _cpu_mesh(2), dense.arch)
    moe = load_model(paths["q8_0"], device="cpu")
    with pytest.raises(ValueError, match="do not divide over 3 EP shards"):
        pep.shard_weights_ep(moe.weights, _cpu_mesh(3), moe.arch)
    with pytest.raises(AssertionError, match="do not divide"):
        jm = jax_load_model(paths["q8_0"], device=False)
        jep.shard_weights_ep(jm.weights, _jax_mesh(3), jm.arch)


def test_ep_engine_refuses_draft_layers_and_calibration(paths):
    """The JAX EPEngine's refusal: no draft model, layer prefix or cosine
    calibration under EP."""
    eng = EPEngine.load(paths["q8_0"], ep=2, device="cpu")
    with pytest.raises(ValueError, match="no draft model / cosine"):
        eng.generate("hi", GenerateConfig(max_tokens=2,
                                          skip_threshold=0.5))
    with pytest.raises(ValueError, match="no draft model / cosine"):
        eng.generate_self_speculative("hi", GenerateConfig(**GREEDY))
    kv = eng._make_kv()
    with pytest.raises(ValueError, match="no draft model / cosine"):
        eng._decode_step(kv, 1, 0, layer_sel=[0])


def test_ep_mesh_needs_devices():
    with pytest.raises(ValueError, match="a 3-way EP mesh needs 3"):
        pep.make_ep_mesh(3, ["cpu"] * 2)
    assert pep.ep_mesh(2, "cpu") == (torch.device("cpu"),) * 2


def test_cli_ep_prints_the_jax_text(paths, capsys):
    """--ep 2 --device cpu: the JAX CLI's --ep 2 text and the resident
    port CLI's, with --benchmark beside."""
    args = ["-m", paths["q8_0"], "-p", "hello world", "-n", "6", "-t", "0"]
    assert cli.main(args + ["--ep", "2", "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert "2-way expert parallel" in got.err
    assert jcli.main(args + ["--ep", "2"]) == 0
    assert capsys.readouterr().out == got.out
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == got.out
    assert cli.main(["-m", paths["q8_0"], "--ep", "2", "--device", "cpu",
                     "--benchmark", "--bench-tokens", "3"]) == 0
    assert "decode:  3 tok" in capsys.readouterr().err


@pytest.mark.parametrize("flags,says", [
    (["--tp", "2"], "its own mesh"),
    (["--cp", "2"], "its own mesh"),
    (["--draft-model", "MODEL"], "not supported under --tp/--cp/--ep"),
    (["--w4a8"], "resident single-chip modes"),
    (["--w8a8"], "resident single-chip modes"),
    (["--streaming"], "does not compose with tiered streaming"),
], ids=["tp", "cp", "draft", "w4a8", "w8a8", "streaming"])
def test_cli_ep_refusals_match_jax(paths, flags, says, capsys):
    """The JAX CLI's refusals of --ep (tests/test_moe.py:329-346 and
    cli.py:236-256): exit 2 and the same message."""
    flags = [paths["q8_0"] if f == "MODEL" else f for f in flags]
    args = ["-m", paths["q8_0"], "-p", "x", "-n", "2", "--ep", "2"] + flags
    assert cli.main(args + ["--device", "cpu"]) == 2
    port_err = capsys.readouterr().err
    assert jcli.main(args) == 2
    jax_err = capsys.readouterr().err
    assert says in port_err and says in jax_err
    tail = lambda e: e.strip().splitlines()[-1].split(": ", 1)[-1]
    assert tail(port_err) == tail(jax_err)


@pytest.mark.parametrize("server", ["--serve", "--http"])
def test_cli_ep_under_a_server_is_refused(paths, server, tmp_path, capsys):
    """The JAX server never reads --ep (it serves without it); the port
    refuses it: the server shards over --dp/--tp."""
    prompts = tmp_path / "p.txt"
    prompts.write_text("hello\n")
    arg = str(prompts) if server == "--serve" else "0"
    assert cli.main(["-m", paths["q8_0"], server, arg, "--ep", "2",
                     "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "does not compose with the batch server" in err
    assert "--dp" in err and "--tp" in err


def test_cli_ep_on_a_dense_model_exits_2(paths, capsys):
    assert cli.main(["-m", paths["dense"], "--ep", "2", "-p", "x",
                     "--device", "cpu"]) == 2
    assert "mixture-of-experts" in capsys.readouterr().err
