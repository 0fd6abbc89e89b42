"""Port parity for context parallelism (parallel/cp.py, CPEngine, --cp) on
the CPU, each piece against its live JAX twin on the conftest's 8-device
CPU mesh, on the same seeded numpy inputs and the same tiny GGUF.

Tolerances: the partials twin 2e-5 for an f32 cache and 3e-2 for bf16
(the flash kernel's limits, tests/test_flash_attention.py: the TPU kernel
rounds p to the cache dtype before the PV dot, the twin keeps f32); the two
combines 2e-5 (tests/test_cp.py); greedy text identical. The CP forward's
logits are held to the resident forward's of the same package at rtol 1e-4,
atol 3e-4 (tests/test_cp.py; both packages read 0.0). Across the packages
the resident forwards already differ by up to 3.8e-3 of the largest logit
on this model (test_torch_model.py's LOGIT_RTOL, 5e-3, says why), so the
port's CP forward is held to the JAX one through that difference: port CP
minus JAX CP equals port resident minus JAX resident, at rtol 1e-4, atol
3e-4.
"""
import warnings
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ntransformer_tpu import cli as jcli
from ntransformer_tpu.inference.engine import CPEngine as JCPEngine
from ntransformer_tpu.inference.engine import Engine as JEngine
from ntransformer_tpu.inference.engine import GenerateConfig as JGenConfig
from ntransformer_tpu.models import llama as jllama
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.ops import layers as jlayers
from ntransformer_tpu.ops.pallas.attention import \
    flash_attention_partials as jax_partials
from ntransformer_tpu.parallel import cp as jcp
from ntransformer_tpu_torch import cli
from ntransformer_tpu_torch.inference.engine import (CPEngine, Engine,
                                                     GenerateConfig)
from ntransformer_tpu_torch.models import llama as pllama
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.ops import layers as play
from ntransformer_tpu_torch.ops.cuda import attention as cuda_attn
from ntransformer_tpu_torch.parallel.cp import (make_cp_kv, make_cp_mesh,
                                                shard_rows)
from test_torch_model import one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.experimental.shard_map import shard_map

NEG_INF = np.float32(cuda_attn.NEG_INF)
CPU4 = ("cpu",) * 4


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("cp") / "cp_q8.gguf"),
                       "tiny", "q8_0", seed=13)


def _qkv(seed, t, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, hq, d)).astype(np.float32),
            rng.standard_normal((hkv, s, d)).astype(np.float32),
            rng.standard_normal((hkv, s, d)).astype(np.float32))


PARTIAL_CASES = [  # t, pos, kpos_offset, s_local, hq, hkv, d
    (8, 200, 64, 64, 8, 2, 64),     # every key of the shard visible
    (8, 100, 64, 64, 8, 4, 128),    # the shard ends past the queries
    (8, 100, 104, 64, 4, 2, 64),    # straddles: rows 0-3 see no key
    (64, 30, 64, 128, 8, 2, 64),    # straddles a 64-row query block
    (70, 10, 0, 128, 8, 4, 64),     # unbucketed T, the first shard
    (8, 100, 192, 64, 8, 2, 64),    # wholly past the queries: masked
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,pos,off,s,hq,hkv,d", PARTIAL_CASES)
def test_partials_twin_matches_pallas_interpret(t, pos, off, s, hq, hkv, d,
                                                bf16):
    q, k, v = _qkv(t + pos + off, t, hq, hkv, s, d)
    scale = 1.0 / np.sqrt(d)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    want = [np.asarray(a) for a in jax_partials(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt), pos, scale,
        kpos_offset=off, interpret=True)]
    got = [a.numpy() for a in cuda_attn.flash_attention_partials(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), pos, scale, kpos_offset=off)]
    assert [a.shape for a in got] == [a.shape for a in want] \
        == [(t, hq, d), (t, hq), (t, hq)]
    acc, m, l = got
    # a row sees a key iff the shard's first key is not past it
    sees = (pos + np.arange(t) >= off)[:, None].repeat(hq, 1)
    np.testing.assert_array_equal(m[~sees], NEG_INF)
    np.testing.assert_array_equal(want[1][~sees], NEG_INF)
    np.testing.assert_array_equal(l[~sees], 0.0)
    np.testing.assert_array_equal(acc[~sees], 0.0)
    if not sees.any():  # the TPU kernel ran no block: exactly 0, NEG_INF, 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    tol = 3e-2 if bf16 else 2e-5
    np.testing.assert_allclose(m[sees], want[1][sees], rtol=tol, atol=tol)
    np.testing.assert_allclose(l[sees], want[2][sees], rtol=tol, atol=tol)
    np.testing.assert_allclose(acc[sees], want[0][sees], rtol=tol, atol=tol)


@pytest.mark.parametrize("t,pos,off,s,hq,hkv,d", PARTIAL_CASES)
def test_partials_take_a_device_offset(t, pos, off, s, hq, hkv, d):
    """Row 2p's device-offset form: pos as a 0-d int64 tensor on q's device
    gives the host int's acc, m and l bit for bit (on the CPU, the plain
    twin, which test_partials_twin_matches_pallas_interpret holds to the
    TPU kernel; on the card the kernel reads it there, and chip_smoke.py
    holds that form to the host int's); a pos of another dtype or shape is
    refused."""
    q, k, v = _qkv(t + pos + off, t, hq, hkv, s, d)
    args = (torch.from_numpy(q), torch.from_numpy(k).to(torch.bfloat16),
            torch.from_numpy(v).to(torch.bfloat16))
    scale = 1.0 / np.sqrt(d)
    host = cuda_attn.flash_attention_partials(*args, pos, scale,
                                              kpos_offset=off)
    dev = cuda_attn.flash_attention_partials(*args, torch.tensor(pos), scale,
                                             kpos_offset=off)
    plain = cuda_attn.flash_attention_partials_plain(
        *args, torch.tensor(pos), scale, kpos_offset=off)
    for a, b, c in zip(host, dev, plain):
        assert torch.equal(a, b) and torch.equal(a, c)
    for bad in (torch.tensor(pos, dtype=torch.int32), torch.tensor([pos,
                                                                    pos])):
        with pytest.raises(ValueError, match="one int64"):
            cuda_attn.flash_attention_partials(*args, bad, scale,
                                               kpos_offset=off)


def _shard_map(fn, n, **kw):
    return shard_map(partial(fn, **kw), mesh=jcp.make_cp_mesh(n),
                     in_specs=(P(None, None, None), P(None, jcp.CP_AXIS, None),
                               P(None, jcp.CP_AXIS, None)),
                     out_specs=P(None, None, None), check_rep=False)


def _split(a, n):
    return list(torch.from_numpy(a).chunk(n, dim=1))


@pytest.mark.parametrize("pos", [0, 200])
def test_attention_cp_matches_jax(pos):
    t, hq, hkv, s, d = 4, 8, 2, 256, 64
    q, k, v = _qkv(pos, t, hq, hkv, s, d)
    want = np.asarray(_shard_map(
        jlayers.attention_cp, 8, pos_start=pos, q_len=t, scale=0.125,
        cp_axis=jcp.CP_AXIS, s_local=s // 8)(*map(jnp.asarray, (q, k, v))))
    got = play.attention_cp(torch.from_numpy(q), _split(k, 8), _split(v, 8),
                            pos, t, 0.125).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    full = play.attention_torch(*map(torch.from_numpy, (q, k, v)), pos, t,
                                0.125).numpy()
    np.testing.assert_allclose(got, full, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("pos", [0, 100, 248])
def test_attention_cp_flash_matches_jax(pos):
    t, hq, hkv, s, d = 8, 4, 2, 256, 64
    q, k, v = _qkv(7, t, hq, hkv, s, d)
    want = np.asarray(_shard_map(
        jlayers.attention_cp_flash, 4, pos_start=pos, q_len=t, scale=0.125,
        cp_axis=jcp.CP_AXIS, s_local=s // 4)(*map(jnp.asarray, (q, k, v))))
    before = cuda_attn.partials_launches
    got = play.attention_cp_flash(torch.from_numpy(q), _split(k, 4),
                                  _split(v, 4), pos, t, 0.125).numpy()
    assert cuda_attn.partials_launches == before  # the CPU takes the twin
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    plain = play.attention_cp(torch.from_numpy(q), _split(k, 4), _split(v, 4),
                              pos, t, 0.125).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-5)


def test_attention_cp_dispatch_on_cpu_is_the_plain_combine():
    q, k, v = _qkv(3, 64, 4, 2, 256, 64)
    args = (torch.from_numpy(q), _split(k, 4), _split(v, 4), 40, 64, 0.125)
    before = cuda_attn.partials_launches
    torch.testing.assert_close(play.attention_cp_dispatch(*args),
                               play.attention_cp(*args))
    assert cuda_attn.partials_launches == before


def test_cp_forward_matches_jax_and_resident(tiny):
    """4 shards of 128 rows: a prefill at 0, a window across the shard 0/1
    boundary at 124 and a decode on the boundary at 128, against the JAX
    CP forward and the port's resident forward."""
    ref = jax_load_model(tiny)
    port = load_model(tiny, device="cpu")
    arch, jw = ref.arch, ref.weights
    jmesh = jcp.make_cp_mesh(4)
    jw_cp = jcp.replicate_weights(jw, jmesh)
    jkv = jcp.shard_kv(jllama.KVCache.create(arch), jmesh)
    jfwd = jcp.make_cp_forward(jmesh, arch, weights_template=jw)
    mesh = make_cp_mesh(4, CPU4)
    kv_cp = make_cp_kv(port.arch, mesh)
    assert [s.k.shape for s in kv_cp] == [(4, 2, 128, 64)] * 4
    kv = pllama.KVCache.create(port.arch, device="cpu")
    jkv_res = jllama.KVCache.create(arch)
    for toks, pos in [([1, 5, 9, 2, 7, 3, 8, 4], 0),
                      ([6, 6, 2, 9, 1, 3, 5, 7], 124), ([5], 128)]:
        jt = jnp.asarray(toks, jnp.int32)
        want, jkv, _ = jfwd(jw_cp, jkv, jt, jnp.int32(pos))
        want_res, jkv_res, _ = jllama.forward(arch, jw, jkv_res, jt, pos)
        got, _, _ = pllama.forward(port.arch, port.weights, kv_cp, toks, pos,
                                   cp=mesh)
        resident, _, _ = pllama.forward(port.arch, port.weights, kv, toks,
                                        pos)
        got, resident = got.numpy(), resident.numpy()
        want, want_res = np.asarray(want), np.asarray(want_res)
        np.testing.assert_allclose(got, resident, rtol=1e-4, atol=3e-4)
        np.testing.assert_allclose(want, want_res, rtol=1e-4, atol=3e-4)
        np.testing.assert_allclose(got - want, resident - want_res,
                                   rtol=1e-4, atol=3e-4)
        assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()
    # the rows landed in the shards that own them, bit for bit as resident
    for i, shard in enumerate(kv_cp):
        rows = slice(i * 128, (i + 1) * 128)
        assert torch.equal(shard.k, kv.k[:, :, rows])
        assert torch.equal(shard.v, kv.v[:, :, rows])


def test_cp_forward_drops_padding_rows(tiny):
    """n_valid: padding rows past it are not written into any shard."""
    port = load_model(tiny, device="cpu")
    mesh = make_cp_mesh(4, CPU4)
    kv_cp = make_cp_kv(port.arch, mesh)
    kv = pllama.KVCache.create(port.arch, device="cpu")
    toks = [3, 1, 4, 1, 5, 9, 2, 6]
    got, _, _ = pllama.forward(port.arch, port.weights, kv_cp, toks, 124,
                               n_valid=5, cp=mesh)
    want, _, _ = pllama.forward(port.arch, port.weights, kv, toks, 124,
                                n_valid=5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=3e-4)
    assert torch.equal(kv_cp[0].k[:, :, 124:], kv.k[:, :, 124:128])
    assert torch.equal(kv_cp[1].k[:, :, :1], kv.k[:, :, 128:129])
    assert not kv_cp[1].k[:, :, 1:].any()


def test_cp_refusals():
    port_arch = pllama.Arch(4, 4, 2, 64, 256, 512, 512, 1e-5, 1e4, False, 510)
    with pytest.raises(ValueError, match="equal shards"):
        shard_rows(port_arch, 4)
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_cp_mesh(3, ["cpu", "cpu"])
    assert make_cp_mesh(2, ["cpu"] * 3) == (torch.device("cpu"),) * 2


def test_cp_forward_refuses_the_int8_cache(tiny):
    port = load_model(tiny, device="cpu")
    mesh = make_cp_mesh(2, CPU4)
    q = pllama.KVCache.create(port.arch, quant=True, device="cpu")
    with pytest.raises(NotImplementedError, match="int8 KV"):
        pllama.forward(port.arch, port.weights, [q, q], [1, 2], 0, cp=mesh)


@pytest.mark.parametrize("chunk", [None, 64], ids=["one_chunk", "chunk64"])
def test_cp_engine_generate_matches_jax_and_resident(tiny, chunk,
                                                      monkeypatch):
    if chunk:
        monkeypatch.setattr(Engine, "PREFILL_CHUNK", chunk)
        monkeypatch.setattr(JEngine, "PREFILL_CHUNK", chunk)
        prompt, n = " ".join(["alpha beta gamma delta"] * 16), 4
    else:
        prompt, n = "alpha beta gamma", 8
    ref = jax_load_model(tiny)
    want, _ = JCPEngine(ref, jcp.make_cp_mesh(4)).generate(
        prompt, JGenConfig(max_tokens=n, temperature=0.0, repeat_penalty=1.0))
    port = load_model(tiny, device="cpu")
    cfg = GenerateConfig(max_tokens=n, temperature=0.0, repeat_penalty=1.0)
    resident, _ = Engine(port).generate(prompt, cfg)
    eng = CPEngine(port, make_cp_mesh(4, CPU4))
    got, stats = eng.generate(prompt, cfg)
    assert got == want == resident
    assert stats.decode_tokens == n
    if chunk:
        assert stats.prefill_tokens > 2 * chunk  # several chunks ran


def test_cp_engine_benchmark_and_refusals(tiny):
    eng = CPEngine.load(tiny, cp=2, device="cpu")
    assert eng.mesh == (torch.device("cpu"),) * 2
    stats = eng.benchmark(n_tokens=3)
    assert stats.decode_tokens == 3 and stats.prefill_tokens > 0
    with pytest.raises(NotImplementedError, match="layer-skip"):
        eng.generate("alpha", GenerateConfig(max_tokens=2,
                                             skip_threshold=0.9))
    with pytest.raises(NotImplementedError) as e:
        CPEngine.load(tiny, cp=2, device="cpu", kv_quant=True)
    with pytest.raises(NotImplementedError) as je:
        JCPEngine.load(tiny, cp=2, kv_quant=True)
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="equal shards"):
        CPEngine.load(tiny, cp=3, device="cpu")


def test_cli_cp_prints_the_resident_text(tiny, capsys):
    base = ["-m", tiny, "--device", "cpu", "-n", "6", "-t", "0",
            "-p", "alpha beta gamma"]
    assert cli.main(base) == 0
    resident = capsys.readouterr()
    assert cli.main(base + ["--cp", "2"]) == 0
    got = capsys.readouterr()
    assert got.out == resident.out
    assert "2-way context parallel" in got.err
    assert "decode:  6 tok" in got.err
    assert cli.main(["-m", tiny, "--device", "cpu", "--cp", "4",
                     "--benchmark", "--bench-tokens", "3"]) == 0
    assert "decode:  3 tok" in capsys.readouterr().err


@pytest.mark.parametrize("flags,says", [
    (["--serve", "p.txt"], "does not compose with the batch server"),
    (["--w4a8"], "resident single-chip modes"),
    (["--w8a8"], "resident single-chip modes"),
    (["--draft-model", "d.gguf"], "not supported under --tp/--cp/--ep"),
    (["--streaming"], "does not compose with tiered streaming"),
], ids=["serve", "w4a8", "w8a8", "draft", "streaming"])
def test_cli_cp_refusals_match_jax(tiny, flags, says, capsys):
    """The JAX CLI's refusals of --cp: exit 2 with the same message."""
    assert cli.main(["-m", tiny, "--device", "cpu", "--cp", "2"]
                    + flags) == 2
    port_err = capsys.readouterr().err
    assert jcli.main(["-m", tiny, "--cp", "2"] + flags) == 2
    jax_err = capsys.readouterr().err
    assert says in port_err and says in jax_err
    tail = lambda e: e.strip().splitlines()[-1].split(": ", 1)[-1]
    assert tail(port_err).endswith(tail(jax_err)[-60:])


def test_cli_cp_refuses_kv_int8_and_tp(tiny, capsys):
    """--kv-int8 is refused with --cp, and with --cp --tp as well (CP x TP
    runs, tests/test_torch_cp_tp.py)."""
    base = ["-m", tiny, "--device", "cpu", "--cp", "2"]
    assert cli.main(base + ["--kv-int8"]) == 2
    assert "--kv-int8 with context parallelism" in capsys.readouterr().err
    assert cli.main(base + ["--tp", "2", "--kv-int8"]) == 2
    assert "--kv-int8 with context parallelism" in capsys.readouterr().err


def test_cli_cp_more_shards_than_cards_raises(tiny, monkeypatch):
    """On the card, --cp N puts one shard on each of the first N cards and
    raises when there are fewer."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cli, "should_stream", lambda path, args: False)
    with pytest.raises(ValueError, match="needs 2 devices; 1 given"):
        cli.main(["-m", tiny, "--cp", "2", "-n", "2"])
    assert make_cp_mesh(1) == (torch.device("cuda", 0),)
