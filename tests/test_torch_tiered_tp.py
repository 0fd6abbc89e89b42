"""Port parity for tiered streaming over a tensor-parallel mesh
(load_model_tiered(mesh=), the streamer's shard-major staging, TieredKV
over a mesh, TieredEngine) on the CPU, with every shard on the CPU.

Tolerances, and why:
  * against the port's resident TP forward (TPEngine's shards of the same
    file): bit for bit (torch.equal). The streamed shards hold the same
    planes, every layer runs the same tp_layer_step, and the partials are
    summed in the same order;
  * against the port's unsharded resident forward: the JAX suite's limits
    for tiered TP against one device (tests/test_tiered.py:355-363: rtol
    1e-4 with atol 2e-4 at the prefill, 5e-4 at a decode step); only the
    order of the shards' f32 sums differs;
  * against the JAX package's tiered TP forward: the resident suite's
    cross-package limits (tests/test_torch_model.py), LOGIT_RTOL = 5e-3 of
    the largest logit with a bf16 cache, INT8_LOGIT_RTOL = 2e-2 with the
    int8 one;
  * requant_ram x TP against single-device requant_ram: the JAX suite's
    rtol 1e-4, atol 5e-4 (tests/test_tiered.py:700).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ntransformer_tpu.inference.engine import GenerateConfig as JGenConfig
from ntransformer_tpu.inference.engine import TieredEngine as JTieredEngine
from ntransformer_tpu.models import tiered as jtiered
from ntransformer_tpu.parallel.tp import TP_AXIS
from ntransformer_tpu_torch.core.dtypes import DType
from ntransformer_tpu_torch.inference.engine import (GenerateConfig,
                                                     TieredEngine, TPEngine)
from ntransformer_tpu_torch.memory import pack as ppack
from ntransformer_tpu_torch.models import llama as pllama
from ntransformer_tpu_torch.models import tiered as ptiered
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.parallel import tp as ptp
from test_torch_model import INT8_LOGIT_RTOL, LOGIT_RTOL, \
    one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

GB = 1 << 30
PADDED = [1, 5, 9, 0, 0, 0, 0, 0]   # a bucketed prefill, n_valid 3
CFG = dict(max_tokens=6, temperature=0.0, repeat_penalty=1.0)


def _mesh(tp):
    return ptp.make_tp_mesh(tp, ["cpu"] * tp)


def _jax_mesh(tp):
    return Mesh(np.asarray(jax.devices()[:tp]), (TP_AXIS,))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiered_tp")
    return {"tiny": write_model(str(d / "tiny.gguf"), "tiny", "q8_0",
                                seed=3),
            "t512": write_model(str(d / "t512.gguf"), "tiny512", "q8_0",
                                seed=6),
            "q6": write_model(str(d / "t512_q6k.gguf"), "tiny512", "q6_k",
                              seed=17)}


def _port(path, hbm, ram, tp=2, **kw):
    return ptiered.load_model_tiered(
        path, max_hbm_layers=hbm, max_ram_layers=ram, hbm_bytes=64 * GB,
        ram_bytes=64 * GB, device="cpu",
        mesh=None if tp is None else _mesh(tp), **kw)


def _run(tm, steps=2, quant=False):
    """Prefill (bucketed, n_valid 3) and greedy steps: [logits]."""
    kv = ptiered.TieredKV.create(tm.arch, tm.tiers, quant=quant,
                                 device="cpu", mesh=tm.mesh)
    lg, kv, _ = ptiered.forward_tiered(tm, kv, PADDED, 0, n_valid=3)
    out = [lg]
    for i in range(steps):
        lg, kv, _ = ptiered.forward_tiered(
            tm, kv, [int(torch.argmax(out[-1][0]))], 3 + i)
        out.append(lg)
    return out


def _resident(path, toks_from, tp=None, quant=False):
    """The port's resident forward (unsharded, or TP over tp shards) fed
    the tokens the tiered run chose."""
    m = load_model(path, device="cpu")
    if tp is None:
        w, kv, kw = m.weights, pllama.KVCache.create(m.arch, quant=quant,
                                                     device="cpu"), {}
    else:
        mesh = _mesh(tp)
        w, kv = ptp.shard_weights(m.weights, mesh, m.arch), \
            ptp.make_tp_kv(m.arch, mesh, quant)
        kw = {"tp": mesh}
    lg, kv, _ = pllama.forward(m.arch, w, kv, PADDED, 0, n_valid=3, **kw)
    out = [lg]
    for i, prev in enumerate(toks_from[:-1]):
        lg, kv, _ = pllama.forward(m.arch, w, kv,
                                   [int(torch.argmax(prev[0]))], 3 + i, **kw)
        out.append(lg)
    return out


def _jax_run(path, hbm, ram, tp, steps=2, quant=False, **kw):
    jm = jtiered.load_model_tiered(path, max_hbm_layers=hbm,
                                   max_ram_layers=ram, hbm_bytes=64 * GB,
                                   ram_bytes=64 * GB, mesh=_jax_mesh(tp),
                                   **kw)
    kv = jtiered.TieredKV.create(jm.arch, jm.tiers, tp=jm.tp, quant=quant)
    lg, kv, _ = jtiered.forward_tiered(jm, kv, jnp.asarray(PADDED, jnp.int32),
                                       0, n_valid=3)
    out = [np.asarray(lg)]
    for i in range(steps):
        lg, kv, _ = jtiered.forward_tiered(
            jm, kv, jnp.asarray([int(np.argmax(out[-1][0]))], jnp.int32),
            3 + i)
        out.append(np.asarray(lg))
    if jm.streamer is not None:
        jm.streamer.close()
    return out


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("which,tp,tiers", [
    ("tiny", 2, (1, 1)), ("tiny", 2, (0, 8)), ("t512", 4, (1, 0)),
    ("t512", 2, (0, 1))], ids=["all_tiers", "zero_resident", "tp4_disk",
                                "ram_disk"])
def test_tiered_tp_matches_resident_tp_and_jax(files, which, tp, tiers):
    path = files[which]
    tm = _port(path, *tiers, tp=tp)
    assert tm.tiers.n_hbm == tiers[0] and tm.tiers.n_streamed > 0
    got = _run(tm)
    tm.close()
    for a, b in zip(got, _resident(path, got, tp=tp)):
        assert torch.equal(a, b)
    one = _resident(path, got)
    np.testing.assert_allclose(got[0].numpy(), one[0].numpy(), rtol=1e-4,
                               atol=2e-4)
    for a, b in zip(got[1:], one[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=5e-4)
    want = _jax_run(path, *tiers, tp)
    for a, b in zip(got, want):
        assert _rel(a, b) <= LOGIT_RTOL


def test_tiered_tp_int8_cache(files):
    path = files["tiny"]
    tm = _port(path, 1, 1)
    got = _run(tm, quant=True)
    kv = ptiered.TieredKV.create(tm.arch, tm.tiers, quant=True, device="cpu",
                                 mesh=tm.mesh)
    assert kv.str[0].k.dtype == torch.int8 and kv.str[0].ks.shape[1] == 1
    tm.close()
    for a, b in zip(got, _resident(path, got, tp=2, quant=True)):
        assert torch.equal(a, b)
    for a, b in zip(got, _jax_run(path, 1, 1, 2, quant=True)):
        assert _rel(a, b) <= INT8_LOGIT_RTOL


def test_requant_ram_tp(files):
    """RAM-tier Q6_K layers requantize to Q4_K at load, then shard; the
    TP run holds to the single-device requant run (the JAX suite's limit),
    differs from the unrequantized TP run, and holds to the JAX package's
    requant_ram x TP."""
    path = files["q6"]

    def run(rq, tp):
        tm = _port(path, 0, 2, tp=tp, requant_ram=rq)
        assert tm.tiers.n_ram == 2
        assert (rq is None) or tm.streamer.ram_meta
        out = _run(tm, steps=0)[0]
        tm.close()
        return out
    tp2 = run(DType.Q4_K, 2)
    np.testing.assert_allclose(tp2.numpy(), run(DType.Q4_K, None).numpy(),
                               rtol=1e-4, atol=5e-4)
    assert not np.allclose(tp2.numpy(), run(None, 2).numpy())
    want = _jax_run(path, 0, 2, 2, steps=0, requant_ram=jtiered.DType.Q4_K)
    assert _rel(tp2, want[0]) <= LOGIT_RTOL


def test_pipeline_variants_and_shard_bytes(files):
    """Synchronous and per-plane copies give the pipelined bits; every
    shard moves its share of each layer (the counters), and a shard's
    staged planes are shard_weights' planes of that layer."""
    path = files["t512"]
    tm = _port(path, 1, 0, tp=2)   # layer 1 from disk
    s = tm.streamer
    base = _run(tm)
    s.reset_stats()
    s.synchronous = True
    assert all(torch.equal(a, b) for a, b in zip(base, _run(tm)))
    s.synchronous = False
    per_token = s.layer_nbytes(1)
    assert s.h2d_bytes == 3 * per_token == sum(s.shard_h2d_bytes)
    assert s.shard_h2d_bytes[0] == s.shard_h2d_bytes[1]
    assert s.relayout_s > 0 and s.disk_bytes == 3 * s.pack.layer_nbytes(1)
    s.prefetch_staging(1, 0)
    s.begin_h2d(1, 0)
    got = s.get_weights(0)
    s.signal_compute_done(0)
    lw = tm.pack.layer_weights(1, tm.pack.read_layer(1))
    for sh, lw_s in enumerate(got):
        want = ptp.shard_layer(lw, sh, 2, "cpu")
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            for nm, a in getattr(want, name).planes.items():
                assert torch.equal(getattr(lw_s, name).planes[nm], a), name
        assert torch.equal(lw_s.attn_norm, want.attn_norm)
    tm.close()
    tm = _port(path, 1, 0, tp=2, h2d="planes")
    assert all(torch.equal(a, b) for a, b in zip(base, _run(tm)))
    tm.close()


def test_shard_layer_meta_layout(files):
    tm = _port(files["tiny"], 1, 8, tp=None)
    meta = tm.pack.layer_meta(1)
    shards = ppack.shard_layer_meta(meta, 2)
    q = meta["tensors"]["wq"]["planes"]["qs"]["shape"]
    o = meta["tensors"]["wo"]["planes"]["qs"]["shape"]
    assert shards[0]["tensors"]["wq"]["planes"]["qs"]["shape"] == \
        [q[0], q[1] // 2]
    assert shards[1]["tensors"]["wo"]["planes"]["qs"]["shape"] == \
        [o[0] // 2, o[1]]
    assert shards[1]["base"] % 4096 == 0
    assert all(m["off"] % ppack.SHARD_ALIGN == 0
               for sm in shards for t in sm["tensors"].values()
               for m in t["planes"].values())
    tm.close()


def test_tier_budget_repeated_and_distinct_cards(files):
    """A card holding c of tp shards holds c/tp of a layer and of the fixed
    bytes: one shard a card is the JAX loader's per-shard rule, all on one
    card the whole; the CPU mesh (repeated) sizes the tiers as one device
    does."""
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert ptiered.tier_budget(tuple(cuda), 1000, 400) == (1000 // 4,
                                                           400 // 4)
    assert ptiered.tier_budget((cuda[0],) * 4, 1000, 400) == (1000, 400)
    assert ptiered.tier_budget((cuda[0], cuda[0], cuda[1], cuda[1]), 1000,
                               400) == (500, 200)
    assert ptiered.tier_budget(None, 1000, 400) == (1000, 400)
    path = files["t512"]
    tm = ptiered.load_model_tiered(path, hbm_bytes=64 * GB,
                                   ram_bytes=64 * GB, device="cpu",
                                   max_hbm_layers=0)
    layer = tm.pack.max_layer_nbytes
    fixed = (ptiered.kv_cache_bytes(tm.arch) + 2 * sum(
        a.numel() * a.element_size() for a in tm.resident.embed.planes
        .values()) + 2 * ((layer + 4095) // 4096 * 4096))
    tm.close()
    for hbm in (0.5, 1.5):
        budget = int(ptiered.WORKSPACE_BYTES + (512 << 20) + fixed
                     + hbm * layer)
        kw = dict(hbm_bytes=budget, ram_bytes=64 * GB, device="cpu")
        one = ptiered.load_model_tiered(path, **kw)
        two = ptiered.load_model_tiered(path, mesh=_mesh(2), **kw)
        assert one.tiers == two.tiers and one.tiers.n_hbm == int(hbm)
        one.close()
        two.close()


def test_tiered_engine_tp_greedy(files):
    """TieredEngine over a TP mesh: greedy text equal to TPEngine's and to
    the JAX TieredEngine's over its mesh; self-speculation drafts on the
    resident TP prefix and reproduces it."""
    path = files["tiny"]
    eng = TieredEngine.load(path, device="cpu", mesh=_mesh(2),
                            max_hbm_layers=1, max_ram_layers=1,
                            hbm_bytes=64 * GB, ram_bytes=64 * GB)
    got, _ = eng.generate("hello", GenerateConfig(**CFG))
    spec, st = eng.generate_self_speculative("hello", GenerateConfig(**CFG))
    eng.tm.close()
    assert st.drafted > 0 and spec == got
    res, _ = TPEngine.load(path, tp=2, device="cpu").generate(
        "hello", GenerateConfig(**CFG))
    je = JTieredEngine.load(path, max_hbm_layers=1, max_ram_layers=1,
                            hbm_bytes=64 * GB, ram_bytes=64 * GB,
                            mesh=_jax_mesh(2))
    want, _ = je.generate("hello", JGenConfig(**CFG))
    je.tm.streamer.close()
    assert got == res == want


def test_tiered_tp_refusals(tmp_path):
    """gemma3 x TP tiered and tiered MoE x TP are refused as the JAX package
    refuses them, with its messages."""
    g3 = write_model(str(tmp_path / "g3.gguf"), "deep", "q8_0", seed=32,
                     arch="gemma3")
    moe = write_model(str(tmp_path / "moe.gguf"), "moe", "q8_0", seed=1)
    for path, says in ((g3, "dual rope"), (moe, "TP meshes")):
        with pytest.raises(NotImplementedError, match=says) as got:
            _port(path, 1, 1)
        with pytest.raises(NotImplementedError, match=says) as want:
            jtiered.load_model_tiered(path, max_hbm_layers=1,
                                      max_ram_layers=1, hbm_bytes=64 * GB,
                                      ram_bytes=64 * GB, mesh=_jax_mesh(2))
        assert str(got.value) == str(want.value)
