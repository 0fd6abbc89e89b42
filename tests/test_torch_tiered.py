"""Port parity for tiered streaming (models/tiered.py, memory/streamer.py,
inference/engine.py TieredEngine) on the CPU: the port's forward_tiered
against the JAX package's forward_tiered on the same GGUF and the same
tiers, and against the port's own unfused resident forward.

Tolerances. Against the JAX package the logits are held to the resident
suite's limits (tests/test_torch_model.py): LOGIT_RTOL = 5e-3 of the largest
logit with a bf16 cache, INT8_LOGIT_RTOL = 2e-2 with the int8 cache (a row
code that rounds the other way moves a whole step). Against the port's own
resident forward the tiered forward runs the same operations on the same
values in the same order, so it is held bit for bit (torch.equal), and so
are its pipeline variants (synchronous, per-plane copies, buffered reads).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.core.dtypes import DType as JDType
from ntransformer_tpu.inference.engine import GenerateConfig as JGenerateConfig
from ntransformer_tpu.inference.engine import TieredEngine as JTieredEngine
from ntransformer_tpu.models import tiered as jtiered
from ntransformer_tpu_torch.core.dtypes import DType
from ntransformer_tpu_torch.inference.engine import GenerateConfig, \
    TieredEngine
from ntransformer_tpu_torch.models import llama as pllama
from ntransformer_tpu_torch.models import tiered as ptiered
from ntransformer_tpu_torch.models.loader import load_model
from test_torch_model import INT8_LOGIT_RTOL, LOGIT_RTOL, \
    one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

GB = 1 << 30
TOKENS = [1, 5, 9, 2]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("tiered") / "tiny.gguf"),
                       "tiny", "q8_0", seed=3)


@pytest.fixture(scope="module")
def tiny_q6(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("tiered6") / "q6.gguf"),
                       "tiny", "q6_k", seed=4)


@pytest.fixture(scope="module")
def resident(tiny):
    return load_model(tiny, device="cpu", fuse=False)


def _port(path, hbm, ram, **kw):
    return ptiered.load_model_tiered(path, max_hbm_layers=hbm,
                                     max_ram_layers=ram, hbm_bytes=64 * GB,
                                     ram_bytes=64 * GB, device="cpu", **kw)


def _jax(path, hbm, ram, **kw):
    return jtiered.load_model_tiered(path, max_hbm_layers=hbm,
                                     max_ram_layers=ram, hbm_bytes=64 * GB,
                                     ram_bytes=64 * GB, **kw)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _run_both(path, hbm, ram, tokens=TOKENS, quant=False, port_kw=None,
              jax_kw=None, **fw):
    tm = _port(path, hbm, ram, **(port_kw or {}))
    jm = _jax(path, hbm, ram, **(jax_kw or {}))
    kv = ptiered.TieredKV.create(tm.arch, tm.tiers, quant=quant,
                                 device="cpu")
    lt, _, ct = ptiered.forward_tiered(tm, kv, tokens, 0, **fw)
    jkv = jtiered.TieredKV.create(jm.arch, jm.tiers, quant=quant)
    lj, _, cj = jtiered.forward_tiered(jm, jkv, jnp.asarray(tokens,
                                                            jnp.int32), 0,
                                       **fw)
    tm.close()
    return lt, lj, ct, cj, tm


def _resident_logits(rm, tokens, layer_sel=None, quant=False):
    kv = pllama.KVCache.create(rm.arch, quant=quant, device="cpu")
    lr, _, _ = pllama.forward(rm.arch, rm.weights, kv, tokens, 0,
                              layer_sel=layer_sel)
    return lr


@pytest.mark.parametrize("tiers", [(1, 8), (1, 1), (0, 8), (2, 1), (4, 0)],
                         ids=["ram", "disk", "zero_resident", "all_tiers",
                              "all_resident"])
def test_tiered_matches_jax_and_resident(tiny, resident, tiers):
    lt, lj, _, _, tm = _run_both(tiny, *tiers)
    assert tm.tiers.n_layers == 4 and tm.tiers.n_hbm == min(tiers[0], 4)
    assert _rel(lt, lj) <= LOGIT_RTOL
    assert torch.equal(lt, _resident_logits(resident, TOKENS))


def test_tiered_decode_sequence(tiny, resident):
    """Prefill then three greedy steps through all three tiers: equal to the
    port's resident forward and the JAX tiered forward at every step."""
    tm = _port(tiny, 2, 1)
    jm = _jax(tiny, 2, 1)
    assert (tm.tiers.n_hbm, tm.tiers.n_ram, tm.tiers.n_disk) == (2, 1, 1)
    kv = ptiered.TieredKV.create(tm.arch, tm.tiers, device="cpu")
    kr = pllama.KVCache.create(resident.arch, device="cpu")
    jkv = jtiered.TieredKV.create(jm.arch, jm.tiers)
    toks = [1, 5, 9]
    lt, kv, _ = ptiered.forward_tiered(tm, kv, toks, 0)
    lr, kr, _ = pllama.forward(resident.arch, resident.weights, kr, toks, 0)
    lj, jkv, _ = jtiered.forward_tiered(jm, jkv, jnp.asarray(toks, jnp.int32),
                                        0)
    for step in range(3):
        assert torch.equal(lt, lr)
        assert _rel(lt, lj) <= LOGIT_RTOL
        nt = int(torch.argmax(lt[0]))
        assert nt == int(jnp.argmax(lj[0]))
        lt, kv, _ = ptiered.forward_tiered(tm, kv, [nt], 3 + step)
        lr, kr, _ = pllama.forward(resident.arch, resident.weights, kr, [nt],
                                   3 + step)
        lj, jkv, _ = jtiered.forward_tiered(jm, jkv,
                                            jnp.asarray([nt], jnp.int32),
                                            3 + step)
    tm.close()


@pytest.mark.parametrize("case", ["skip_streamed", "skip_resident",
                                  "draft_only"])
def test_tiered_skip_and_draft_only(tiny, resident, case):
    kw, sel, tiers = {
        "skip_streamed": (dict(skip=frozenset({2})), [0, 1, 3], (1, 8)),
        "skip_resident": (dict(skip=frozenset({1})), [0, 2, 3], (2, 1)),
        "draft_only": (dict(draft_only=True), [0, 1], (2, 8)),
    }[case]
    lt, lj, _, _, _ = _run_both(tiny, *tiers, tokens=[1, 5], **kw)
    assert _rel(lt, lj) <= LOGIT_RTOL
    assert torch.equal(lt, _resident_logits(resident, [1, 5], sel))


def test_tiered_early_exit(tiny, resident):
    """The JAX suite's case (tests/test_tiered.py::test_tiered_early_exit):
    the exit triggers on layer 2's cosine, so layers 0-2 run and layer 3 is
    skipped, its transfer too."""
    lt, lj, _, _, tm = _run_both(tiny, 1, 8, tokens=[1],
                                 early_exit_threshold=1e-9)
    assert _rel(lt, lj) <= LOGIT_RTOL
    assert torch.equal(lt, _resident_logits(resident, [1], [0, 1, 2]))


def test_tiered_cosines_match_jax(tiny):
    lt, lj, ct, cj, _ = _run_both(tiny, 1, 8, tokens=[1, 5],
                                  with_cosine=True)
    assert ct.shape == (4,)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tiers", [(2, 1), (2, 8)], ids=["all_tiers", "ram"])
def test_tiered_int8_kv(tiny, resident, tiers):
    """int8 KV through the tiers, prefill and a decode step: against the
    JAX int8 tiered forward and the port's int8 resident forward."""
    tm = _port(tiny, *tiers)
    jm = _jax(tiny, *tiers)
    kv = ptiered.TieredKV.create(tm.arch, tm.tiers, quant=True, device="cpu")
    assert kv.res.quantized and kv.str.quantized
    kr = pllama.KVCache.create(resident.arch, quant=True, device="cpu")
    jkv = jtiered.TieredKV.create(jm.arch, jm.tiers, quant=True)
    toks = [1, 5, 9]
    lt, kv, _ = ptiered.forward_tiered(tm, kv, toks, 0)
    lr, kr, _ = pllama.forward(resident.arch, resident.weights, kr, toks, 0)
    lj, jkv, _ = jtiered.forward_tiered(jm, jkv, jnp.asarray(toks, jnp.int32),
                                        0)
    assert torch.equal(lt, lr) and _rel(lt, lj) <= INT8_LOGIT_RTOL
    nt = int(torch.argmax(lt[0]))
    lt, kv, _ = ptiered.forward_tiered(tm, kv, [nt], 3)
    lr, kr, _ = pllama.forward(resident.arch, resident.weights, kr, [nt], 3)
    lj, jkv, _ = jtiered.forward_tiered(jm, jkv, jnp.asarray([nt], jnp.int32),
                                        3)
    assert torch.equal(lt, lr) and _rel(lt, lj) <= INT8_LOGIT_RTOL
    tm.close()


def test_requant_ram_equals_offline_requant(tiny_q6):
    """Runtime tier-B requant (every streamed layer in RAM) equals the
    offline Q4_K pack bit for bit, and the JAX runtime requant."""
    rt = _port(tiny_q6, 0, 8, requant_ram=DType.Q4_K)
    assert set(rt.streamer.ram_meta) == {0, 1, 2, 3}
    off = _port(tiny_q6, 0, 8, requant=DType.Q4_K)
    kv1 = ptiered.TieredKV.create(rt.arch, rt.tiers, device="cpu")
    kv2 = ptiered.TieredKV.create(off.arch, off.tiers, device="cpu")
    l1, _, _ = ptiered.forward_tiered(rt, kv1, TOKENS, 0)
    l2, _, _ = ptiered.forward_tiered(off, kv2, TOKENS, 0)
    assert rt.streamer.layer_nbytes(1) < rt.pack.layer_nbytes(1)
    assert torch.equal(l1, l2)
    jm = _jax(tiny_q6, 0, 8, requant_ram=JDType.Q4_K)
    lj, _, _ = jtiered.forward_tiered(
        jm, jtiered.TieredKV.create(jm.arch, jm.tiers),
        jnp.asarray(TOKENS, jnp.int32), 0)
    assert _rel(l1, lj) <= LOGIT_RTOL
    rt.close()
    off.close()


@pytest.mark.parametrize("variant", ["synchronous", "planes", "buffered"])
def test_pipeline_variants_bit_identical(tiny, variant):
    """The synchronous pipeline, one copy per plane and page-cache reads
    give the pipelined result bit for bit."""
    base = _port(tiny, 1, 1)
    kw = {"planes": dict(h2d="planes"),
          "buffered": dict(direct_io=False)}.get(variant, {})
    other = _port(tiny, 1, 1, **kw)
    if variant == "synchronous":
        other.streamer.synchronous = True
    outs = []
    for tm in (base, other):
        kv = ptiered.TieredKV.create(tm.arch, tm.tiers, device="cpu")
        lt, kv, _ = ptiered.forward_tiered(tm, kv, TOKENS, 0)
        l2, _, _ = ptiered.forward_tiered(tm, kv, [7], 4)
        outs.append((lt, l2))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    # tier C really read the disk: two streamed-from-disk layers per token
    assert base.streamer.disk_bytes > 0
    assert other.streamer.pool.direct_reads + \
        other.streamer.pool.buffered_reads > 0
    base.close()
    other.close()


def test_chunked_prefill_matches_single_shot(tiny, resident):
    tm = _port(tiny, 1, 8)
    eng = TieredEngine(tm)
    eng.PREFILL_CHUNK = 8
    ids = [(i * 7 + 3) % 50 for i in range(20)]
    logits, _, _ = eng._prefill(eng._make_kv(), ids)
    lr = _resident_logits(resident, ids)
    assert _rel(logits, lr[-1:].numpy()) <= LOGIT_RTOL
    tm.close()


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_tiered_engine_generate_matches_jax(tiny, kv_int8):
    """Greedy TieredEngine.generate: the same tokens as a live JAX
    TieredEngine on the same tiers."""
    eng = TieredEngine.load(tiny, device="cpu", kv_quant=kv_int8,
                            max_hbm_layers=1, max_ram_layers=1,
                            hbm_bytes=64 * GB, ram_bytes=64 * GB)
    jeng = JTieredEngine.load(tiny, kv_quant=kv_int8, max_hbm_layers=1,
                              max_ram_layers=1, hbm_bytes=64 * GB,
                              ram_bytes=64 * GB)
    ids = [1, 17, 42, 99, 7]
    cfg = GenerateConfig(max_tokens=8, temperature=0.0, repeat_penalty=1.0)
    jcfg = JGenerateConfig(max_tokens=8, temperature=0.0, repeat_penalty=1.0)
    text, st = eng.generate("", cfg, prompt_ids=ids)
    jtext, jst = jeng.generate("", jcfg, prompt_ids=ids)
    assert st.decode_tokens == jst.decode_tokens and text == jtext
    eng.tm.close()


def test_tiered_engine_skip_calibration(tiny):
    """A generate with skip_threshold calibrates the skip set from the
    prefill's cosines and drops those layers afterwards."""
    eng = TieredEngine.load(tiny, device="cpu", max_hbm_layers=1,
                            max_ram_layers=8, hbm_bytes=64 * GB,
                            ram_bytes=64 * GB)
    cfg = GenerateConfig(max_tokens=3, temperature=0.0, repeat_penalty=1.0,
                         skip_threshold=1e-6)  # every middle layer skips
    _, st = eng.generate("", cfg, prompt_ids=[1, 5, 9])
    assert st.skipped_layers == [1, 2] and eng.skip == frozenset({1, 2})
    stats = eng.benchmark(prompt_ids=[1, 5, 9], n_tokens=3)
    assert stats.decode_tokens == 3
    eng.tm.close()


def test_tiered_refuses_moe(tmp_path):
    """A mixture-of-experts file streams experts (models/tiered_moe.py) and
    refuses what the JAX package refuses of it: requant, of the pack or of
    the RAM tier."""
    path = write_model(str(tmp_path / "moe.gguf"), "moe", "q8_0", seed=1)
    for kw in ({"requant": DType.Q4_K}, {"requant_ram": DType.Q4_K}):
        with pytest.raises(NotImplementedError, match="requant"):
            _port(path, 1, 1, **kw)


def test_tiered_loads_moe_as_expert_streamer(tmp_path):
    """load_model_tiered hands an MoE file to the expert streamer (the JAX
    package's dispatch); forward_tiered and TieredEngine's cache take it."""
    from ntransformer_tpu_torch.models.tiered_moe import TieredMoEModel
    path = write_model(str(tmp_path / "moe.gguf"), "moe", "q8_0", seed=1)
    tm = _port(path, 1, 1)
    assert isinstance(tm, TieredMoEModel)
    assert tm.n_resident == tm.arch.n_layers
    kv = TieredEngine(tm)._make_kv()
    assert isinstance(kv, pllama.KVCache)
    got, _, _ = ptiered.forward_tiered(tm, kv, TOKENS, 0)
    res = load_model(path, device="cpu")
    want, _, _ = pllama.forward(res.arch, res.weights,
                                pllama.KVCache.create(res.arch, device="cpu"),
                                TOKENS, 0)
    assert torch.equal(got, want)
    tm.close()


def test_tiered_kv_bytes_match_jax():
    from ntransformer_tpu.models.llama import Arch as JArch
    arch = pllama.Arch(n_layers=32, n_heads=32, n_kv_heads=8, head_dim=128,
                       hidden_size=4096, intermediate_size=14336,
                       vocab_size=128256, norm_eps=1e-5, rope_theta=5e5,
                       rope_interleaved=False, max_seq_len=4096)
    jarch = JArch(**dataclasses.asdict(arch))
    for quant in (False, True):
        assert ptiered.kv_cache_bytes(arch, quant) == \
            jtiered.kv_cache_bytes(jarch, quant)


def test_profiler_folds_completed_copies():
    """record_copy keeps events only for copies in flight: completed ones
    are folded into the totals that copy_stats reports."""
    from ntransformer_tpu_torch.utils.timing import Profiler

    class Event:
        def __init__(self, t, done):
            self.t, self.done = t, done

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

        def elapsed_time(self, end):
            return end.t - self.t

    prof = Profiler()
    for i in range(100):
        prof.record_copy("h2d", Event(i, True), Event(i + 0.5, True), 10)
    assert len(prof._copies["h2d"]) == 0
    late = Event(200.25, False)
    prof.record_copy("h2d", Event(200, True), late, 7)
    assert len(prof._copies["h2d"]) == 1
    assert prof.copy_stats("h2d") == (101, 1007, 50.25)
    assert "h2d" in prof.summary()
    prof.reset()
    assert prof.copy_stats("h2d") == (0, 0, 0.0)
