"""Port parity for tiered mixture-of-experts (models/tiered_moe.py,
memory/experts.py ExpertStreamer, TieredEngine on an MoE file) on the CPU.
Mirrors tests/test_tiered_moe.py case for case: the streamed forward
against the JAX package's forward_tiered_moe on the same file, and against
the port's own resident forward, which it equals bit for bit (the same
operations on the same planes in the same order: a streamed expert's
planes are views of its pack bytes, the resident ones views of the stacked
planes, and the select's plain twin gathers the same values). The
streamer's hit, miss, demand and prefetch counts equal the JAX streamer's
on the same tokens.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.inference.engine import GenerateConfig as JGenerateConfig
from ntransformer_tpu.inference.engine import TieredEngine as JTieredEngine
from ntransformer_tpu.models import llama as jl
from ntransformer_tpu.models import tiered_moe as jtm
from ntransformer_tpu.models.tiered import load_model_tiered as jload_tiered
from ntransformer_tpu_torch.core.dtypes import DType
from ntransformer_tpu_torch.inference.engine import (Engine, GenerateConfig,
                                                     TieredEngine)
from ntransformer_tpu_torch.models import llama as pl
from ntransformer_tpu_torch.models import tiered as ptiered
from ntransformer_tpu_torch.models import tiered_moe as ptm
from ntransformer_tpu_torch.models.loader import load_model
from test_torch_model import INT8_LOGIT_RTOL, LOGIT_RTOL, \
    one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

GB = 1 << 30
TOKENS = [1, 5, 9, 2]


@pytest.fixture(scope="module")
def moe_gguf(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("tmoe") / "moe_q8.gguf"),
                       "moe", "q8_0", seed=21)


@pytest.fixture(scope="module")
def resident(moe_gguf):
    return load_model(moe_gguf, device="cpu")


@pytest.fixture(scope="module")
def tmoe(moe_gguf):
    tm = ptiered.load_model_tiered(moe_gguf, hbm_bytes=64 * GB,
                                   ram_bytes=64 * GB, device="cpu")
    assert isinstance(tm, ptm.TieredMoEModel)
    yield tm
    tm.close()


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _res_step(resident, quant=False):
    kv = pl.KVCache.create(resident.arch, quant=quant, device="cpu")
    return lambda toks, pos: pl.forward(resident.arch, resident.weights, kv,
                                        toks, pos)[0]


def _tm_step(tm, quant=False):
    kv = pl.KVCache.create(tm.arch, quant=quant, device="cpu")
    return lambda toks, pos: ptm.forward_tiered_moe(tm, kv, toks, pos)[0]


def test_tiered_moe_prefill_parity(tmoe, resident, moe_gguf):
    """The streamed prefill (every expert through the LRU once) equals the
    resident prefill bit for bit and the JAX package's within LOGIT_RTOL."""
    got = _tm_step(tmoe)(TOKENS, 0)
    assert torch.equal(got, _res_step(resident)(TOKENS, 0))
    jm = jload_tiered(moe_gguf, hbm_bytes=64 * GB, ram_bytes=64 * GB)
    want, _, _ = jtm.forward_tiered_moe(jm, jl.KVCache.create(jm.arch),
                                        jnp.asarray(TOKENS, jnp.int32), 0)
    jm.estreamer.close()
    assert _rel(got, want) <= LOGIT_RTOL


def test_tiered_moe_decode_parity_and_hits(tmoe, resident, moe_gguf):
    """Six greedy decode steps: the resident tokens and logits bit for bit,
    and the prediction counters equal to the JAX streamer's."""
    jm = jload_tiered(moe_gguf, hbm_bytes=64 * GB, ram_bytes=64 * GB)
    jkv = jl.KVCache.create(jm.arch)
    jlt, jkv, _ = jtm.forward_tiered_moe(jm, jkv, jnp.asarray(TOKENS), 0)
    step_t, step_r = _tm_step(tmoe), _res_step(resident)
    lt, lr = step_t(TOKENS, 0), step_r(TOKENS, 0)
    tmoe.estreamer.reset_stats()
    jm.estreamer.reset_stats()
    for i in range(6):
        nt = int(torch.argmax(lt[-1]))
        assert nt == int(torch.argmax(lr[-1])) \
            == int(np.argmax(np.asarray(jlt)[-1])), i
        lt, lr = step_t([nt], 4 + i), step_r([nt], 4 + i)
        jlt, jkv, _ = jtm.forward_tiered_moe(
            jm, jkv, jnp.asarray([nt], jnp.int32), 4 + i)
        assert torch.equal(lt, lr), i
        assert _rel(lt, jlt) <= LOGIT_RTOL, i
    st, jst = tmoe.estreamer.stats(), jm.estreamer.stats()
    jm.estreamer.close()
    assert st["hits"] + st["misses"] == 6 * tmoe.arch.n_layers \
        * tmoe.arch.n_experts_used
    assert st["hit_rate"] > 0.5, st
    for key in ("hits", "misses", "demand_loads", "prefetches", "cached"):
        assert st[key] == jst[key], key


def test_tiered_moe_lru_eviction_correct(moe_gguf, resident):
    """An LRU of 2 expert sets, smaller than a token's working set: evictions
    and demand loads, and the resident logits bit for bit."""
    tm = ptm.load_model_tiered_moe(moe_gguf, hbm_expert_slots=2,
                                   device="cpu")
    step_t, step_r = _tm_step(tm), _res_step(resident)
    lt, lr = step_t([1, 5, 9], 0), step_r([1, 5, 9], 0)
    assert torch.equal(lt, lr)
    nt = int(torch.argmax(lt[-1]))
    assert torch.equal(step_t([nt], 3), step_r([nt], 3))
    st = tm.estreamer.stats()
    assert st["cached"] <= 2 and st["evictions"] > 0 and st["misses"] > 0
    tm.close()


def test_tiered_moe_disk_tier(moe_gguf, resident):
    """ram_bytes=0 serves every expert from its pack sub-range (the disk
    tier through the staging ring; an LRU of 3 sets, half a token's working
    set, so decode reads the disk too): the resident logits bit for bit,
    with the prefetched disk reads landing as hits."""
    tm = ptm.load_model_tiered_moe(moe_gguf, ram_bytes=0, hbm_expert_slots=3,
                                   device="cpu")
    est = tm.estreamer
    assert not est.ram_blobs and est.stages
    step_t, step_r = _tm_step(tm), _res_step(resident)
    lt, lr = step_t(TOKENS, 0), step_r(TOKENS, 0)
    assert torch.equal(lt, lr)
    assert est.stats()["disk_bytes"] > 0
    est.reset_stats()
    for i in range(3):
        nt = int(torch.argmax(lt[-1]))
        lt, lr = step_t([nt], 4 + i), step_r([nt], 4 + i)
        assert torch.equal(lt, lr), i
    st = est.stats()
    assert st["disk_bytes"] > 0 and st["prefetches"] > 0 and st["hits"] > 0
    assert est.pool.direct_reads + est.pool.buffered_reads > 0
    tm.close()


def test_tiered_moe_engine_generate(moe_gguf):
    """TieredEngine drives the MoE file end to end: the resident Engine's
    greedy text and the JAX TieredEngine's."""
    cfg = dict(max_tokens=6, temperature=0.0, repeat_penalty=1.0)
    eng = TieredEngine.load(moe_gguf, max_seq_len=128, device="cpu")
    assert isinstance(eng.tm, ptm.TieredMoEModel)
    text, stats = eng.generate("alpha beta", GenerateConfig(**cfg))
    assert stats.decode_tokens > 0
    res, _ = Engine.load(moe_gguf, max_seq_len=128, device="cpu").generate(
        "alpha beta", GenerateConfig(**cfg))
    want, _ = JTieredEngine.load(moe_gguf, max_seq_len=128).generate(
        "alpha beta", JGenerateConfig(**cfg))
    assert text == res == want
    eng.tm.close()


def test_tiered_moe_int8_kv(tmoe, moe_gguf):
    """The int8 cache composes with expert streaming: within the int8
    class's bound of the bf16 cache, and of the JAX package's int8 run."""
    lq = _tm_step(tmoe, quant=True)(TOKENS, 0)
    lf = _tm_step(tmoe)(TOKENS, 0)
    assert _rel(lq, lf.numpy()) < 0.05
    jm = jload_tiered(moe_gguf, hbm_bytes=64 * GB, ram_bytes=64 * GB)
    want, _, _ = jtm.forward_tiered_moe(
        jm, jl.KVCache.create(jm.arch, quant=True),
        jnp.asarray(TOKENS, jnp.int32), 0)
    jm.estreamer.close()
    assert _rel(lq, want) <= INT8_LOGIT_RTOL


def test_tiered_moe_refusals(tmoe, moe_gguf):
    """Layer skip and the resident draft stream layers: refused with the
    JAX package's type and message; so is requant (either pack or RAM)."""
    kv = pl.KVCache.create(tmoe.arch, device="cpu")
    with pytest.raises(NotImplementedError, match="dense-tiered"):
        ptm.forward_tiered_moe(tmoe, kv, [1], 0, draft_only=True)
    with pytest.raises(NotImplementedError, match="dense-tiered"):
        ptm.forward_tiered_moe(tmoe, kv, [1], 0, skip=frozenset({1}))
    with pytest.raises(NotImplementedError, match="dense-tiered"):
        ptm.forward_tiered_moe(tmoe, kv, [1], 0, early_exit_threshold=0.9)
    for kw in ({"requant": DType.Q4_K}, {"requant_ram": DType.Q4_K}):
        with pytest.raises(NotImplementedError, match="requant"):
            ptiered.load_model_tiered(moe_gguf, device="cpu", **kw)
