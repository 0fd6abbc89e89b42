"""Port parity for data parallelism (parallel/dp.py and the TP forms of the
batched steps in models/batched.py) on the CPU, at tools/make_test_gguf.py's
tiny preset (Hkv = 2 caps tp at 2), against the live JAX package's
make_batched_decode_sharded on the conftest's 8-device CPU mesh and against
the port's own unsharded step, over two chained steps from the same
prefilled caches.

Tolerances, and why:
  * against the JAX sharded step: LOGIT_RTOL (5e-3 of the largest logit),
    the resident suite's cross-package limit (tests/test_torch_model.py);
  * against the port's unsharded step at tp = 1: rtol/atol 2e-4 for the
    first step, as tests/test_dp.py:60-61 holds the JAX package's, and atol
    5e-3 for the second, as tests/test_dp.py:69-72 does: the first step's
    k/v rows, computed in a batch of B/dp rather than B, may differ in the
    last f32 bit and then round to another bf16 in the cache; each dp group
    is also bit-equal to the unsharded step run on its slots alone (the
    same batch, so the same plans);
  * at tp = 2: rtol/atol 2e-2, the TP suite's limit (tests/test_tp.py:45-49):
    the shards' f32 partials are summed in another order than one product's
    K loop, and an activation that crosses a bf16 rounding edge moves the
    next product by a whole bf16 step (tests/test_torch_tp.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.parallel import dp as jdp
from ntransformer_tpu.parallel.multihost import make_mesh as jmake_mesh
from ntransformer_tpu_torch.models.batched import (BatchedKV,
                                                   batched_decode_step,
                                                   batched_verify_step)
from ntransformer_tpu_torch.models.llama import KVCache, forward
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.parallel import dp
from ntransformer_tpu_torch.parallel.multihost import make_mesh
from test_dp import _prefill_batch as jax_prefill_batch
from test_torch_model import LOGIT_RTOL, one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

PROMPTS = [[1, 5], [9, 2, 7], [3], [11, 12, 13, 14],
           [4, 4], [6], [8, 1], [2, 9, 9]]
# (rtol, atol) of the first and the second step against the unsharded one
TOL = {1: ((2e-4, 2e-4), (0.0, 5e-3)), 2: ((2e-2, 2e-2), (2e-2, 2e-2))}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("dp") / "dp_q8.gguf"),
                       "tiny", "q8_0", seed=12)


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def prefilled(model):
    """Each prompt prefilled into its own cache: (caches, first greedy
    tokens, positions)."""
    caches, toks = [], []
    for ids in PROMPTS:
        kv = KVCache.create(model.arch, device="cpu")
        logits, kv, _ = forward(model.arch, model.weights, kv,
                                torch.tensor(ids), 0)
        caches.append(kv)
        toks.append(int(torch.argmax(logits[0])))
    return caches, torch.tensor(toks), torch.tensor([len(p) for p in PROMPTS])


def _batched(arch, caches) -> BatchedKV:
    bkv = BatchedKV.create(arch, len(caches), device="cpu")
    for b, kv in enumerate(caches):
        bkv.insert(b, kv)
    return bkv


def _sharded_kv(mesh, arch, caches) -> list:
    """The groups' caches, each slot's heads split over its tp shards."""
    grid = dp.make_server_kv(mesh, arch, len(caches))
    h = arch.n_kv_heads // mesh.tp
    for b, kv in enumerate(caches):
        parts = [KVCache(kv.k[:, s * h:(s + 1) * h],
                         kv.v[:, s * h:(s + 1) * h]) for s in range(mesh.tp)]
        dp.insert_slot(mesh, grid, parts, b, len(caches))
    return grid


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_sharded(path, dp_n, tp_n, toks2):
    """JAX's make_batched_decode_sharded over two steps, the second fed
    toks2."""
    jm = jax_load_model(path)
    arch, w = jm.arch, jm.weights
    mesh = jmake_mesh(tp=tp_n, dp=dp_n)
    bkv, t, p, a = jax_prefill_batch(jm, PROMPTS)
    w_sh, _ = jdp.shard_server_state(mesh, arch, w, len(PROMPTS))
    _, kv_spec, _ = jdp._specs(mesh, w)
    bkv = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                       bkv, kv_spec)
    step = jdp.make_batched_decode_sharded(mesh, arch, w)
    l1, bkv = step(w_sh, bkv, t, p, a)
    l2, _ = step(w_sh, bkv, jnp.asarray(toks2, jnp.int32), p + 1, a)
    return np.asarray(l1), np.asarray(l2)


@pytest.mark.parametrize("dp_n,tp_n", [(8, 1), (4, 2)])
def test_sharded_step_matches_jax_and_unsharded(path, model, prefilled,
                                                dp_n, tp_n):
    arch = model.arch
    caches, toks, pos = prefilled
    act = torch.ones(len(PROMPTS), dtype=torch.bool)
    ref_kv = _batched(arch, caches)
    r1, _ = batched_decode_step(arch, model.weights, ref_kv, toks, pos, act)
    toks2 = torch.argmax(r1, -1)
    r2, _ = batched_decode_step(arch, model.weights, ref_kv, toks2, pos + 1,
                                act)

    mesh = make_mesh(tp=tp_n, dp=dp_n, devices=["cpu"] * (dp_n * tp_n))
    assert mesh.shape == {"dp": dp_n, "tp": tp_n}
    w, _ = dp.shard_server_state(mesh, arch, model.weights, len(PROMPTS),
                                 with_kv=False)
    kv = _sharded_kv(mesh, arch, caches)
    step = dp.make_batched_decode_sharded(mesh, arch)
    l1, kv = step(w, kv, toks, pos, act)
    l2, kv = step(w, kv, toks2, pos + 1, act)
    assert l1.shape == r1.shape and l2.shape == r2.shape
    for got, ref, (rtol, atol) in zip((l1, l2), (r1, r2), TOL[tp_n]):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol,
                                   atol=atol)
    j1, j2 = _jax_sharded(path, dp_n, tp_n, toks2.numpy())
    assert _rel(l1, j1) <= LOGIT_RTOL and _rel(l2, j2) <= LOGIT_RTOL
    if tp_n == 1:
        # every group bit-equal to the unsharded step on its slots alone
        per = len(PROMPTS) // dp_n
        for g in range(dp_n):
            sl = slice(g * per, (g + 1) * per)
            alone = _batched(arch, caches[sl])
            a1, _ = batched_decode_step(arch, model.weights, alone, toks[sl],
                                        pos[sl], act[sl])
            assert torch.equal(a1, l1[sl]), g


def test_sharded_verify_matches_unsharded(model, prefilled):
    """The verify window over a (4, 2) mesh: [B, K+1, V] in slot order,
    within the TP limit of the unsharded window."""
    arch = model.arch
    caches, toks, pos = prefilled
    act = torch.ones(len(PROMPTS), dtype=torch.bool)
    vt = torch.stack([toks, toks + 1, toks + 2], dim=1) % arch.vocab_size
    ref, _ = batched_verify_step(arch, model.weights, _batched(arch, caches),
                                 vt, pos, act)
    mesh = make_mesh(tp=2, dp=4, devices=["cpu"] * 8)
    w, _ = dp.shard_server_state(mesh, arch, model.weights, len(PROMPTS),
                                 with_kv=False)
    kv = _sharded_kv(mesh, arch, caches)
    got, _ = dp.make_batched_verify_sharded(mesh, arch)(w, kv, vt, pos, act)
    assert got.shape == ref.shape == (len(PROMPTS), 3, arch.vocab_size)
    (rtol, atol), _ = TOL[2]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol,
                               atol=atol)


def test_weights_shared_by_groups_on_one_device(model):
    """Placed once per (device, tp index): two groups on one device share
    every shard object, and each group's cache is its own contiguous
    tensor of B/dp slots and Hkv/tp heads."""
    mesh = make_mesh(tp=2, dp=2, devices=["cpu"] * 4)
    w, kv = dp.shard_server_state(mesh, model.arch, model.weights, 4)
    assert w[0][0] is w[1][0] and w[0][1] is w[1][1]
    assert w[0][0] is not w[0][1]
    a = model.arch
    for row in kv:
        for c in row:
            assert c.k.is_contiguous()
            assert tuple(c.k.shape) == (a.n_layers, 2, a.n_kv_heads // 2,
                                        a.max_seq_len, a.head_dim)
    assert kv[0][0].k.data_ptr() != kv[1][0].k.data_ptr()


def test_batch_that_does_not_divide_over_dp_is_refused(model):
    mesh = make_mesh(tp=1, dp=4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not divide over dp=4"):
        dp.shard_server_state(mesh, model.arch, model.weights, 6)
