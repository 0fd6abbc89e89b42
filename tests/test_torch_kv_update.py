"""Port parity for the in-place KV append (ops/cuda/kv_update.py): its plain
twins and the plain multi-row variant against the JAX package's Pallas
append kernels in interpret mode and its dynamic-update-slice variant, on
the same numpy inputs. Every result is bit-equal: the append only moves
values (a bf16 cache rounds f32 rows to nearest even in both)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.ops.pallas import kv_update as jkv
from ntransformer_tpu_torch.ops.cuda import kv_update as pkv
from test_torch_model import one_torch_thread  # noqa: F401


def _np(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _t(t: torch.Tensor):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _both(arrs, bf16=()):
    """The same numpy arrays as JAX and torch values; the indices in bf16
    become bf16 caches in both."""
    j, p = [], []
    for i, a in enumerate(arrs):
        if i in bf16:
            j.append(jnp.asarray(a, jnp.bfloat16))
            p.append(torch.from_numpy(a).to(torch.bfloat16))
        else:
            j.append(jnp.asarray(a))
            p.append(torch.from_numpy(a.copy()))
    return j, p


def test_append_rows_int8_codes_and_scales():
    """append_rows: int8 codes and [B, Hkv, S, 1] scales, an inactive slot,
    positions 0 and S - 1, two slots at one position."""
    rng = np.random.default_rng(11)
    B, Hkv, S, D = 4, 2, 32, 16
    kc = rng.integers(-100, 100, (B, Hkv, S, D)).astype(np.int8)
    ks = rng.standard_normal((B, Hkv, S, 1)).astype(np.float32)
    row_c = rng.integers(-100, 100, (B, Hkv, 1, D)).astype(np.int8)
    row_s = rng.standard_normal((B, Hkv, 1, 1)).astype(np.float32)
    pos = np.array([0, 7, 31, 7], np.int32)
    active = np.array([True, False, True, True])
    (jc, js, jrc, jrs), (pc, ps, prc, prs) = _both([kc, ks, row_c, row_s])
    want = jkv.append_rows((jc, js), (jrc, jrs), jnp.asarray(pos),
                           jnp.asarray(active), interpret=True)
    got = pkv.append_rows((pc, ps), (prc, prs), torch.from_numpy(pos),
                          torch.from_numpy(active))
    assert got[0] is pc and got[1] is ps  # written in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_t(g), _np(w))


def test_append_rows_bf16_cast():
    rng = np.random.default_rng(2)
    B, Hkv, S, D = 2, 2, 16, 8
    cache = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    row = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    pos = np.array([3, 15], np.int32)
    act = np.array([True, True])
    (jc, jr), (pc, pr) = _both([cache, row], bf16=(0,))
    (want,) = jkv.append_rows((jc,), (jr,), jnp.asarray(pos),
                              jnp.asarray(act), interpret=True)
    (got,) = pkv.append_rows((pc,), (pr,), torch.from_numpy(pos),
                             torch.from_numpy(act))
    np.testing.assert_array_equal(_t(got), _np(want))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_append_rows_stacked_matches_pallas(int8):
    """Every layer's row at once; int8 mixes 5-D codes with 4-D S-minor
    scale buffers in one call."""
    rng = np.random.default_rng(13 + int8)
    L, B, Hkv, S, D = 3, 4, 2, 128, 32
    pos = np.array([0, 40, 127, 64], np.int32)
    active = np.array([True, False, True, True])
    if int8:
        arrs = [rng.integers(-127, 127, (L, B, Hkv, S, D)).astype(np.int8),
                (rng.random((L, B, Hkv, S)) + 0.5).astype(np.float32),
                rng.integers(-127, 127, (L, B, Hkv, 1, D)).astype(np.int8),
                (rng.random((L, B, Hkv, 1, 1)) + 0.5).astype(np.float32)]
        bf16 = ()
    else:
        arrs = [rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32),
                rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32),
                rng.standard_normal((L, B, Hkv, 1, D)).astype(np.float32),
                rng.standard_normal((L, B, Hkv, 1, D)).astype(np.float32)]
        bf16 = (0, 1)
    (j0, j1, j2, j3), (p0, p1, p2, p3) = _both(arrs, bf16)
    want = jkv.append_rows_stacked((j0, j1), (j2, j3), jnp.asarray(pos),
                                   jnp.asarray(active), interpret=True)
    got = pkv.append_rows_stacked((p0, p1), (p2, p3), torch.from_numpy(pos),
                                  torch.from_numpy(active))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_t(g), _np(w))


@pytest.mark.parametrize("lr,t", [(3, 1), (2, 1), (3, 4), (1, 3)],
                         ids=["all-layers", "prefix", "window", "prefix-win"])
def test_append_rows_stacked_dus_matches_jax(lr, t):
    """The multi-row variant: a leading prefix of the layers and T rows
    per sequence (the draft and verify steps), codes and S-minor scales."""
    rng = np.random.default_rng(5 * lr + t)
    L, B, Hkv, S, D = 3, 4, 2, 64, 16
    kc = rng.integers(-127, 127, (L, B, Hkv, S, D)).astype(np.int8)
    ks = (rng.random((L, B, Hkv, S)) + 0.5).astype(np.float32)
    rc = rng.integers(-127, 127, (lr, B, Hkv, t, D)).astype(np.int8)
    rs = (rng.random((lr, B, Hkv, t, 1)) + 0.5).astype(np.float32)
    kb = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    rb = rng.standard_normal((lr, B, Hkv, t, D)).astype(np.float32)
    pos = np.array([0, 17, S - t, 30], np.int32)
    active = np.array([True, True, True, False])
    j, p = _both([kc, ks, kb, rc, rs, rb], bf16=(2,))
    want = jkv.append_rows_stacked_dus(tuple(j[:3]), tuple(j[3:]),
                                       jnp.asarray(pos), jnp.asarray(active))
    got = pkv.append_rows_stacked_dus(tuple(p[:3]), tuple(p[3:]),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(active))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_t(g), _np(w))


def test_cpu_tensors_take_the_plain_twin():
    rng = np.random.default_rng(1)
    cache = torch.from_numpy(rng.standard_normal((2, 3, 2, 16, 8))
                             .astype(np.float32)).to(torch.bfloat16)
    rows = torch.from_numpy(rng.standard_normal((2, 3, 2, 8))
                            .astype(np.float32))
    pos, act = torch.tensor([1, 5, 15]), torch.tensor([True, False, True])
    old, ref = cache.clone(), cache.clone()
    before = pkv.launches
    pkv.append_rows_stacked((cache,), (rows,), pos, act)
    pkv.append_rows_stacked_plain((ref,), (rows,), pos, act)
    assert pkv.launches == before
    assert torch.equal(cache.view(torch.int16), ref.view(torch.int16))
    assert torch.equal(cache[:, 1], old[:, 1])  # inactive: frozen
    assert torch.equal(cache[:, 0, :, 1], rows[:, 0].to(torch.bfloat16))
    assert torch.equal(cache[:, 2, :, 15], rows[:, 2].to(torch.bfloat16))
    # the kernel's dtypes hold on the CPU too
    with pytest.raises(ValueError, match="bf16, int8 or f32"):
        pkv.append_rows_stacked((cache.to(torch.float16),), (rows,), pos, act)
    with pytest.raises(ValueError, match="int8 rows"):
        pkv.append_rows(((cache[0].to(torch.int8)),), (rows[0],), pos, act)
