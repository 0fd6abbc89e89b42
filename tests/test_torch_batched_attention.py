"""Port parity for batched flash decode / verify (ops/cuda/batched_attention
.py): the kernel's plain twin, which CPU tensors take, against the JAX
package's Pallas kernel in interpret mode (dot_impl "f32") and against the
references the JAX suite holds that kernel to (tests/test_batched_flash.py),
on the same numpy inputs.

Tolerances. Against the interpret-mode kernel the twin computes the same
f32 arithmetic in another summation order: 1e-5 (measured 6e-7). Against
the JAX suite's references, its own limits: 2e-2 for a bf16 cache (the
reference attends a bf16 copy), 2e-4 for int8 (exact dequantized f32), 1e-6
for a stacked cache against the unstacked one and for an s_live bucket
against the whole cache."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.models.batched import batched_attention as j_batched
from ntransformer_tpu.ops.layers import attention_jnp
from ntransformer_tpu.ops.pallas.batched_attention import (
    flash_decode_batched as j_decode, flash_verify_batched as j_verify)
from ntransformer_tpu_torch.models.batched import batched_attention
from ntransformer_tpu_torch.ops.cuda import batched_attention as pba
from test_torch_model import one_torch_thread  # noqa: F401

TWIN_TOL = 1e-5


def _mk(B, Hq, Hkv, S, D, T=1, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D) if T == 1 else (B, T, Hq, D))
    k = rng.standard_normal((B, Hkv, S, D))
    v = rng.standard_normal((B, Hkv, S, D))
    kn = rng.standard_normal((B, Hkv, T, D))
    vn = rng.standard_normal((B, Hkv, T, D))
    return [a.astype(np.float32) for a in (q, k, v, kn, vn)]


def _quant(x):
    s = np.abs(x).max(-1, keepdims=True) / 127.0 + 1e-9
    return np.round(x / s).astype(np.int8), s.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    return _t(a).to(torch.bfloat16)


@pytest.mark.parametrize("group", [1, 4])
def test_decode_bf16(group):
    """Cache keys [0, pos - 1] plus the virtual row, with every cache row at
    or past pos poisoned: equal to the kernel, and to the JAX reference
    with the row written at pos."""
    B, Hkv, S, D = 3, 2, 64, 32
    q, k, v, kn, vn = _mk(B, Hkv * group, Hkv, S, D)
    pos = np.array([0, 17, 63], np.int32)
    kk, vv = k.copy(), v.copy()
    for b in range(B):
        kk[b, :, pos[b]:] = 100.0
        vv[b, :, pos[b]:] = 100.0
    scale = 1.0 / math.sqrt(D)
    got = pba.flash_decode_batched(_t(q), _bf16(kk), _bf16(vv), _t(kn),
                                   _t(vn), _t(pos), scale).numpy()
    want = np.asarray(j_decode(
        jnp.asarray(q), jnp.asarray(kk, jnp.bfloat16),
        jnp.asarray(vv, jnp.bfloat16), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pos), scale, interpret=True))
    np.testing.assert_allclose(got, want, rtol=TWIN_TOL, atol=TWIN_TOL)
    ref_k, ref_v = k.copy(), v.copy()
    knb = np.asarray(jnp.asarray(kn, jnp.bfloat16).astype(jnp.float32))
    vnb = np.asarray(jnp.asarray(vn, jnp.bfloat16).astype(jnp.float32))
    for b in range(B):
        ref_k[b, :, pos[b]] = knb[b, :, 0]
        ref_v[b, :, pos[b]] = vnb[b, :, 0]
    ref = np.asarray(j_batched(
        jnp.asarray(q), jnp.asarray(ref_k, jnp.bfloat16),
        jnp.asarray(ref_v, jnp.bfloat16), jnp.asarray(pos), scale))
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


def test_decode_int8():
    B, Hkv, S, D = 4, 2, 128, 32
    q, k, v, kn, vn = _mk(B, 2 * Hkv, Hkv, S, D, seed=3)
    pos = np.array([5, 0, 100, 127], np.int32)
    (kc, ks), (vc, vs) = _quant(k), _quant(v)
    (knc, kns), (vnc, vns) = _quant(kn[:, :, 0]), _quant(vn[:, :, 0])
    scale = 1.0 / math.sqrt(D)
    got = pba.flash_decode_batched(
        _t(q), (_t(kc), _t(ks)), (_t(vc), _t(vs)), (_t(knc), _t(kns)),
        (_t(vnc), _t(vns)), _t(pos), scale).numpy()
    want = np.asarray(j_decode(
        jnp.asarray(q), (jnp.asarray(kc), jnp.asarray(ks)),
        (jnp.asarray(vc), jnp.asarray(vs)), (jnp.asarray(knc),
                                             jnp.asarray(kns)),
        (jnp.asarray(vnc), jnp.asarray(vns)), jnp.asarray(pos), scale,
        interpret=True))
    np.testing.assert_allclose(got, want, rtol=TWIN_TOL, atol=TWIN_TOL)
    # f32 reference on the exact dequantized values, the row merged at pos
    kf = kc.astype(np.float32) * ks
    vf = vc.astype(np.float32) * vs
    for b in range(B):
        kf[b, :, pos[b]] = knc[b].astype(np.float32) * kns[b]
        vf[b, :, pos[b]] = vnc[b].astype(np.float32) * vns[b]
    ref = np.asarray(jax.vmap(attention_jnp, (0, 0, 0, 0, None, None))(
        jnp.asarray(q).reshape(B, 1, 2 * Hkv, D), jnp.asarray(kf),
        jnp.asarray(vf), jnp.asarray(pos), 1, scale)).reshape(got.shape)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_decode_stacked_layer():
    """A stacked [L, B, Hkv, S, D] cache and a layer index read the same as
    that layer alone, and as the JAX kernel's stacked read."""
    B, Hkv, S, D, L = 2, 2, 32, 32, 3
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, 4, D)).astype(np.float32)
    k = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    pos = np.array([10, 31], np.int32)
    scale = 1.0 / math.sqrt(D)
    for li in range(L):
        got = pba.flash_decode_batched(_t(q), _bf16(k), _bf16(v), _t(kn),
                                       _t(vn), _t(pos), scale,
                                       layer=li).numpy()
        alone = pba.flash_decode_batched(_t(q), _bf16(k[li]), _bf16(v[li]),
                                         _t(kn), _t(vn), _t(pos),
                                         scale).numpy()
        np.testing.assert_allclose(got, alone, rtol=1e-6, atol=1e-6)
        want = np.asarray(j_decode(
            jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(pos), scale, layer=jnp.int32(li), interpret=True))
        np.testing.assert_allclose(got, want, rtol=TWIN_TOL, atol=TWIN_TOL)


@pytest.mark.parametrize("group", [1, 4])
def test_verify_bf16(group):
    """T = 3 causal virtual rows on poisoned caches."""
    B, Hkv, S, D, T = 3, 2, 64, 32, 3
    q, k, v, kn, vn = _mk(B, Hkv * group, Hkv, S, D, T=T)
    pos = np.array([0, 17, 61], np.int32)
    for b in range(B):
        k[b, :, pos[b]:] = 100.0
        v[b, :, pos[b]:] = 100.0
    scale = 1.0 / math.sqrt(D)
    got = pba.flash_verify_batched(_t(q), _bf16(k), _bf16(v), _t(kn), _t(vn),
                                   _t(pos), scale).numpy()
    want = np.asarray(j_verify(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pos), scale, interpret=True))
    assert got.shape == (B, T, Hkv * group, D)
    np.testing.assert_allclose(got, want, rtol=TWIN_TOL, atol=TWIN_TOL)


@pytest.mark.parametrize("T", [1, 3])
def test_int8_window_softcap_inactive(T):
    """int8 cache, sliding window, softcap and an inactive slot: frozen rows
    [0, pos + t] attended per window token, the virtual rows masked."""
    B, Hkv, S, D, group = 3, 2, 64, 32, 2
    q, k, v, kn, vn = _mk(B, Hkv * group, Hkv, S, D, T=T, seed=5)
    pos = np.array([2, 30, 59], np.int32)
    act = np.array([1, 0, 1], np.int32)
    win, cap = 24, 30.0
    scale = 1.0 / math.sqrt(D)
    (kc, ks), (vc, vs) = _quant(k), _quant(v)
    (knc, kns), (vnc, vns) = _quant(kn), _quant(vn)
    ks, vs = ks.reshape(B, Hkv, S), vs.reshape(B, Hkv, S)
    for b in range(B):
        if act[b]:
            kc[b, :, pos[b]:] = 127
            vc[b, :, pos[b]:] = 127
    fn, jfn = ((pba.flash_decode_batched, j_decode) if T == 1
               else (pba.flash_verify_batched, j_verify))
    got = fn(_t(q), (_t(kc), _t(ks)), (_t(vc), _t(vs)),
             (_t(knc), _t(kns)), (_t(vnc), _t(vns)), _t(pos), scale,
             active=_t(act), window=win, softcap=cap).numpy()
    want = np.asarray(jfn(
        jnp.asarray(q), (jnp.asarray(kc), jnp.asarray(ks)),
        (jnp.asarray(vc), jnp.asarray(vs)),
        (jnp.asarray(knc), jnp.asarray(kns)),
        (jnp.asarray(vnc), jnp.asarray(vns)), jnp.asarray(pos), scale,
        active=jnp.asarray(act), window=jnp.int32(win), softcap=cap,
        interpret=True))
    np.testing.assert_allclose(got, want, rtol=TWIN_TOL, atol=TWIN_TOL)


def test_s_live_bucket_equals_full_cache():
    """An s_live bucket covering every attended key (non-power-of-two rungs
    included, and an inactive slot's frozen row) changes nothing."""
    B, Hkv, S, D = 3, 2, 512, 32
    q, k, v, kn, vn = _mk(B, 2 * Hkv, Hkv, S, D, seed=3)
    pos = np.array([0, 101, 183], np.int32)
    act = np.array([True, True, False])
    scale = 1.0 / math.sqrt(D)
    args = (_t(q), _bf16(k), _bf16(v), _t(kn), _t(vn), _t(pos), scale)
    full = pba.flash_decode_batched(*args, active=_t(act)).numpy()
    for s_live in (192, 256, 384):
        got = pba.flash_decode_batched(*args, active=_t(act),
                                       s_live=s_live).numpy()
        np.testing.assert_allclose(got, full, rtol=1e-6, atol=1e-6)
        want = np.asarray(j_decode(
            jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(pos), scale, active=jnp.asarray(act),
            interpret=True, s_live=s_live))
        np.testing.assert_allclose(got, want, rtol=TWIN_TOL, atol=TWIN_TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_plain_batched_attention_matches_jax(int8):
    """models/batched.batched_attention, the plain path's reference (row
    already written at pos; int8 attended through a bf16 dequant)."""
    B, Hkv, S, D = 3, 2, 48, 32
    q, k, v, _, _ = _mk(B, 4, Hkv, S, D, seed=7)
    pos = np.array([0, 20, 47], np.int32)
    scale = 1.0 / math.sqrt(D)
    if int8:
        (kc, ks), (vc, vs) = _quant(k), _quant(v)
        ks, vs = ks.reshape(B, Hkv, S), vs.reshape(B, Hkv, S)
        got = batched_attention(_t(q), (_t(kc), _t(ks)), (_t(vc), _t(vs)),
                                _t(pos), scale, window=9, softcap=20.0)
        want = j_batched(jnp.asarray(q), (jnp.asarray(kc), jnp.asarray(ks)),
                         (jnp.asarray(vc), jnp.asarray(vs)),
                         jnp.asarray(pos), scale, window=jnp.int32(9),
                         softcap=20.0)
    else:
        got = batched_attention(_t(q), _bf16(k), _bf16(v), _t(pos), scale)
        want = j_batched(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos),
                         scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TWIN_TOL,
                               atol=TWIN_TOL)


def test_cpu_tensors_take_the_plain_twin():
    B, Hkv, S, D = 2, 2, 32, 64
    q, k, v, kn, vn = _mk(B, 4, Hkv, S, D, seed=1)
    before = pba.launches
    out = pba.flash_decode_batched(_t(q), _bf16(k), _bf16(v), _t(kn), _t(vn),
                                   torch.tensor([3, 31]), 0.125)
    assert pba.launches == before and out.shape == (B, 4, D)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
