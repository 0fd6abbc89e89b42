"""Port parity: attention_torch and the flash kernel's plain twin against
attention_jnp and the Pallas flash kernel in interpret mode, on the same
numpy inputs; 2e-5 for f32 caches and 3e-2 for bf16 caches
(tests/test_flash_attention.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.ops.layers import attention_jnp
from ntransformer_tpu.ops.pallas.attention import flash_attention
from ntransformer_tpu_torch.ops import layers as play
from ntransformer_tpu_torch.ops.cuda import attention as cuda_attn


def _mk(seed, t, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, hq, d)).astype(np.float32),
            rng.standard_normal((hkv, s, d)).astype(np.float32),
            rng.standard_normal((hkv, s, d)).astype(np.float32))


def _jax(arrs, bf16):
    q, k, v = (jnp.asarray(a) for a in arrs)
    if bf16:
        k, v = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
    return q, k, v


def _torch(arrs, bf16):
    q, k, v = (torch.from_numpy(a) for a in arrs)
    if bf16:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    return q, k, v


CASES = [  # t, pos, hq, hkv, s, d, window, softcap
    (1, 0, 8, 4, 256, 128, None, 0.0),
    (8, 100, 8, 4, 256, 128, None, 0.0),
    (64, 0, 8, 4, 128, 64, None, 0.0),
    (70, 30, 8, 2, 128, 64, None, 0.0),
    (16, 40, 4, 2, 128, 64, 16, 0.0),
    (64, 32, 8, 4, 128, 64, 24, 0.0),
    (8, 64, 4, 2, 128, 64, None, 50.0),
    (64, 16, 8, 4, 128, 64, 32, 30.0),
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,pos,hq,hkv,s,d,window,softcap", CASES)
def test_attention_torch_matches_jnp(t, pos, hq, hkv, s, d, window, softcap,
                                     bf16):
    arrs = _mk(t + pos, t, hq, hkv, s, d)
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(attention_jnp(*_jax(arrs, bf16), pos, t, scale,
                                    window=window, softcap=softcap))
    got = play.attention_torch(*_torch(arrs, bf16), pos, t, scale,
                               window=window, softcap=softcap).numpy()
    tol = 3e-2 if bf16 else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,pos,hq,hkv,s,d,window,softcap", CASES[2:])
def test_flash_plain_matches_pallas_interpret(t, pos, hq, hkv, s, d, window,
                                              softcap, bf16):
    arrs = _mk(3 * t + pos, t, hq, hkv, s, d)
    scale = 1.0 / np.sqrt(d)
    q, k, v = _jax(arrs, bf16)
    want = np.asarray(flash_attention(
        q, k, v, pos, t, scale, interpret=True,
        window=None if window is None else jnp.int32(window),
        softcap=softcap))
    got = cuda_attn.flash_attention_plain(*_torch(arrs, bf16), pos, t, scale,
                                          window=window,
                                          softcap=softcap).numpy()
    tol = 3e-2 if bf16 else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_dispatch_on_cpu_takes_the_plain_path():
    """q_len >= 64 on a CPU tensor: attention_torch, no kernel launch."""
    q, k, v = _torch(_mk(5, 64, 8, 4, 128, 64), True)
    before = cuda_attn.launches
    got = play.attention(q, k, v, 0, 64, 0.125)
    assert cuda_attn.launches == before
    torch.testing.assert_close(got, play.attention_torch(q, k, v, 0, 64,
                                                         0.125))
    torch.testing.assert_close(
        cuda_attn.flash_attention_cuda(q, k, v, 0, 64, 0.125),
        cuda_attn.flash_attention_plain(q, k, v, 0, 64, 0.125))


@pytest.mark.parametrize("t,hq,hkv,s,d,pos", [
    (64, 8, 4, 128, 32, 0),    # head dim 32
    (64, 6, 4, 128, 64, 0),    # Hq not a multiple of Hkv
    (64, 8, 4, 128, 64, 65),   # rows past the cache end
])
def test_flash_shape_checks_raise(t, hq, hkv, s, d, pos):
    q = torch.zeros(t, hq, d)
    k = torch.zeros(hkv, s, d)
    with pytest.raises(ValueError):
        cuda_attn.flash_attention_cuda(q, k, k, pos, t, 0.1)
