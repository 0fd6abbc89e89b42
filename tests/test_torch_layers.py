"""Port parity: RMSNorm, the RoPE table, both RoPE pairings and both
gated activations against the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.ops import layers as jlay
from ntransformer_tpu_torch.ops import layers as play


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm(dtype):
    x = _rng(0).standard_normal((5, 256)).astype(np.float32) * 3
    w = _rng(1).standard_normal(256).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = np.asarray(jlay.rms_norm(jx, jnp.asarray(w), 1e-5)
                      .astype(jnp.float32))
    got = play.rms_norm(tx, torch.from_numpy(w), 1e-5)
    assert got.dtype == tx.dtype
    tol = 1e-2 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("factors", [False, True])
def test_rope_table(factors):
    ff = (np.linspace(1.0, 8.0, 32).astype(np.float32) if factors else None)
    jc, js = jlay.rope_table(512, 64, 500000.0, ff)
    tc, ts = play.rope_table(512, 64, 500000.0, ff)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)


@pytest.mark.parametrize("interleaved", [False, True])
def test_apply_rope_pairings(interleaved):
    x = _rng(2).standard_normal((7, 4, 64)).astype(np.float32)
    cos, sin = jlay.rope_table(64, 64, 10000.0)
    cos, sin = np.asarray(cos)[10:17], np.asarray(sin)[10:17]
    want = np.asarray(jlay.apply_rope(jnp.asarray(x), jnp.asarray(cos),
                                      jnp.asarray(sin), interleaved))
    got = play.apply_rope(torch.from_numpy(x), torch.from_numpy(cos),
                          torch.from_numpy(sin), interleaved).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rope_pairings_differ():
    """The two pairings are different rotations (a mixed-up flag fails)."""
    x = torch.from_numpy(_rng(3).standard_normal((3, 2, 16))
                         .astype(np.float32))
    c, s = play.rope_table(8, 16, 10000.0)
    a = play.apply_rope(x, c[5:8], s[5:8], False)
    b = play.apply_rope(x, c[5:8], s[5:8], True)
    assert float((a - b).abs().max()) > 1e-2


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_gated_activations(act):
    g = _rng(4).standard_normal((6, 128)).astype(np.float32) * 2
    u = _rng(5).standard_normal((6, 128)).astype(np.float32)
    want = np.asarray(jlay.swiglu(jnp.asarray(g), jnp.asarray(u), act))
    got = play.swiglu(torch.from_numpy(g), torch.from_numpy(u), act).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
