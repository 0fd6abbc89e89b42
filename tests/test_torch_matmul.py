"""Port parity: the Q8_0 matmul's plain twin and the CPU `qmatmul` against
the JAX `qmatmul` (its CPU jnp path: bf16 dequant, bf16 activations, f32
dot — the TPU kernel's arithmetic) and a numpy golden, on the same numpy
inputs, at the JAX suite's 1e-4 (tests/test_pallas_matmul.py)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ntransformer_tpu.core.dtypes import DType
from ntransformer_tpu.core.layout import dequant_planes, relayout
from ntransformer_tpu.core.quant import quantize
from ntransformer_tpu.ops.linear import QLinear as JQLinear
from ntransformer_tpu.ops.linear import qmatmul as jax_qmatmul
from ntransformer_tpu_torch.core.dtypes import DType as PDType
from ntransformer_tpu_torch.ops import linear as plinear
from ntransformer_tpu_torch.ops.cuda import matmul as cuda_matmul

TOL = 1e-4


def _planes(n, k, seed, lead=None):
    rng = np.random.default_rng(seed)
    shape = (n, k) if lead is None else (lead, n, k)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    if lead is None:
        return relayout(quantize(w, DType.Q8_0), DType.Q8_0, n, k)
    parts = [relayout(quantize(w[i], DType.Q8_0), DType.Q8_0, n, k)
             for i in range(lead)]
    return {nm: np.stack([p[nm] for p in parts]) for nm in parts[0]}


def _port_ql(planes, k, n):
    return plinear.QLinear(PDType.Q8_0, k, n, {
        "qs": torch.from_numpy(planes["qs"]),
        "d": torch.from_numpy(np.ascontiguousarray(planes["d"])
                              .view(np.int16))})


def _jax_ql(planes, k, n):
    return JQLinear(DType.Q8_0, k, n,
                    {nm: jnp.asarray(v) for nm, v in planes.items()})


def _x(t, k, seed):
    return (np.random.default_rng(seed).standard_normal((t, k)) * 0.5) \
        .astype(np.float32)


@pytest.mark.parametrize("t", [1, 4, 70])
@pytest.mark.parametrize("n,k", [(256, 512), (384, 512), (128, 1376)])
def test_qmatmul_matches_jax(t, n, k):
    planes = _planes(n, k, seed=n * 7 + k)
    x = _x(t, k, seed=t)
    want = np.asarray(jax_qmatmul(jnp.asarray(x), _jax_ql(planes, k, n)))
    ql = _port_ql(planes, k, n)
    got = plinear.qmatmul(torch.from_numpy(x), ql).numpy()
    plain = cuda_matmul.quant_matmul_plain(torch.from_numpy(x),
                                           ql.planes["qs"],
                                           ql.planes["d"]).numpy()
    assert got.dtype == np.float32 and got.shape == (t, n)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(plain, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [1, 8])
def test_plain_twin_matches_bf16_golden(t):
    """Against the numpy golden dequant (core/layout.dequant_planes) with
    both operands rounded to bf16 and the product taken in f64. (The Pallas
    kernel in interpret mode dots at full f32 on the CPU, so it is not the
    oracle of the bf16 arithmetic the TPU and this port run.)"""
    n, k = 256, 512
    planes = _planes(n, k, seed=11)
    x = _x(t, k, seed=12)
    w = dequant_planes(planes, DType.Q8_0, k, n)
    want = (x.astype(ml_dtypes.bfloat16).astype(np.float64)
            @ w.astype(ml_dtypes.bfloat16).astype(np.float64))
    ql = _port_ql(planes, k, n)
    got = cuda_matmul.quant_matmul_plain(torch.from_numpy(x),
                                         ql.planes["qs"], ql.planes["d"])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [1, 70])
def test_stacked_layer_select(t):
    """A stacked [L, K, N] plane read through its free layer view."""
    n, k = 256, 512
    planes = _planes(n, k, seed=5, lead=3)
    x = _x(t, k, seed=6)
    want = np.asarray(jax_qmatmul(jnp.asarray(x), _jax_ql(planes, k, n),
                                  layer=jnp.int32(2)))
    got = plinear.qmatmul(torch.from_numpy(x), _port_ql(planes, k, n),
                          layer=2).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_bf16_activations_round_like_jax():
    """bf16 x goes in as is; f32 x is rounded to bf16 first — either way the
    same product."""
    n, k = 128, 256
    planes = _planes(n, k, seed=9)
    x = torch.from_numpy(_x(3, k, seed=10))
    ql = _port_ql(planes, k, n)
    a = plinear.qmatmul(x, ql)
    b = plinear.qmatmul(x.to(torch.bfloat16), ql)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cuda_wrapper_on_cpu_is_the_plain_twin():
    n, k = 384, 512
    planes = _planes(n, k, seed=13)
    ql = _port_ql(planes, k, n)
    x = torch.from_numpy(_x(4, k, seed=14))
    before = cuda_matmul.launches
    got = cuda_matmul.quant_matmul_cuda(x, ql.planes["qs"], ql.planes["d"])
    want = cuda_matmul.quant_matmul_plain(x, ql.planes["qs"], ql.planes["d"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert cuda_matmul.launches == before  # nothing was launched


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_kernel_mode_on_cpu(mode, monkeypatch):
    monkeypatch.setattr(plinear, "KERNEL_MODE", mode)
    x = torch.zeros(2, 64)
    assert not plinear.kernels_enabled(x)
    n, k = 128, 64
    ql = _port_ql(_planes(n, k, seed=15), k, n)
    xr = torch.from_numpy(_x(2, k, seed=16))
    torch.testing.assert_close(
        plinear.qmatmul(xr, ql),
        cuda_matmul.quant_matmul_plain(xr, ql.planes["qs"], ql.planes["d"]),
        rtol=0, atol=0)


@pytest.mark.parametrize("k,n,dk", [(48, 128, 1), (64, 128, 3),
                                    (64, 96, 2)])
def test_shape_checks_raise(k, n, dk):
    """K must be a multiple of 32 and the planes must match x."""
    x = torch.zeros(1, k)
    qs = torch.zeros(k if dk != 3 else 32, n, dtype=torch.int8)
    d = torch.zeros(max(1, k // 32) if dk != 2 else 5, n, dtype=torch.int16)
    with pytest.raises(ValueError):
        cuda_matmul.quant_matmul_cuda(x, qs, d)


def test_pad_qlinear_lanes_pads_zero_columns():
    n, k = 96, 64
    ql = _port_ql(_planes(n, k, seed=17), k, n)
    padded = plinear.pad_qlinear_lanes(ql, 128)
    assert padded.n == 128 and padded.planes["qs"].shape == (64, 128)
    x = torch.from_numpy(_x(2, k, seed=18))
    y = plinear.qmatmul(x, padded)
    torch.testing.assert_close(y[:, :n], plinear.qmatmul(x, ql), rtol=0,
                               atol=0)
    assert float(y[:, n:].abs().max()) == 0.0
