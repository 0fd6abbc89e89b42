"""Port parity: the Q4_0 / Q4_K / Q5_K / Q6_K matmul's plain twin and the
CPU `qmatmul` against the JAX `qmatmul` (its CPU jnp path: bf16 dequant,
bf16 activations, f32 dot — the TPU kernel's arithmetic) and a numpy
golden, on the same numpy inputs, at the JAX suite's 1e-4
(tests/test_pallas_matmul.py); `split_x` against `split_x_jnp`; a
lane-padded head against the unpadded one."""
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
from ntransformer_tpu.ops.linear import split_x_jnp
from ntransformer_tpu_torch.core.dtypes import DType as PDType
from ntransformer_tpu_torch.models.convert import array_to_torch
from ntransformer_tpu_torch.ops import linear as plinear
from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
from test_torch_model import one_torch_thread  # noqa: F401

TOL = 1e-4
NIBBLE = ["q4_0", "q4_k", "q5_k", "q6_k"]


def _planes(dtype, n, k, seed, lead=None):
    rng = np.random.default_rng(seed)
    shape = (n, k) if lead is None else (lead, n, k)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    if lead is None:
        return relayout(quantize(w, DType(dtype)), DType(dtype), n, k)
    parts = [relayout(quantize(w[i], DType(dtype)), DType(dtype), n, k)
             for i in range(lead)]
    return {nm_: np.stack([p[nm_] for p in parts]) for nm_ in parts[0]}


def _port_ql(dtype, planes, k, n):
    return plinear.QLinear(PDType(dtype), k, n,
                           {nm_: array_to_torch(v, "cpu")
                            for nm_, v in planes.items()})


def _jax_ql(dtype, planes, k, n):
    return JQLinear(DType(dtype), k, n,
                    {nm_: jnp.asarray(v) for nm_, v in planes.items()})


def _x(t, k, seed):
    return (np.random.default_rng(seed).standard_normal((t, k)) * 0.5) \
        .astype(np.float32)


@pytest.mark.parametrize("t", [1, 4, 70])
@pytest.mark.parametrize("k,n", [(512, 256), (512, 640), (1280, 384)])
@pytest.mark.parametrize("dtype", NIBBLE)
def test_qmatmul_matches_jax(dtype, k, n, t):
    planes = _planes(dtype, n, k, seed=n * 7 + k)
    x = _x(t, k, seed=t)
    want = np.asarray(jax_qmatmul(jnp.asarray(x),
                                  _jax_ql(dtype, planes, k, n)))
    ql = _port_ql(dtype, planes, k, n)
    got = plinear.qmatmul(torch.from_numpy(x), ql).numpy()
    plain = nm.nibble_matmul_plain(torch.from_numpy(x), ql.planes,
                                   ql.dtype).numpy()
    assert got.dtype == np.float32 and got.shape == (t, n)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(plain, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", NIBBLE)
def test_stacked_layer_select(dtype):
    """Stacked [L, rows, N] planes read through their free layer view."""
    n, k = 256, 512
    planes = _planes(dtype, n, k, seed=5, lead=3)
    x = _x(4, k, seed=6)
    want = np.asarray(jax_qmatmul(jnp.asarray(x),
                                  _jax_ql(dtype, planes, k, n),
                                  layer=jnp.int32(2)))
    got = plinear.qmatmul(torch.from_numpy(x),
                          _port_ql(dtype, planes, k, n), layer=2).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", NIBBLE)
def test_plain_twin_matches_bf16_golden(dtype):
    """Against the numpy golden dequant (core/layout.dequant_planes) with
    both operands rounded to bf16 and the product taken in f64. (The Pallas
    kernel in interpret mode dots at full f32 on the CPU, so it is not the
    oracle of the bf16 arithmetic the TPU and this port run.)"""
    n, k = 384, 1280
    planes = _planes(dtype, n, k, seed=11)
    x = _x(8, k, seed=12)
    w = dequant_planes(planes, DType(dtype), k, n)
    want = (x.astype(ml_dtypes.bfloat16).astype(np.float64)
            @ w.astype(ml_dtypes.bfloat16).astype(np.float64))
    ql = _port_ql(dtype, planes, k, n)
    got = nm.nibble_matmul_plain(torch.from_numpy(x), ql.planes, ql.dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", NIBBLE)
def test_cuda_wrapper_on_cpu_is_the_plain_twin(dtype):
    n, k = 384, 512
    ql = _port_ql(dtype, _planes(dtype, n, k, seed=13), k, n)
    x = torch.from_numpy(_x(4, k, seed=14))
    before = {d: kern.launches for d, kern in nm.KERNELS.items()}
    got = nm.nibble_matmul_cuda(x, ql.planes, ql.dtype)
    want = nm.nibble_matmul_plain(x, ql.planes, ql.dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # nothing was launched
    assert {d: kern.launches for d, kern in nm.KERNELS.items()} == before


@pytest.mark.parametrize("dtype", NIBBLE)
def test_split_x_matches_jax(dtype):
    """split_x pairs plane row r's nibbles with x: x_lo[r] and x_hi[r] are
    the elements the dequant puts the low and high nibble at."""
    x = _x(3, 512, seed=15).reshape(3, 1, 512)
    lo, hi = plinear.split_x(torch.from_numpy(x), PDType(dtype))
    jlo, jhi = split_x_jnp(jnp.asarray(x), DType(dtype))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    # x_lo . W_lo + x_hi . W_hi (plane order) is the element-order product
    planes = _planes(dtype, 64, 512, seed=16)
    w = dequant_planes(planes, DType(dtype), 512, 64)
    idx = np.arange(512)[None]
    ilo, ihi = (a.numpy()[0] for a in plinear.split_x(torch.from_numpy(idx),
                                                      PDType(dtype)))
    np.testing.assert_allclose(lo.numpy()[:, 0] @ w[ilo]
                               + hi.numpy()[:, 0] @ w[ihi],
                               x[:, 0] @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,k,n", [("q4_k", 384, 256), ("q4_0", 48, 128),
                                       ("q6_k", 768, 64)])
def test_shape_checks_raise(dtype, k, n):
    """K must hold whole blocks (32 for Q4_0, 256 for the K-quants) and the
    planes must match x."""
    planes = _port_ql(dtype, _planes(dtype, n, 512, seed=17), 512, n).planes
    with pytest.raises(ValueError):
        nm.nibble_matmul_cuda(torch.zeros(1, k), planes, PDType(dtype))


def test_plane_dtype_checked():
    """A Q6_K scale plane given as uint8 (its sign lost) is refused."""
    planes = _port_ql("q6_k", _planes("q6_k", 64, 256, seed=18), 256,
                      64).planes
    planes["sc_lo"] = planes["sc_lo"].view(torch.uint8)
    with pytest.raises(ValueError, match="sc_lo"):
        nm.nibble_matmul_cuda(torch.zeros(1, 256), planes, PDType.Q6_K)


@pytest.mark.parametrize("dtype", ["q4_k", "q6_k"])
def test_lane_padded_head_gives_the_same_logits(dtype):
    """The JAX package pads K-quant heads to 2048 lanes; the port does not,
    but a padded head (as weights_from_numpy brings it over) gives the
    unpadded head's columns and zeros beyond them."""
    n, k = 384, 512
    ql = _port_ql(dtype, _planes(dtype, n, k, seed=19), k, n)
    padded = plinear.pad_qlinear_lanes(ql, 2048)
    assert padded.n == 2048
    x = torch.from_numpy(_x(3, k, seed=20))
    y = plinear.qmatmul(x, padded)
    torch.testing.assert_close(y[:, :n], plinear.qmatmul(x, ql), rtol=1e-6,
                               atol=1e-6)
    assert float(y[:, n:].abs().max()) == 0.0
