"""Port parity: f16-bit decode, the Q8_0 dequant oracle and the port's own
copies of the numpy modules, against the JAX package on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.core.dequant import dequantize as jax_dequantize
from ntransformer_tpu.core.dtypes import DType
from ntransformer_tpu.core.layout import dequant_planes, relayout
from ntransformer_tpu.core.quant import quantize
from ntransformer_tpu.ops.dequant_jnp import dequant_planes_jnp
from ntransformer_tpu.ops.f16bits import f16_bits_to_f32 as jax_f16_bits
from ntransformer_tpu_torch.core import dequant as port_dequant
from ntransformer_tpu_torch.core import layout as port_layout
from ntransformer_tpu_torch.core.dtypes import DType as PDType
from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch
from ntransformer_tpu_torch.ops.f16bits import f16_bits_to_f32

SHAPES = [(256, 512), (384, 512), (128, 1376)]  # (N, K)


def _finite_f16_bits() -> np.ndarray:
    bits = np.arange(65536, dtype=np.uint16)
    return bits[((bits >> 10) & 0x1F) != 0x1F]  # every pattern but NaN/Inf


@pytest.mark.parametrize("form", ["int16", "numpy_uint16", "int32"])
def test_f16_bits_all_finite_patterns(form):
    """All 63488 finite f16 patterns — signed zeros and subnormals
    included — decode to the JAX version's f32 bits exactly."""
    b = _finite_f16_bits()
    want = np.asarray(jax_f16_bits(jnp.asarray(b)))
    arg = {"int16": lambda: torch.from_numpy(b.view(np.int16)),
           "numpy_uint16": lambda: b,
           "int32": lambda: torch.from_numpy(b.astype(np.int32))}[form]()
    got = f16_bits_to_f32(arg).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _q8_planes(n, k, seed):
    x = (np.random.default_rng(seed).standard_normal((n, k)) * 0.05) \
        .astype(np.float32)
    return relayout(quantize(x, DType.Q8_0), DType.Q8_0, n, k)


def _torch_planes(planes):
    return {"qs": torch.from_numpy(planes["qs"]),
            "d": torch.from_numpy(planes["d"].view(np.int16))}


@pytest.mark.parametrize("n,k", SHAPES)
def test_dequant_q8_0_bit_exact_f32(n, k):
    planes = _q8_planes(n, k, seed=n + k)
    got = dequant_planes_torch(_torch_planes(planes), PDType.Q8_0, k, n)
    golden = dequant_planes(planes, DType.Q8_0, k, n)
    jnp_out = np.asarray(dequant_planes_jnp(
        {nm: jnp.asarray(v) for nm, v in planes.items()}, DType.Q8_0, k, n))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  golden.view(np.uint32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  jnp_out.view(np.uint32))


@pytest.mark.parametrize("n,k", SHAPES)
def test_dequant_q8_0_bit_exact_bf16(n, k):
    """The matmul's operand: the same bf16 rounding as the JAX path."""
    planes = _q8_planes(n, k, seed=7 + n)
    got = dequant_planes_torch(_torch_planes(planes), PDType.Q8_0, k, n,
                               out_dtype=torch.bfloat16)
    want = np.asarray(dequant_planes_jnp(
        {nm: jnp.asarray(v) for nm, v in planes.items()}, DType.Q8_0, k, n,
        out_dtype=jnp.bfloat16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_dequant_stacked_planes():
    """[L, K/32, N] scale planes repeat along K, not along L."""
    planes = [_q8_planes(128, 256, seed=s) for s in (1, 2)]
    stacked = {nm: torch.stack([_torch_planes(p)[nm] for p in planes])
               for nm in ("qs", "d")}
    got = dequant_planes_torch(stacked, PDType.Q8_0, 256, 128)
    for i, p in enumerate(planes):
        np.testing.assert_array_equal(
            got[i].numpy(), dequant_planes(p, DType.Q8_0, 256, 128))


@pytest.mark.parametrize("dtype", ["q4_0", "q4_k", "q6_k"])
def test_unported_quant_dtypes_raise(dtype):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dequant_planes_torch({}, PDType(dtype), 256, 128)


@pytest.mark.parametrize("dtype", ["w4a8", "w8a8"])
def test_port_layout_engine_formats_raise(dtype):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_layout.dequant_planes({}, PDType(dtype), 512, 128)


@pytest.mark.parametrize("dtype", ["q8_0", "q4_0", "q4_k", "q5_k", "q6_k"])
def test_port_numpy_copies_match(dtype):
    """The port's own copies of core/dequant.py and core/layout.py give the
    JAX package's planes and golden dequant on the same bytes."""
    n, k = 128, 512
    x = (np.random.default_rng(3).standard_normal((n, k)) * 0.05) \
        .astype(np.float32)
    raw = quantize(x, DType(dtype))
    want = relayout(raw, DType(dtype), n, k)
    got = port_layout.relayout(raw, PDType(dtype), n, k)
    assert set(got) == set(want)
    for nm in want:
        np.testing.assert_array_equal(got[nm], want[nm])
    np.testing.assert_array_equal(
        port_layout.dequant_planes(got, PDType(dtype), k, n),
        dequant_planes(want, DType(dtype), k, n))
    np.testing.assert_array_equal(
        port_dequant.dequantize(raw, PDType(dtype), n, k),
        jax_dequantize(raw, DType(dtype), n, k))
