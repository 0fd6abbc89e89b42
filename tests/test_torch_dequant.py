"""Port parity: f16-bit decode, the dequant oracle of every GGUF format the
port loads (Q8_0, Q4_0, Q4_K, Q5_K, Q6_K) and the port's own copies of the
numpy modules (dequant, layout, quant, the GGUF reader and writer), against
the JAX package on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.core.dequant import dequantize as jax_dequantize
from ntransformer_tpu.core.dtypes import DType
from ntransformer_tpu.core.gguf import GGUFReader as JGGUFReader
from ntransformer_tpu.core.layout import dequant_planes, relayout
from ntransformer_tpu.core.quant import quantize
from ntransformer_tpu.ops.dequant_jnp import dequant_planes_jnp
from ntransformer_tpu.ops.f16bits import f16_bits_to_f32 as jax_f16_bits
from ntransformer_tpu_torch.core import dequant as port_dequant
from ntransformer_tpu_torch.core import gguf as port_gguf
from ntransformer_tpu_torch.core import layout as port_layout
from ntransformer_tpu_torch.core import quant as port_quant
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


@pytest.mark.parametrize("dtype", ["q2_k"])
def test_unported_quant_dtypes_raise(dtype):
    """A quantized dtype without planes or a kernel is refused by name (the
    loader dequantizes such a GGUF matrix to bf16 instead)."""
    planes = {"w": torch.zeros(512, 128)}
    with pytest.raises(NotImplementedError, match="q2_k has no kernel"):
        dequant_planes_torch(planes, PDType(dtype), 512, 128)


NIBBLE = ["q4_0", "q4_k", "q5_k", "q6_k"]


def _nibble_planes(dtype, n, k, seed):
    x = (np.random.default_rng(seed).standard_normal((n, k)) * 0.05) \
        .astype(np.float32)
    return relayout(quantize(x, DType(dtype)), DType(dtype), n, k)


def _to_torch(planes):
    return {nm: torch.from_numpy(np.ascontiguousarray(v).view(np.int16)
                                 if v.dtype == np.uint16 else v)
            for nm, v in planes.items()}


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("n,k", [(256, 512), (128, 1280)])
@pytest.mark.parametrize("dtype", NIBBLE)
def test_dequant_nibble_formats_bit_exact(dtype, n, k, out):
    """Q4_0, Q4_K, Q5_K and Q6_K planes dequantize to dequant_planes_jnp's
    f32 and bf16 bits exactly (and, in f32, to the numpy golden's)."""
    planes = _nibble_planes(dtype, n, k, seed=n + k)
    tdt, jdt, view = ((torch.float32, jnp.float32, np.uint32) if out == "f32"
                      else (torch.bfloat16, jnp.bfloat16, np.uint16))
    got = dequant_planes_torch(_to_torch(planes), PDType(dtype), k, n,
                               out_dtype=tdt)
    want = np.asarray(dequant_planes_jnp(
        {nm: jnp.asarray(v) for nm, v in planes.items()}, DType(dtype), k, n,
        out_dtype=jdt))
    bits = got.view(torch.int32 if out == "f32" else torch.int16).numpy()
    np.testing.assert_array_equal(bits.view(view), want.view(view))
    if out == "f32":
        np.testing.assert_array_equal(
            got.numpy(), dequant_planes(planes, DType(dtype), k, n))


@pytest.mark.parametrize("dtype", NIBBLE)
def test_dequant_nibble_stacked_planes(dtype):
    """[L, rows, N] planes: every plane repeats along K, not along L."""
    n, k = 128, 512
    parts = [_nibble_planes(dtype, n, k, seed=s) for s in (4, 5)]
    stacked = {nm: torch.stack([_to_torch(p)[nm] for p in parts])
               for nm in parts[0]}
    got = dequant_planes_torch(stacked, PDType(dtype), k, n)
    assert tuple(got.shape) == (2, k, n)
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(
            got[i].numpy(), dequant_planes(p, DType(dtype), k, n))


@pytest.mark.parametrize("dtype", ["f32", "f16", "q8_0", "q4_0", "q4_k",
                                   "q5_k", "q6_k"])
def test_port_quantizer_bytes_equal(dtype):
    """The port's copy of core/quant.py gives the JAX package's bytes, on
    an input with a zero block, a constant block and outliers."""
    x = (np.random.default_rng(8).standard_normal((64, 512)) * 0.05) \
        .astype(np.float32)
    x[3] = 0.0
    x[5, :256] = 0.25
    x[7, 17] = 4.0
    got = port_quant.quantize(x, PDType(dtype))
    assert bytes(got) == bytes(quantize(x, DType(dtype)))


def test_port_gguf_writer_round_trips(tmp_path):
    """A file written by the port's GGUFWriter reads back the same through
    both packages' readers: metadata of every kind and f32, f16 and
    quantized tensors."""
    path = str(tmp_path / "w.gguf")
    w = port_gguf.GGUFWriter(path)
    meta = {"general.architecture": "llama", "llama.block_count": 4,
            "llama.rope.freq_base": 10000.0, "flag": True, "neg": -3,
            "big": 2 ** 40,
            "tokenizer.ggml.tokens": ["<s>", "▁a", "b"],
            "tokenizer.ggml.scores": np.array([0.0, -1.5, -2.0],
                                              np.float32),
            "tokenizer.ggml.token_type": np.array([3, 1, 1], np.int32)}
    for key, v in meta.items():
        w.add_meta(key, v)
    rng = np.random.default_rng(9)
    a32 = rng.standard_normal((4, 8)).astype(np.float32)
    a16 = rng.standard_normal(16).astype(np.float16)
    q = (rng.standard_normal((8, 256)) * 0.05).astype(np.float32)
    w.add_tensor("a", a32)
    w.add_tensor("b", a16)
    w.add_tensor("c", raw=port_quant.quantize(q, PDType.Q4_K), shape=(8, 256),
                 dtype=PDType.Q4_K)
    w.write()
    for reader in (port_gguf.GGUFReader(path), JGGUFReader(path)):
        for key, v in meta.items():
            got = reader.metadata[key]
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got, v)
            else:
                assert got == v, key
        assert reader.tensor_order == ["a", "b", "c"]
        assert reader.info("c").dtype.value == "q4_k"
        assert reader.info("a").shape == (4, 8)
        np.testing.assert_array_equal(
            reader.raw_bytes("a").view(np.float32).reshape(4, 8), a32)
        np.testing.assert_array_equal(reader.raw_bytes("b").view(np.float16),
                                      a16)
        assert bytes(reader.raw_bytes("c")) == bytes(quantize(q, DType.Q4_K))


@pytest.mark.parametrize("dtype", ["w4a8", "w8a8"])
def test_port_layout_engine_formats_raise(dtype):
    """The engine-native formats come from load-time requant only: the
    port's relayout refuses file bytes in them, as the JAX package's does."""
    with pytest.raises(ValueError, match="no planar layout"):
        port_layout.relayout(np.zeros(512 * 128, np.uint8), PDType(dtype),
                             128, 512)
    with pytest.raises(ValueError, match="no planar layout"):
        relayout(np.zeros(512 * 128, np.uint8), DType(dtype), 128, 512)


@pytest.mark.parametrize("dtype", ["w4a8", "w8a8"])
def test_port_layout_dequant_engine_formats(dtype):
    """The port's core/layout.dequant_planes reconstructs W4A8 / W8A8 planes
    bit for bit as the JAX package's does."""
    from ntransformer_tpu.core.w4a8 import requant_w4a8
    from ntransformer_tpu.core.w8a8 import requant_w8a8
    w = (np.random.default_rng(4).standard_normal((1024, 128)) * 0.02) \
        .astype(np.float32)
    planes = (requant_w4a8 if dtype == "w4a8" else requant_w8a8)(w)
    np.testing.assert_array_equal(
        port_layout.dequant_planes(planes, PDType(dtype), 1024, 128),
        dequant_planes(planes, DType(dtype), 1024, 128))


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


@pytest.mark.parametrize("dtype", ["q8_0", "q4_0", "q4_k", "q5_k", "q6_k"])
def test_port_layout_tiled_transpose(dtype):
    """Planes larger than one tile of the port's transposing copy
    (core/layout.transposed: 256 x 256 tiles, the last ones ragged here)
    are C-contiguous and equal the JAX package's, byte for byte."""
    n, k = 640, 1280
    x = (np.random.default_rng(5).standard_normal((n, k)) * 0.05) \
        .astype(np.float32)
    raw = quantize(x, DType(dtype))
    want = relayout(raw, DType(dtype), n, k)
    got = port_layout.relayout(raw, PDType(dtype), n, k)
    assert set(got) == set(want)
    assert max(a.size for a in got.values()) > 256 * 256
    for nm in want:
        assert got[nm].flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got[nm], want[nm])
