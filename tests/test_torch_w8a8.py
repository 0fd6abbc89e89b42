"""Port parity for the W8A8 serving format: the port's numpy copy
(core/w8a8.py), its torch twins (ops/dequant_torch.py), the plain twin of
the int8 matmul kernel (ops/cuda/w8a8.py), the `qmatmul` dispatch and
`convert_qlinear_w8a8` against the JAX package on the same numpy inputs.

Planes and activation codes must be bit-equal (numpy and torch alike); the
products are held at the JAX suite's 1e-5 (tests/test_w8a8.py) against the
interpret-mode Pallas kernel and the JAX CPU `qmatmul`, and bit for bit
against the numpy golden, whose arithmetic the twin repeats (an exact
integer dot, then (p * am) * s). Sources: Q8_0, Q4_K and a float matrix
(the JAX loader holds it as bf16 before conversion, the port's host plane as
f32: the port rounds it first)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ntransformer_tpu.core import w8a8 as jw8
from ntransformer_tpu.core.dtypes import DType
from ntransformer_tpu.core.layout import relayout
from ntransformer_tpu.core.quant import quantize
from ntransformer_tpu.ops.linear import QLinear as JQLinear
from ntransformer_tpu.ops.linear import convert_qlinear_w8a8 as jconvert
from ntransformer_tpu.ops.linear import qmatmul as jax_qmatmul
from ntransformer_tpu.ops.pallas.w8a8 import w8a8_matmul_pallas
from ntransformer_tpu_torch.core import w8a8 as pw8
from ntransformer_tpu_torch.core.dtypes import DType as PDType
from ntransformer_tpu_torch.models.convert import array_to_torch
from ntransformer_tpu_torch.ops import dequant_torch as pdq
from ntransformer_tpu_torch.ops import linear as plinear
from ntransformer_tpu_torch.ops.cuda import w8a8 as cw8
from test_torch_model import one_torch_thread  # noqa: F401

K, N = 512, 256
TOL = 1e-5


def _w(seed, shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.02) \
        .astype(np.float32)


def _x(t, seed, k=K):
    """Activations with a drifting scale and offset along K (not symmetric)
    and, for t > 2, one all-zero row (its scale stays 1)."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.5, 2.0, k, dtype=np.float32)
    x = (rng.normal(size=(t, k)) * ramp + 0.1 * ramp).astype(np.float32)
    if t > 2:
        x[1] = 0.0
    return x


def _source(kind, seed, lead=None, k=K, n=N):
    """(JAX QLinear, port QLinear with numpy host planes) of a [k, n]
    matrix (or [lead, k, n]) in format `kind`, as each loader holds it."""
    shape = (n, k) if lead is None else (lead, n, k)
    w = _w(seed, shape)
    if kind == "bf16":
        wt = np.ascontiguousarray(np.swapaxes(w, -1, -2))
        jq = JQLinear(DType.BF16, k, n, {"w": wt.astype(ml_dtypes.bfloat16)})
        return jq, plinear.QLinear(PDType.BF16, k, n, {"w": wt})
    mats = [w] if lead is None else list(w)
    parts = [relayout(quantize(m, DType(kind)), DType(kind), n, k)
             for m in mats]
    planes = (parts[0] if lead is None else
              {nm: np.stack([p[nm] for p in parts]) for nm in parts[0]})
    return (JQLinear(DType(kind), k, n, planes),
            plinear.QLinear(PDType(kind), k, n, dict(planes)))


def _torch_ql(ql, bf16_float=False):
    """ql with its planes as CPU tensors; a float plane as bf16 when asked,
    as it lies on the card once placed."""
    planes = dict(ql.planes)
    if bf16_float and "w" in planes:
        planes["w"] = planes["w"].astype(ml_dtypes.bfloat16)
    return plinear.QLinear(ql.dtype, ql.k, ql.n,
                           {nm: array_to_torch(v, "cpu")
                            for nm, v in planes.items()})


def _pt(planes):
    return {nm: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for nm, v in planes.items()}


def test_numpy_copy_matches_the_jax_module():
    w = _w(1, (K, N))
    want = jw8.requant_w8a8(w)
    got = pw8.requant_w8a8(w)
    for nm in want:
        np.testing.assert_array_equal(got[nm], want[nm])
    np.testing.assert_array_equal(pw8.dequant_w8a8(got, K, N),
                                  jw8.dequant_w8a8(want, K, N))
    x = _x(5, 2)
    for a, b in zip(pw8.quantize_rows(x), jw8.quantize_rows(x)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pw8.w8a8_matmul_golden(x, got, K, N),
                                  jw8.w8a8_matmul_golden(x, want, K, N))


def test_torch_requant_and_row_quant_bit_equal():
    w = _w(3, (K, N))
    want = jw8.requant_w8a8(w)
    got = pdq.requant_w8a8_torch(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and tuple(got["s"].shape) == (1, N)
    for nm in want:
        np.testing.assert_array_equal(got[nm].numpy(), want[nm])
    x = _x(6, 4)
    codes, am = pdq.quantize_rows_torch(torch.from_numpy(x))
    jcodes, jam = jw8.quantize_rows(x)
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(am.numpy(), jam)
    assert float(am[1]) == 1.0  # the zero row


@pytest.mark.parametrize("planes_on", ["numpy", "torch"])
@pytest.mark.parametrize("kind", ["q8_0", "q4_k", "bf16"])
def test_convert_planes_bit_equal(kind, planes_on):
    """convert_qlinear_w8a8 of the same source gives the JAX package's
    planes bit for bit: numpy host planes through core/, torch planes
    through the torch twins."""
    jq, pq = _source(kind, seed=7)
    if planes_on == "torch":
        pq = _torch_ql(pq, bf16_float=True)
    want = jconvert(jq)
    got = plinear.convert_qlinear_w8a8(pq)
    assert got.dtype == PDType.W8A8 and (got.k, got.n) == (K, N)
    assert isinstance(got.planes["q"], np.ndarray) == (planes_on == "numpy")
    for nm, v in want.planes.items():
        np.testing.assert_array_equal(_pt(got.planes)[nm], np.asarray(v),
                                      err_msg=nm)


def test_float_source_is_rounded_to_bf16_first():
    """Without the bf16 rounding the port's f32 host plane would requantize
    to other codes than the JAX package's bf16 plane."""
    jq, pq = _source("bf16", seed=8)
    raw = pw8.requant_w8a8(pq.planes["w"])
    want = jconvert(jq).planes
    assert not all(np.array_equal(raw[nm], np.asarray(want[nm]))
                   for nm in raw)
    got = plinear.convert_qlinear_w8a8(pq).planes
    for nm in want:
        np.testing.assert_array_equal(got[nm], np.asarray(want[nm]))


def test_convert_stacked_planes_and_idempotent():
    jq, pq = _source("q8_0", seed=9, lead=3)
    want = jconvert(jq)
    for planes_on in ("numpy", "torch"):
        src = pq if planes_on == "numpy" else _torch_ql(pq)
        got = plinear.convert_qlinear_w8a8(src)
        assert tuple(got.planes["q"].shape) == (3, K, N)
        assert tuple(got.planes["s"].shape) == (3, 1, N)
        for nm, v in want.planes.items():
            np.testing.assert_array_equal(_pt(got.planes)[nm], np.asarray(v))
        assert plinear.convert_qlinear_w8a8(got) is got


def _wplanes(seed):
    return jw8.requant_w8a8(_w(seed, (K, N)))


@pytest.mark.parametrize("t", [1, 4, 8, 32, 64, 70, 512])
def test_plain_twin_matches_jax(t):
    """The plain twin and the port's CPU qmatmul against the interpret-mode
    Pallas kernel and the JAX CPU qmatmul at 1e-5, and the numpy golden
    bit for bit."""
    planes = _wplanes(10)
    x = _x(t, 11)
    jql = JQLinear(DType.W8A8, K, N,
                   {nm: jnp.asarray(v) for nm, v in planes.items()})
    kern = np.asarray(w8a8_matmul_pallas(jnp.asarray(x), jql,
                                         interpret=True))
    cpu = np.asarray(jax_qmatmul(jnp.asarray(x), jql))
    pq = plinear.QLinear(PDType.W8A8, K, N,
                         {nm: torch.from_numpy(v) for nm, v in planes.items()})
    plain = cw8.w8a8_matmul_plain(torch.from_numpy(x), pq.planes["q"],
                                  pq.planes["s"]).numpy()
    got = plinear.qmatmul(torch.from_numpy(x), pq).numpy()
    assert got.dtype == np.float32 and got.shape == (t, N)
    for want in (kern, cpu):
        np.testing.assert_allclose(plain, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(plain, jw8.w8a8_matmul_golden(x, planes,
                                                                K, N))


def test_bf16_activations_match_jax():
    """The layers hand qmatmul bf16 activations; both packages quantize
    their f32 values."""
    planes = _wplanes(12)
    x = _x(8, 13).astype(ml_dtypes.bfloat16)
    jql = JQLinear(DType.W8A8, K, N,
                   {nm: jnp.asarray(v) for nm, v in planes.items()})
    want = np.asarray(jax_qmatmul(jnp.asarray(x), jql))
    pq = plinear.QLinear(PDType.W8A8, K, N,
                         {nm: torch.from_numpy(v) for nm, v in planes.items()})
    got = plinear.qmatmul(array_to_torch(x, "cpu"), pq).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_stacked_layer_select():
    """Stacked [L, ...] planes read through their free layer view, against
    the interpret-mode kernel's scalar-prefetched layer."""
    planes = _wplanes(14)
    stacked = {nm: np.stack([v * (i + 1) for i in range(3)])
               for nm, v in planes.items()}
    stacked["q"] = np.stack([planes["q"], -planes["q"], planes["q"] // 2])
    x = _x(3, 15)
    jql = JQLinear(DType.W8A8, K, N,
                   {nm: jnp.asarray(v) for nm, v in stacked.items()})
    pq = plinear.QLinear(PDType.W8A8, K, N, {
        nm: torch.from_numpy(v) for nm, v in stacked.items()})
    for li in range(3):
        want = np.asarray(w8a8_matmul_pallas(jnp.asarray(x), jql,
                                             interpret=True,
                                             layer=jnp.int32(li)))
        got = plinear.qmatmul(torch.from_numpy(x), pq, layer=li).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_above_max_rows_takes_the_dequant_tail_on_cpu():
    """Past MAX_ROWS the JAX qmatmul falls to the bf16 dequant product; the
    port's CPU path does the same (the card refuses such a T)."""
    planes = _wplanes(16)
    t = cw8.MAX_ROWS + 3
    x = np.random.default_rng(17).normal(size=(t, K)).astype(np.float32)
    jql = JQLinear(DType.W8A8, K, N,
                   {nm: jnp.asarray(v) for nm, v in planes.items()})
    want = np.asarray(jax_qmatmul(jnp.asarray(x), jql))
    pq = plinear.QLinear(PDType.W8A8, K, N,
                         {nm: torch.from_numpy(v) for nm, v in planes.items()})
    got = plinear.qmatmul(torch.from_numpy(x), pq).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dequant_planes_bit_equal():
    planes = _wplanes(18)
    stacked = {nm: np.stack([v, v * 2]) for nm, v in planes.items()}
    got = pdq.dequant_planes_torch(
        {nm: torch.from_numpy(v) for nm, v in stacked.items()}, PDType.W8A8,
        K, N)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), jw8.dequant_w8a8(
                {nm: v[i] for nm, v in stacked.items()}, K, N))


def test_cuda_wrapper_on_cpu_is_the_plain_twin():
    planes = {nm: torch.from_numpy(v) for nm, v in _wplanes(19).items()}
    x = torch.from_numpy(_x(5, 20))
    before = cw8.launches
    got = cw8.w8a8_matmul_cuda(x, planes["q"], planes["s"])
    torch.testing.assert_close(
        got, cw8.w8a8_matmul_plain(x, planes["q"], planes["s"]), rtol=0,
        atol=0)
    assert cw8.launches == before


@pytest.mark.parametrize("q_shape,s_shape", [((K, N), (N,)),
                                             ((K + 16, N), (1, N)),
                                             ((K, N), (1, N + 1))])
def test_shape_checks_raise(q_shape, s_shape):
    with pytest.raises(ValueError):
        cw8.w8a8_matmul_cuda(torch.zeros(1, K),
                             torch.zeros(q_shape, dtype=torch.int8),
                             torch.ones(s_shape))


def _quant_case(case):
    """x [T, K] f32 for a folded-quantization case, and its layout/dtype:
    the kernel's quantize pass reads bf16 or f32 x at any strides."""
    kind, k = case
    rng = np.random.default_rng(k + len(kind))
    if kind == "ties":
        # amax 127 gives am = 1: every x.5 is a rounding tie (half to even)
        x = rng.integers(-126, 126, size=(4, k)).astype(np.float32) + 0.5
        x[:, 0] = 127.0
        x[2, ::3] = -127.0
        x[3, 1] = -0.5
        return x
    x = (rng.normal(size=(8, k)) * np.linspace(0.5, 2.0, k)
         + 0.1).astype(np.float32)
    x[3] = 0.0  # a zero row keeps scale 1
    x[5, :7] = 1e-42  # subnormal values in a live row
    return x


_QUANT_CASES = [("ties", 512), ("rows", 512), ("rows", 4096),
                ("rows", 14336)]


@pytest.mark.parametrize("layout", ["f32", "bf16", "f32 column-major",
                                    "bf16 column-major"])
@pytest.mark.parametrize("case", _QUANT_CASES,
                         ids=[f"{a}-{b}" for a, b in _QUANT_CASES])
def test_folded_quantization_matches_jax(case, layout):
    """The quantization the W8A8 kernel folds in (its twin,
    quantize_rows_torch, on the f32 values of x as the wrapper hands them
    over) against JAX's core/w8a8.quantize_rows, codes and scales bit for
    bit: zero rows, exact .5 ties, K 512-14336, bf16 and f32 x, and the
    column-major view the embedding lookup gives layer 0."""
    x = _quant_case(case)
    if layout.startswith("bf16"):
        x = x.astype(ml_dtypes.bfloat16)
    want_a, want_am = jw8.quantize_rows(jnp.asarray(x.astype(np.float32)),
                                        jnp)
    xt = array_to_torch(x, "cpu")
    if "column-major" in layout:
        xt = xt.t().contiguous().t()
        assert not xt.is_contiguous()
    got_a, got_am = pdq.quantize_rows_torch(xt.to(torch.float32))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_am.numpy(), np.asarray(want_am))
    # and through the matmul twin the wrapper runs on a CPU tensor
    planes = jw8.requant_w8a8(_w(30, (x.shape[1], 64)))
    want = jw8.w8a8_matmul_golden(x.astype(np.float32), planes, x.shape[1],
                                  64)
    got = cw8.w8a8_matmul_cuda(xt, torch.from_numpy(planes["q"]),
                               torch.from_numpy(planes["s"]))
    np.testing.assert_array_equal(got.numpy(), want)
