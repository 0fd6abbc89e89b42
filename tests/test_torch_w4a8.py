"""Port parity for the W4A8 format: the port's numpy copy (core/w4a8.py),
its torch twins (ops/dequant_torch.py), the plain twins of the decode kernel
(ops/cuda/w4a8.py, T = 1) and of the T > 1 tile (the w4a8_matmul entry of
ops/cuda/nibble_matmul.py), the `qmatmul` dispatch and
`convert_qlinear_w4a8` against the JAX package on the same numpy inputs,
at K 1024 and N 256 as tests/test_w4a8.py.

Planes and activation codes and scales must be bit-equal (numpy and torch
alike), the exact group sums within 1e-6 (their summation order is the
device's). The decode product is held at the JAX suite's 2e-5 of its
largest value against the interpret-mode Pallas kernel and the JAX CPU
`qmatmul` (its golden); the T > 1 product at 1e-4 against the JAX CPU
`qmatmul` (bf16 dequant, bf16 activations, f32 dot), not the
interpret-mode tile, which dots at full f32 (ROADMAP queue 3)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ntransformer_tpu.core import w4a8 as jw4
from ntransformer_tpu.core.dtypes import DType
from ntransformer_tpu.ops.dequant_jnp import dequant_planes_jnp
from ntransformer_tpu.ops.linear import QLinear as JQLinear
from ntransformer_tpu.ops.linear import convert_qlinear_w4a8 as jconvert
from ntransformer_tpu.ops.linear import qmatmul as jax_qmatmul
from ntransformer_tpu.ops.pallas.w4a8 import w4a8_decode_pallas
from ntransformer_tpu_torch.core import w4a8 as pw4
from ntransformer_tpu_torch.core.dtypes import DType as PDType
from ntransformer_tpu_torch.models.convert import array_to_torch
from ntransformer_tpu_torch.ops import dequant_torch as pdq
from ntransformer_tpu_torch.ops import linear as plinear
from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
from ntransformer_tpu_torch.ops.cuda import w4a8 as cw4
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_w8a8 import _pt, _source, _torch_ql, _w, _x

K, N = 1024, 256
DECODE_RTOL = 2e-5
MATMUL_TOL = 1e-4


def _wplanes(seed):
    return jw4.requant_w4a8(_w(seed, (K, N)))


def _pql(planes):
    return plinear.QLinear(PDType.W4A8, K, N,
                           {nm_: torch.from_numpy(np.ascontiguousarray(v))
                            for nm_, v in planes.items()})


def _jql(planes):
    return JQLinear(DType.W4A8, K, N,
                    {nm_: jnp.asarray(v) for nm_, v in planes.items()})


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_numpy_copy_matches_the_jax_module():
    w = _w(1, (K, N))
    want = jw4.requant_w4a8(w)
    got = pw4.requant_w4a8(w)
    for nm_ in want:
        np.testing.assert_array_equal(got[nm_], want[nm_])
    np.testing.assert_array_equal(pw4.dequant_w4a8(got, K, N),
                                  jw4.dequant_w4a8(want, K, N))
    x = _x(1, 2, K)
    a, b = pw4.quantize_activations(x), jw4.quantize_activations(x)
    for nm_ in b:
        np.testing.assert_array_equal(a[nm_], b[nm_])
    np.testing.assert_array_equal(pw4.w4a8_matmul_golden(x, got, K, N),
                                  jw4.w4a8_matmul_golden(x, want, K, N))
    with pytest.raises(ValueError):
        pw4.requant_w4a8(np.zeros((768, 8), np.float32))


def test_torch_requant_bit_equal():
    w = _w(3, (K, N))
    want = jw4.requant_w4a8(w)
    got = pdq.requant_w4a8_torch(torch.from_numpy(w))
    assert got["qs"].dtype == torch.uint8
    for nm_ in want:
        np.testing.assert_array_equal(got[nm_].numpy(), want[nm_], err_msg=nm_)


@pytest.mark.parametrize("t", [1, 3])
def test_activation_codes_bit_equal(t):
    """Codes and alpha bit for bit, xsum within 1e-6; a zero group keeps
    alpha at its 1e-30 clamp and codes 0."""
    x = _x(t, 4, K)
    x[0, 256:512] = 0.0
    got = pdq.quantize_activations_torch(torch.from_numpy(x))
    want = jw4.quantize_activations(x)
    for nm_ in ("a_lo", "a_hi", "alpha_lo", "alpha_hi"):
        assert got[nm_].dtype == torch.from_numpy(want[nm_]).dtype, nm_
        np.testing.assert_array_equal(got[nm_].numpy(), want[nm_], err_msg=nm_)
    for nm_ in ("xsum_lo", "xsum_hi"):
        np.testing.assert_allclose(got[nm_].numpy(), want[nm_], rtol=1e-6,
                                   atol=1e-6 * np.abs(x).sum(), err_msg=nm_)
    assert float(got["alpha_hi"][0, 0]) == np.float32(1e-30)


@pytest.mark.parametrize("planes_on", ["numpy", "torch"])
@pytest.mark.parametrize("kind", ["q8_0", "q4_k", "bf16"])
def test_convert_planes_bit_equal(kind, planes_on):
    jq, pq = _source(kind, seed=7, k=K, n=N)
    if planes_on == "torch":
        pq = _torch_ql(pq, bf16_float=True)
    want = jconvert(jq)
    got = plinear.convert_qlinear_w4a8(pq)
    assert got.dtype == PDType.W4A8 and (got.k, got.n) == (K, N)
    assert isinstance(got.planes["qs"], np.ndarray) == (planes_on == "numpy")
    for nm_, v in want.planes.items():
        np.testing.assert_array_equal(_pt(got.planes)[nm_], np.asarray(v),
                                      err_msg=nm_)


def test_convert_stacked_planes_and_idempotent():
    jq, pq = _source("q4_k", seed=9, lead=2, k=K, n=N)
    want = jconvert(jq)
    for planes_on in ("numpy", "torch"):
        src = pq if planes_on == "numpy" else _torch_ql(pq)
        got = plinear.convert_qlinear_w4a8(src)
        assert tuple(got.planes["qs"].shape) == (2, K // 2, N)
        assert tuple(got.planes["s_lo"].shape) == (2, K // 512, N)
        for nm_, v in want.planes.items():
            np.testing.assert_array_equal(_pt(got.planes)[nm_], np.asarray(v))
        assert plinear.convert_qlinear_w4a8(got) is got


def test_dequant_planes_bit_equal():
    """dequant_planes_torch on stacked planes against the JAX package's jnp
    and numpy dequant of each layer."""
    one, two = _wplanes(10), _wplanes(11)
    stacked = {nm_: np.stack([one[nm_], two[nm_]]) for nm_ in one}
    got = pdq.dequant_planes_torch(
        {nm_: torch.from_numpy(v) for nm_, v in stacked.items()},
        PDType.W4A8, K, N)
    for i in range(2):
        layer = {nm_: v[i] for nm_, v in stacked.items()}
        want = jw4.dequant_w4a8(layer, K, N)
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(dequant_planes_jnp(
                {nm_: jnp.asarray(v) for nm_, v in layer.items()},
                DType.W4A8, K, N)))


def test_decode_twin_matches_jax():
    """T = 1: the plain twin and the port's CPU qmatmul against the
    interpret-mode Pallas kernel and the JAX CPU qmatmul (the golden)."""
    planes = _wplanes(12)
    x = _x(1, 13, K)
    kern = np.asarray(w4a8_decode_pallas(jnp.asarray(x), _jql(planes),
                                         interpret=True))
    cpu = np.asarray(jax_qmatmul(jnp.asarray(x), _jql(planes)))
    pq = _pql(planes)
    plain = cw4.w4a8_decode_plain(torch.from_numpy(x), pq.planes).numpy()
    got = plinear.qmatmul(torch.from_numpy(x), pq).numpy()
    assert got.shape == (1, N) and got.dtype == np.float32
    np.testing.assert_array_equal(got, plain)
    for want in (kern, cpu):
        assert _rel(plain, want) <= DECODE_RTOL
    # bf16 activations, as the layers hand them over
    xb = x.astype(ml_dtypes.bfloat16)
    want = np.asarray(jax_qmatmul(jnp.asarray(xb), _jql(planes)))
    got = plinear.qmatmul(array_to_torch(xb, "cpu"), pq).numpy()
    assert _rel(got, want) <= DECODE_RTOL


def test_decode_stacked_layer_select():
    one, two = _wplanes(14), _wplanes(15)
    stacked = {nm_: np.stack([one[nm_], two[nm_]]) for nm_ in one}
    x = _x(1, 16, K)
    pq = _pql(stacked)
    for li in range(2):
        want = np.asarray(w4a8_decode_pallas(jnp.asarray(x), _jql(stacked),
                                             interpret=True,
                                             layer=jnp.int32(li)))
        got = plinear.qmatmul(torch.from_numpy(x), pq, layer=li).numpy()
        assert _rel(got, want) <= DECODE_RTOL


@pytest.mark.parametrize("t", [4, 70])
def test_t_gt_1_tile_matches_jax(t):
    """T > 1: the w4a8_matmul twin and the CPU qmatmul against the JAX CPU
    qmatmul (exact dequant to bf16), also through a stacked layer view."""
    one, two = _wplanes(17), _wplanes(18)
    stacked = {nm_: np.stack([one[nm_], two[nm_]]) for nm_ in one}
    x = _x(t, 19, K)
    want = np.asarray(jax_qmatmul(jnp.asarray(x), _jql(stacked),
                                  layer=jnp.int32(1)))
    pq = _pql(stacked)
    got = plinear.qmatmul(torch.from_numpy(x), pq, layer=1).numpy()
    plain = nm.nibble_matmul_plain(torch.from_numpy(x), pq.layer(1).planes,
                                   PDType.W4A8).numpy()
    np.testing.assert_allclose(got, want, rtol=MATMUL_TOL, atol=MATMUL_TOL)
    np.testing.assert_allclose(plain, want, rtol=MATMUL_TOL, atol=MATMUL_TOL)


def test_wrappers_on_cpu_launch_nothing():
    """On CPU tensors each wrapper is its plain twin; the tile refuses
    T = 1 (the decode kernel's product) and the decode kernel T > 1."""
    pq = _pql(_wplanes(20))
    before = (cw4.launches, nm.KERNELS[PDType.W4A8].launches)
    x1 = torch.from_numpy(_x(1, 21, K))
    torch.testing.assert_close(cw4.w4a8_decode_cuda(x1, pq.planes),
                               cw4.w4a8_decode_plain(x1, pq.planes),
                               rtol=0, atol=0)
    x4 = torch.from_numpy(_x(4, 22, K))
    torch.testing.assert_close(
        nm.nibble_matmul_cuda(x4, pq.planes, PDType.W4A8),
        nm.nibble_matmul_plain(x4, pq.planes, PDType.W4A8), rtol=0, atol=0)
    assert (cw4.launches, nm.KERNELS[PDType.W4A8].launches) == before
    with pytest.raises(ValueError, match="w4a8_decode"):
        nm.nibble_matmul_cuda(x1, pq.planes, PDType.W4A8)
    with pytest.raises(ValueError, match="T = 1"):
        cw4.w4a8_decode_cuda(x4, pq.planes)


@pytest.mark.parametrize("k", [768, 1536])
def test_shape_checks_raise(k):
    """K must hold whole 512-element units and match the planes."""
    pq = _pql(_wplanes(23))
    with pytest.raises(ValueError):
        cw4.w4a8_decode_cuda(torch.zeros(1, k), pq.planes)
    with pytest.raises(ValueError):
        nm.nibble_matmul_cuda(torch.zeros(2, k), pq.planes, PDType.W4A8)


# ------------------------------------------------------------------------
# The decode kernel quantizes x itself: the twin's quantization (alpha by an
# IEEE division, xsum in the kernel's fixed tree) and the pair plan; the
# T > 1 tile at shapes that cut its 128-row, 128/256-column tiles.

def _wplanes_kn(seed, k, n):
    return jw4.requant_w4a8(_w(seed, (k, n)))


def _ql_kn(planes, k, n, on="torch"):
    if on == "torch":
        return plinear.QLinear(PDType.W4A8, k, n,
                               {nm_: torch.from_numpy(np.ascontiguousarray(v))
                                for nm_, v in planes.items()})
    return JQLinear(DType.W4A8, k, n,
                    {nm_: jnp.asarray(v) for nm_, v in planes.items()})


@pytest.mark.parametrize("k", [512, 1024, 14336])
def test_tree_xsum_against_float64_and_jax(k):
    """The twin's group sums (the kernel's tree) against an exact float64
    sum, within the f32 rounding of 255 adds, and against the JAX package's
    quantize_activations within the same; codes and alpha bit for bit."""
    x = _x(1, 30 + k, k)
    acts = cw4._activations(torch.from_numpy(x))
    want = jw4.quantize_activations(x)
    g = x.reshape(-1, 256).astype(np.float64)
    exact = g.sum(axis=1)
    # 255 roundings of at most half an ulp of a partial of |x| sums
    tol = 255 * np.finfo(np.float32).eps * np.abs(g).sum(axis=1)
    for half, sl in (("lo", slice(0, None, 2)), ("hi", slice(1, None, 2))):
        got = acts[f"xsum_{half}"].numpy().astype(np.float64)
        assert np.all(np.abs(got - exact[sl]) <= tol[sl])
        np.testing.assert_allclose(got, want[f"xsum_{half}"][0],
                                   rtol=0, atol=float(tol.max()))
        np.testing.assert_array_equal(acts[f"alpha_{half}"].numpy(),
                                      want[f"alpha_{half}"][0])
        np.testing.assert_array_equal(acts[f"a_{half}"].numpy(),
                                      want[f"a_{half}"][0].astype(np.int8))


def test_tree_sum_order():
    """tree_sum halves the axis: ((v0 + v2) + (v1 + v3)) for four values,
    not the left-to-right order."""
    v = torch.tensor([[1.0, 2.0 ** -24, -1.0, 2.0 ** -24]])
    assert float(cw4.tree_sum(v)[0]) == float((v[0, 0] + v[0, 2])
                                              + (v[0, 1] + v[0, 3]))
    assert float(cw4.tree_sum(v)[0]) != float(((v[0, 0] + v[0, 1])
                                               + v[0, 2]) + v[0, 3])


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,n", [(512, 256), (1024, 256), (14336, 64)])
def test_decode_twin_matches_jax_across_k(k, n, x_dtype):
    """T = 1 at one pair, two pairs and the 8B down's 28 pairs (narrow N),
    with f32 and bf16 activations: the plain twin and the CPU qmatmul
    against the JAX decode (the interpret-mode Pallas kernel) and the JAX
    package's golden (core/w4a8.w4a8_matmul_golden). The JAX CPU qmatmul
    joins where K is the JAX suite's size: at 28 pairs it is itself
    2.2e-5 of its largest value from the golden."""
    planes = _wplanes_kn(40 + k, k, n)
    x = _x(1, 41 + k, k)
    if x_dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    xt = array_to_torch(x, "cpu")
    pq = _ql_kn(planes, k, n)
    plain = cw4.w4a8_decode_plain(xt, pq.planes).numpy()
    np.testing.assert_array_equal(plinear.qmatmul(xt, pq).numpy(), plain)
    kern = np.asarray(w4a8_decode_pallas(
        jnp.asarray(x), _ql_kn(planes, k, n, "jax"), interpret=True))
    gold = jw4.w4a8_matmul_golden(x.astype(np.float32), planes, k, n)
    for want in (kern, gold):
        assert _rel(plain, want) <= DECODE_RTOL
    if k <= 1024:
        want = np.asarray(jax_qmatmul(jnp.asarray(x),
                                      _ql_kn(planes, k, n, "jax")))
        assert _rel(plain, want) <= DECODE_RTOL


@pytest.mark.parametrize("k,want", [
    (512, 1),      # one pair
    (1024, 2),     # repolm512's down
    (4096, 8),     # the 8B qkv, wo, gate|up and head: one pass
    (14336, 7),    # the 8B down, 28 pairs: 4 runs of 7
    (28672, 8),    # 56 pairs: 7 runs of 8
])
def test_pair_plan(k, want):
    """Pairs a block: all of K up to 8 (one warp a pair), else the fewest
    runs of at most 8."""
    pps = cw4.pair_plan(k)
    assert pps == want
    pairs = k // 512
    assert pps <= 8 and -(-pairs // pps) == -(-pairs // 8)


@pytest.mark.parametrize("t,n", [(130, 256), (70, 200), (257, 512)])
def test_t_gt_1_tile_ragged_shapes_match_jax(t, n):
    """T > 1 at a T that is not a multiple of the tile's 128 rows and a
    ragged N (200: no 16-column vector copies), through a stacked layer
    view: the w4a8_matmul twin and the CPU qmatmul against the JAX CPU
    qmatmul."""
    k = 1024
    one, two = _wplanes_kn(50 + t, k, n), _wplanes_kn(51 + t, k, n)
    stacked = {nm_: np.stack([one[nm_], two[nm_]]) for nm_ in one}
    x = _x(t, 52 + t, k)
    want = np.asarray(jax_qmatmul(jnp.asarray(x),
                                  _ql_kn(stacked, k, n, "jax"),
                                  layer=jnp.int32(1)))
    pq = _ql_kn(stacked, k, n)
    got = plinear.qmatmul(torch.from_numpy(x), pq, layer=1).numpy()
    plain = nm.nibble_matmul_plain(torch.from_numpy(x), pq.layer(1).planes,
                                   PDType.W4A8).numpy()
    assert got.shape == (t, n)
    np.testing.assert_allclose(got, want, rtol=MATMUL_TOL, atol=MATMUL_TOL)
    np.testing.assert_allclose(plain, want, rtol=MATMUL_TOL, atol=MATMUL_TOL)


@pytest.mark.parametrize("t,n,want", [
    (512, 28672, (256, 128)),  # gate|up prefill: 448 tiles of 256 rows
    (512, 6144, (256, 128)),   # qkv: 96 tiles, at least half the SMs
    (512, 4096, (128, 128)),   # wo, down: 64 tiles of either larger shape
    (130, 28672, (256, 128)),
    (32, 28672, (128, 256)),   # a batched step: 256 rows would be empty
    (70, 512, (128, 128)),     # repolm512
])
def test_w4a8_tile_shape(monkeypatch, t, n, want):
    """The T > 1 tile's shape: the first of 256 x 128 (T > 128), 128 x 256
    and 128 x 128 that gives at least half of 132 SMs a block."""
    monkeypatch.setattr(nm.plans, "sm_count", lambda device: 132)
    assert nm.w4a8_tile(None, t, n) == want
