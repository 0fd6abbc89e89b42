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
from ntransformer_tpu_torch.ops.cuda import plans

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


@pytest.mark.parametrize("t", [1, 4, 8, 32, 70])
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


def _kernel_order_model(x, qs, d, sms=132):
    """The CUDA kernel's order of f32 sums, on the CPU: up to
    plans.SKINNY_ROWS tokens, each 16-row mma product added to its warp's
    sum in step order (a warp's steps are rows kb + 32 (w + 4 i) of its K
    split), a block's 4 warps added in warp order and the cluster's splits
    in rank order; past it the tile adds the 16-row products in K order."""
    t, k = x.shape
    n = qs.shape[1]
    xb = x.to(torch.bfloat16).to(torch.float32)
    w = cuda_matmul.dequant_planes_torch(
        {"qs": qs, "d": d}, PDType.Q8_0, k, n,
        out_dtype=torch.bfloat16).to(torch.float32)

    def mma(k0):
        return xb[:, k0:k0 + 16] @ w[k0:k0 + 16]

    if t > plans.SKINNY_ROWS:
        y = torch.zeros(t, n)
        for k0 in range(0, k, 16):
            y = y + mma(k0)
        return y
    nsplit, split_k = plans.skinny_plan(sms, t, k, n)
    y = None
    for r in range(nsplit):
        kb, ke = r * split_k, min((r + 1) * split_k, k)
        blk = None
        for wp in range(4):
            acc = torch.zeros(t, n)
            for k0 in range(kb + 32 * wp, ke, 128):
                acc = acc + mma(k0)
                acc = acc + mma(k0 + 16)
            blk = acc if blk is None else blk + acc
        y = blk if y is None else y + blk
    return y


@pytest.mark.parametrize("t", [1, 8, 32, 70])
@pytest.mark.parametrize("n,k", [(384, 512), (128, 1376)])
def test_kernel_summation_order_matches_jax(t, n, k):
    """The kernel's summation order (split-K clusters and warps at small T,
    the tile's K order past plans.SKINNY_ROWS), reproduced on the CPU, stays
    within the JAX suite's 1e-4 of JAX's qmatmul."""
    planes = _planes(n, k, seed=t + n)
    x = _x(t, k, seed=t + 1)
    want = np.asarray(jax_qmatmul(jnp.asarray(x), _jax_ql(planes, k, n)))
    ql = _port_ql(planes, k, n)
    got = _kernel_order_model(torch.from_numpy(x), ql.planes["qs"],
                              ql.planes["d"]).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


_SHAPES_8B = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
              (4096, 128256)]


@pytest.mark.parametrize("t", [1, 8, 16, 32])
@pytest.mark.parametrize("k,n", _SHAPES_8B,
                         ids=["qkv", "wo", "gate_up", "down", "head"])
@pytest.mark.parametrize("sms", [132, 114])
def test_skinny_plan_covers_the_sms(sms, k, n, t):
    """The skinny kernel's plan at the 8B shapes: at least one block an SM,
    at most one portable cluster of splits, each split whole 128-row units,
    the splits covering K in rank order with none empty."""
    nsplit, split_k = plans.skinny_plan(sms, t, k, n)
    assert -(-n // plans.STRIP_COLS) * nsplit >= sms
    assert 1 <= nsplit <= plans.MAX_CLUSTER
    assert split_k % plans.SPLIT_UNIT == 0
    bounds = [(r * split_k, min((r + 1) * split_k, k))
              for r in range(nsplit)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a < b for a, b in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(nsplit - 1))


@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096)],
                         ids=["gate_up", "down"])
@pytest.mark.parametrize("sms", [132, 114])
def test_skinny_plan_at_mixtral_expert_shapes(sms, k, n):
    """The T = 1 select's plan (Q8_0 and W8A8) at the Mixtral-8x7B expert
    shapes: one routed expert is planned as a matrix of its own shape, so
    every SM gets a block, the splits are one portable cluster of whole
    128-row units and cover K once, in rank order."""
    nsplit, split_k = plans.skinny_plan(sms, 1, k, n)
    assert -(-n // plans.STRIP_COLS) * nsplit >= sms
    assert 1 <= nsplit <= plans.MAX_CLUSTER
    assert split_k % plans.SPLIT_UNIT == 0
    bounds = [(r * split_k, min((r + 1) * split_k, k))
              for r in range(nsplit)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(nsplit - 1))


@pytest.mark.parametrize("stage_k", [64, 128], ids=["q8_0", "w8a8"])
@pytest.mark.parametrize("t", [33, 70, 128, 256, 512])
@pytest.mark.parametrize("k,n", _SHAPES_8B,
                         ids=["qkv", "wo", "gate_up", "down", "head"])
@pytest.mark.parametrize("sms", [132, 114])
def test_tile_plan_covers_the_sms(sms, k, n, t, stage_k):
    """The tile's plan: 256 rows only past 128 tokens; K split in at most
    two in rank order, none empty nor shallower than MIN_TILE_STAGES; and
    the blocks cover the SMs unless every plan that covers them costs more
    in the measured model (a second wave of blocks: at T = 512 the 8B qkv's
    96 256-row blocks, 0.0808 ms on an H100 80GB HBM3 at 700 W, beat its
    192 128-row ones, 0.1234; experiments/matmul_plans.py)."""
    bm, nsplit, split_k = plans.tile_plan(sms, t, k, n, stage_k)
    assert bm in (128, 256) and (bm == 128 or t > 128)
    assert nsplit in (1, 2) and split_k % stage_k == 0
    stages = -(-k // stage_k)
    assert nsplit == 1 or split_k // stage_k >= plans.MIN_TILE_STAGES
    bounds = [(r * split_k, min((r + 1) * split_k, k))
              for r in range(nsplit)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a < b for a, b in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(nsplit - 1))
    blocks = -(-t // bm) * -(-n // plans.TILE_COLS) * nsplit
    if blocks < sms:
        cost = plans.tile_cost(sms, t, n, bm, nsplit)
        for cbm in ((128, 256) if t > 128 else (128,)):
            for cns in ((1, 2) if stages >= 2 * plans.MIN_TILE_STAGES
                        else (1,)):
                if -(-t // cbm) * -(-n // plans.TILE_COLS) * cns >= sms:
                    assert plans.tile_cost(sms, t, n, cbm, cns) > cost
