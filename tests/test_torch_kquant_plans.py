"""The Q4_K, Q5_K and Q6_K kernels of `csrc/kquant_matmul.cu` on the CPU: their
launch plans (`ops/cuda/plans.py` with the K-quant unit) at the 8B shapes,
and a model of their order of f32 sums held against the JAX `qmatmul` (its
CPU jnp path: bf16 dequant, bf16 activations, f32 dot) at the JAX suite's
1e-4, as tests/test_torch_matmul.py does for Q8_0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.core.dtypes import DType
from ntransformer_tpu.core.layout import relayout
from ntransformer_tpu.core.quant import quantize
from ntransformer_tpu.ops.linear import QLinear as JQLinear
from ntransformer_tpu.ops.linear import qmatmul as jax_qmatmul
from ntransformer_tpu_torch.core.dtypes import DType as PDType
from ntransformer_tpu_torch.models.convert import array_to_torch
from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm
from ntransformer_tpu_torch.ops.cuda import plans
from ntransformer_tpu_torch.ops.dequant_torch import dequant_planes_torch

TOL = 1e-4
KQUANT = ["q4_k", "q5_k", "q6_k"]
# a skinny warp step is 32 plane rows at element k = 64 s; the elements
# that start its k16 blocks, in the order each accumulator takes them (the
# low nibbles of rows 0-15, their high nibbles, then rows 16-31): Q4_K's
# and Q5_K's are the 64 elements from k; Q6_K's the low nibbles of 128 G +
# 32 e + 0-31 (G = k // 128, e = k // 64 % 2) and their high nibbles 64 on
STEP = 64


def step_blocks(dtype: str, k: int) -> tuple:
    if dtype in ("q4_k", "q5_k"):
        return tuple(k + o for o in (0, 32, 16, 48))
    base = 128 * (k // 128) + 32 * (k // 64 % 2)
    return tuple(base + o for o in (0, 64, 16, 80))


def skinny_warps(dtype: str, t: int) -> int:
    """Warps a skinny block (csrc/kquant_matmul.cu Skinny::WARPS): 4, or 3
    for Q5_K and Q6_K at 17-32 tokens, where 4 warps' slots (their qh rows
    among them) leave one block an SM."""
    return 3 if dtype in ("q5_k", "q6_k") and t > 16 else 4


_SHAPES_8B = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
              (4096, 128256)]
_IDS_8B = ["qkv", "wo", "gate_up", "down", "head"]


def _planes(dtype, n, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    return relayout(quantize(w, DType(dtype)), DType(dtype), n, k)


def _x(t, k, seed):
    return (np.random.default_rng(seed).standard_normal((t, k)) * 0.5) \
        .astype(np.float32)


def tile_blocks(dtype: str, st: int) -> tuple:
    """Elements that start the k16 blocks of tile stage st (32 plane rows,
    64 k-values), in wgmma order: Q4_K's and Q5_K's are 64 consecutive
    elements; Q6_K
    stage st holds the low nibbles of 128 (st // 2) + 32 (st % 2) + 0-31
    and their high nibbles 64 elements on."""
    if dtype in ("q4_k", "q5_k"):
        return tuple(64 * st + o for o in (0, 16, 32, 48))
    base = 128 * (st // 2) + 32 * (st % 2)
    return tuple(base + o for o in (0, 16, 64, 80))


def kernel_order_model(x, planes, dtype: str, sms: int = 132):
    """The kernels' order of f32 sums, on the CPU, each 16-element k-block
    product taken as one f32 product of the bf16 operands. Up to
    plans.SKINNY_ROWS tokens (the skinny kernel): a warp's steps are
    elements kb + STEP (w + W i) of its K split (W warps a block), each
    adding its blocks in `step_blocks` order to the warp's sum; a block's
    warps are added in warp order and the cluster's splits in rank order.
    Past it (the wgmma tile): each K split adds its stages' blocks in
    `tile_blocks` order, the splits added in rank order."""
    t, k = x.shape
    pdt = PDType(dtype)
    n = next(iter(planes.values())).shape[1]
    xb = x.to(torch.bfloat16).to(torch.float32)
    w = dequant_planes_torch(planes, pdt, k, n,
                             out_dtype=torch.bfloat16).to(torch.float32)

    def mma(k0):
        return xb[:, k0:k0 + 16] @ w[k0:k0 + 16]

    y = None
    if t > plans.SKINNY_ROWS:
        _, nsplit, split_k = plans.tile_plan(sms, t, k, n, 64)
        for r in range(nsplit):
            acc = torch.zeros(t, n)
            for st in range(r * split_k // 64,
                            min((r + 1) * split_k, k) // 64):
                for k0 in tile_blocks(dtype, st):
                    acc = acc + mma(k0)
            y = acc if y is None else y + acc
        return y
    nsplit, split_k = plans.skinny_plan(sms, t, k, n, plans.KQUANT_UNIT)
    warps = skinny_warps(dtype, t)
    for r in range(nsplit):
        kb, ke = r * split_k, min((r + 1) * split_k, k)
        blk = None
        for wp in range(warps):
            acc = torch.zeros(t, n)
            for k0 in range(kb + STEP * wp, ke, warps * STEP):
                for b in step_blocks(dtype, k0):
                    acc = acc + mma(b)
            blk = acc if blk is None else blk + acc
        y = blk if y is None else y + blk
    return y


@pytest.mark.parametrize("dtype", KQUANT)
def test_model_blocks_cover_k_once(dtype):
    """Each element of K falls in exactly one block of the skinny steps and
    of the tile's stages: the models above sum every product once."""
    k = 1024
    for blocks in (lambda s: step_blocks(dtype, STEP * s),
                   lambda s: tile_blocks(dtype, s)):
        got = sorted(b + i for s in range(k // 64) for b in blocks(s)
                     for i in range(16))
        assert got == list(range(k))


@pytest.mark.parametrize("t", [1, 8, 32, 70])
@pytest.mark.parametrize("n,k", [(384, 512), (256, 2560)])
@pytest.mark.parametrize("dtype", KQUANT)
def test_kernel_summation_order_matches_jax(dtype, n, k, t):
    """The kernels' summation order (warp steps and split clusters at small
    T, the tile's stages past plans.SKINNY_ROWS), reproduced on the CPU,
    stays within the JAX suite's 1e-4 of JAX's qmatmul."""
    planes = _planes(dtype, n, k, seed=t + n + k)
    x = _x(t, k, seed=t + 1)
    want = np.asarray(jax_qmatmul(
        jnp.asarray(x),
        JQLinear(DType(dtype), k, n,
                 {nm_: jnp.asarray(v) for nm_, v in planes.items()})))
    tp = {nm_: array_to_torch(v, "cpu") for nm_, v in planes.items()}
    got = kernel_order_model(torch.from_numpy(x), tp, dtype).numpy()
    plain = nm.nibble_matmul_plain(torch.from_numpy(x), tp,
                                   PDType(dtype)).numpy()
    assert got.shape == (t, n)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)


def _bounds(nsplit, split_k, k):
    return [(r * split_k, min((r + 1) * split_k, k)) for r in range(nsplit)]


@pytest.mark.parametrize("t", [1, 8, 16, 32])
@pytest.mark.parametrize("k,n", _SHAPES_8B, ids=_IDS_8B)
@pytest.mark.parametrize("sms", [132, 114])
def test_skinny_plan_in_superblocks_covers_the_sms(sms, k, n, t):
    """The K-quant skinny plan at the 8B shapes: every SM gets a block, at
    most one portable cluster of splits, each split whole superblocks (128
    plane rows, 256 elements), the splits covering K in rank order with
    none empty."""
    nsplit, split_k = plans.skinny_plan(sms, t, k, n, plans.KQUANT_UNIT)
    assert -(-n // plans.STRIP_COLS) * nsplit >= sms
    assert 1 <= nsplit <= plans.MAX_CLUSTER
    assert split_k % plans.KQUANT_UNIT == 0 and (split_k // 2) % 128 == 0
    bounds = _bounds(nsplit, split_k, k)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a < b for a, b in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(nsplit - 1))


@pytest.mark.parametrize("t", [33, 64, 70, 128, 512])
@pytest.mark.parametrize("k,n", _SHAPES_8B, ids=_IDS_8B)
@pytest.mark.parametrize("sms", [132, 114])
def test_tile_plan_in_stages(sms, k, n, t):
    """The K-quant tile's plan (32-plane-row stages of 64 k-values): 256
    rows only past 128 tokens, K split in at most two in whole stages,
    none empty nor shallower than MIN_TILE_STAGES."""
    bm, nsplit, split_k = plans.tile_plan(sms, t, k, n, 64)
    assert bm in (128, 256) and (bm == 128 or t > 128)
    assert nsplit in (1, 2) and split_k % 64 == 0
    assert nsplit == 1 or split_k // 64 >= plans.MIN_TILE_STAGES
    bounds = _bounds(nsplit, split_k, k)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a < b for a, b in bounds)


def test_skinny_plan_shortens_splits_to_cover_the_sms():
    """16 superblocks (the 8B wo) over 32 strips: 5 splits are wanted but
    equal splits of 4 superblocks give 4 (128 blocks); splits of 3 give 6
    (192), and every SM a block."""
    assert plans.skinny_plan(132, 1, 4096, 4096, plans.KQUANT_UNIT) \
        == (6, 768)
    # the Q8_0 unit keeps its plan there: 32 units make 5 splits of 7
    assert plans.skinny_plan(132, 1, 4096, 4096) == (5, 896)


@pytest.mark.parametrize("dtype", KQUANT)
def test_kquant_kernels_are_the_new_source(dtype):
    """Q4_K, Q5_K and Q6_K are the skinny kernel and the wgmma tile of
    csrc/kquant_matmul.cu: one launch a product, no GEMV split rows."""
    kern = nm.KERNELS[PDType(dtype)]
    assert kern.source == "csrc/kquant_matmul.cu"
    assert (kern.chunk_rows, kern.split_rows) == (0, 0)
    assert kern.name in nm._KQ_SIGNATURES and kern.name not in nm._SIGNATURES
