"""The Q4_0, Q4_K, Q5_K and Q6_K kernels of `csrc/kquant_matmul.cu` on the
CPU: their launch plans (`ops/cuda/plans.py` with the K-quant unit, or
Q4_0's 64-element step) at the 8B shapes, and a model of their order of f32
sums held against the JAX `qmatmul` (its CPU jnp path: bf16 dequant, bf16
activations, f32 dot) at the JAX suite's 1e-4, as tests/test_torch_matmul.py
does for Q8_0."""
import dataclasses
import os
import re

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
KQUANT = ["q4_0", "q4_k", "q5_k", "q6_k"]  # the formats of kquant_matmul.cu
# a skinny warp step is 32 plane rows at element k = 64 s; the elements
# that start its k16 blocks, in the order each accumulator takes them (the
# low nibbles of rows 0-15, their high nibbles, then rows 16-31): Q4_0's
# are k, k + 16, k + 32, k + 48 (rows 0-15 hold elements k + 0-15 and
# k + 16-31, rows 16-31 the next 32); Q4_K's and Q5_K's the 64 elements
# from k in the order 0, 32, 16, 48; Q6_K's the low nibbles of 128 G +
# 32 e + 0-31 (G = k // 128, e = k // 64 % 2) and their high nibbles 64 on
STEP = 64


def step_blocks(dtype: str, k: int) -> tuple:
    if dtype == "q4_0":
        return tuple(k + o for o in (0, 16, 32, 48))
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
    64 k-values), in wgmma order: Q4_0's, Q4_K's and Q5_K's are 64
    consecutive elements (Q4_0: rows 0-15's low nibbles, their high ones,
    then rows 16-31's; Q4_K: the low nibbles' 32, then the high ones'); Q6_K
    stage st holds the low nibbles of 128 (st // 2) + 32 (st % 2) + 0-31
    and their high nibbles 64 elements on."""
    if dtype in ("q4_0", "q4_k", "q5_k"):
        return tuple(64 * st + o for o in (0, 16, 32, 48))
    base = 128 * (st // 2) + 32 * (st % 2)
    return tuple(base + o for o in (0, 16, 64, 80))


def split_unit(dtype: str) -> int:
    """The skinny plan's unit of K: Q4_0's step, the K-quants' superblock."""
    return plans.Q4_0_UNIT if dtype == "q4_0" else plans.KQUANT_UNIT


def kernel_order_model(x, planes, dtype: str, sms: int = 132,
                       plan_n: int | None = None):
    """The kernels' order of f32 sums, on the CPU, each 16-element k-block
    product taken as one f32 product of the bf16 operands. Up to
    plans.SKINNY_ROWS tokens (the skinny kernel): a warp's steps are
    elements kb + STEP (w + W i) of its K split (W warps a block), each
    adding its blocks in `step_blocks` order to the warp's sum; a block's
    warps are added in warp order and the cluster's splits in rank order.
    Past it (the wgmma tile): each K split adds its stages' blocks in
    `tile_blocks` order, the splits added in rank order. A block past K
    (Q4_0's half step or stage where K % 64 == 32) is zero-filled: it adds
    nothing. plan_n: the N the plans see (default the planes' own), so a
    few columns of a wide matrix are summed as the kernel sums them."""
    t, k = x.shape
    pdt = PDType(dtype)
    n = next(iter(planes.values())).shape[1]
    pn = plan_n or n
    xb = x.to(torch.bfloat16).to(torch.float32)
    w = dequant_planes_torch(planes, pdt, k, n,
                             out_dtype=torch.bfloat16).to(torch.float32)

    def add(acc, k0):
        return acc + xb[:, k0:k0 + 16] @ w[k0:k0 + 16] if k0 < k else acc

    y = None
    if t > plans.SKINNY_ROWS:
        _, nsplit, split_k = plans.tile_plan(sms, t, k, pn, 64)
        for r in range(nsplit):
            acc = torch.zeros(t, n)
            for st in range(r * split_k // 64,
                            -(-min((r + 1) * split_k, k) // 64)):
                for k0 in tile_blocks(dtype, st):
                    acc = add(acc, k0)
            y = acc if y is None else y + acc
        return y
    nsplit, split_k = plans.skinny_plan(sms, t, k, pn, split_unit(dtype))
    warps = skinny_warps(dtype, t)
    for r in range(nsplit):
        kb, ke = r * split_k, min((r + 1) * split_k, k)
        blk = None
        for wp in range(warps):
            acc = torch.zeros(t, n)
            for k0 in range(kb + STEP * wp, ke, warps * STEP):
                for b in step_blocks(dtype, k0):
                    acc = add(acc, b)
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


# Q4_0 at the 8B shapes, summed as the kernels sum 128 of their columns
# (a column's order of sums follows the plan of the whole width), and at
# K = 1056, whose last step and stage are half (K % 64 == 32)
_Q4_0_SHAPES = _SHAPES_8B + [(1056, 256)]
_Q4_0_IDS = _IDS_8B + ["odd_k_1056"]


@pytest.mark.parametrize("t", [1, 8, 32, 70])
@pytest.mark.parametrize("k,n", _Q4_0_SHAPES, ids=_Q4_0_IDS)
def test_q4_0_summation_order_at_8b_shapes_matches_jax(k, n, t):
    """Q4_0's skinny steps (blocks k, k + 16, k + 32, k + 48) and tile
    stages at the 8B shapes' plans (head too) and at the half step of
    K = 1056, reproduced on the CPU for 128 columns, within 1e-4 of JAX's
    qmatmul and of the plain twin."""
    cols = min(n, 128)
    planes = _planes("q4_0", cols, k, seed=k + t)
    x = _x(t, k, seed=t + 7)
    want = np.asarray(jax_qmatmul(
        jnp.asarray(x),
        JQLinear(DType.Q4_0, k, cols,
                 {nm_: jnp.asarray(v) for nm_, v in planes.items()})))
    tp = {nm_: array_to_torch(v, "cpu") for nm_, v in planes.items()}
    got = kernel_order_model(torch.from_numpy(x), tp, "q4_0",
                             plan_n=n).numpy()
    plain = nm.nibble_matmul_plain(torch.from_numpy(x), tp,
                                   PDType.Q4_0).numpy()
    assert got.shape == (t, cols)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)


def test_q4_0_blocks_cover_a_half_step_once():
    """At K = 1056 the blocks of the whole steps and of the half step's
    first two blocks cover K once; the half step's last two blocks lie
    past K (the kernels zero-fill them)."""
    k = 1056
    for blocks in (lambda s: step_blocks("q4_0", STEP * s),
                   lambda s: tile_blocks("q4_0", s)):
        starts = [b for s in range(-(-k // 64)) for b in blocks(s)]
        got = sorted(b + i for b in starts if b < k for i in range(16))
        assert got == list(range(k))
        assert [b for b in starts if b >= k] == [k, k + 16]


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


@pytest.mark.parametrize("t", [1, 8, 16, 32])
@pytest.mark.parametrize("k,n", _Q4_0_SHAPES, ids=_Q4_0_IDS)
@pytest.mark.parametrize("sms", [132, 114])
def test_q4_0_skinny_plan_in_steps(sms, k, n, t):
    """The Q4_0 skinny plan: splits of whole 64-element steps (a half step
    ends the last split where K % 64 == 32), at most one portable cluster,
    covering K once in rank order with none empty; at the 8B shapes every
    SM gets a block."""
    nsplit, split_k = plans.skinny_plan(sms, t, k, n, plans.Q4_0_UNIT)
    assert 1 <= nsplit <= plans.MAX_CLUSTER
    assert split_k % plans.Q4_0_UNIT == 0
    bounds = _bounds(nsplit, split_k, k)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a < b for a, b in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(nsplit - 1))
    if k != 1056:
        assert -(-n // plans.STRIP_COLS) * nsplit >= sms


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


@pytest.mark.parametrize("unit", [plans.KQUANT_UNIT, plans.Q4_0_UNIT],
                         ids=["kquant", "q4_0"])
@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096)],
                         ids=["gate_up", "down"])
@pytest.mark.parametrize("sms", [132, 114])
def test_skinny_plan_at_mixtral_expert_shapes(sms, k, n, unit):
    """The T = 1 select's plan at the Mixtral-8x7B expert shapes (Q4_K
    gate/up, Q6_K down; Q4_0 and Q5_K alike): every SM gets a block, the
    splits are one portable cluster of whole superblocks (or 64-element
    steps) covering K once in rank order."""
    nsplit, split_k = plans.skinny_plan(sms, 1, k, n, unit)
    assert -(-n // plans.STRIP_COLS) * nsplit >= sms
    assert 1 <= nsplit <= plans.MAX_CLUSTER
    assert split_k % unit == 0
    bounds = _bounds(nsplit, split_k, k)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a < b for a, b in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(nsplit - 1))


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
    """Q4_0, Q4_K, Q5_K and Q6_K are the skinny kernel and the wgmma tile of
    csrc/kquant_matmul.cu: one launch a product, no GEMV chunk or split
    rows (the Kernel record holds the entry, its TPU kernel, its source and
    its counter alone)."""
    kern = nm.KERNELS[PDType(dtype)]
    assert kern.source == "csrc/kquant_matmul.cu"
    assert [f.name for f in dataclasses.fields(kern)] == \
        ["name", "replaces", "source", "launches"]
    assert PDType(dtype) in nm.KQ_FORMATS
    assert kern.name in nm._KQ_SIGNATURES and kern.name not in nm._SIGNATURES
    assert not hasattr(nm, "split_plan") and not hasattr(nm, "sm_count")


def test_nibble_source_holds_the_w4a8_tile_alone():
    """csrc/nibble_matmul.cu lost the Q4_0 kernels (the GEMV, its split-K
    reduce and the mma.sync tile) to csrc/kquant_matmul.cu: it defines
    none of them and exports w4a8_matmul (and nt_error_string) alone."""
    src = open(os.path.join(nm.build.CSRC_DIR, "nibble_matmul.cu")).read()
    for gone in ("nib_gemv_kernel", "splitk_reduce_kernel", "nib_mma_kernel",
                 "q4_0"):
        assert gone not in src
    exports = re.findall(r'extern "C" [^(]*?(\w+)\(', src)
    assert exports == ["w4a8_matmul", "nt_error_string"]
    kq = open(os.path.join(nm.build.CSRC_DIR, "kquant_matmul.cu")).read()
    assert "KQUANT_ENTRY(q4_0_matmul, Q40, TileQ40)" in kq
