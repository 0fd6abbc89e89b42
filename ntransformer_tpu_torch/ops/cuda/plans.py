"""Launch plans of the Q8_0, W8A8, Q4_0 and K-quant (Q4_K, Q5_K, Q6_K)
matmul kernels (`csrc/q8_0_matmul.cu`, `csrc/w8a8_matmul.cu`,
`csrc/kquant_matmul.cu`): plain integer arithmetic on the shapes and the SM
count, so the CPU tests hold them.

Up to SKINNY_ROWS tokens a product runs the skinny kernel: blocks of 4 warps
(3 for Q5_K and Q6_K past 16 tokens) own a strip of 128 columns and a K
split of whole units (128 rows for Q8_0 and W8A8, a 256-element superblock
for the K-quants, a 64-element step for Q4_0); the splits of a strip
are one thread-block cluster of at most 8 blocks, summed in rank order.
Past SKINNY_ROWS it runs the wgmma tile of 256 or 128 rows by 128 columns,
its K split in two the same way where that measured faster.
"""
from __future__ import annotations

import torch

SKINNY_ROWS = 32      # the skinny kernel's most tokens
MAX_CLUSTER = 8       # K splits of a skinny strip: one portable cluster
SPLIT_UNIT = 128      # K rows: one 32-row step for each of a block's warps
KQUANT_UNIT = 256     # K elements: a K-quant superblock (128 plane rows)
Q4_0_UNIT = 64        # K elements: a skinny step, two Q4_0 blocks
MIN_TILE_STAGES = 8   # a tile's K split keeps at least these stages
STRIP_COLS = 128      # the skinny kernel's columns a block
TILE_COLS = 128

_SM_COUNT: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def skinny_plan(sms: int, t: int, k: int, n: int,
                unit: int = SPLIT_UNIT) -> tuple[int, int]:
    """(splits, K rows a split) of the skinny kernel: the fewest splits
    whose (strip, split) blocks give every SM one (fewer, longer streams
    measured faster than two blocks an SM: Q8_0 0.0528 against 0.0813 ms on
    the device at the 8B gate|up, T = 1, experiments/matmul_plans.py on an
    H100 80GB HBM3 at 700 W), at most MAX_CLUSTER splits of whole `unit`s
    of K, none empty. The splits are equal but the last, so where K's units
    do not divide into the wanted count the split is shortened until they
    give at least as many (the 8B wo in Q4_K: 16 superblocks make 4 splits
    of 4, 128 blocks, or 6 of 3, 192)."""
    if not 1 <= t <= SKINNY_ROWS:
        raise ValueError(f"the skinny kernel takes 1-{SKINNY_ROWS} tokens, "
                         f"not {t}")
    strips = -(-n // STRIP_COLS)
    units = -(-k // unit)
    want = max(1, min(-(-sms // strips), MAX_CLUSTER, units))
    per = -(-units // want)
    while per > 1 and -(-units // per) < want \
            and -(-units // (per - 1)) <= MAX_CLUSTER:
        per -= 1
    split_k = per * unit
    return -(-k // split_k), split_k


# the tile's cost model, fitted to experiments/matmul_plans.py's sweep of
# (rows, splits) at T = 64-512 over the 8B shapes: a 256-row block takes
# 1.5 times a 128-row one (each weight stage feeds twice the rows), and a
# split's reduction through distributed shared memory costs a fifth
ROWS_COST = {128: 1.0, 256: 1.5}
SPLIT_COST = {1: 1.0, 2: 1.2}


def tile_cost(sms: int, t: int, n: int, bm: int, nsplit: int) -> float:
    """The model's time of a tile plan, in units of one 128-row block over
    all of K: waves of blocks times a block's share of K."""
    blocks = -(-t // bm) * -(-n // TILE_COLS) * nsplit
    return -(-blocks // sms) * ROWS_COST[bm] / nsplit * SPLIT_COST[nsplit]


def tile_plan(sms: int, t: int, k: int, n: int,
              stage_k: int) -> tuple[int, int, int]:
    """(rows, K splits, K rows a split) of the wgmma tile, whose stages are
    stage_k rows deep (64 for Q8_0 and the K-quants, 128 for W8A8): the plan
    of least `tile_cost` among 128 rows (256 too past 128 tokens) and 1 or
    2 splits of at least MIN_TILE_STAGES stages, none empty; ties go to
    fewer splits, then to more rows."""
    stages = -(-k // stage_k)
    cands = [(bm, ns) for bm in ((128, 256) if t > 128 else (128,))
             for ns in ((1, 2) if stages >= 2 * MIN_TILE_STAGES else (1,))]
    bm, nsplit = min(cands, key=lambda c: (tile_cost(sms, t, n, *c), c[1],
                                           -c[0]))
    per = -(-stages // nsplit)
    return bm, -(-stages // per), per * stage_k
