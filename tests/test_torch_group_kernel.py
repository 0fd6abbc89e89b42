"""The batched flash group kernel's decomposition (csrc/batched_attention.cu,
group_kernel; the cache-dot forms "int8", "int8_v" and "bf16"), modelled in
plain PyTorch and held against the JAX package's Pallas kernel in interpret
mode (ntransformer_tpu/ops/pallas/batched_attention.py::_impl) on the same
numpy inputs.

The kernel splits each TPU key block over a cluster of blocks, each a
contiguous slice of the block's live keys. The model does the same: the
per-block row max (max over the slices' maxima, exchanged in the cluster),
the prefix max over key blocks (the max pass's per-block maxima, past the
first block), p against it, the row max of p * vs over the slices, the int8
codes of p * vs, the int32 value-dot partials added in rank order, and the
f32 denominator parts added in rank order; then the combine pass. Maxima
are exact, so the int8 codes of p are those of one undivided walk over the
block (asserted equal), and the output is held to the forms' limits of
tests/test_torch_batched_attention.py (DOT_TOL)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.ops.pallas import batched_attention as jba
from ntransformer_tpu_torch.ops.cuda import batched_attention as pba
from test_torch_batched_attention import DOT_TOL, _quant, _t
from test_torch_model import one_torch_thread  # noqa: F401

NEG_INF = pba.NEG_INF
SMS = 132  # the H100's SMs, for the cluster layout


def _codes(pv, pm):
    return torch.round(pv * (torch.full_like(pm, 127.0) / pm))


def _model(sc, see, v, vs, pos, act, *, t_n, window, block_s, n_blocks,
           dot, csize):
    """(m, l, acc [B, Hkv, R, 1/1/D], codes) of the group kernel's
    decomposition over scores sc [B, Hkv, R, S] (scaled, folded, capped) with
    visibility see; codes[(b, h, g)] = the int8 codes [R, keys] of block g
    (int8 forms) in key order."""
    b_n, hkv, r_n, _ = sc.shape
    d = v.shape[-1]
    parts = {}
    codes = {}
    block_max = torch.full((b_n, hkv, n_blocks, r_n), NEG_INF)
    lohi = {}
    for b in range(b_n):
        p_b, a_b = int(pos[b]), bool(act[b])
        last = p_b - 1 if a_b else p_b + t_n - 1
        for g in range(n_blocks):
            g0, g1 = g * block_s, (g + 1) * block_s - 1
            runs = g0 <= last and g1 >= p_b - window + 1
            k0 = max(g0, p_b - window + 1, 0)
            k1 = min(g1, last, sc.shape[-1] - 1) + 1 if runs else k0
            n = max(k1 - k0, 0)
            sl = -(-n // csize)
            # the slices of the cluster: [lo, hi) each
            lohi[b, g] = [(min(k0 + r * sl, max(k1, k0)),
                           min(k1, k0 + (r + 1) * sl)) for r in range(csize)]
            for h in range(hkv):
                # the max pass: each slice's row max, max over the cluster
                m = torch.full((r_n,), NEG_INF)
                for lo, hi in lohi[b, g]:
                    if hi > lo:
                        s = sc[b, h, :, lo:hi].masked_fill(
                            ~see[b, :, lo:hi], NEG_INF)
                        m = torch.maximum(m, s.amax(-1))
                block_max[b, h, g] = m if runs else NEG_INF
    for b in range(b_n):
        for g in range(n_blocks):
            for h in range(hkv):
                # the running max at block g: the prefix max of the per-
                # block maxima (at one block, the block's own)
                m = block_max[b, h, :g + 1].amax(0)
                if all(hi <= lo for lo, hi in lohi[b, g]):
                    m = torch.where(block_max[b, h, g] == NEG_INF,
                                    block_max[b, h, g], m)
                l_parts, pm, pvs = [], torch.zeros(r_n), []
                for lo, hi in lohi[b, g]:
                    s = sc[b, h, :, lo:hi].masked_fill(~see[b, :, lo:hi],
                                                       float("-inf"))
                    p = torch.exp(s - m[:, None])
                    l_parts.append(p.sum(-1))
                    pv = p * vs[b, h, None, lo:hi] if vs is not None else p
                    pvs.append(pv)
                    if pv.shape[-1]:
                        pm = torch.maximum(pm, pv.amax(-1))
                pm = pm + 1e-30
                l = l_parts[0]
                for x in l_parts[1:]:
                    l = l + x
                if dot == "bf16":
                    acc = torch.zeros(r_n, d)
                    for (lo, hi), pv in zip(lohi[b, g], pvs):
                        acc = acc + pv.to(torch.bfloat16).float() @ \
                            v[b, h, lo:hi].float()
                else:
                    acc_i = torch.zeros(r_n, d, dtype=torch.int64)
                    cs = []
                    for (lo, hi), pv in zip(lohi[b, g], pvs):
                        c = _codes(pv, pm[:, None])
                        cs.append(c)
                        acc_i = acc_i + (c.to(torch.int64)
                                         @ v[b, h, lo:hi].to(torch.int64))
                    codes[b, h, g] = torch.cat(cs, -1)
                    acc = acc_i.float() * (pm[:, None] * (1.0 / 127.0))
                parts[b, h, g] = (m, l, acc)
    return parts, codes


def _combine(parts, q, kn, vn, kns, vns, act, *, b_n, hkv, n_blocks, t_n,
             group, window, scale, softcap):
    """The combine pass: the splits merged in order, the virtual rows (f32)
    folded in, normalised."""
    r_n = q.shape[2]
    out = torch.zeros_like(q)
    for b in range(b_n):
        for h in range(hkv):
            ms = torch.stack([parts[b, h, g][0] for g in range(n_blocks)])
            m = ms.amax(0)
            l = torch.zeros(r_n)
            a = torch.zeros(r_n, q.shape[-1])
            for g in range(n_blocks):
                w = torch.exp(parts[b, h, g][0] - m)
                l = l + w * parts[b, h, g][1]
                a = a + w[:, None] * parts[b, h, g][2]
            sv = (q[b, h] @ kn[b, h].float().T) * scale
            if kns is not None:
                sv = sv * kns[b, h][None]
            if softcap:
                sv = softcap * torch.tanh(sv * (1.0 / softcap))
            tok = torch.arange(r_n)[:, None] // group
            i = torch.arange(t_n)[None, :]
            vis = bool(act[b]) & (i <= tok) & (i > tok - window)
            sv = sv.masked_fill(~vis, NEG_INF)
            mv = torch.maximum(m, sv.amax(-1))
            alpha = torch.exp(m - mv)
            pn = torch.exp(sv - mv[:, None]).masked_fill(~vis, 0.0)
            l = alpha * l + pn.sum(-1)
            if vns is not None:
                pn = pn * vns[b, h][None]
            a = a * alpha[:, None] + pn @ vn[b, h].float()
            out[b, h] = a / l[:, None]
    return out


# label: B, Hq, Hkv, S, D, T, pos, active, s_live, window, softcap
CASES = {
    # one key block (S 1024 int8 at Hkv 2, D 64), the 8B serving layout
    "one_block": (3, 8, 2, 1024, 64, 1, [512, 600, 1000], [1, 1, 1], None,
                  None, 0.0),
    # s_live 2176: 17 blocks of 128 at Hkv 8, D 128
    "s_live_2176": (2, 8, 8, 2560, 128, 1, [2100, 1950], [1, 1], 2176, None,
                    0.0),
    # an inactive slot attends its frozen rows [0, pos + t], no virtual row
    "inactive": (3, 8, 2, 512, 64, 2, [100, 300, 450], [1, 0, 1], None, None,
                 0.0),
    # a T = 4 verify window with a sliding window and a softcap
    "window_t4": (2, 8, 2, 512, 64, 4, [60, 400], [1, 1], None, 48, 20.0),
}


def _run(name, dot, seed):
    (b_n, hq, hkv, s, d, t, pos, act, s_live, win, cap) = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b_n, t, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b_n, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    kn, vn = (rng.standard_normal((b_n, hkv, t, d)).astype(np.float32)
              for _ in range(2))
    group = hq // hkv
    qr = (q.reshape(b_n, t, hkv, group, d).transpose(0, 2, 1, 3, 4)
          .reshape(b_n, hkv, t * group, d))
    scale = 1.0 / math.sqrt(d)
    window = pba.NO_WINDOW if win is None else win
    (kc, ks), (vc, vs) = _quant(k), _quant(v)
    (knc, kns), (vnc, vns) = _quant(kn), _quant(vn)
    ks, vs, kns, vns = (x[..., 0] for x in (ks, vs, kns, vns))
    scal = jnp.stack([jnp.zeros((b_n,), jnp.int32),
                      jnp.asarray(pos, jnp.int32), jnp.asarray(act, jnp.int32),
                      jnp.full((b_n,), window, jnp.int32)])
    want = np.asarray(jba._impl(
        *(jnp.asarray(x) for x in (qr, kc, vc, ks, vs, knc, vnc, kns, vns)),
        scal, quant=True, scale=scale, stacked=False, interpret=True,
        softcap=cap, n_virtual=t, dot_impl=dot, s_live=s_live))

    qt = _t(qr)
    live = s if s_live is None else min(s_live, s)
    block_s, n_blocks = pba.key_blocks(s, live, hkv, d, True)
    csize, slice_cap = pba.group_layout(t * group, block_s, n_blocks, b_n,
                                        hkv, SMS)
    sc = pba._cache_scores(qt, _t(kc), _t(ks), scale, dot)
    if cap:
        sc = cap * torch.tanh(sc * (1.0 / cap))
    post = torch.tensor(pos).view(b_n, 1, 1)
    actt = torch.tensor(act, dtype=torch.bool).view(b_n, 1, 1)
    qpos = post + (torch.arange(t * group) // group).view(1, -1, 1)
    kp = torch.arange(s).view(1, 1, s)
    see = (torch.where(actt, kp <= post - 1, kp <= qpos) & (kp > qpos - window)
           & (kp < live))
    parts, codes = _model(sc, see, _t(vc), _t(vs), pos, act, t_n=t,
                          window=window, block_s=block_s, n_blocks=n_blocks,
                          dot=dot, csize=csize)
    # one undivided walk over each block gives the same codes of p
    for (b, h, g), c in codes.items():
        m = parts[b, h, g][0]
        keys = see[b].clone()
        keys[:, :g * block_s] = False
        keys[:, (g + 1) * block_s:] = False
        cols = keys.any(0).nonzero().flatten()
        if cols.numel() == 0:
            continue
        lo, hi = int(cols[0]), int(cols[-1]) + 1
        s_blk = sc[b, h, :, lo:hi].masked_fill(~see[b, :, lo:hi],
                                               float("-inf"))
        pv = torch.exp(s_blk - m[:, None]) * _t(vs)[b, h, None, lo:hi]
        pm = pv.amax(-1, keepdim=True) + 1e-30
        # the model's codes cover the block's live range, the keys some row
        # of the block sees
        assert torch.equal(c, _codes(pv, pm)), (b, h, g)
    got = _combine(parts, qt, _t(knc), _t(vnc), _t(kns), _t(vns), act,
                   b_n=b_n, hkv=hkv, n_blocks=n_blocks, t_n=t, group=group,
                   window=window, scale=scale, softcap=cap).numpy()
    twin = pba._call(qt, (_t(kc), _t(ks)), (_t(vc), _t(vs)),
                     (_t(knc), _t(kns)), (_t(vnc), _t(vns)),
                     torch.tensor(pos, dtype=torch.int32),
                     torch.tensor(act, dtype=torch.int32), layer=None,
                     scale=scale, window=win, softcap=cap, s_live=s_live,
                     group=group, dot_impl=dot).numpy()
    return got, want, twin, (block_s, n_blocks, csize)


@pytest.mark.parametrize("name,dot", [(c, d) for c in CASES
                                      for d in ("int8_v", "int8", "bf16")])
def test_group_decomposition_matches_jax(name, dot):
    got, want, twin, (block_s, n_blocks, csize) = _run(name, dot, seed=7)
    if name == "s_live_2176":
        assert (block_s, n_blocks) == (128, 17)
    else:
        assert n_blocks == 1 and csize > 1  # the block is really split
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= DOT_TOL[dot], (name, dot, rel)
    # and the kernel's plain twin (one undivided walk) agrees as closely
    rel_twin = float(np.abs(got - twin).max() / np.abs(twin).max())
    assert rel_twin <= DOT_TOL[dot], (name, dot, rel_twin)


@pytest.mark.parametrize("r_n,block_s,n_blocks,b_n,hkv,want", [
    (4, 1024, 1, 32, 8, (2, 512)),   # the B = 32 int8 decode step
    (4, 1024, 1, 1, 8, (8, 128)),    # B = 1: 64 blocks for 8 (b, h)
    (16, 1024, 1, 8, 8, (5, 256)),   # a T = 4 verify at B = 8
    (4, 128, 17, 4, 8, (1, 128)),    # 17 blocks: the grid is full already
    (4, 1024, 4, 8, 8, (2, 512)),    # a bf16 cache of four 1024-key blocks
    (32, 2048, 1, 1, 8, (8, 256)),   # T = 8 at a 2048-key block
])
def test_group_layout(r_n, block_s, n_blocks, b_n, hkv, want):
    csize, slice_cap = pba.group_layout(r_n, block_s, n_blocks, b_n, hkv,
                                        SMS)
    assert (csize, slice_cap) == want
    assert 1 <= csize <= pba.MAX_CLUSTER and slice_cap % 128 == 0
    assert slice_cap * csize >= block_s
    rb = pba.row_capacity(r_n)
    assert rb >= r_n and 5 * rb * slice_cap <= 96 << 10


def test_group_layout_refuses_what_no_cluster_holds():
    with pytest.raises(ValueError, match="cluster"):
        pba.group_layout(32, 8192, 1, 1, 4, SMS)


@pytest.mark.parametrize("r_n,want", [(1, 4), (4, 4), (5, 8), (8, 8),
                                      (12, 32), (32, 32)])
def test_row_capacity(r_n, want):
    assert pba.row_capacity(r_n) == want
