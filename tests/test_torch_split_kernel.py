"""The batched flash split kernel's decomposition (csrc/batched_attention.cu,
split_kernel; the cache-dot forms "f32" and "int8_s"), modelled in plain
PyTorch and held against the JAX package's Pallas kernel in interpret mode
(ntransformer_tpu/ops/pallas/batched_attention.py::_impl) on the same numpy
inputs.

The kernel splits the live keys of each (sequence, head) over
`split_plan`'s blocks (a function of the shapes alone), each a share of
whole 128-key tiles but the last. Inside a block warp w owns keys [32 w, 32
w + 32) of every tile and keeps its own online softmax over them (running
max, denominator and value sums, tile by tile, so no score is kept); the
four warps are added in warp order, each scaled to the block's row max;
the splits are merged in rank order (a cluster's rank 0, or the combine
pass past a cluster), then the virtual rows are folded in and the rows
normalised. The model does the same, and the output is held to the forms'
limit of tests/test_torch_batched_attention.py (DOT_TOL: f32 summation
order only). Its bits do not depend on the s_live bucket."""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.ops.pallas import batched_attention as jba
from ntransformer_tpu_torch.ops.cuda import batched_attention as pba
from test_torch_batched_attention import DOT_TOL, _quant, _t
from test_torch_group_kernel import _combine
from test_torch_model import one_torch_thread  # noqa: F401

NEG_INF = pba.NEG_INF
TILE, WARP_KEYS, WARPS = 128, 32, 4  # the kernel's S_TK, S_WK and warps


def split_bounds(n_live: int, first: int, nsplit: int) -> list:
    """[k0, k1) of each split over n_live keys from `first`: shares of whole
    tiles but the last (empty past the live range)."""
    chunk = -(-n_live // nsplit) if n_live > 0 else 0
    chunk = -(-chunk // TILE) * TILE
    out = []
    for s in range(nsplit):
        k0 = first + s * chunk
        out.append((k0, max(k0, min(k0 + chunk, first + n_live))))
    return out


def _block(sc, see, v, vs, k0, k1):
    """One block's partial (m, l, acc) [R] / [R] / [R, D]: per warp, the
    online softmax over its 32 keys of each tile; then the warps in warp
    order, each scaled to the block's row max."""
    r_n, d = sc.shape[0], v.shape[-1]
    m = [torch.full((r_n,), NEG_INF) for _ in range(WARPS)]
    l = [torch.zeros(r_n) for _ in range(WARPS)]
    acc = [torch.zeros(r_n, d) for _ in range(WARPS)]
    for kt in range(k0, k1, TILE):
        for w in range(WARPS):
            a = kt + WARP_KEYS * w
            e = min(a + WARP_KEYS, k1)
            if a >= k1:
                continue
            s, vis = sc[:, a:e], see[:, a:e]
            m_new = torch.maximum(m[w], s.masked_fill(~vis, NEG_INF).amax(-1))
            alpha = torch.exp(m[w] - m_new)
            p = torch.where(vis, torch.exp(s - m_new[:, None]),
                            torch.zeros(()))
            l[w] = alpha * l[w] + p.sum(-1)
            pv = p * vs[None, a:e] if vs is not None else p
            acc[w] = acc[w] * alpha[:, None] + pv @ v[a:e]
            m[w] = m_new
    mb = torch.stack(m).amax(0)
    lb, ab = torch.zeros(r_n), None
    for w in range(WARPS):
        e = torch.exp(m[w] - mb)
        lb = lb + e * l[w]
        c = acc[w] * e[:, None]
        ab = c if ab is None else ab + c
    return mb, lb, ab


def split_model(sc, see, v, vs, pos, act, *, t_n, window, s_live, nsplit):
    """{(b, h, split): (m, l, acc)}: the split kernel's partials over scores
    sc [B, Hkv, R, S] (scaled, scale-folded, capped) with visibility see
    [B, R, S]; each split walks [k0, k1) of the live range of its sequence,
    bounded by s_live (which the wrapper's bucket keeps above every live
    key)."""
    b_n, hkv = sc.shape[:2]
    s = sc.shape[-1]
    parts = {}
    for b in range(b_n):
        p_b, a_b = int(pos[b]), bool(act[b])
        last = min(p_b - 1 if a_b else p_b + t_n - 1, min(s, s_live) - 1)
        first = max(p_b - window + 1, 0)
        bounds = split_bounds(last - first + 1, first, nsplit)
        for h in range(hkv):
            for g, (k0, k1) in enumerate(bounds):
                parts[b, h, g] = _block(sc[b, h], see[b], v[b, h],
                                        None if vs is None else vs[b, h],
                                        k0, k1)
    return parts


# label: B, Hq, Hkv, S, D, T, pos, active, int8 cache, window, softcap, SMs
CASES = {
    # the split plan's own count at the H100's SMs: a cluster of 4 splits
    "decode_int8": (3, 8, 2, 512, 64, 1, [5, 300, 450], [1, 1, 1], True,
                    None, 0.0, 132),
    # few SMs: two splits of two tiles each, the last partial
    "decode_int8_tiles": (3, 8, 2, 512, 64, 1, [5, 300, 450], [1, 1, 1],
                          True, None, 0.0, 12),
    # a T = 4 verify with an inactive slot (its frozen rows [0, pos + t])
    "verify_t4_inactive": (2, 8, 2, 512, 64, 4, [60, 400], [1, 0], True,
                           None, 0.0, 6),
    # a sliding window and a softcap
    "window_softcap": (3, 8, 2, 512, 64, 2, [10, 200, 480], [1, 0, 1], True,
                       48, 20.0, 132),
    # a bf16 cache: decode and a T = 4 verify, inactive slot
    "bf16_decode": (2, 8, 2, 512, 64, 1, [100, 511], [1, 1], False, None,
                    0.0, 8),
    "bf16_verify_t4": (3, 8, 2, 384, 64, 4, [3, 200, 379], [1, 0, 1], False,
                       None, 0.0, 132),
}


def _run(name, dot, seed, s_live=None):
    (b_n, hq, hkv, s, d, t, pos, act, int8, win, cap, sms) = CASES[name]
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
    scal = jnp.stack([jnp.zeros((b_n,), jnp.int32),
                      jnp.asarray(pos, jnp.int32), jnp.asarray(act, jnp.int32),
                      jnp.full((b_n,), window, jnp.int32)])
    kw = dict(scale=scale, stacked=False, interpret=True, softcap=cap,
              n_virtual=t, dot_impl=dot, s_live=s_live)
    if int8:
        (kc, ks), (vc, vs) = _quant(k), _quant(v)
        (knc, kns), (vnc, vns) = _quant(kn), _quant(vn)
        ks, vs, kns, vns = (x[..., 0] for x in (ks, vs, kns, vns))
        want = jba._impl(*(jnp.asarray(x) for x in (qr, kc, vc, ks, vs, knc,
                                                    vnc, kns, vns)),
                         scal, quant=True, **kw)
        kt_, vt_, knt, vnt = _t(kc), _t(vc), _t(knc), _t(vnc)
        kst, vst, knst, vnst = _t(ks), _t(vs), _t(kns), _t(vns)
    else:
        kb, vb, knb, vnb = (jnp.asarray(x, jnp.bfloat16)
                            for x in (k, v, kn, vn))
        want = jba._impl(jnp.asarray(qr), kb, vb, None, None, knb, vnb, None,
                         None, scal, quant=False, **kw)
        kt_, vt_, knt, vnt = (_t(np.array(x.astype(jnp.float32)))
                              for x in (kb, vb, knb, vnb))
        kst = vst = knst = vnst = None
    want = np.asarray(want)

    qt = _t(qr)
    live = s if s_live is None else min(s_live, s)
    nsplit, csize = pba.split_plan(s, b_n, hkv, sms)
    sc = pba._cache_scores(qt, kt_, kst, scale, dot)
    if cap:
        sc = cap * torch.tanh(sc * (1.0 / cap))
    post = torch.tensor(pos).view(b_n, 1, 1)
    actt = torch.tensor(act, dtype=torch.bool).view(b_n, 1, 1)
    qpos = post + (torch.arange(t * group) // group).view(1, -1, 1)
    kp = torch.arange(s).view(1, 1, s)
    see = (torch.where(actt, kp <= post - 1, kp <= qpos) & (kp > qpos - window)
           & (kp < live))
    parts = split_model(sc, see, vt_.float(), vst, pos, act, t_n=t,
                        window=window, s_live=live, nsplit=nsplit)
    got = _combine(parts, qt, knt, vnt, knst, vnst, act, b_n=b_n, hkv=hkv,
                   n_blocks=nsplit, t_n=t, group=group, window=window,
                   scale=scale, softcap=cap)
    return got, want, (nsplit, csize)


@pytest.mark.parametrize("name,dot", [(c, d) for c in CASES
                                      for d in ("f32", "int8_s")
                                      if CASES[c][8] or d == "f32"])
def test_split_decomposition_matches_jax(name, dot):
    got, want, (nsplit, csize) = _run(name, dot, seed=len(name) + len(dot))
    assert nsplit > 1  # the keys are really split
    assert csize in (0, nsplit)
    rel = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert rel <= DOT_TOL[dot], (name, dot, rel)


@pytest.mark.parametrize("name,dot", [("decode_int8_tiles", "f32"),
                                      ("verify_t4_inactive", "int8_s"),
                                      ("bf16_verify_t4", "f32")])
def test_split_result_is_the_same_in_every_s_live_bucket(name, dot):
    """The split plan and the walk take no s_live: a bucket over the live
    keys (rounded to 128 as the batched steps pass it) gives the whole
    cache's bits."""
    (_, _, _, s, _, t, pos, act, *_rest) = CASES[name]
    live = max(p + t for p in pos) + 1
    bucket = min(s, -(-live // 128) * 128)
    full, _, plan = _run(name, dot, seed=3)
    cut, _, plan_cut = _run(name, dot, seed=3, s_live=bucket)
    assert plan == plan_cut
    assert torch.equal(full, cut)


def test_split_plan_takes_no_s_live():
    assert "s_live" not in inspect.signature(pba.split_plan).parameters


@pytest.mark.parametrize("s,b_n,hkv,sms,want", [
    (1024, 32, 8, 132, (1, 1)),    # the B = 32 int8 step: a block an SM
    (1024, 1, 8, 132, (8, 8)),     # B = 1, S 1024: 8 tiles, one cluster
    (4096, 1, 8, 132, (8, 8)),     # B = 1, S 4096: 4 tiles a split
    (32768, 1, 8, 132, (17, 0)),   # a long cache: past a cluster, combine
    (4096, 8, 8, 132, (3, 3)),     # B = 8 bf16 at S 4096 (and its verify)
    (1024, 4, 8, 114, (4, 4)),     # another card's SMs
    (256, 3, 2, 132, (2, 2)),      # a short cache: one tile a split
])
def test_split_plan(s, b_n, hkv, sms, want):
    nsplit, csize = pba.split_plan(s, b_n, hkv, sms)
    assert (nsplit, csize) == want
    # every SM a block, or a tile of the full cache a split, or a cluster's
    # splits of at most _SPLIT_TILES tiles
    tiles = -(-s // TILE)
    assert (b_n * hkv * nsplit >= sms or nsplit == tiles
            or (nsplit == pba.MAX_CLUSTER
                and -(-tiles // nsplit) <= pba._SPLIT_TILES))
    assert csize == (nsplit if nsplit <= pba.MAX_CLUSTER else 0)


@pytest.mark.parametrize("n_live,first,nsplit", [(550, 0, 2), (1, 7, 8),
                                                 (0, 0, 3), (1000, 24, 5)])
def test_split_bounds_cover_the_live_keys_once(n_live, first, nsplit):
    """The splits cover [first, first + n_live) in order, each a share of
    whole tiles but the last."""
    bounds = split_bounds(n_live, first, nsplit)
    keys = [k for k0, k1 in bounds for k in range(k0, k1)]
    assert keys == list(range(first, first + n_live))
    assert all((k1 - k0) % TILE == 0 for k0, k1 in bounds
               if k1 < first + n_live and k1 > k0)
