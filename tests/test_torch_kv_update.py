"""Port parity for the in-place KV append (ops/cuda/kv_update.py): its plain
twins and the plain multi-row variant against the JAX package's Pallas
append kernels in interpret mode and its dynamic-update-slice variant, on
the same numpy inputs. Every result is bit-equal: the append only moves
values (a bf16 cache rounds f32 rows to nearest even in both)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.ops.pallas import kv_update as jkv
from ntransformer_tpu_torch.ops.cuda import kv_update as pkv
from test_torch_model import one_torch_thread  # noqa: F401


def _np(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _t(t: torch.Tensor):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _both(arrs, bf16=()):
    """The same numpy arrays as JAX and torch values; the indices in bf16
    become bf16 caches in both."""
    j, p = [], []
    for i, a in enumerate(arrs):
        if i in bf16:
            j.append(jnp.asarray(a, jnp.bfloat16))
            p.append(torch.from_numpy(a).to(torch.bfloat16))
        else:
            j.append(jnp.asarray(a))
            p.append(torch.from_numpy(a.copy()))
    return j, p


def test_append_rows_int8_codes_and_scales():
    """append_rows: int8 codes and [B, Hkv, S, 1] scales, an inactive slot,
    positions 0 and S - 1, two slots at one position."""
    rng = np.random.default_rng(11)
    B, Hkv, S, D = 4, 2, 32, 16
    kc = rng.integers(-100, 100, (B, Hkv, S, D)).astype(np.int8)
    ks = rng.standard_normal((B, Hkv, S, 1)).astype(np.float32)
    row_c = rng.integers(-100, 100, (B, Hkv, 1, D)).astype(np.int8)
    row_s = rng.standard_normal((B, Hkv, 1, 1)).astype(np.float32)
    pos = np.array([0, 7, 31, 7], np.int32)
    active = np.array([True, False, True, True])
    (jc, js, jrc, jrs), (pc, ps, prc, prs) = _both([kc, ks, row_c, row_s])
    want = jkv.append_rows((jc, js), (jrc, jrs), jnp.asarray(pos),
                           jnp.asarray(active), interpret=True)
    got = pkv.append_rows((pc, ps), (prc, prs), torch.from_numpy(pos),
                          torch.from_numpy(active))
    assert got[0] is pc and got[1] is ps  # written in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_t(g), _np(w))


def test_append_rows_bf16_cast():
    rng = np.random.default_rng(2)
    B, Hkv, S, D = 2, 2, 16, 8
    cache = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    row = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    pos = np.array([3, 15], np.int32)
    act = np.array([True, True])
    (jc, jr), (pc, pr) = _both([cache, row], bf16=(0,))
    (want,) = jkv.append_rows((jc,), (jr,), jnp.asarray(pos),
                              jnp.asarray(act), interpret=True)
    (got,) = pkv.append_rows((pc,), (pr,), torch.from_numpy(pos),
                             torch.from_numpy(act))
    np.testing.assert_array_equal(_t(got), _np(want))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_append_rows_stacked_matches_pallas(int8):
    """Every layer's row at once; int8 mixes 5-D codes with 4-D S-minor
    scale buffers in one call."""
    rng = np.random.default_rng(13 + int8)
    L, B, Hkv, S, D = 3, 4, 2, 128, 32
    pos = np.array([0, 40, 127, 64], np.int32)
    active = np.array([True, False, True, True])
    if int8:
        arrs = [rng.integers(-127, 127, (L, B, Hkv, S, D)).astype(np.int8),
                (rng.random((L, B, Hkv, S)) + 0.5).astype(np.float32),
                rng.integers(-127, 127, (L, B, Hkv, 1, D)).astype(np.int8),
                (rng.random((L, B, Hkv, 1, 1)) + 0.5).astype(np.float32)]
        bf16 = ()
    else:
        arrs = [rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32),
                rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32),
                rng.standard_normal((L, B, Hkv, 1, D)).astype(np.float32),
                rng.standard_normal((L, B, Hkv, 1, D)).astype(np.float32)]
        bf16 = (0, 1)
    (j0, j1, j2, j3), (p0, p1, p2, p3) = _both(arrs, bf16)
    want = jkv.append_rows_stacked((j0, j1), (j2, j3), jnp.asarray(pos),
                                   jnp.asarray(active), interpret=True)
    got = pkv.append_rows_stacked((p0, p1), (p2, p3), torch.from_numpy(pos),
                                  torch.from_numpy(active))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_t(g), _np(w))


@pytest.mark.parametrize("lr,t", [(3, 1), (2, 1), (3, 4), (1, 3)],
                         ids=["all-layers", "prefix", "window", "prefix-win"])
def test_append_rows_stacked_dus_matches_jax(lr, t):
    """The multi-row variant: a leading prefix of the layers and T rows
    per sequence (the draft and verify steps), codes and S-minor scales."""
    rng = np.random.default_rng(5 * lr + t)
    L, B, Hkv, S, D = 3, 4, 2, 64, 16
    kc = rng.integers(-127, 127, (L, B, Hkv, S, D)).astype(np.int8)
    ks = (rng.random((L, B, Hkv, S)) + 0.5).astype(np.float32)
    rc = rng.integers(-127, 127, (lr, B, Hkv, t, D)).astype(np.int8)
    rs = (rng.random((lr, B, Hkv, t, 1)) + 0.5).astype(np.float32)
    kb = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    rb = rng.standard_normal((lr, B, Hkv, t, D)).astype(np.float32)
    pos = np.array([0, 17, S - t, 30], np.int32)
    active = np.array([True, True, True, False])
    j, p = _both([kc, ks, kb, rc, rs, rb], bf16=(2,))
    want = jkv.append_rows_stacked_dus(tuple(j[:3]), tuple(j[3:]),
                                       jnp.asarray(pos), jnp.asarray(active))
    got = pkv.append_rows_stacked_dus(tuple(p[:3]), tuple(p[3:]),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(active))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_t(g), _np(w))


def test_cpu_tensors_take_the_plain_twin():
    rng = np.random.default_rng(1)
    cache = torch.from_numpy(rng.standard_normal((2, 3, 2, 16, 8))
                             .astype(np.float32)).to(torch.bfloat16)
    rows = torch.from_numpy(rng.standard_normal((2, 3, 2, 8))
                            .astype(np.float32))
    pos, act = torch.tensor([1, 5, 15]), torch.tensor([True, False, True])
    old, ref = cache.clone(), cache.clone()
    before = pkv.launches
    pkv.append_rows_stacked((cache,), (rows,), pos, act)
    pkv.append_rows_stacked_plain((ref,), (rows,), pos, act)
    assert pkv.launches == before
    assert torch.equal(cache.view(torch.int16), ref.view(torch.int16))
    assert torch.equal(cache[:, 1], old[:, 1])  # inactive: frozen
    assert torch.equal(cache[:, 0, :, 1], rows[:, 0].to(torch.bfloat16))
    assert torch.equal(cache[:, 2, :, 15], rows[:, 2].to(torch.bfloat16))
    # the kernel's dtypes hold on the CPU too
    with pytest.raises(ValueError, match="bf16, int8 or f32"):
        pkv.append_rows_stacked((cache.to(torch.float16),), (rows,), pos, act)
    with pytest.raises(ValueError, match="int8 rows"):
        pkv.append_rows(((cache[0].to(torch.int8)),), (rows[0],), pos, act)


def _kernel_model(caches, rows, pos, active):
    """csrc/kv_update.cu's launch geometry on the CPU: the wrapper's
    launch_plan gives the grid; thread t of block (x, b) finds its array
    (the last whose first block is <= x) and its unit u = (x - first) *
    THREADS + t of sequence b's L * Hkv rows, and moves the 16-byte chunk
    (vec) or element u % units of row (u // (Hkv units), b, u // units %
    Hkv) to position pos[b], converted to the cache's dtype. Inactive
    sequences and positions outside the cache write nothing. Returns the
    written caches and, for each, how many times each of its bytes was
    written."""
    l_n, b_n, h_n, s = caches[0].shape[:4]
    arrays = [(c.element_size(), r.element_size(),
               c.shape[4] if c.dim() == 5 else 1,
               c.data_ptr() % 16 == 0 and r.data_ptr() % 16 == 0)
              for c, r in zip(caches, rows)]
    plan, blocks = pkv.launch_plan(arrays, l_n, h_n)
    out, counts, src = [], [], []
    for c, r, (cs, _, dc, _) in zip(caches, rows, arrays):
        out.append(c.clone().contiguous().view(torch.uint8).numpy()
                   .reshape(l_n, b_n, h_n, s, dc * cs).copy())
        counts.append(np.zeros(out[-1].shape, np.int64))
        src.append(r.to(c.dtype).contiguous().view(torch.uint8).numpy()
                   .reshape(l_n, b_n, h_n, dc * cs))
    t = np.arange(pkv.THREADS)
    for b in range(b_n):
        p = int(pos[b])
        if not active[b] or not 0 <= p < s:
            continue
        for x in range(blocks):
            i = max(q for q, (_, _, first) in enumerate(plan) if x >= first)
            vec, units, first = plan[i]
            cs = arrays[i][0]
            u = (x - first) * pkv.THREADS + t
            u = u[u < l_n * h_n * units]
            ll, rem = u // (h_n * units), u % (h_n * units)
            hh, cc = rem // units, rem % units
            width = 16 if vec else cs
            for l_, h_, c_ in zip(ll, hh, cc):
                sl = slice(width * c_, width * (c_ + 1))
                out[i][l_, b, h_, p, sl] = src[i][l_, b, h_, sl]
                counts[i][l_, b, h_, p, sl] += 1
    written = [torch.from_numpy(o.reshape(-1)).view(c.dtype).reshape(c.shape)
               for o, c in zip(out, caches)]
    return written, counts


def _stacked_case(kind: str, seed: int):
    """L = 3, B = 4, Hkv = 2, S = 128: slot 1 inactive, pos 0, 40, S - 1,
    64. int8: codes (D = 32: 16-byte chunks) and their S-minor scales (one
    float a row); int8_odd: D = 12 codes (12 bytes a row: elements); bf16:
    caches of D = 32 taking f32 rows (a chunk reads 32 bytes)."""
    rng = np.random.default_rng(seed)
    L, B, Hkv, S = 3, 4, 2, 128
    pos = np.array([0, 40, S - 1, 64], np.int32)
    active = np.array([True, False, True, True])
    if kind.startswith("int8"):
        d = 12 if kind == "int8_odd" else 32
        arrs = [rng.integers(-127, 127, (L, B, Hkv, S, d)).astype(np.int8),
                (rng.random((L, B, Hkv, S)) + 0.5).astype(np.float32),
                rng.integers(-127, 127, (L, B, Hkv, 1, d)).astype(np.int8),
                (rng.random((L, B, Hkv, 1, 1)) + 0.5).astype(np.float32)]
        return arrs, (), pos, active
    arrs = [rng.standard_normal((L, B, Hkv, S, 32)).astype(np.float32),
            rng.standard_normal((L, B, Hkv, S, 32)).astype(np.float32),
            rng.standard_normal((L, B, Hkv, 1, 32)).astype(np.float32),
            rng.standard_normal((L, B, Hkv, 1, 32)).astype(np.float32)]
    return arrs, (0, 1), pos, active


@pytest.mark.parametrize("kind", ["int8", "int8_odd", "bf16"])
def test_launch_geometry_covers_each_active_row_once(kind):
    """The kernel's geometry, modelled from the wrapper's launch_plan,
    writes every byte of each active (layer, sequence, head) row at pos[b]
    exactly once and nothing else, and gives what the plain twin and the
    JAX package's Pallas kernel (interpret mode) give, bit for bit."""
    arrs, bf16, pos, active = _stacked_case(kind, 21)
    (j0, j1, j2, j3), (p0, p1, p2, p3) = _both(arrs, bf16)
    got, counts = _kernel_model((p0, p1), (p2, p3), pos, active)
    for cnt, c in zip(counts, (p0, p1)):
        want = np.zeros(cnt.shape, np.int64)
        for b in np.flatnonzero(active):
            want[:, b, :, pos[b]] = 1
        np.testing.assert_array_equal(cnt, want)
    plain = pkv.append_rows_stacked_plain(
        (p0.clone(), p1.clone()), (p2, p3), torch.from_numpy(pos),
        torch.from_numpy(active))
    jax_out = jkv.append_rows_stacked((j0, j1), (j2, j3), jnp.asarray(pos),
                                      jnp.asarray(active), interpret=True)
    for g, pl, w in zip(got, plain, jax_out):
        np.testing.assert_array_equal(_t(g), _t(pl))
        np.testing.assert_array_equal(_t(g), _np(w))


def test_launch_plan_at_the_8b_shapes():
    """L = 32, Hkv = 8, D = 128: int8 codes in 8 chunks a row (16 blocks a
    sequence), their scales one float a row (2 blocks), bf16 caches from f32
    rows in 16 chunks (32 blocks); each array's blocks its own, in order;
    an unaligned array moves elements."""
    int8 = [(1, 1, 128, True), (4, 4, 1, True)] * 2
    plan, blocks = pkv.launch_plan(int8, 32, 8)
    assert plan == [(True, 8, 0), (False, 1, 16), (True, 8, 18),
                    (False, 1, 34)] and blocks == 36
    plan, blocks = pkv.launch_plan([(2, 4, 128, True)] * 2, 32, 8)
    assert plan == [(True, 16, 0), (True, 16, 32)] and blocks == 64
    plan, blocks = pkv.launch_plan([(2, 4, 128, True)] * 2, 1, 8)
    assert plan == [(True, 16, 0), (True, 16, 1)] and blocks == 2
    plan, _ = pkv.launch_plan([(2, 2, 128, False)], 32, 8)
    assert plan == [(False, 128, 0)]
