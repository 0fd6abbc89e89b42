"""Batched flash decode / verify attention: the wrapper of
`csrc/batched_attention.cu` and its plain PyTorch twin.

Replaces ntransformer_tpu/ops/pallas/batched_attention.py::_impl / _kernel
(entries flash_decode_batched and flash_verify_batched) in all five of its
cache-dot forms, `dot_impl` "f32" (the default), "int8", "int8_s", "int8_v"
and "bf16". B sequences attend one layer of a stacked [L, B, Hkv, S, D]
cache (or an unstacked [B, Hkv, S, D] one), bf16 or int8 codes with S-minor
f32 scales, plus the T new k/v rows that are not written yet (the virtual
block: T = 1 decodes, T > 1 is a speculative verify window). Active slots
see cache keys [0, pos - 1] and the virtual rows causally; inactive slots see
the frozen keys [0, pos + t] and no virtual row. The int8 scales fold into
the score and probability columns. Returns f32.

The cache dots (the TPU kernel's, an int8 form acts on an int8 cache only
and is "f32" on a bf16 cache): "f32" computes in f32; "int8_s" dots q,
quantized per row, with the int8 key codes; "int8_v" quantizes p * vs per
row over a key block and dots it with the int8 value codes; "int8" does
both; "bf16" rounds q and p to bf16 for the dots. The virtual block is f32
in every form. "int8_v", "int8" and "bf16" round p against the running max
of one TPU key block (`block_s`, from the 128-rounded s_live as the TPU
kernel picks it), so the twin walks those blocks in order with the online
softmax, and the kernel cuts its work at the same blocks. On CPU tensors the
twin computes the form it is asked for (the JAX entries force "f32" in
interpret mode).

On the H100 it is bound by bytes (every live K/V row once). The kernel
splits each sequence's live keys across blocks and merges the partials in a
fixed-order second pass, so small batches fill the card; a block stops at
its own sequence's last live key. See the source for the details.

`s_live` keeps the JAX argument's contract: every attended key lies below
it, and the result equals the whole-cache result. The kernel reads no key
at or past it (and none past a sequence's own last live key).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NAME = "batched_attention"
REPLACES = "ntransformer_tpu/ops/pallas/batched_attention.py:269 _impl"
# the cache-dot forms of its _kernel
REPLACES_DOT = "ntransformer_tpu/ops/pallas/batched_attention.py:175 _kernel"
_SIGNATURES = {"batched_flash_attention": [ctypes.c_void_p] * 15
               + [ctypes.c_int] * 14 + [ctypes.c_float] * 4
               + [ctypes.c_void_p]}
NO_WINDOW = 2 ** 30  # a window larger than any context masks nothing
MAX_ROWS = 32        # query rows per (sequence, kv head): group * T
MAX_NEW = 8          # virtual rows per sequence
_MIN_SPLIT_KEYS = 64  # fewest live keys worth a block of their own
# the cache-dot forms and their codes in the kernel's C interface
DOT_IMPLS = {"f32": 0, "bf16": 1, "int8": 2, "int8_s": 3, "int8_v": 4}
# the forms that round p against one key block's running max
BLOCKED_DOTS = ("bf16", "int8", "int8_v")
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
_BLOCK_TARGET = 1 << 21  # the TPU kernel's K-tile target, bytes

# kernel launches since the last reset (chip_smoke.py reads and resets it):
# a call is two, the split pass and its combine pass; by_dot splits the
# same count by the form the kernel ran
launches = 0
launches_by_dot = dict.fromkeys(DOT_IMPLS, 0)
_SM_COUNT: dict[int, int] = {}
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def effective_dot(dot_impl: str, quant: bool) -> str:
    """The form a call runs: an int8 form on a bf16 cache is "f32"."""
    if dot_impl not in DOT_IMPLS:
        raise ValueError(f"dot_impl {dot_impl!r}: want one of "
                         f"{sorted(DOT_IMPLS)}")
    return "f32" if not quant and dot_impl.startswith("int8") else dot_impl


def pick_block_s(s: int, per_pos_bytes: int) -> int:
    """The TPU kernel's key block (its _pick_block_s at the default 2 MiB
    target): the whole span if its K tile fits, else the largest power-of-
    two divisor of s from 8 up whose tile fits (the smallest divisor if
    none fits, the whole span if none divides)."""
    if s * per_pos_bytes <= _BLOCK_TARGET:
        return s
    best = None
    c = 8
    while c <= s:
        if s % c == 0 and (best is None or c * per_pos_bytes <= _BLOCK_TARGET):
            best = c
        c *= 2
    return s if best is None else best


def key_blocks(s: int, live: int, hkv: int, d: int, quant: bool):
    """(block_s, n_blocks) of the TPU kernel over a cache of s keys with
    live-prefix bound `live` (<= s): s_live rounded up to 128 (a Mosaic
    lane rule that fixes the blocking, and so the rounding of p), capped at
    s."""
    s_r = min(s, (live + 127) // 128 * 128)
    block_s = pick_block_s(s_r, hkv * d * (1 if quant else 2))
    return block_s, s_r // block_s


def _unpack(cache):
    """(codes, scales or None) of a cache; legacy [.., S, 1] scales lose
    their trailing axis (order-preserving)."""
    if isinstance(cache, tuple):
        c, s = cache
        if s.dim() == c.dim():
            s = s.reshape(s.shape[:-1])
        return c, s
    return cache, None


def _int_dot(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An integer-valued dot, exact (float64 holds every int32 sum here),
    as f32: the kernel's int32 dot converted as the TPU kernel converts
    it."""
    return torch.einsum(eq, a.to(torch.float64),
                        b.to(torch.float64)).to(torch.float32)


def _cache_scores(q, k, ks, scale: float, dot: str) -> torch.Tensor:
    """Scores [B, Hkv, R, S] of the cache keys in form `dot`, scaled and
    key-scale folded (before the softcap)."""
    if dot in ("int8", "int8_s"):
        # q per row: qm = max|q| + 1e-30, codes round(q * (127 / qm))
        qm = q.abs().amax(-1, keepdim=True) + 1e-30
        codes = torch.round(q * (torch.full_like(qm, 127.0) / qm))
        sc = _int_dot("bhrd,bhsd->bhrs", codes, k) * (qm * (scale / 127.0))
    else:
        qd = q.to(torch.bfloat16).to(torch.float32) if dot == "bf16" else q
        sc = torch.einsum("bhrd,bhsd->bhrs", qd, k.to(torch.float32)) * scale
    if ks is not None:
        sc = sc * ks[:, :, None, :].to(torch.float32)
    return sc


def _blocked_softmax(sc, see, v, vs, pos, act, *, t_n: int, window: int,
                     block_s: int, n_blocks: int, dot: str):
    """The TPU kernel's walk over its key blocks for the forms that round
    p per block: the online softmax in block order, a sequence's state
    untouched by a block its live range misses (the kernel does not visit
    it). Returns the running (m, l, acc) [B, Hkv, R, 1 / 1 / D]."""
    b_n, hkv, r_n, _ = sc.shape
    dev = sc.device
    m = torch.full((b_n, hkv, r_n, 1), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(b_n, hkv, r_n, v.shape[-1], device=dev)
    pos = pos.view(b_n)
    last = torch.where(act.view(b_n), pos - 1, pos + t_n - 1)
    first = pos - window + 1
    for j in range(n_blocks):
        a, e = j * block_s, (j + 1) * block_s
        runs = ((a <= last) & (e - 1 >= first)).view(b_n, 1, 1, 1)
        sj = sc[..., a:e].masked_fill(~see[..., a:e], NEG_INF)
        m_new = torch.maximum(m, sj.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sj - m_new)
        l_new = alpha * l + p.sum(-1, keepdim=True)
        vj = v[:, :, a:e]
        if vs is not None:
            p = p * vs[:, :, None, a:e].to(torch.float32)
        if dot == "bf16":
            o = torch.einsum("bhrs,bhsd->bhrd",
                             p.to(torch.bfloat16).to(torch.float32),
                             vj.to(torch.float32))
        else:  # the int8 value dot: p * vs per row over the block
            pm = p.amax(-1, keepdim=True) + 1e-30
            codes = torch.round(p * (torch.full_like(pm, 127.0) / pm))
            o = _int_dot("bhrs,bhsd->bhrd", codes, vj) * (pm * (1.0 / 127.0))
        acc_new = acc * alpha + o
        m = torch.where(runs, m_new, m)
        l = torch.where(runs, l_new, l)
        acc = torch.where(runs, acc_new, acc)
    return m, l, acc


def batched_flash_plain(qr, k, v, ks, vs, kn, vn, kns, vns, pos, active, *,
                        layer, scale: float, window: int, softcap: float,
                        s_live: int, group: int,
                        dot_impl: str = "f32") -> torch.Tensor:
    """The kernel's function in plain PyTorch, in its layout: qr [B, Hkv,
    R, D] (row r = t * group + g); k/v [L?, B, Hkv, S, D] (layer picks one
    of a stacked cache) with scales [L?, B, Hkv, S] or None; kn/vn [B, Hkv,
    T, D] in the cache dtype with kns/vns [B, Hkv, T] or None. "f32" and
    "int8_s" take one softmax over the live cache keys and the visible
    virtual rows; the per-block forms walk the TPU kernel's key blocks and
    then fold in the virtual rows. Returns [B, Hkv, R, D] f32."""
    if layer is not None:
        k, v = k[layer], v[layer]
        if ks is not None:
            ks, vs = ks[layer], vs[layer]
    b_n, hkv, r_n, d = qr.shape
    s = k.shape[2]
    t_n = kn.shape[2]
    dev = qr.device
    dot = effective_dot(dot_impl, ks is not None)
    q = qr.to(torch.float32)
    sc = _cache_scores(q, k, ks, scale, dot)
    sn = torch.einsum("bhrd,bhtd->bhrt", q, kn.to(torch.float32)) * scale
    if ks is not None:
        sn = sn * kns[:, :, None, :].to(torch.float32)
    if softcap:
        sc = softcap * torch.tanh(sc * (1.0 / softcap))
        sn = softcap * torch.tanh(sn * (1.0 / softcap))
    pos = pos.to(dev, torch.long).view(b_n, 1, 1)
    act = active.to(dev, torch.bool).view(b_n, 1, 1)
    tok = (torch.arange(r_n, device=dev) // group).view(1, r_n, 1)
    qpos = pos + tok                                        # [B, R, 1]
    kp = torch.arange(s, device=dev).view(1, 1, s)
    see = (torch.where(act, kp <= pos - 1, kp <= qpos) & (kp > qpos - window)
           & (kp < s_live))
    vi = torch.arange(t_n, device=dev).view(1, 1, t_n)
    see_new = act & (vi <= tok) & (vi > tok - window)
    if dot not in BLOCKED_DOTS:
        scores = torch.cat([sc.masked_fill(~see[:, None], float("-inf")),
                            sn.masked_fill(~see_new[:, None], float("-inf"))],
                           dim=-1)
        p = torch.softmax(scores, dim=-1)
        pc, pn = p[..., :s], p[..., s:]
        if vs is not None:
            pc = pc * vs[:, :, None, :].to(torch.float32)
            pn = pn * vns[:, :, None, :].to(torch.float32)
        return (torch.einsum("bhrs,bhsd->bhrd", pc, v.to(torch.float32))
                + torch.einsum("bhrt,bhtd->bhrd", pn, vn.to(torch.float32)))
    block_s, n_blocks = key_blocks(s, s_live, hkv, d, ks is not None)
    m, l, acc = _blocked_softmax(sc, see[:, None], v, vs, pos, act, t_n=t_n,
                                 window=window, block_s=block_s,
                                 n_blocks=n_blocks, dot=dot)
    # the virtual rows, f32 in every form
    sn = sn.masked_fill(~see_new[:, None], NEG_INF)
    m_new = torch.maximum(m, sn.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(sn - m_new)
    l = alpha * l + p.sum(-1, keepdim=True)
    if vns is not None:
        p = p * vns[:, :, None, :].to(torch.float32)
    acc = acc * alpha + torch.einsum("bhrt,bhtd->bhrd", p,
                                     vn.to(torch.float32))
    return acc / l


def _split_count(device: torch.device, b_n: int, hkv: int, keys: int) -> int:
    """Blocks per (sequence, head): enough to cover the SMs twice, with at
    least _MIN_SPLIT_KEYS keys each when the cache is full."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    want = -(-2 * _SM_COUNT[idx] // (b_n * hkv))
    return max(1, min(want, -(-keys // _MIN_SPLIT_KEYS)))


def _scratch(dev: torch.device, stream: int, numel: int) -> torch.Tensor:
    """The split pass's partials (acc, m, l), one f32 buffer per (device,
    stream), grown on demand: the calls on a stream run their split and
    combine passes in order, so each layer's call reuses it."""
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=torch.float32, device=dev)
        _SCRATCH[key] = buf
    return buf


def _call(qr, k_cache, v_cache, k_new, v_new, pos, active, *, layer, scale,
          window, softcap, s_live, group, dot_impl) -> torch.Tensor:
    """Shared body of the two entries, in the kernel layout: qr [B, Hkv, R,
    D]; k_new/v_new [B, Hkv, T, D] (or (codes, scales [B, Hkv, T(, 1)]))."""
    global launches
    k, ks = _unpack(k_cache)
    v, vs = _unpack(v_cache)
    quant = ks is not None
    dot = effective_dot(dot_impl, quant)
    kn, kns = k_new if quant else (k_new, None)
    vn, vns = v_new if quant else (v_new, None)
    stacked = layer is not None
    if k.dim() != (5 if stacked else 4) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"cache {tuple(k.shape)} / {tuple(v.shape)}: want "
                         f"[{'L, ' if stacked else ''}B, Hkv, S, D]")
    b_n, hkv, r_n, d = qr.shape
    t_n = r_n // group
    s = k.shape[-2]
    if tuple(k.shape[-4:]) != (b_n, hkv, s, d):
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"[{b_n}, {hkv}, .., {d}]")
    if stacked and not 0 <= int(layer) < k.shape[0]:
        raise ValueError(f"layer {layer} outside the {k.shape[0]}-layer "
                         "cache")
    kn = kn.reshape(b_n, hkv, t_n, d)
    vn = vn.reshape(b_n, hkv, t_n, d)
    if quant:
        kns, vns = kns.reshape(b_n, hkv, t_n), vns.reshape(b_n, hkv, t_n)
    else:
        kn, vn = kn.to(k.dtype), vn.to(v.dtype)
    win = NO_WINDOW if window is None else int(window)
    live = s if s_live is None else min(int(s_live), s)
    pos = torch.as_tensor(pos)
    active = (torch.ones(b_n, dtype=torch.int32) if active is None
              else torch.as_tensor(active))
    kw = dict(layer=None if layer is None else int(layer), scale=scale,
              window=win, softcap=float(softcap), s_live=live, group=group,
              dot_impl=dot)
    # the kernel's dtypes, held on every device: a cache it refuses is
    # refused on the CPU too
    if k.dtype not in ((torch.int8,) if quant else (torch.bfloat16,)) \
            or v.dtype != k.dtype:
        raise ValueError(f"batched flash attention takes a bf16 cache or int8 "
                         f"codes with f32 scales; got {k.dtype}")
    if quant and (any(x.dtype != torch.float32 for x in (ks, vs))
                  or kn.dtype != torch.int8 or vn.dtype != torch.int8):
        raise ValueError("an int8 cache takes f32 scales and int8 new rows")
    if qr.device.type == "cpu":
        return batched_flash_plain(qr, k, v, ks, vs, kn, vn, kns, vns, pos,
                                   active, **kw)
    dev = qr.device
    tensors = [k, v, kn, vn] + ([ks, vs, kns, vns] if quant else [])
    if not qr.is_cuda or any(x.device != dev for x in tensors):
        raise ValueError("batched flash attention wants every tensor on one "
                         "CUDA device")
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not supported (64 or 128)")
    if r_n > MAX_ROWS or t_n > MAX_NEW:
        raise ValueError(f"{r_n} query rows per kv head (group {group} x "
                         f"T {t_n}) exceed the kernel's {MAX_ROWS} "
                         f"(T <= {MAX_NEW})")
    if not (k.is_contiguous() and v.is_contiguous()
            and (not quant or (ks.is_contiguous() and vs.is_contiguous()))):
        raise ValueError("batched flash attention wants contiguous caches")
    if any(x.data_ptr() % 16 for x in (k, v)):
        raise ValueError("batched flash attention wants 16-byte aligned "
                         "caches")
    qr = qr.to(torch.float32).contiguous()
    kn, vn = kn.contiguous(), vn.contiguous()
    if quant:
        kns = kns.to(torch.float32).contiguous()
        vns = vns.to(torch.float32).contiguous()
    if qr.data_ptr() % 16:
        qr = qr.clone()
    # no-ops for the int32 vectors the batched steps pass
    pos32 = pos.to(dev, torch.int32).contiguous()
    act32 = active.to(dev, torch.int32).contiguous()
    if dot in BLOCKED_DOTS:
        # one split per key block of the TPU kernel
        block_s, nsplit = key_blocks(s, live, hkv, d, quant)
    else:
        # from the shapes alone, so an s_live bucket changes no bit of the
        # result
        block_s, nsplit = s, _split_count(dev, b_n, hkv, s)
    n_acc, n_ml = b_n * hkv * nsplit * r_n * d, b_n * hkv * nsplit * r_n
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = _scratch(dev, stream, n_acc + 2 * n_ml)
    out = torch.empty(b_n, hkv, r_n, d, dtype=torch.float32, device=dev)
    lib = build.load(NAME, _SIGNATURES)
    rc = lib.batched_flash_attention(
        qr.data_ptr(), k.data_ptr(), v.data_ptr(),
        ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
        kn.data_ptr(), vn.data_ptr(), kns.data_ptr() if quant else None,
        vns.data_ptr() if quant else None, pos32.data_ptr(),
        act32.data_ptr(), part.data_ptr(), part[n_acc:].data_ptr(),
        part[n_acc + n_ml:].data_ptr(), out.data_ptr(), b_n, hkv, s, r_n,
        t_n, group, d, int(quant), 0 if layer is None else int(layer), live,
        win, nsplit, DOT_IMPLS[dot], block_s, float(scale), float(softcap),
        scale / 127.0, 1.0 / 127.0, stream)
    build.check(lib, rc, NAME)
    launches += 2
    launches_by_dot[dot] += 2
    return out


def flash_decode_batched(q, k_cache, v_cache, k_new, v_new, pos, scale: float,
                         *, layer=None, active=None, window=None,
                         softcap: float = 0.0, s_live=None,
                         dot_impl: str = "f32") -> torch.Tensor:
    """Batched decode attention over per-sequence caches plus each
    sequence's current (not yet written) k/v row.

    q [B, Hq, D]; pos [B] = each sequence's position (cache keys [0, pos -
    1] are live). k_cache/v_cache: [B, Hkv, S, D] bf16, or (int8 codes,
    f32 scales [B, Hkv, S]) tuples; with `layer` the cache carries a
    leading [L] axis. k_new/v_new: [B, Hkv, (1,) D] floats, or (codes,
    scales [B, Hkv, 1]) matching the cache. active [B] (default all):
    inactive slots attend the frozen rows [0, pos] and not the new row.
    window: keys kept in (pos - window, pos]; softcap: softcap * tanh(s /
    softcap) after the int8 scale fold. dot_impl: the cache-dot form (see
    the module). Returns [B, Hq, D] f32. On CPU tensors this is the plain
    twin; on CUDA it launches the kernel or raises."""
    b_n, hq, d = q.shape
    hkv = _unpack(k_cache)[0].shape[-3]
    group = hq // hkv
    out = _call(q.reshape(b_n, hkv, group, d), k_cache, v_cache, k_new,
                v_new, pos, active, layer=layer, scale=scale, window=window,
                softcap=softcap, s_live=s_live, group=group,
                dot_impl=dot_impl)
    return out.reshape(b_n, hq, d)


def flash_verify_batched(q, k_cache, v_cache, k_new, v_new, pos, scale: float,
                         *, layer=None, active=None, window=None,
                         softcap: float = 0.0, s_live=None,
                         dot_impl: str = "f32") -> torch.Tensor:
    """Speculative verify-window attention: q [B, T, Hq, D], window token t
    at pos + t; its k/v row is virtual row t ([B, Hkv, T, D], or (codes,
    scales [B, Hkv, T(, 1)])), visible to window tokens >= t. Caches,
    active, window, softcap, s_live and dot_impl as in flash_decode_batched;
    inactive slots attend the frozen rows [0, pos + t] and no virtual row.
    Returns [B, T, Hq, D] f32."""
    b_n, t_n, hq, d = q.shape
    hkv = _unpack(k_cache)[0].shape[-3]
    group = hq // hkv
    qr = (q.reshape(b_n, t_n, hkv, group, d).permute(0, 2, 1, 3, 4)
          .reshape(b_n, hkv, t_n * group, d))
    out = _call(qr, k_cache, v_cache, k_new, v_new, pos, active, layer=layer,
                scale=scale, window=window, softcap=softcap, s_live=s_live,
                group=group, dot_impl=dot_impl)
    return (out.reshape(b_n, hkv, t_n, group, d).permute(0, 2, 1, 3, 4)
            .reshape(b_n, t_n, hq, d))
