"""Batched flash decode / verify attention: the wrapper of
`csrc/batched_attention.cu` and its plain PyTorch twin.

Replaces ntransformer_tpu/ops/pallas/batched_attention.py::_impl / _kernel
(entries flash_decode_batched and flash_verify_batched) in its default
dot_impl="f32" form. B sequences attend one layer of a stacked
[L, B, Hkv, S, D] cache (or an unstacked [B, Hkv, S, D] one), bf16 or int8
codes with S-minor f32 scales, plus the T new k/v rows that are not written
yet (the virtual block: T = 1 decodes, T > 1 is a speculative verify
window). Active slots see cache keys [0, pos - 1] and the virtual rows
causally; inactive slots see the frozen keys [0, pos + t] and no virtual
row. All arithmetic is f32; the int8 scales fold into the score and
probability columns. Returns f32.

On the H100 it is bound by bytes (every live K/V row once). The kernel
splits each sequence's live keys across blocks and merges the partials in a
fixed-order second pass, so small batches fill the card; a block stops at
its own sequence's last live key. See the source for the details.

`s_live` keeps the JAX argument's contract: every attended key lies below
it, and the result equals the whole-cache result. The kernel reads no key
at or past it (and none past a sequence's own last live key), with no
rounding of the bucket: the TPU's 128-multiple is a Mosaic lane rule.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NAME = "batched_attention"
REPLACES = "ntransformer_tpu/ops/pallas/batched_attention.py:269 _impl"
_SIGNATURES = {"batched_flash_attention": [ctypes.c_void_p] * 15
               + [ctypes.c_int] * 12 + [ctypes.c_float] * 2
               + [ctypes.c_void_p]}
NO_WINDOW = 2 ** 30  # a window larger than any context masks nothing
MAX_ROWS = 32        # query rows per (sequence, kv head): group * T
MAX_NEW = 8          # virtual rows per sequence
_MIN_SPLIT_KEYS = 64  # fewest live keys worth a block of their own

# kernel launches since the last reset (chip_smoke.py reads and resets it):
# a call is two, the split pass and its combine pass
launches = 0
_SM_COUNT: dict[int, int] = {}
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _unpack(cache):
    """(codes, scales or None) of a cache; legacy [.., S, 1] scales lose
    their trailing axis (order-preserving)."""
    if isinstance(cache, tuple):
        c, s = cache
        if s.dim() == c.dim():
            s = s.reshape(s.shape[:-1])
        return c, s
    return cache, None


def batched_flash_plain(qr, k, v, ks, vs, kn, vn, kns, vns, pos, active, *,
                        layer, scale: float, window: int, softcap: float,
                        s_live: int, group: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in its layout: qr [B, Hkv,
    R, D] (row r = t * group + g); k/v [L?, B, Hkv, S, D] (layer picks one
    of a stacked cache) with scales [L?, B, Hkv, S] or None; kn/vn [B, Hkv,
    T, D] in the cache dtype with kns/vns [B, Hkv, T] or None. One softmax
    over the live cache keys and the visible virtual rows, all in f32.
    Returns [B, Hkv, R, D] f32."""
    if layer is not None:
        k, v = k[layer], v[layer]
        if ks is not None:
            ks, vs = ks[layer], vs[layer]
    b_n, _, r_n, _ = qr.shape
    s = k.shape[2]
    t_n = kn.shape[2]
    dev = qr.device
    q = qr.to(torch.float32)
    sc = torch.einsum("bhrd,bhsd->bhrs", q, k.to(torch.float32)) * scale
    sn = torch.einsum("bhrd,bhtd->bhrt", q, kn.to(torch.float32)) * scale
    if ks is not None:
        sc = sc * ks[:, :, None, :].to(torch.float32)
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
          window, softcap, s_live, group) -> torch.Tensor:
    """Shared body of the two entries, in the kernel layout: qr [B, Hkv, R,
    D]; k_new/v_new [B, Hkv, T, D] (or (codes, scales [B, Hkv, T(, 1)]))."""
    global launches
    k, ks = _unpack(k_cache)
    v, vs = _unpack(v_cache)
    quant = ks is not None
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
              window=win, softcap=float(softcap), s_live=live, group=group)
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
    # from the shapes alone, so an s_live bucket changes no bit of the result
    nsplit = _split_count(dev, b_n, hkv, s)
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
        win, nsplit, float(scale), float(softcap), stream)
    build.check(lib, rc, NAME)
    launches += 2
    return out


def flash_decode_batched(q, k_cache, v_cache, k_new, v_new, pos, scale: float,
                         *, layer=None, active=None, window=None,
                         softcap: float = 0.0, s_live=None) -> torch.Tensor:
    """Batched decode attention over per-sequence caches plus each
    sequence's current (not yet written) k/v row.

    q [B, Hq, D]; pos [B] = each sequence's position (cache keys [0, pos -
    1] are live). k_cache/v_cache: [B, Hkv, S, D] bf16, or (int8 codes,
    f32 scales [B, Hkv, S]) tuples; with `layer` the cache carries a
    leading [L] axis. k_new/v_new: [B, Hkv, (1,) D] floats, or (codes,
    scales [B, Hkv, 1]) matching the cache. active [B] (default all):
    inactive slots attend the frozen rows [0, pos] and not the new row.
    window: keys kept in (pos - window, pos]; softcap: softcap * tanh(s /
    softcap) after the int8 scale fold. Returns [B, Hq, D] f32. On CPU
    tensors this is the plain twin; on CUDA it launches the kernel or
    raises."""
    b_n, hq, d = q.shape
    hkv = _unpack(k_cache)[0].shape[-3]
    group = hq // hkv
    out = _call(q.reshape(b_n, hkv, group, d), k_cache, v_cache, k_new,
                v_new, pos, active, layer=layer, scale=scale, window=window,
                softcap=softcap, s_live=s_live, group=group)
    return out.reshape(b_n, hq, d)


def flash_verify_batched(q, k_cache, v_cache, k_new, v_new, pos, scale: float,
                         *, layer=None, active=None, window=None,
                         softcap: float = 0.0, s_live=None) -> torch.Tensor:
    """Speculative verify-window attention: q [B, T, Hq, D], window token t
    at pos + t; its k/v row is virtual row t ([B, Hkv, T, D], or (codes,
    scales [B, Hkv, T(, 1)])), visible to window tokens >= t. Caches,
    active, window, softcap and s_live as in flash_decode_batched; inactive
    slots attend the frozen rows [0, pos + t] and no virtual row. Returns
    [B, T, Hq, D] f32."""
    b_n, t_n, hq, d = q.shape
    hkv = _unpack(k_cache)[0].shape[-3]
    group = hq // hkv
    qr = (q.reshape(b_n, t_n, hkv, group, d).permute(0, 2, 1, 3, 4)
          .reshape(b_n, hkv, t_n * group, d))
    out = _call(qr, k_cache, v_cache, k_new, v_new, pos, active, layer=layer,
                scale=scale, window=window, softcap=softcap, s_live=s_live,
                group=group)
    return (out.reshape(b_n, hkv, t_n, group, d).permute(0, 2, 1, 3, 4)
            .reshape(b_n, t_n, hq, d))
