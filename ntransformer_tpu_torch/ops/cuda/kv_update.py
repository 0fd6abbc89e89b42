"""In-place KV-cache row append: the wrapper of `csrc/kv_update.cu`, its plain
PyTorch twins, and the plain multi-row variant.

Replaces ntransformer_tpu/ops/pallas/kv_update.py::_append_stacked_impl /
_stacked_kernel (entry append_rows_stacked) and _append_impl / _kernel
(entry append_rows). For each active sequence b the new row of every layer
lands at pos[b] of its cache; inactive sequences keep their contents. The
caches are written IN PLACE and returned, where the JAX package aliases
them into the kernel's outputs.

On the H100 the append is bound by the bytes written (about 2 MB at L = 32,
B = 32 int8 with scales, under a microsecond), so one launch's cost sets its
time: the kernel writes only the rows (the TPU kernel's read-merge-write of
a whole sublane tile is a Mosaic rule) and covers every layer and cache in
one launch.

`append_rows_stacked_dus` is the JAX package's own non-Pallas path (its
dynamic-update-slice variant): rows for a leading prefix of the layers and T
rows per sequence, written with indexed PyTorch writes on every device. The
batched decode step takes it at B = 1 and for a layer-prefix step, and the
verify step always, as the JAX package does.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NAME = "kv_update"
REPLACES = "ntransformer_tpu/ops/pallas/kv_update.py:130 _append_stacked_impl"
_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}
_MAX_ARRAYS = 4
_SIGNATURES = {"kv_append": [ctypes.c_int]
               + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int] * _MAX_ARRAYS
               + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3}

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def _check_dtypes(caches, rows):
    """The dtypes the kernel writes, held on every device so that a cache
    the kernel refuses is refused on the CPU too: bf16, int8 or f32 caches
    and rows, int8 rows for an int8 cache only. (Hopper needs no S tiling,
    where the TPU kernel needs S to divide by the dtype's sublane tile.)"""
    for c, r in zip(caches, rows):
        if c.dtype not in _KINDS or r.dtype not in _KINDS:
            raise ValueError(f"kv append takes bf16, int8 or f32; got "
                             f"{c.dtype} cache, {r.dtype} rows")
        if (c.dtype == torch.int8) != (r.dtype == torch.int8):
            raise ValueError("an int8 cache takes int8 rows (and only it)")


def _index(cache: torch.Tensor, pos: torch.Tensor, lr: int, t: int):
    """Broadcast index tensors selecting rows [pos[b], pos[b] + t) of layers
    [0, lr) of every sequence of `cache` ([L, B, H, S, Dc], or an S-minor
    [L, B, H, S]), and the mask of the positions inside the cache."""
    b_n, h_n, s = cache.shape[1], cache.shape[2], cache.shape[3]
    dev = cache.device
    rows = pos.to(dev, torch.long)[:, None] + torch.arange(t, device=dev)
    inside = (rows >= 0) & (rows < s)                       # [B, t]
    p = rows.clamp(0, s - 1)
    li = torch.arange(lr, device=dev).view(lr, 1, 1, 1)
    bi = torch.arange(b_n, device=dev).view(1, b_n, 1, 1)
    hi = torch.arange(h_n, device=dev).view(1, 1, h_n, 1)
    pi = p.view(1, b_n, 1, t)
    if cache.dim() == 4:
        return (li, bi, hi, pi), inside.view(1, b_n, 1, t)
    dc = cache.shape[-1]
    ci = torch.arange(dc, device=dev).view(1, 1, 1, 1, dc)
    idx = tuple(a.unsqueeze(-1) for a in (li, bi, hi, pi)) + (ci,)
    return idx, inside.view(1, b_n, 1, t, 1)


def _write_rows(cache, rows, pos, active, t: int):
    """cache[l, b, h, pos[b] + i] = rows[l, b, h, i] for l < rows' layer
    count, the active b and the positions inside the cache."""
    lr = rows.shape[0]
    b_n, h_n = cache.shape[1], cache.shape[2]
    shape = (lr, b_n, h_n, t) + ((cache.shape[-1],) if cache.dim() == 5
                                 else ())
    new = rows.reshape(shape).to(cache.dtype)
    idx, inside = _index(cache, pos, lr, t)
    act = active.to(cache.device, torch.bool).view(
        (1, b_n, 1, 1) + ((1,) if cache.dim() == 5 else ()))
    keep = act & inside
    cache[idx] = torch.where(keep, new, cache[idx])


def append_rows_stacked_plain(caches, rows, pos, active):
    """The kernel's function in plain PyTorch: one indexed write per cache.
    caches: [L, B, Hkv, S, Dc] code caches and/or [L, B, Hkv, S] S-minor
    scale buffers; rows: [L, B, Hkv, (1,) Dc] (scales [L, B, Hkv, 1(, 1)]).
    Returns the caches, written in place."""
    caches = tuple(caches)
    for c, r in zip(caches, rows):
        _write_rows(c, r, pos, active, 1)
    return caches


def append_rows_plain(caches, rows, pos, active):
    """append_rows in plain PyTorch: caches [B, Hkv, S, Dc] as L = 1 views."""
    caches = tuple(caches)
    for c, r in zip(caches, rows):
        _write_rows(c[None], r.reshape((1,) + tuple(r.shape)), pos, active, 1)
    return caches


def append_rows_stacked_dus(caches, rows, pos, active):
    """The JAX package's dynamic-update-slice variant, as indexed PyTorch
    writes: rows may cover a leading prefix of the layers ([Lr, B, Hkv, T,
    Dc] with Lr <= L, scales [Lr, B, Hkv, T(, 1)]) and T >= 1 contiguous
    positions per sequence. Returns the caches, written in place."""
    caches = tuple(caches)
    for c, r in zip(caches, rows):
        lr, b_n, h_n = r.shape[0], c.shape[1], c.shape[2]
        dc = c.shape[-1] if c.dim() == 5 else 1
        t = r.numel() // (lr * b_n * h_n * dc)
        _write_rows(c, r, pos, active, t)
    return caches


def _launch(caches, rows, pos, active, n_layers: int):
    global launches
    dev = caches[0].device
    if not 1 <= len(caches) <= _MAX_ARRAYS or len(rows) != len(caches):
        raise ValueError(f"kv append takes 1 to {_MAX_ARRAYS} caches, each "
                         f"with its rows; got {len(caches)} and {len(rows)}")
    b_n, h_n, s = caches[0].shape[1:4]
    # keep: the rows' contiguous copies stay alive until the launch is
    # enqueued (a copy freed early could be handed to the next one)
    args, keep = [], []
    for c, r in zip(caches, rows):
        if c.device != dev or r.device != dev:
            raise ValueError("kv append wants every cache and row on one "
                             "CUDA device")
        if not c.is_contiguous():
            raise ValueError("kv append writes contiguous caches in place")
        if tuple(c.shape[:4]) != (n_layers, b_n, h_n, s):
            raise ValueError(f"cache {tuple(c.shape)} does not match "
                             f"[{n_layers}, {b_n}, {h_n}, {s}, ...]")
        dc = c.shape[-1] if c.dim() == 5 else 1
        if r.numel() != n_layers * b_n * h_n * dc:
            raise ValueError(f"rows {tuple(r.shape)} are not one row per "
                             f"(layer, sequence, head) of {tuple(c.shape)}")
        r = r.contiguous()
        keep.append(r)
        args += [c.data_ptr(), r.data_ptr(), _KINDS[c.dtype],
                 _KINDS[r.dtype], dc]
    for _ in range(_MAX_ARRAYS - len(caches)):
        args += [None, None, 0, 0, 1]
    pos32 = pos.to(dev, torch.int32).contiguous()
    act32 = active.to(dev, torch.int32).contiguous()
    if pos32.numel() != b_n or act32.numel() != b_n:
        raise ValueError(f"pos/active must hold one entry per sequence "
                         f"({b_n})")
    lib = build.load(NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.kv_append(len(caches), *args, n_layers, b_n, h_n, s,
                           pos32.data_ptr(), act32.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, NAME)
    launches += 1


def append_rows_stacked(caches, rows, pos, active):
    """All-layers bulk append, in place: caches [L, B, Hkv, S, Dc] codes
    and/or [L, B, Hkv, S] S-minor scale buffers; rows [L, B, Hkv, (1,) Dc]
    (scales [L, B, Hkv, 1(, 1)]); pos/active [B]. On a CPU tensor this is
    the plain twin; on a CUDA tensor it launches the kernel or raises."""
    caches, rows = tuple(caches), tuple(rows)
    _check_dtypes(caches, rows)
    if caches[0].device.type == "cpu":
        return append_rows_stacked_plain(caches, rows, pos, active)
    _launch(caches, rows, torch.as_tensor(pos),
            torch.as_tensor(active), caches[0].shape[0])
    return caches


def append_rows(caches, rows, pos, active):
    """One row per sequence into [B, Hkv, S, Dc] caches at pos[b], in place
    (rows [B, Hkv, (1,) Dc]); inactive slots keep their contents. On a CPU
    tensor this is the plain twin; on a CUDA tensor it launches the kernel
    (as an L = 1 view) or raises."""
    caches, rows = tuple(caches), tuple(rows)
    _check_dtypes(caches, rows)
    if caches[0].device.type == "cpu":
        return append_rows_plain(caches, rows, pos, active)
    if any(c.dim() != 4 for c in caches):
        raise ValueError("append_rows takes [B, Hkv, S, Dc] caches")
    _launch(tuple(c[None] for c in caches), rows,
            torch.as_tensor(pos), torch.as_tensor(active), 1)
    return caches
