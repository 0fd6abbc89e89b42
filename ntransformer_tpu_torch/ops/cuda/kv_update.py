"""In-place KV-cache row append: the wrapper of `csrc/kv_update.cu`, its plain
PyTorch twins, and the plain multi-row variant.

Replaces ntransformer_tpu/ops/pallas/kv_update.py::_append_stacked_impl /
_stacked_kernel (entry append_rows_stacked) and _append_impl / _kernel
(entry append_rows). For each active sequence b the new row of every layer
lands at pos[b] of its cache; inactive sequences keep their contents. The
caches are written IN PLACE and returned, where the JAX package aliases
them into the kernel's outputs.

On the H100 the append is bound by the bytes moved (about 2 MB each way at
L = 32, B = 32 int8 with scales, about a microsecond), so one launch's cost
sets its time: the kernel moves only the rows, 16 bytes a thread (the TPU
kernel's read-merge-write of a whole sublane tile is a Mosaic rule), and
covers every layer and cache in one launch. The wrapper's host work is
most of a call at decode sizes; it hands the arrays to the C entry as one
packed descriptor and makes no view or copy of a tensor that is already
as the kernel takes it.

`append_rows_stacked_dus` is the JAX package's own non-Pallas path (its
dynamic-update-slice variant): rows for a leading prefix of the layers and T
rows per sequence, written with indexed PyTorch writes on every device. The
batched decode step takes it at B = 1 and for a layer-prefix step, and the
verify step always, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NAME = "kv_update"
REPLACES = "ntransformer_tpu/ops/pallas/kv_update.py:130 _append_stacked_impl"
_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}
_SIZE = (2, 1, 4)  # element bytes by kind
_MAX_ARRAYS = 4
THREADS = 128  # the kernel's threads a block
_SIGNATURES = {"kv_append": [ctypes.c_void_p] + [ctypes.c_int] * 6
               + [ctypes.c_void_p] * 3}
# the C entry's descriptor, an array's 8 values: cache, rows, cache kind,
# row kind, dc, and its launch_plan (vec, units a row, first block)
_DESC = ctypes.c_longlong * (8 * _MAX_ARRAYS)

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


@functools.lru_cache(maxsize=None)
def _array_plan(cs: int, rs: int, dc: int, aligned: bool,
                rows_per_seq: int) -> tuple[int, int, int]:
    """(vec, units a row, blocks a sequence) of one array: 16-byte chunks
    of the cache row where its bytes, and the row's, divide into them and
    both arrays are 16-byte aligned, else elements."""
    vec = aligned and dc * cs % 16 == 0 and dc * rs % 16 == 0
    units = dc * cs // 16 if vec else dc
    return int(vec), units, -(-rows_per_seq * units // THREADS)


def launch_plan(arrays, n_layers: int, n_heads: int):
    """The kernel's grid along x (its y is the sequence): `arrays` holds an
    (cache element bytes, row element bytes, dc, both 16-byte aligned)
    tuple an array. Returns ([(vec, units a row, first block)] an array,
    blocks). A thread of block x moves unit u = (x - first) * THREADS +
    thread of its sequence's n_layers * n_heads rows, layer u // (n_heads
    units), head u // units % n_heads, unit u % units: a 16-byte chunk of
    the cache row where vec, else an element. The wrapper builds the same
    plan array by array (_array_plan)."""
    plan, blocks = [], 0
    for cs, rs, dc, aligned in arrays:
        vec, units, nb = _array_plan(cs, rs, dc, aligned,
                                     n_layers * n_heads)
        plan.append((vec, units, blocks))
        blocks += nb
    return plan, blocks


def _vector(v, dev: torch.device, di: int) -> torch.Tensor:
    """pos or active as the kernel reads it: a contiguous int32 vector on
    card di (the batched step hands them over so: then nothing is made)."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v)
    if v.dtype != torch.int32 or v.get_device() != di \
            or not v.is_contiguous():
        v = v.to(dev, torch.int32).contiguous()
    return v


def _launch(caches, rows, pos, active, stacked: bool):
    """One kernel launch writing `rows` into `caches` ([L, B, Hkv, S(, Dc)]
    when stacked, else [B, Hkv, S(, Dc)]: an L = 1 view) at pos[b]. The
    checks of the CPU path (_check_dtypes) are made here array by array,
    beside the rest: at decode sizes the host work is most of a call."""
    global launches
    n = len(caches)
    if not 1 <= n <= _MAX_ARRAYS or len(rows) != n:
        raise ValueError(f"kv append takes 1 to {_MAX_ARRAYS} caches, each "
                         f"with its rows; got {n} and {len(rows)}")
    c0 = caches[0]
    dev, di = c0.device, c0.get_device()
    nd = 4 if stacked else 3  # the leading dims: (L,) B, Hkv, S
    lead = c0.shape[:nd]
    if len(lead) != nd:
        raise ValueError(f"cache {tuple(c0.shape)} has fewer than {nd} "
                         "leading dims")
    l_n = lead[0] if stacked else 1
    b_n, h_n, s = lead[-3:]
    desc = _DESC()
    # keep: the rows' contiguous copies stay alive until the launch is
    # enqueued (a copy freed early could be handed to the next one)
    keep, blocks, per_seq = [], 0, l_n * h_n
    for i, (c, r) in enumerate(zip(caches, rows)):
        ck, rk = _KINDS.get(c.dtype), _KINDS.get(r.dtype)
        if ck is None or rk is None or (ck == 1) != (rk == 1):
            _check_dtypes((c,), (r,))  # raises, saying which rule
        if c.get_device() != di or r.get_device() != di:
            raise ValueError("kv append wants every cache and row on one "
                             "CUDA device")
        if not c.is_contiguous():
            raise ValueError("kv append writes contiguous caches in place")
        if c.shape[:nd] != lead:
            raise ValueError(f"cache {tuple(c.shape)} does not match "
                             f"{list(lead)} + [...]")
        dc = c.shape[nd] if c.dim() > nd else 1
        if r.numel() != per_seq * b_n * dc:
            raise ValueError(f"rows {tuple(r.shape)} are not one row per "
                             f"(layer, sequence, head) of {tuple(c.shape)}")
        if not r.is_contiguous():
            r = r.contiguous()
            keep.append(r)
        cp, rp = c.data_ptr(), r.data_ptr()
        vec, units, nb = _array_plan(_SIZE[ck], _SIZE[rk], dc,
                                     (cp | rp) % 16 == 0, per_seq)
        desc[8 * i:8 * i + 8] = (cp, rp, ck, rk, dc, vec, units, blocks)
        blocks += nb
    pos, active = _vector(pos, dev, di), _vector(active, dev, di)
    if pos.numel() != b_n or active.numel() != b_n:
        raise ValueError(f"pos/active must hold one entry per sequence "
                         f"({b_n})")
    lib = build.load(NAME, _SIGNATURES)
    with torch.cuda.device(dev):
        # the raw handle of the current stream: torch.cuda.current_stream
        # builds a Stream object, ~3.5 us of the call's host time
        rc = lib.kv_append(desc, n, blocks, l_n, b_n, h_n, s,
                           pos.data_ptr(), active.data_ptr(),
                           torch._C._cuda_getCurrentRawStream(di))
    build.check(lib, rc, NAME)
    launches += 1


def append_rows_stacked(caches, rows, pos, active):
    """All-layers bulk append, in place: caches [L, B, Hkv, S, Dc] codes
    and/or [L, B, Hkv, S] S-minor scale buffers; rows [L, B, Hkv, (1,) Dc]
    (scales [L, B, Hkv, 1(, 1)]); pos/active [B]. On a CPU tensor this is
    the plain twin; on a CUDA tensor it launches the kernel or raises."""
    if caches[0].is_cpu:
        caches, rows = tuple(caches), tuple(rows)
        _check_dtypes(caches, rows)
        return append_rows_stacked_plain(caches, rows, pos, active)
    _launch(caches, rows, pos, active, True)
    return tuple(caches)


def append_rows(caches, rows, pos, active):
    """One row per sequence into [B, Hkv, S, Dc] caches at pos[b], in place
    (rows [B, Hkv, (1,) Dc]); inactive slots keep their contents. On a CPU
    tensor this is the plain twin; on a CUDA tensor it launches the kernel
    (as an L = 1 view) or raises."""
    if caches[0].is_cpu:
        caches, rows = tuple(caches), tuple(rows)
        _check_dtypes(caches, rows)
        return append_rows_plain(caches, rows, pos, active)
    if any(c.dim() not in (3, 4) for c in caches):
        raise ValueError("append_rows takes [B, Hkv, S, Dc] caches (scales "
                         "[B, Hkv, S])")
    _launch(caches, rows, pos, active, False)
    return tuple(caches)
