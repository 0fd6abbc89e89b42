"""Prefill flash attention: the wrappers of `csrc/flash_attention.cu` and
their plain PyTorch twins.

Replaces ntransformer_tpu/ops/pallas/attention.py::_flash_impl /
_attn_kernel, both entries:
  flash_attention           causal GQA attention of q [T,Hq,D] over the
                            cache k/v [Hkv,S,D]: online softmax in f32, p
                            rounded to bf16 before the PV product, KV tiles
                            past causality or below the window skipped.
                            Returns [T,Hq,D] f32. The offset is a host int
                            or, as the TPU kernel's scalar prefetch, an
                            int64 on the card that each block reads.
  flash_attention_partials  one shard's pass under context parallelism: the
                            cache is a [Hkv,S_local,D] slice whose key i sits
                            at global position kpos_offset + i. Returns the
                            unnormalized acc [T,Hq,D], m [T,Hq], l [T,Hq]
                            f32 for the exact combine across shards
                            (ops/layers.attention_cp_flash). Its offset
                            takes the same two forms as the first entry's;
                            kpos_offset, the shard's fixed start, is a host
                            int.

On the H100 it is bound by operations (the tensor cores). A block packs
128 query rows of one kv head (128 / group tokens x the group's heads), a
producer warpgroup streams that head's visible K/V tiles through a TMA ring,
and two wgmma warpgroups run QK^T and PV on them — the TPU grid's sequential KV
axis becomes that loop, and nothing carries between blocks. The kernel
takes a bf16 cache; see the source for the details.
"""
from __future__ import annotations

import ctypes

import torch

from ..layers import attention_torch
from . import build

NAME = "flash_attention"
REPLACES = "ntransformer_tpu/ops/pallas/attention.py:120 _flash_impl"
PARTIALS_NAME = "flash_attention_partials"
PARTIALS_REPLACES = ("ntransformer_tpu/ops/pallas/attention.py:210 "
                     "flash_attention_partials")
_SIGNATURES = {"flash_attention_fwd": [ctypes.c_void_p] * 4
               + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
               + [ctypes.c_void_p] * 2,
               "flash_attention_partials_fwd": [ctypes.c_void_p] * 6
               + [ctypes.c_int] * 8 + [ctypes.c_float]
               + [ctypes.c_void_p] * 2}
NO_WINDOW = 2 ** 30  # a window larger than any context masks nothing
MAX_GROUP = 128      # query heads a kv head: a block packs 128 query rows
# the masked score, finite (the TPU kernel's): a shard whose keys are all
# masked exports m = NEG_INF and drops out of the combine with no NaN
NEG_INF = -0.7 * torch.finfo(torch.float32).max

# kernel launches since the last reset (chip_smoke.py reads and resets
# them), one count per entry
launches = 0
partials_launches = 0


def check_shapes(q, k_cache, v_cache, pos: int):
    """(T, Hq, Hkv, S, D) of a flash call, or ValueError."""
    t, hq, hkv, s, d = check_dims(q, k_cache, v_cache)
    if not 0 <= pos <= s - t:
        raise ValueError(f"rows [{pos}, {pos + t}) fall outside the "
                         f"{s}-row cache")
    return t, hq, hkv, s, d


def check_dims(q, k_cache, v_cache):
    """(T, Hq, Hkv, S, D) of q [T,Hq,D] over k/v [Hkv,S,D], or
    ValueError."""
    if q.dim() != 3 or k_cache.dim() != 3:
        raise ValueError(f"flash attention wants q [T,Hq,D], k/v [Hkv,S,D]; "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    t, hq, d = q.shape
    hkv, s, dk = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or dk != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)} do not agree")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d not in (64, 128):
        raise ValueError(f"head dim {d} not supported (64 or 128)")
    return t, hq, hkv, s, d


def flash_attention_plain(q, k_cache, v_cache, pos, q_len: int,
                          scale: float, *, window=None,
                          softcap: float = 0.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: attention_torch of q cast to
    the cache dtype (the kernel's operand types); pos a host int or a 0-d
    device tensor."""
    return attention_torch(q.to(k_cache.dtype), k_cache, v_cache, pos, q_len,
                           scale, window=window, softcap=softcap)


def flash_attention_cuda(q, k_cache, v_cache, pos, q_len: int,
                         scale: float, *, window=None,
                         softcap: float = 0.0) -> torch.Tensor:
    """Causal GQA flash attention, [T,Hq,D] f32. q is cast to the cache
    dtype. pos: the first query's position, a host int (checked against the
    cache here) or a 0-d int64 tensor on q's device, which the kernel reads
    on the card and nothing reads on the host (the caller keeps rows
    [pos, pos + T) inside the cache; a CUDA graph replays the call at any
    offset). On a CPU tensor this is the plain twin (any float cache); on a
    CUDA tensor it launches the kernel (a bf16 cache) or raises."""
    global launches
    on_device = isinstance(pos, torch.Tensor)
    if on_device:
        t, hq, hkv, s, d = check_dims(q, k_cache, v_cache)
        if pos.numel() != 1 or pos.dtype != torch.int64 \
                or pos.device != q.device:
            raise ValueError(f"a device pos is one int64 on q's device; got "
                             f"{pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
        pos = pos.reshape(())
    else:
        pos = int(pos)
        t, hq, hkv, s, d = check_shapes(q, k_cache, v_cache, pos)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k_cache, v_cache, pos, q_len, scale,
                                     window=window, softcap=softcap)
    q = _kernel_operands(q, k_cache, v_cache)
    lib = build.load(NAME, _SIGNATURES)
    out = torch.empty(t, hq, d, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), t, hq, hkv, s, d,
            int(k_cache.dtype == torch.float32), 0 if on_device else pos,
            NO_WINDOW if window is None else int(window), float(scale),
            float(softcap), pos.data_ptr() if on_device else None,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, NAME)
    launches += 1
    return out


def _kernel_operands(q, k_cache, v_cache):
    """Check the caches a kernel entry reads; q cast to their dtype,
    contiguous and 16-byte aligned. The kernel takes a bf16 cache only: no
    path of the port holds an f32 one (KVCache is bf16, or int8 codes
    attended as a bf16 dequant)."""
    if not (q.is_cuda and k_cache.device == q.device
            and v_cache.device == q.device):
        raise ValueError("flash attention wants q, k, v on one CUDA device")
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise ValueError(f"the flash attention kernel wants a bf16 cache; "
                         f"got {k_cache.dtype}, {v_cache.dtype}")
    if q.shape[1] // k_cache.shape[0] > MAX_GROUP:
        raise ValueError(f"GQA group {q.shape[1] // k_cache.shape[0]} "
                         f"exceeds the kernel's {MAX_GROUP} query heads a "
                         f"kv head")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash attention wants contiguous caches")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash attention wants 16-byte aligned caches")
    q = q.to(k_cache.dtype).contiguous()
    return q.clone() if q.data_ptr() % 16 else q


def flash_attention_partials_plain(q, k_local, v_local, pos,
                                   scale: float, *, kpos_offset: int):
    """The partials kernel's function in plain PyTorch, in f32 from q cast
    to the cache dtype (pos a host int or a 0-d int64 tensor on q's
    device): per (query row, head) the largest visible score m
    (NEG_INF where the shard holds no visible key), l = sum exp(s - m) and
    acc = sum exp(s - m) v over the visible keys. A row with no visible key
    gives acc 0, m NEG_INF, l 0. (The TPU kernel leaves in such a row's acc
    and l what its processed blocks summed at p = exp(0) = 1; the combine
    weights the row by exp(NEG_INF - m) = 0 either way.)"""
    t, hq, d = q.shape
    hkv, s, _ = k_local.shape
    group = hq // hkv
    qf = q.to(k_local.dtype).to(torch.float32).reshape(t, hkv, group, d)
    scores = torch.einsum("thgd,hsd->hgts", qf,
                          k_local.to(torch.float32)) * scale
    key_pos = kpos_offset + torch.arange(s, device=q.device)[None, :]
    q_pos = pos + torch.arange(t, device=q.device)[:, None]
    vis = (key_pos <= q_pos)[None, None]                 # [1, 1, T, S]
    scores = scores.masked_fill(~vis, NEG_INF)
    m = scores.amax(-1, keepdim=True)                    # [Hkv, g, T, 1]
    p = torch.exp(scores - m).masked_fill(~vis, 0.0)
    acc = torch.einsum("hgts,hsd->thgd", p, v_local.to(torch.float32))

    def back(x):  # [Hkv, g, T] -> [T, Hq]
        return x.reshape(hq, t).transpose(0, 1)
    return acc.reshape(t, hq, d), back(m[..., 0]), back(p.sum(-1))


def flash_attention_partials(q, k_local, v_local, pos, scale: float, *,
                             kpos_offset: int):
    """One shard's flash pass: (acc [T,Hq,D], m [T,Hq], l [T,Hq]) f32, q at
    global positions pos + t, key i of k/v_local [Hkv,S_local,D] at
    kpos_offset + i, causal. pos: a host int (range-checked here) or a 0-d
    int64 tensor on q's device, which the kernel reads on the card and
    nothing reads on the host (a CUDA graph replays the call at any
    offset); kpos_offset a host int. On a CPU tensor this is the plain
    twin; on a CUDA tensor it launches the kernel or raises."""
    global partials_launches
    kpos_offset = int(kpos_offset)
    t, hq, hkv, s, d = check_dims(q, k_local, v_local)
    on_device = isinstance(pos, torch.Tensor)
    if on_device:
        if pos.numel() != 1 or pos.dtype != torch.int64 \
                or pos.device != q.device:
            raise ValueError(f"a device pos is one int64 on q's device; got "
                             f"{pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
        pos = pos.reshape(())
    else:
        pos = int(pos)
    if (not on_device and (pos < 0 or pos + t > NO_WINDOW)) \
            or kpos_offset < 0 or kpos_offset + s > NO_WINDOW:
        raise ValueError(f"query positions from {pos} ({t} rows) or key "
                         f"positions [{kpos_offset}, {kpos_offset + s}) "
                         f"out of range")
    if q.device.type == "cpu":
        return flash_attention_partials_plain(q, k_local, v_local, pos, scale,
                                              kpos_offset=kpos_offset)
    q = _kernel_operands(q, k_local, v_local)
    lib = build.load(NAME, _SIGNATURES)
    acc = torch.empty(t, hq, d, dtype=torch.float32, device=q.device)
    m = torch.empty(t, hq, dtype=torch.float32, device=q.device)
    l = torch.empty(t, hq, dtype=torch.float32, device=q.device)
    # a shard's device need not be the current one: the launch (and the
    # default stream's handle, 0) go to the current device
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_partials_fwd(
            q.data_ptr(), k_local.data_ptr(), v_local.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), t, hq, hkv, s, d,
            int(k_local.dtype == torch.float32), 0 if on_device else pos,
            kpos_offset, float(scale),
            pos.data_ptr() if on_device else None,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, PARTIALS_NAME)
    partials_launches += 1
    return acc, m, l
