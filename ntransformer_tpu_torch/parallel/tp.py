"""Tensor parallelism: the weights and the KV heads split over shards.

Port of ntransformer_tpu/parallel/tp.py. The plan is Megatron's, adapted to
quantized planes:

  wq/wk/wv/gate/up, the fused wqkv/wqk/gate|up and the qwen2 biases:
                     column-parallel, each plane split on N (lanes); the
                     query and KV heads split with them, so attention needs
                     no exchange (Hq and Hkv divide by the same tp);
  wo/down          : row-parallel, each plane split on its rows (K); the
                     shards' partial products are summed;
  embed / LM head  : row-parallel on K (hidden), so the 128,256-token vocab
                     never splits: the embedding's K-slices are
                     concatenated, the partial logits summed;
  KV cache         : split on the head axis ([L, Hkv/tp, S, D] a shard);
  norms, post norms, q/k norms, rope tables: replicated.

One process drives every shard, as in parallel/cp.py: a mesh is a tuple of
torch devices in which a device may repeat (two or four shards on one card
run every product at its shard shape; on a host with four cards, one shard
on each). `forward(..., tp=mesh)` in models/llama.py runs the replicated
work on the mesh's first device and sums the shards' partials there in
shard order. A tp row of a (dp, tp) mesh (parallel/multihost.py) may span
processes: each process then places and computes only the shards it owns,
and the partials are all-gathered and summed in shard order in every
process.

A shard's plane shapes stay valid layouts while K/tp keeps each format's
block (rows_div) and N/tp is whole heads. On CUDA the shard shapes must
also be ones the port's kernels take (`check_shardable`): a row-parallel
product's K/tp a whole number of its kernel's K units (the Q8_0 and Q4_0
32-element blocks, the K-quants' 256-element superblock; the skinny kernel
splits K in those units, ops/cuda/plans.py). W4A8 and W8A8 planes do not
shard yet, as the JAX CLI refuses --w4a8/--w8a8 with --tp. N/tp needs no
more: the skinny kernel's 128-column strips and the wgmma tile's 128
columns (plans.STRIP_COLS, TILE_COLS) mask a ragged last strip. A shape a
kernel cannot take is refused when the weights are sharded, never run
through a plain twin.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.dtypes import DType
from ..core.layout import LAYOUTS
from ..models.llama import Arch, KVCache, LayerWeights, ModelWeights, \
    fuse_layer_weights
from ..models.loader import resolve_device
from ..ops.linear import QLinear

# how each LayerWeights field splits
COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")
FUSED = {"wqkv": ("wq", "wk", "wv"), "wqk": ("wq", "wk"),
         "w_gate_up": ("w_gate", "w_up")}
ROW = ("wo", "w_down")
LANE_VECTORS = ("bq", "bk", "bv")          # qwen2 biases: their columns
REPLICATED = ("attn_norm", "ffn_norm", "attn_post_norm", "ffn_post_norm",
              "q_norm", "k_norm")

# K elements of one unit of each shardable format's kernel
# (ops/cuda/matmul.py, nibble_matmul.py: the block a product's K must be a
# multiple of)
KERNEL_K_UNIT = {DType.Q8_0: 32, DType.Q4_0: 32, DType.Q4_K: 256,
                 DType.Q5_K: 256, DType.Q6_K: 256}

_MOE_REFUSAL = ("MoE x tensor parallelism not supported - shard the "
                "experts instead (parallel/ep.py)")


def make_mesh_of(kind: str, n: int, devices=None) -> tuple[torch.device, ...]:
    """The first n of `devices` as a one-axis mesh of `kind` ("TP", "CP",
    "EP", "PP"); by default the first n CUDA devices (raises without CUDA).
    Raises if there are fewer (a list given may repeat a device)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n < 1 or len(devices) < n:
        raise ValueError(f"a {n}-way {kind} mesh needs {n} devices; "
                         f"{len(devices)} given")
    return tuple(devices[:n])


def make_tp_mesh(n: int, devices=None) -> tuple[torch.device, ...]:
    """The first n of `devices` as a TP mesh (make_mesh_of)."""
    return make_mesh_of("TP", n, devices)


def entry_mesh(make, n: int, device="cuda"):
    """The mesh the entry points place n positions on, built by `make(n,
    devices=None)`: one on each of the first n cards for "cuda"
    (ValueError if there are fewer; raises without CUDA), every position on
    the device for one with an index ("cuda:0") or "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return make(n, [dev] * n)
    return make(n)


def tp_mesh(n: int, device="cuda") -> tuple[torch.device, ...]:
    """entry_mesh of a TP mesh."""
    return entry_mesh(make_tp_mesh, n, device)


def local_arch(arch: Arch, tp: int) -> Arch:
    return arch.local_arch(tp)


def weight_specs(weights: ModelWeights) -> dict[str, str]:
    """The plan as a plain description: {field: "column" | "row" |
    "replicate"} for every tensor the weights hold ("layers.wq", "embed",
    ...). Raises for a mixture-of-experts model."""
    lw = weights.layers
    if lw is not None and lw.ffn_gate_inp is not None:
        raise NotImplementedError(_MOE_REFUSAL + "; DP-only serving "
                                  "replicates and works")
    specs = {"embed": "row", "lm_head": "row", "output_norm": "replicate",
             "rope_cos": "replicate", "rope_sin": "replicate"}
    if lw is None:
        return specs
    for f in dataclasses.fields(lw):
        if getattr(lw, f.name) is None:
            continue
        if f.name in COLUMN or f.name in FUSED or f.name in LANE_VECTORS:
            specs["layers." + f.name] = "column"
        elif f.name in ROW:
            specs["layers." + f.name] = "row"
        else:
            specs["layers." + f.name] = "replicate"
    return specs


def _row_split(weights: ModelWeights):
    """(name, QLinear) of every row-parallel matrix."""
    out = [("embed", weights.embed)]
    if weights.lm_head is not weights.embed:
        out.append(("lm_head", weights.lm_head))
    if weights.layers is not None:
        out = [("wo", weights.layers.wo),
               ("w_down", weights.layers.w_down)] + out
    return out


def _column_split(lw: LayerWeights):
    return [(nm, getattr(lw, nm)) for nm in COLUMN + tuple(FUSED)
            if getattr(lw, nm) is not None]


def check_shardable(arch: Arch, weights: ModelWeights, tp: int,
                    kernel_alignment: bool = False):
    """Validate the plan (ValueError otherwise): the JAX package's checks
    (KV heads, each row-split matrix's K/tp on its format's block) and
    every column-split N dividing by tp; engine-native formats refused.
    kernel_alignment: also the port's kernels' limits at the shard shapes
    (the module docstring): on for a mesh with a CUDA device."""
    if arch.n_kv_heads % tp:
        raise ValueError(f"n_kv_heads {arch.n_kv_heads} not divisible by "
                         f"tp={tp}")
    mats = _row_split(weights)
    if weights.layers is not None:
        mats += _column_split(weights.layers)
    for name, ql in mats:
        if ql.dtype in (DType.W4A8, DType.W8A8):
            # the JAX CLI refuses --w4a8/--w8a8 with --tp the same way
            raise ValueError(
                f"{name}: {ql.dtype.value} planes do not shard yet (the "
                "parallel engines shard source planes; convert-then-shard "
                "lands with a parity test before it is enabled)")
    for name, ql in _row_split(weights):
        if ql.dtype in LAYOUTS:
            blk = max(s.rows_div for s in LAYOUTS[ql.dtype])
            if ql.k % tp or (ql.k // tp) % blk:
                raise ValueError(f"{name}: K/tp = {ql.k}/{tp} breaks "
                                 f"{ql.dtype} block alignment")
        # the gather of an untied embedding runs no product kernel
        product = name != "embed" or weights.lm_head is weights.embed
        if kernel_alignment and product and ql.dtype in KERNEL_K_UNIT:
            unit = KERNEL_K_UNIT[ql.dtype]
            if ql.k % tp or (ql.k // tp) % unit:
                raise ValueError(f"{name}: K/tp = {ql.k}/{tp} is not a "
                                 f"whole number of the {ql.dtype.value} "
                                 f"kernel's {unit}-element K units")
    if weights.layers is not None:
        for name, ql in _column_split(weights.layers):
            if ql.n % tp:
                raise ValueError(f"{name}: N = {ql.n} does not split into "
                                 f"{tp} column shards")


def _widths(arch: Arch, name: str, ql: QLinear) -> list[int]:
    """The part widths of a matrix fused in tp = 1 order."""
    q, kv = arch.n_heads * arch.head_dim, arch.n_kv_heads * arch.head_dim
    return {"wqkv": [q, kv, kv], "wqk": [q, kv],
            "w_gate_up": [ql.n // 2, ql.n // 2]}[name]


def unfuse_layer_weights(lw: LayerWeights, arch: Arch) -> LayerWeights:
    """The parts of weights fused in tp = 1 order, as column views of the
    fused planes (no copy)."""
    out = lw
    for name, parts in FUSED.items():
        ql = getattr(lw, name)
        if ql is None:
            continue
        off, got = 0, {}
        for part, w in zip(parts, _widths(arch, name, ql)):
            got[part] = QLinear(ql.dtype, ql.k, w, {
                nm: a[..., off:off + w] for nm, a in ql.planes.items()})
            off += w
        out = dataclasses.replace(out, **{name: None}, **got)
    return out


def _place(t: torch.Tensor, dev) -> torch.Tensor:
    """t on dev, contiguous: a copy only where it is needed."""
    return t.to(dev).contiguous()


def _columns(ql: QLinear, s: int, tp: int, dev) -> QLinear:
    w = ql.n // tp
    return QLinear(ql.dtype, ql.k, w, {
        nm: _place(a[..., s * w:(s + 1) * w], dev)
        for nm, a in ql.planes.items()})


def _rows(ql: QLinear, s: int, tp: int, dev) -> QLinear:
    planes = {}
    for nm, a in ql.planes.items():
        r = a.shape[-2] // tp
        planes[nm] = _place(a[..., s * r:(s + 1) * r, :], dev)
    return QLinear(ql.dtype, ql.k // tp, ql.n, planes)


def shard_layer(lw: LayerWeights, s: int, tp: int, dev) -> LayerWeights:
    """Shard s of unfused layer weights (stacked or one layer) on dev."""
    fields = {}
    for f in dataclasses.fields(lw):
        v = getattr(lw, f.name)
        if v is None:
            fields[f.name] = None
        elif f.name in COLUMN:
            fields[f.name] = _columns(v, s, tp, dev)
        elif f.name in ROW:
            fields[f.name] = _rows(v, s, tp, dev)
        elif f.name in LANE_VECTORS:
            w = v.shape[-1] // tp
            fields[f.name] = _place(v[..., s * w:(s + 1) * w], dev)
        elif f.name in REPLICATED:
            fields[f.name] = v.to(dev)
        else:
            raise NotImplementedError(_MOE_REFUSAL)
    return LayerWeights(**fields)


def shard_weights(weights: ModelWeights, mesh, arch: Arch,
                  fuse: bool = False, only=None) -> list[ModelWeights]:
    """One ModelWeights per shard, each on its own device of `mesh`, with
    the plan above. Host (CPU) weights go straight to their shards: no
    unsharded copy lands on a card. Weights fused in tp = 1 order
    (`fuse_layer_weights(lw)`) are split back into their parts first, and
    each shard's fused planes rebuilt from its slices of the parts; with
    unfused weights `fuse=True` does the same. Either way shard s holds the
    planes of the JAX package's `fuse_layer_weights(lw, tp)` followed by a
    contiguous column split. A tied head stays the embedding's object on
    every shard. weights.layers may be None (a tiered model with no
    resident layer). only: the shard indices to place (default: the shards
    this process owns, every shard of a plain tuple); the others are
    None."""
    tp = len(mesh)
    lw = weights.layers
    if lw is not None and lw.ffn_gate_inp is not None:
        raise NotImplementedError(_MOE_REFUSAL)
    check_shardable(arch, weights, tp,
                    any(torch.device(d).type == "cuda" for d in mesh))
    tied = weights.lm_head is weights.embed
    fused = lw is not None and any(getattr(lw, nm) is not None
                                   for nm in FUSED)
    if fused:
        lw = unfuse_layer_weights(lw, arch)
    if only is None:
        from .multihost import owned
        only = owned(mesh)
    out = []
    for s, dev in enumerate(mesh):
        if s not in only:
            out.append(None)
            continue
        layers = None
        if lw is not None:
            layers = shard_layer(lw, s, tp, dev)
            if fuse or fused:
                layers = fuse_layer_weights(layers)
        embed = _rows(weights.embed, s, tp, dev)
        out.append(ModelWeights(
            embed=embed, layers=layers,
            output_norm=weights.output_norm.to(dev),
            lm_head=embed if tied else _rows(weights.lm_head, s, tp, dev),
            rope_cos=weights.rope_cos.to(dev),
            rope_sin=weights.rope_sin.to(dev)))
    return out


def make_tp_kv(arch: Arch, mesh, quant: bool = False) -> list[KVCache]:
    """The cache of a tp-way mesh: shard s's [L, Hkv/tp, S, D] heads (int8
    codes and their scales alike with quant=True), created on its own
    device; None for a shard another process owns."""
    from .multihost import owned
    local = local_arch(arch, len(mesh))
    mine = owned(mesh)
    return [KVCache.create(local, quant=quant, device=d) if s in mine
            else None for s, d in enumerate(mesh)]


def _graphed(device) -> bool:
    """Whether make_tp_decode_loop's loop replays a captured program on
    `device`: iff it is a CUDA device."""
    return torch.device(device).type == "cuda"


def make_tp_decode_loop(mesh, arch: Arch, n_steps: int, *,
                        kv_quant: bool = False, graphs=None):
    """The greedy decode loop over a TP mesh (the JAX make_tp_decode_loop,
    whose lax.scan runs inside shard_map). Returns f(shards, kv,
    first_token, pos0) -> (tokens [n_steps], kv): n_steps greedy tokens
    from first_token (an int or a one-element device tensor) at pos0 (a
    host int) through forward(tp=mesh), each argmax kept on the device as
    the next token; the cache (make_tp_kv's, int8 iff kv_quant) is written
    in place.

    On CUDA cards, the mesh on one or several of them
    (models/graphs.check_capturable), the loop kind of a ForwardGraphs
    bound to (shards, kv) replays n_steps times with no host read in
    between: graphs(kv) gives it where the caller keeps one (TPEngine's
    _graphs_of, for its own cache), else f keeps one bound to the last
    (shards, kv) it was given. Elsewhere a Python loop of the same
    forwards runs, the argmax on the device."""
    from ..models.graphs import ForwardGraphs, one_card
    from ..models.llama import forward
    held = {}

    def f(shards, kv, first_token, pos0):
        if any(c is not None and c.quantized != kv_quant for c in kv):
            raise ValueError(f"the loop was made for a "
                             f"{'int8' if kv_quant else 'bf16'} cache")
        pos0 = int(pos0)
        dev = next(w for w in shards if w is not None).output_norm.device
        g = graphs(kv) if graphs is not None else None
        if g is None and _graphed(dev) and one_card(mesh):
            if held.get("kv") is not kv or held.get("shards") is not shards:
                held.update(kv=kv, shards=shards,
                            g=ForwardGraphs(arch, shards, kv, tp=mesh))
            g = held["g"]
        if g is not None:
            toks, _ = g.loop(kv, first_token, pos0, n_steps)
            return toks.clone(), kv
        tok = torch.as_tensor(first_token, device=dev).reshape(1)
        toks = []
        for i in range(n_steps):
            logits, kv, _ = forward(arch, shards, kv, tok, pos0 + i, tp=mesh)
            tok = torch.argmax(logits[0]).reshape(1)
            toks.append(tok)
        return torch.cat(toks), kv
    return f
