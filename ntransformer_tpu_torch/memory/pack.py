"""NTP1 pack: per-layer contiguous planar weight images for streaming
(PyTorch port, no JAX and no ml_dtypes).

Port of ntransformer_tpu/memory/pack.py. The GGML -> planar re-layout
(core/layout.py) is host work that must not be redone per token, so a GGUF is
packed once into an .ntp sidecar: every layer's planes and vectors as one
contiguous blob, each blob 4096-aligned in the file (O_DIRECT-friendly).
Tier-B layers are then raw byte blobs in pinned RAM and a tier-C fetch is one
contiguous read, with no per-fetch transformation.

The port writes the JAX package's NTP1 version-5 format byte for byte (the
same header JSON, offsets and plane bytes), so either package reads the
other's pack. Float matrices stream as bf16: the f32 -> bf16 conversion is
round-to-nearest-even on the f32 bits, equal to ml_dtypes' bfloat16 cast.
A mixture-of-experts layer's blob holds its attention, router and vectors,
then each expert's gate, up and down planes at a 4096-aligned sub-range
(meta["experts"]), so one expert is one O_DIRECT read: the (layer, expert)
streaming unit of memory/experts.py.

File layout: magic NTP1 | u32 version | u64 json_len | header JSON |
zero-pad to 4096 | per-layer blobs, each 4096-aligned; the file end padded
to 4096 so an O_DIRECT read of the last blob's rounded extent stays inside.

`unpack_layer` turns one blob, on the host or on the card, into a
LayerWeights of views (slice + view(dtype) + reshape). The CUDA kernels read
their planes with 16-byte vector loads where a plane's address allows it;
a plane whose address is not 16-byte aligned is copied into its own tensor
rather than handed to a kernel as a misaligned view.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.dequant import dequantize
from ..core.dtypes import DType
from ..core.layout import LAYOUTS, dequant_planes, relayout
from ..core.quant import quantize
from ..models.llama import LayerWeights
from ..models.loader import load_norm
from ..ops.linear import QLinear

MAGIC = b"NTP1"
# the JAX package's format version (5: MoE layers may carry per-expert
# sub-ranges; 2-4 added the optional LAYER_BIASES vectors)
PACK_VERSION = 5
ALIGN = 4096
PLANE_ALIGN = 16  # the kernels' vector-load alignment

# pack tensor key -> GGUF suffix (the LayerWeights field is the key)
LAYER_TENSORS = {
    "wq": "attn_q.weight", "wk": "attn_k.weight", "wv": "attn_v.weight",
    "wo": "attn_output.weight", "w_gate": "ffn_gate.weight",
    "w_up": "ffn_up.weight", "w_down": "ffn_down.weight",
}
LAYER_NORMS = {"attn_norm": "attn_norm.weight", "ffn_norm": "ffn_norm.weight"}
# optional f32 vectors, packed when the GGUF has them
LAYER_BIASES = {"bq": "attn_q.bias", "bk": "attn_k.bias",
                "bv": "attn_v.bias",
                "q_norm": "attn_q_norm.weight",
                "k_norm": "attn_k_norm.weight",
                "attn_post_norm": "post_attention_norm.weight",
                "ffn_post_norm": "post_ffw_norm.weight"}

# pack dtype name -> (torch dtype of the plane in the port, bytes); f16-bit
# planes (uint16) are held as int16 with the same bits
_PLANE_DTYPES = {"int8": (torch.int8, 1), "uint8": (torch.uint8, 1),
                 "uint16": (torch.int16, 2), "bfloat16": (torch.bfloat16, 2),
                 "float32": (torch.float32, 4)}


def _align(n: int, a: int = ALIGN) -> int:
    return (n + a - 1) // a * a


def plane_nbytes(m: dict) -> int:
    """Bytes of one plane or vector described by its meta entry."""
    return int(np.prod(m["shape"])) * _PLANE_DTYPES[m["dtype"]][1]


def _plane_rows(spec, k: int) -> int:
    """Rows of a plane of a [K, N] matrix; rows_div 0 is W8A8's fixed
    one-row scale plane."""
    return 1 if spec.rows_div == 0 else k // spec.rows_div


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns (uint16), round to nearest even on the f32
    bits; a NaN becomes the canonical quiet NaN of its sign."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))
               >> 16).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        rounded[nan] = (((u[nan] >> 16) & np.uint32(0x8000))
                        | np.uint32(0x7FC0)).astype(np.uint16)
    return rounded


# an MoE layer's expert matrices, in their order inside an expert's range
EXPERT_TENSORS = {"w_gate": "ffn_gate_exps.weight",
                  "w_up": "ffn_up_exps.weight",
                  "w_down": "ffn_down_exps.weight"}
ROUTER = "ffn_gate_inp"


class PackWriter:
    """Builds an .ntp pack from a GGUFReader, layer by layer."""

    def __init__(self, reader, requant: DType | None = None):
        self.reader = reader
        self.requant = requant

    def _effective_dtype(self, info) -> DType:
        k = info.shape[-1]
        if (self.requant is not None and info.dtype == DType.Q6_K
                and k % 256 == 0):  # K-quant superblock alignment
            return self.requant
        return info.dtype

    def _tensor_meta(self, info, off: int) -> tuple[dict, int]:
        """(tensor meta dict, new offset) for one matrix at blob offset."""
        n, k = info.shape[-2], info.shape[-1]
        dtype = self._effective_dtype(info)
        pmeta = {}
        if dtype in LAYOUTS:
            for spec in LAYOUTS[dtype]:
                rows = _plane_rows(spec, k)
                pmeta[spec.name] = {"off": off, "dtype": spec.np_dtype,
                                    "shape": [rows, int(n)]}
                off += rows * n * _PLANE_DTYPES[spec.np_dtype][1]
        else:
            # float tensors stream as bf16 (2 B/elem)
            pmeta["w"] = {"off": off, "dtype": "bfloat16",
                          "shape": [int(k), int(n)]}
            off += k * n * 2
        return ({"qdtype": dtype.name if dtype in LAYOUTS else "BF16",
                 "k": int(k), "n": int(n), "planes": pmeta}, off)

    def _layer_meta(self, i: int) -> dict:
        """Layer i's plane offsets and shapes, from the tensor infos alone."""
        pre = f"blk.{i}."
        moe = f"{pre}{ROUTER}.weight" in self.reader
        off = 0
        tensors = {}
        for key, suffix in LAYER_TENSORS.items():
            if pre + suffix not in self.reader:
                continue  # pure-MoE layers carry no dense FFN
            tensors[key], off = self._tensor_meta(
                self.reader.info(pre + suffix), off)
        if moe:
            tensors[ROUTER], off = self._tensor_meta(
                self.reader.info(f"{pre}{ROUTER}.weight"), off)
        norms = {}
        for key, suffix in list(LAYER_NORMS.items()) + list(
                LAYER_BIASES.items()):
            if key in LAYER_BIASES and pre + suffix not in self.reader:
                continue
            info = self.reader.info(pre + suffix)
            n_elems = int(np.prod(info.shape))
            norms[key] = {"off": off, "dtype": "float32", "shape": [n_elems]}
            off += n_elems * 4
        meta = {"tensors": tensors, "norms": norms}
        if moe:
            # each expert's planes at a 4096-aligned offset of the blob
            n_exp = int(self.reader.info(pre + EXPERT_TENSORS["w_gate"])
                        .shape[0])
            experts = []
            for _ in range(n_exp):
                off = _align(off)
                emeta = {"off": off, "tensors": {}}
                for key, suffix in EXPERT_TENSORS.items():
                    emeta["tensors"][key], off = self._tensor_meta(
                        self.reader.info(pre + suffix), off)
                emeta["size"] = off - emeta["off"]
                experts.append(emeta)
            meta["experts"] = experts
        meta["size"] = off
        return meta

    def _tensor_chunks(self, raw, info, n: int, k: int) -> list[bytes]:
        dtype = self._effective_dtype(info)
        if dtype != info.dtype:
            w = dequantize(raw, info.dtype, n, k)
            raw = np.frombuffer(quantize(w, dtype), np.uint8)
        if dtype in LAYOUTS:
            planes = relayout(raw, dtype, n, k)
            return [np.ascontiguousarray(planes[spec.name]).tobytes()
                    for spec in LAYOUTS[dtype]]  # deterministic plane order
        return [bf16_bits(np.ascontiguousarray(
            dequantize(raw, dtype, n, k).T)).tobytes()]

    def _layer_blob(self, i: int, meta: dict) -> bytes:
        """Layer i's blob, matching _layer_meta's layout."""
        pre = f"blk.{i}."
        chunks: list[bytes] = []
        for key in meta["tensors"]:
            suffix = LAYER_TENSORS.get(key, f"{ROUTER}.weight")
            info = self.reader.info(pre + suffix)
            n, k = info.shape
            chunks += self._tensor_chunks(self.reader.raw_bytes(pre + suffix),
                                          info, n, k)
        for key, suffix in list(LAYER_NORMS.items()) + list(
                LAYER_BIASES.items()):
            if key in meta["norms"]:
                chunks.append(load_norm(self.reader, pre + suffix)
                              .astype(np.float32).tobytes())
        size = sum(len(c) for c in chunks)
        for e, emeta in enumerate(meta.get("experts", ())):
            chunks.append(b"\0" * (emeta["off"] - size))  # 4096 alignment
            size = emeta["off"]
            for suffix in EXPERT_TENSORS.values():
                info = self.reader.info(pre + suffix)
                n_exp, n, k = info.shape
                raw = np.frombuffer(self.reader.raw_bytes(pre + suffix),
                                    np.uint8)
                per = raw.size // n_exp
                part = self._tensor_chunks(raw[e * per:(e + 1) * per], info,
                                           n, k)
                chunks += part
                size += sum(len(c) for c in part)
        out = b"".join(chunks)
        if len(out) != meta["size"]:
            raise AssertionError(f"layer {i}: blob of {len(out)} bytes, meta "
                                 f"says {meta['size']}")
        return out

    def write(self, path: str, layers: range | None = None,
              progress=None, src_key: str | None = None) -> "PackReader":
        """Two-pass streaming write: every offset from metadata first, then
        one layer materialized at a time (peak host memory: one layer)."""
        md = self.reader.metadata
        layers = layers if layers is not None else range(
            int(md[f"{md['general.architecture']}.block_count"]))
        metas = [self._layer_meta(i) for i in layers]
        header = {"version": PACK_VERSION, "n_layers": len(metas),
                  "layers": metas, "layer_ids": list(layers),
                  "src_key": src_key}
        # aligned offsets (slack for the "offset" fields added below)
        hdr0 = json.dumps(header).encode()
        base = _align(4 + 4 + 8 + len(hdr0) + 32 * len(metas) + 256)
        off = base
        for meta in metas:
            meta["offset"] = off
            off = _align(off + meta["size"])
        hdr = json.dumps(header).encode()
        if 16 + len(hdr) > base:
            raise AssertionError("pack header outgrew its slack")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(np.uint32(PACK_VERSION).tobytes())
            f.write(np.uint64(len(hdr)).tobytes())
            f.write(hdr)
            f.write(b"\0" * (base - 16 - len(hdr)))
            for i, meta in zip(layers, metas):
                f.seek(meta["offset"])
                f.write(self._layer_blob(i, meta))
                if progress:
                    progress(i)
            end = f.tell()
            if end % ALIGN:
                f.write(b"\0" * (_align(end) - end))
        os.replace(tmp, path)
        return PackReader(path)


def unpack_layer(blob: torch.Tensor, meta: dict) -> tuple[LayerWeights, int]:
    """LayerWeights of views into `blob` (a uint8 tensor on any device
    holding one layer's bytes, laid out as `meta`): slice, view(dtype),
    reshape. A plane whose address is not PLANE_ALIGN-aligned is copied into
    its own (aligned) tensor. Returns (weights, planes copied)."""
    copied = 0

    def view(m):
        nonlocal copied
        dt, _ = _PLANE_DTYPES[m["dtype"]]
        raw = blob[m["off"]: m["off"] + plane_nbytes(m)]
        if raw.data_ptr() % PLANE_ALIGN:
            raw = raw.clone()
            copied += 1
        return raw.view(dt).reshape(m["shape"])

    fields = {}
    for key, t in meta["tensors"].items():
        planes = {p: view(pm) for p, pm in t["planes"].items()}
        dt = DType[t["qdtype"]]
        if dt not in LAYOUTS and dt not in (DType.F32, DType.BF16):
            dt = DType.F32
        fields[key] = QLinear(dt, t["k"], t["n"], planes)
    for key, m in meta["norms"].items():
        fields[key] = view(m)
    for key in LAYER_TENSORS:
        fields.setdefault(key, None)
    return LayerWeights(**fields), copied


def expert_views(blob: torch.Tensor, emeta: dict, base: int = 0) -> dict:
    """{w_gate, w_up, w_down} QLinears of views into `blob` (a uint8 tensor
    on any device) laid out as the expert meta `emeta`, its plane offsets
    less `base` (emeta["off"] when blob holds only this expert's bytes).
    A view that is not 16-byte aligned is handed to the kernels as it is:
    their wrappers turn the 16-byte copies off for it."""
    out = {}
    for key, t in emeta["tensors"].items():
        planes = {}
        for p, m in t["planes"].items():
            dt, _ = _PLANE_DTYPES[m["dtype"]]
            off = m["off"] - base
            planes[p] = blob[off: off + plane_nbytes(m)].view(dt).reshape(
                m["shape"])
        dt = DType[t["qdtype"]]
        if dt not in LAYOUTS and dt not in (DType.F32, DType.BF16):
            dt = DType.F32
        out[key] = QLinear(dt, t["k"], t["n"], planes)
    return out


class PackReader:
    """Reads layer blobs and rebuilds LayerWeights from their bytes."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != MAGIC:
                raise ValueError(f"{path}: not an NTP1 pack")
            (self.version,) = np.frombuffer(f.read(4), np.uint32)
            (hlen,) = np.frombuffer(f.read(8), np.uint64)
            self.header = json.loads(f.read(int(hlen)))
        self.n_layers = self.header["n_layers"]
        self.layer_ids = self.header.get("layer_ids",
                                         list(range(self.n_layers)))

    def layer_meta(self, j: int) -> dict:
        return self.header["layers"][j]

    def layer_nbytes(self, j: int) -> int:
        return self.layer_meta(j)["size"]

    @property
    def max_layer_nbytes(self) -> int:
        return max(m["size"] for m in self.header["layers"])

    def read_layer(self, j: int, out: np.ndarray | None = None,
                   nbytes: int | None = None) -> np.ndarray:
        """Layer j's blob, or its first `nbytes` (into `out` when given)."""
        meta = self.layer_meta(j)
        size = meta["size"] if nbytes is None else nbytes
        if out is None:
            out = np.empty(size, np.uint8)
        with open(self.path, "rb") as f:
            f.seek(meta["offset"])
            n = f.readinto(memoryview(out)[:size])
        if n != size:
            raise OSError(f"{self.path}: short read {n} != {size}")
        return out

    def layer_weights(self, j: int, blob: np.ndarray,
                      meta: dict | None = None) -> LayerWeights:
        """LayerWeights of CPU tensor views into `blob` (a numpy uint8
        buffer). `meta` overrides the pack's layer meta (a tier-B requant
        re-describes its RAM blobs)."""
        lw, _ = unpack_layer(torch.from_numpy(blob),
                             meta if meta is not None else self.layer_meta(j))
        return lw

    # -- per-expert access (MoE packs; models/tiered_moe.py) -----------------
    def n_experts(self, j: int) -> int:
        return len(self.layer_meta(j).get("experts", ()))

    def expert_meta(self, j: int, e: int) -> dict:
        return self.layer_meta(j)["experts"][e]

    def expert_nbytes(self, j: int, e: int) -> int:
        return self.expert_meta(j, e)["size"]

    def read_expert(self, j: int, e: int,
                    out: np.ndarray | None = None) -> np.ndarray:
        """One expert's bytes (its 4096-aligned sub-range of the layer's
        blob), into `out` when given."""
        lmeta = self.layer_meta(j)
        emeta = lmeta["experts"][e]
        size = emeta["size"]
        if out is None:
            out = np.empty(size, np.uint8)
        with open(self.path, "rb") as f:
            f.seek(lmeta["offset"] + emeta["off"])
            n = f.readinto(memoryview(out)[:size])
        if n != size:
            raise OSError(f"{self.path}: short read {n} != {size}")
        return out

    def expert_weights(self, j: int, e: int, blob: np.ndarray,
                       whole_layer: bool = True) -> dict:
        """{w_gate, w_up, w_down} QLinears of CPU tensor views into `blob`:
        the whole layer's blob, or (whole_layer=False) one expert's bytes as
        read_expert gives them."""
        emeta = self.expert_meta(j, e)
        return expert_views(torch.from_numpy(blob), emeta,
                            base=0 if whole_layer else emeta["off"])


def requant_layer_meta(meta: dict, target: DType) -> dict:
    """Metadata half of the runtime tier-B requant: re-describe each Q6_K
    tensor (k % 256 == 0) at `target`'s plane layout and recompute every
    offset. Pure metadata, so tiers and staging can be sized before any
    data is read."""
    off = 0
    tensors = {}
    for key, t in meta["tensors"].items():
        k, n = t["k"], t["n"]
        pmeta = {}
        if t["qdtype"] == "Q6_K" and k % 256 == 0 and target in LAYOUTS:
            for spec in LAYOUTS[target]:
                rows = _plane_rows(spec, k)
                pmeta[spec.name] = {"off": off, "dtype": spec.np_dtype,
                                    "shape": [rows, int(n)]}
                off += rows * n * _PLANE_DTYPES[spec.np_dtype][1]
            tensors[key] = {"qdtype": target.name, "k": k, "n": n,
                            "planes": pmeta}
        else:
            for p, pm in t["planes"].items():
                pmeta[p] = {"off": off, "dtype": pm["dtype"],
                            "shape": pm["shape"]}
                off += plane_nbytes(pm)
            tensors[key] = {**t, "planes": pmeta}
    norms = {}
    for key, m in meta["norms"].items():
        norms[key] = {**m, "off": off}
        off += plane_nbytes(m)
    return {"tensors": tensors, "norms": norms, "size": off}


def requant_layer_blob(meta: dict, blob: np.ndarray, new_meta: dict,
                       target: DType, out: np.ndarray | None = None
                       ) -> np.ndarray:
    """Data half of the runtime tier-B requant: the blob matching
    requant_layer_meta(meta, target). Q6_K planes dequantize (exactly) and
    requantize to `target`, the same chain as the pack-time requant, so a
    runtime-requantized layer equals the offline pack's byte for byte;
    other tensors and the vectors copy through at their new offsets."""
    if out is None:
        out = np.empty(new_meta["size"], np.uint8)

    def oview(m):
        return blob[m["off"]: m["off"] + plane_nbytes(m)]

    def put(m, data_u8):
        out[m["off"]: m["off"] + data_u8.size] = data_u8

    for key, t in meta["tensors"].items():
        nt = new_meta["tensors"][key]
        if nt["qdtype"] != t["qdtype"]:
            k, n = t["k"], t["n"]
            planes = {p: oview(pm).view(pm["dtype"]).reshape(pm["shape"])
                      for p, pm in t["planes"].items()}
            wt = dequant_planes(planes, DType[t["qdtype"]], k, n)  # [K, N]
            raw = np.frombuffer(
                quantize(np.ascontiguousarray(wt.T), target), np.uint8)
            new_planes = relayout(raw, target, n, k)
            for p, pm in nt["planes"].items():
                arr = np.ascontiguousarray(new_planes[p])
                put(pm, np.frombuffer(arr.tobytes(), np.uint8))
        else:
            for p, pm in t["planes"].items():
                put(nt["planes"][p], oview(pm))
    for key, m in meta["norms"].items():
        put(new_meta["norms"][key], oview(m))
    return out


# --- tensor parallelism: shard-major layer blobs ------------------------------
SHARD_ALIGN = 256  # each plane of a shard's blob (>= PLANE_ALIGN)
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def shard_layer_meta(meta: dict, tp: int) -> list[dict]:
    """The layer's blob re-described for a tp-way TP mesh (parallel/tp.py):
    one meta a shard, holding its planes and vectors at their shard shapes
    (column-parallel matrices and the qwen2 biases split on N, wo and down
    on their plane rows, the norms whole), laid out from the shard's own
    offset 0, with "size" and "base", its offset in the shard-major blob
    (shard after shard, each 4096-aligned). A shard's bytes are then one
    contiguous span that unpack_layer turns into its LayerWeights."""
    from ..parallel.tp import COLUMN, LANE_VECTORS, ROW
    if "experts" in meta or ROUTER in meta["tensors"]:
        raise NotImplementedError(
            "tiered MoE does not compose with TP meshes or requant yet — "
            "drop those flags, or serve resident/EP")
    shards, base = [], 0
    for _ in range(tp):
        off, tensors, norms = 0, {}, {}
        for key, t in meta["tensors"].items():
            col = key in COLUMN
            if not col and key not in ROW:
                raise ValueError(f"{key}: no tensor-parallel split")
            planes = {}
            for p, pm in t["planes"].items():
                rows, n = pm["shape"]
                off = _align(off, SHARD_ALIGN)
                planes[p] = {"off": off, "dtype": pm["dtype"],
                             "shape": [rows, n // tp] if col
                             else [rows // tp, n]}
                off += plane_nbytes(planes[p])
            tensors[key] = {**t, "k": t["k"] if col else t["k"] // tp,
                            "n": t["n"] // tp if col else t["n"],
                            "planes": planes}
        for key, m in meta["norms"].items():
            n = m["shape"][0]
            off = _align(off, SHARD_ALIGN)
            norms[key] = {**m, "off": off,
                          "shape": [n // tp] if key in LANE_VECTORS else [n]}
            off += plane_nbytes(norms[key])
        shards.append({"tensors": tensors, "norms": norms, "size": off,
                       "base": base})
        base = _align(base + off)
    return shards


def shard_blob_nbytes(shards: list[dict]) -> int:
    """Bytes of the shard-major blob that shard_layer_meta describes."""
    return shards[-1]["base"] + shards[-1]["size"]


def _bits(buf: np.ndarray, m: dict, base: int = 0) -> np.ndarray:
    """A plane or vector of a uint8 buffer as same-width unsigned ints of
    its shape (a bit copy needs no float type)."""
    nb = plane_nbytes(m)
    item = _PLANE_DTYPES[m["dtype"]][1]
    return buf[base + m["off"]: base + m["off"] + nb].view(
        _UINT[item]).reshape(m["shape"])


def shard_layer_blob(meta: dict, blob: np.ndarray, shards: list[dict],
                     out: np.ndarray) -> np.ndarray:
    """Copy a layer's blob (laid out as `meta`) into `out` as the
    shard-major blob of shard_layer_meta: every shard's slice of every
    plane (strided column slices become contiguous) and vector."""
    from ..parallel.tp import COLUMN, LANE_VECTORS
    for s, sm in enumerate(shards):
        b = sm["base"]
        for key, t in meta["tensors"].items():
            for p, pm in t["planes"].items():
                dm = sm["tensors"][key]["planes"][p]
                src, dst = _bits(blob, pm), _bits(out, dm, b)
                if key in COLUMN:
                    w = dm["shape"][1]
                    dst[...] = src[:, s * w:(s + 1) * w]
                else:
                    r = dm["shape"][0]
                    dst[...] = src[s * r:(s + 1) * r]
        for key, m in meta["norms"].items():
            dm = sm["norms"][key]
            src, dst = _bits(blob, m), _bits(out, dm, b)
            n = dm["shape"][0]
            dst[...] = src[s * n:(s + 1) * n] if key in LANE_VECTORS else src
    return out


def pack_path_for(gguf_path: str, requant: DType | None = None) -> str:
    suffix = f".requant_{requant.name.lower()}.ntp" if requant else ".ntp"
    return gguf_path + suffix


def gguf_content_key(gguf_path: str) -> str:
    """Content key for pack staleness: the file size, and a hash of the
    header region plus 16 strided 256 KB samples of the tensor data and the
    tail (a same-size re-export changes only tensor data)."""
    import hashlib
    size = os.path.getsize(gguf_path)
    h = hashlib.sha256()
    head = 4 << 20
    with open(gguf_path, "rb") as f:
        h.update(f.read(head))
        if size > head:
            sample, n = 256 << 10, 16
            span = size - head
            for i in range(n):
                f.seek(head + (span * i) // n)
                h.update(f.read(min(sample, size - f.tell())))
            f.seek(max(size - sample, head))  # always include the tail
            h.update(f.read())
    return f"{size}-{h.hexdigest()[:16]}"


def ensure_pack(reader, gguf_path: str, requant: DType | None = None,
                progress=None) -> PackReader:
    """A PackReader for the GGUF, building the sidecar if it is missing or
    its content key is stale (in the temp directory when the model's
    directory is read-only)."""
    path = pack_path_for(gguf_path, requant)
    key = gguf_content_key(gguf_path)
    if os.path.exists(path):
        try:
            pr = PackReader(path)
            # an old pack of a vector-carrying GGUF lacks its vectors
            needs_biases = ((pr.version < 2
                             and "blk.0.attn_q.bias" in reader)
                            or (pr.version < 3
                                and "blk.0.attn_q_norm.weight" in reader)
                            or (pr.version < 4
                                and "blk.0.post_attention_norm.weight"
                                in reader))
            if pr.header.get("src_key") == key and not needs_biases:
                return pr
        except (ValueError, OSError, KeyError, json.JSONDecodeError):
            pass  # unreadable or old-format pack: rebuild below
    try:
        return PackWriter(reader, requant).write(path, progress=progress,
                                                 src_key=key)
    except OSError:
        import tempfile
        alt = os.path.join(tempfile.gettempdir(), os.path.basename(path))
        return PackWriter(reader, requant).write(alt, progress=progress,
                                                 src_key=key)
