"""GGUF container reader.

Zero-copy mmap reader equivalent in capability to the reference's GGUFLoader
(ref: src/model/loader.cpp:23-310): parses GGUF v2/v3 headers, metadata KV
store (including the vocab arrays), tensor infos, and exposes tensors as
zero-copy numpy views into the mapped file. Also records absolute file
offsets per tensor for the storage-streaming tier (ref: loader.h:75-80).

A copy of the JAX package's reader and writer (the port imports nothing
from that package). The writer lets the port write a requantized model on a
machine without JAX (chip_smoke.py); tests/test_torch_dequant.py reads a
file it wrote with both packages' readers.
"""
from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field

import numpy as np

from .dtypes import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    DType,
    GGUFValueType,
    dtype_to_ggml,
    ggml_to_dtype,
    row_nbytes,
)


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # logical shape, row-major [rows..., cols] (numpy order)
    dtype: DType
    ggml_type: int
    offset: int  # relative to data section start
    file_offset: int = 0  # absolute offset in the file (for direct storage reads)
    nbytes: int = 0


class GGUFReader:
    """mmap-backed GGUF file reader with zero-copy tensor views."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        # MADV_SEQUENTIAL equivalent of loader.cpp:40; harmless if unsupported.
        try:
            self._mm.madvise(mmap.MADV_SEQUENTIAL)
        except (AttributeError, OSError):
            pass
        self._buf = memoryview(self._mm)
        self._pos = 0
        self.metadata: dict[str, object] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self.tensor_order: list[str] = []
        self.alignment = GGUF_DEFAULT_ALIGNMENT
        self.data_offset = 0
        self._parse()

    # --- low-level scanners -------------------------------------------------
    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from("<" + fmt, self._buf, self._pos)
        self._pos += size
        return vals[0] if len(vals) == 1 else vals

    def _read_str(self) -> str:
        n = self._read("Q")
        s = bytes(self._buf[self._pos : self._pos + n])
        self._pos += n
        return s.decode("utf-8", errors="replace")

    _SCALAR_FMT = {
        GGUFValueType.UINT8: "B",
        GGUFValueType.INT8: "b",
        GGUFValueType.UINT16: "H",
        GGUFValueType.INT16: "h",
        GGUFValueType.UINT32: "I",
        GGUFValueType.INT32: "i",
        GGUFValueType.FLOAT32: "f",
        GGUFValueType.UINT64: "Q",
        GGUFValueType.INT64: "q",
        GGUFValueType.FLOAT64: "d",
    }

    _SCALAR_NP = {
        GGUFValueType.UINT8: np.uint8,
        GGUFValueType.INT8: np.int8,
        GGUFValueType.UINT16: np.uint16,
        GGUFValueType.INT16: np.int16,
        GGUFValueType.UINT32: np.uint32,
        GGUFValueType.INT32: np.int32,
        GGUFValueType.FLOAT32: np.float32,
        GGUFValueType.UINT64: np.uint64,
        GGUFValueType.INT64: np.int64,
        GGUFValueType.FLOAT64: np.float64,
    }

    def _read_value(self, vtype: int):
        vt = GGUFValueType(vtype)
        if vt == GGUFValueType.STRING:
            return self._read_str()
        if vt == GGUFValueType.BOOL:
            return bool(self._read("B"))
        if vt == GGUFValueType.ARRAY:
            elem_type = self._read("I")
            n = self._read("Q")
            et = GGUFValueType(elem_type)
            if et in self._SCALAR_NP:
                # Vectorized read of numeric arrays (vocab scores, token types)
                dt = np.dtype(self._SCALAR_NP[et]).newbyteorder("<")
                nbytes = dt.itemsize * n
                arr = np.frombuffer(self._buf, dtype=dt, count=n, offset=self._pos).copy()
                self._pos += nbytes
                return arr
            return [self._read_value(elem_type) for _ in range(n)]
        return self._read(self._SCALAR_FMT[vt])

    # --- header parse (ref: loader.cpp:56-185) ------------------------------
    def _parse(self):
        magic = self._read("I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic:#x})")
        version = self._read("I")
        if version not in (2, 3):
            raise ValueError(f"{self.path}: unsupported GGUF version {version}")
        n_tensors = self._read("Q")
        n_kv = self._read("Q")

        for _ in range(n_kv):
            key = self._read_str()
            vtype = self._read("I")
            self.metadata[key] = self._read_value(vtype)

        self.alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))

        raw_infos = []
        for _ in range(n_tensors):
            name = self._read_str()
            n_dims = self._read("I")
            dims = [self._read("Q") for _ in range(n_dims)]
            ggml_type = self._read("I")
            offset = self._read("Q")
            raw_infos.append((name, dims, ggml_type, offset))

        # Data section starts at the next alignment boundary (loader.cpp:173-184)
        a = self.alignment
        self.data_offset = (self._pos + a - 1) // a * a

        for name, dims, ggml_type, offset in raw_infos:
            dt = ggml_to_dtype(ggml_type)
            # GGUF dims are innermost-first; numpy shape is outermost-first.
            shape = tuple(reversed(dims))
            n_elems = 1
            for d in dims:
                n_elems *= d
            nbytes = row_nbytes(dt, n_elems)
            info = TensorInfo(
                name=name,
                shape=shape,
                dtype=dt,
                ggml_type=ggml_type,
                offset=offset,
                file_offset=self.data_offset + offset,
                nbytes=nbytes,
            )
            self.tensors[name] = info
            self.tensor_order.append(name)

    # --- tensor access -------------------------------------------------------
    def raw_bytes(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of a tensor's packed bytes (loader.cpp:255-276)."""
        info = self.tensors[name]
        start = info.file_offset
        end = start + info.nbytes
        if end > len(self._buf):
            raise ValueError(f"tensor {name} extends past end of file")
        return np.frombuffer(self._buf, dtype=np.uint8, count=info.nbytes, offset=start)

    def info(self, name: str) -> TensorInfo:
        return self.tensors[name]

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def close(self):
        # Zero-copy tensor views may still reference the mapping; in that case
        # leave it to be unmapped when the last view is garbage-collected.
        try:
            self._buf.release()
            self._mm.close()
        except BufferError:
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def print_info(self):
        """Human-readable summary (ref: loader.cpp:287-310)."""
        print(f"GGUF {self.path}: {len(self.tensors)} tensors, "
              f"{len(self.metadata)} metadata keys, align={self.alignment}")
        for k in sorted(self.metadata):
            v = self.metadata[k]
            if isinstance(v, (list, np.ndarray)) and len(v) > 8:
                v = f"<array len={len(v)}>"
            print(f"  {k} = {v}")


@dataclass
class _PendingTensor:
    name: str
    dims: list[int]  # GGUF order (innermost first)
    dtype: DType
    data: bytes


class GGUFWriter:
    """Minimal GGUF v3 writer for tests, benchmarks, and requant tools."""

    def __init__(self, path: str | os.PathLike, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = os.fspath(path)
        self.alignment = alignment
        self.metadata: dict[str, tuple[int, object]] = {}
        self._tensors: list[_PendingTensor] = []

    # --- metadata ------------------------------------------------------------
    def add_meta(self, key: str, value, vtype: GGUFValueType | None = None,
                 elem_type: GGUFValueType | None = None):
        if vtype is None:
            if isinstance(value, bool):
                vtype = GGUFValueType.BOOL
            elif isinstance(value, int):
                vtype = GGUFValueType.UINT32 if 0 <= value < 2**32 else GGUFValueType.INT64
            elif isinstance(value, float):
                vtype = GGUFValueType.FLOAT32
            elif isinstance(value, str):
                vtype = GGUFValueType.STRING
            elif isinstance(value, (list, tuple, np.ndarray)):
                vtype = GGUFValueType.ARRAY
            else:
                raise TypeError(f"cannot infer GGUF type for {type(value)}")
        self.metadata[key] = (vtype, (value, elem_type))

    def add_tensor(self, name: str, array: np.ndarray | None = None, *,
                   raw: bytes | None = None, shape: tuple[int, ...] | None = None,
                   dtype: DType | None = None):
        """Add either an f32/f16 numpy array or pre-quantized raw bytes."""
        if raw is not None:
            assert shape is not None and dtype is not None
            dims = list(reversed(shape))
            n_elems = int(np.prod(shape))
            expect = row_nbytes(dtype, n_elems)
            if len(raw) != expect:
                raise ValueError(f"{name}: raw size {len(raw)} != expected {expect}")
            self._tensors.append(_PendingTensor(name, dims, dtype, bytes(raw)))
            return
        assert array is not None
        if array.dtype == np.float32:
            dt = DType.F32
        elif array.dtype == np.float16:
            dt = DType.F16
        elif array.dtype == np.int32:
            dt = DType.I32
        else:
            raise TypeError(f"{name}: unsupported array dtype {array.dtype}")
        self._tensors.append(
            _PendingTensor(name, list(reversed(array.shape)), dt, array.tobytes()))

    # --- serialization -------------------------------------------------------
    @staticmethod
    def _pack_str(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    _SCALAR_FMT = GGUFReader._SCALAR_FMT

    def _pack_value(self, vtype: GGUFValueType, payload) -> bytes:
        value, elem_type = payload if isinstance(payload, tuple) else (payload, None)
        if vtype == GGUFValueType.STRING:
            return self._pack_str(value)
        if vtype == GGUFValueType.BOOL:
            return struct.pack("<B", 1 if value else 0)
        if vtype == GGUFValueType.ARRAY:
            if elem_type is None:
                first = value[0] if len(value) else ""
                if isinstance(first, str):
                    elem_type = GGUFValueType.STRING
                elif isinstance(first, float) or (
                        isinstance(value, np.ndarray) and value.dtype.kind == "f"):
                    elem_type = GGUFValueType.FLOAT32
                else:
                    elem_type = GGUFValueType.INT32
            out = struct.pack("<IQ", int(elem_type), len(value))
            if elem_type == GGUFValueType.STRING:
                for v in value:
                    out += self._pack_str(v)
            else:
                fmt = self._SCALAR_FMT[elem_type]
                for v in value:
                    out += struct.pack("<" + fmt, v)
            return out
        return struct.pack("<" + self._SCALAR_FMT[vtype], value)

    def write(self):
        out = bytearray()
        out += struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION,
                           len(self._tensors), len(self.metadata))
        for key, (vtype, payload) in self.metadata.items():
            out += self._pack_str(key)
            out += struct.pack("<I", int(vtype))
            out += self._pack_value(vtype, payload)

        # Tensor infos with running aligned offsets
        a = self.alignment
        offset = 0
        infos = bytearray()
        for t in self._tensors:
            infos += self._pack_str(t.name)
            infos += struct.pack("<I", len(t.dims))
            for d in t.dims:
                infos += struct.pack("<Q", d)
            infos += struct.pack("<IQ", int(dtype_to_ggml(t.dtype)), offset)
            offset += (len(t.data) + a - 1) // a * a
        out += infos

        data_start = (len(out) + a - 1) // a * a
        out += b"\x00" * (data_start - len(out))
        for t in self._tensors:
            out += t.data
            pad = (-len(t.data)) % a
            out += b"\x00" * pad

        with open(self.path, "wb") as f:
            f.write(out)
