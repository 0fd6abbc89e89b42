"""ctypes bindings of the native staging engine (csrc/ntstage.cpp).

Port of ntransformer_tpu/memory/native.py. The library is built at first
use with g++ into `ntransformer_tpu_torch/_build/` (listed in .gitignore),
named by a hash of the source and the flags, as ops/cuda/build.py builds the
kernels. There is no Python fallback: a failed build, a failed open or a
failed read raises.

One fallback stays because it is the I/O's semantics, not a workaround: a
read asked to bypass the page cache (O_DIRECT) goes through the page cache
when a precondition of O_DIRECT fails (an unaligned offset or buffer, a
rounded extent past the end of the file, a filesystem without O_DIRECT).
`StagePool.direct_reads` / `buffered_reads` count which path each read
took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(PKG_DIR, "csrc", "ntstage.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
DIRECT_ALIGN = 4096

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libntstage-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/ntstage.cpp unless its library exists; returns the
    library's path. Raises if g++ fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SRC} needs g++: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a parallel build never sees half a file
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library (built at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.ntstage_create.restype = ctypes.c_void_p
            lib.ntstage_create.argtypes = [ctypes.c_int]
            lib.ntstage_destroy.argtypes = [ctypes.c_void_p]
            lib.ntstage_open.restype = ctypes.c_int
            lib.ntstage_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.ntstage_close.argtypes = [ctypes.c_int]
            lib.ntstage_is_direct.restype = ctypes.c_int
            lib.ntstage_is_direct.argtypes = [ctypes.c_int]
            lib.ntstage_submit_read.restype = ctypes.c_uint64
            lib.ntstage_submit_read.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int]
            lib.ntstage_submit_copy.restype = ctypes.c_uint64
            lib.ntstage_submit_copy.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_uint64, ctypes.c_int]
            lib.ntstage_wait.restype = ctypes.c_int
            lib.ntstage_wait.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            _LIB = lib
    return _LIB


def aligned_empty(size: int, align: int = DIRECT_ALIGN) -> np.ndarray:
    """An uninitialized uint8 buffer whose data pointer is `align`-aligned
    (O_DIRECT requires aligned destinations). The view keeps the
    over-allocated base alive."""
    raw = np.empty(size + align, np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off: off + size]


CHUNKS_PER_READ = 8  # a read or copy is split into this many pool jobs


class StagePool:
    """Thread-pooled chunked file reads and memcpys into preallocated
    buffers (native), plus a small Python executor for jobs that must run
    Python (the streamer's fence-then-read)."""

    def __init__(self, n_threads: int = 8):
        self.n_threads = n_threads
        self._lib = get_lib()
        self._pool = self._lib.ntstage_create(n_threads)
        self._fds: dict[tuple[str, bool], int] = {}
        self._fsizes: dict[str, int] = {}
        self._exec: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()
        self.direct_reads = 0
        self.buffered_reads = 0

    def _fd(self, path: str, direct: bool = False) -> int:
        key = (path, direct)
        fd = self._fds.get(key)
        if fd is None:
            fd = self._lib.ntstage_open(path.encode(), 1 if direct else 0)
            if fd < 0:
                raise OSError(f"ntstage_open failed for {path}")
            self._fds[key] = fd
        return fd

    def _fsize(self, path: str) -> int:
        s = self._fsizes.get(path)
        if s is None:
            s = os.path.getsize(path)
            self._fsizes[path] = s
        return s

    def read(self, path: str, offset: int, size: int, dest: np.ndarray,
             direct: bool = False):
        """Start reading file[offset:offset + size] into dest[:size];
        returns a handle for wait(). direct=True bypasses the page cache
        when every O_DIRECT precondition holds (aligned offset and buffer,
        the 4096-rounded extent inside the buffer and the file, a
        filesystem that takes it), and reads through it otherwise."""
        if dest.nbytes < size:
            raise ValueError(f"read of {size} bytes into a {dest.nbytes}-byte "
                             "buffer")
        fd, rd_size = None, size
        with self._lock:  # reads are submitted from worker threads too
            rounded = (size + DIRECT_ALIGN - 1) // DIRECT_ALIGN * DIRECT_ALIGN
            if (direct and offset % DIRECT_ALIGN == 0
                    and dest.ctypes.data % DIRECT_ALIGN == 0
                    and dest.nbytes >= rounded
                    and offset + rounded <= self._fsize(path)):
                fd = self._fd(path, direct=True)
                if self._lib.ntstage_is_direct(fd):
                    rd_size = rounded
                else:  # the filesystem refused O_DIRECT: reopened buffered
                    fd = None
            if fd is None:
                fd = self._fd(path)
                self.buffered_reads += 1
            else:
                self.direct_reads += 1
        job = self._lib.ntstage_submit_read(
            self._pool, fd, offset, rd_size,
            dest.ctypes.data_as(ctypes.c_void_p), CHUNKS_PER_READ)
        return ("native", job)

    def copy(self, src: np.ndarray, dest: np.ndarray, size: int):
        """Start a parallel memcpy src[:size] -> dest[:size]."""
        job = self._lib.ntstage_submit_copy(
            self._pool, src.ctypes.data_as(ctypes.c_void_p),
            dest.ctypes.data_as(ctypes.c_void_p), size, CHUNKS_PER_READ)
        return ("native", job)

    def run(self, fn):
        """Run a Python callable on the pool's Python executor."""
        if self._exec is None:
            self._exec = ThreadPoolExecutor(max_workers=2,
                                            thread_name_prefix="ntstage-py")
        return ("py", self._exec.submit(fn))

    def wait(self, handle) -> None:
        kind, h = handle
        if kind == "native":
            err = self._lib.ntstage_wait(self._pool, h)
            if err:
                raise OSError(err, "ntstage job failed")
        else:
            h.result()

    def close(self):
        if self._exec is not None:
            self._exec.shutdown(wait=True)
            self._exec = None
        if self._pool:
            for fd in self._fds.values():
                self._lib.ntstage_close(fd)
            self._fds.clear()
            self._lib.ntstage_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
