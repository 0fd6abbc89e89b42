"""Builds the CUDA kernels of `csrc/` at first use and binds them with ctypes.

Each source has a plain C interface. `nvcc` compiles it for sm_90a into a
shared library under `ntransformer_tpu_torch/_build/` (listed in
.gitignore), named by a hash of the source, the shared headers and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. A library may have parts, `csrc/<name>.<part>.cu` beside
`csrc/<name>.cu` (the K-quant formats, batched flash's head dims and cache
dtypes). Every library is built the same way: nvcc compiles each of its
translation units with -c, all at once and in parallel, then links them
into the one library. Nothing here runs at import time: a CPU-only machine
without `nvcc` imports every module of the port, and only a call on a CUDA
tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def sources(name: str) -> list[str]:
    """The translation units of library `name`: csrc/<name>.cu, then its
    parts csrc/<name>.<part>.cu in name order."""
    parts = sorted(f for f in os.listdir(CSRC_DIR)
                   if f.startswith(name + ".") and f.endswith(".cu")
                   and f != name + ".cu")
    return [os.path.join(CSRC_DIR, name + ".cu")] + [
        os.path.join(CSRC_DIR, f) for f in parts]


def library_path(name: str) -> tuple[str, str]:
    """(source, shared library) paths of kernel source `csrc/<name>.cu`.
    The hash covers the source and its parts, every shared header of csrc/
    (`*.cuh`) and the flags, so an edited header rebuilds the sources that
    include it."""
    srcs = sources(name)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in srcs + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return srcs[0], os.path.join(BUILD_DIR,
                                 f"lib{name}-{digest.hexdigest()[:16]}.so")


def _nvcc(args: list[str]) -> str:
    proc = subprocess.run([nvcc_path(), *args], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {args[-1]}:\n{proc.stderr}")
    return proc.stderr


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` (and its parts) unless its library exists;
    returns nvcc's report (ptxas register and shared-memory use) or "" when
    cached."""
    _, out = library_path(name)
    if os.path.exists(out):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    srcs = sources(name)
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    try:
        with ThreadPoolExecutor(len(srcs)) as ex:
            reports = list(ex.map(
                lambda so: _nvcc([*NVCC_FLAGS, "-c", "-o", so[1], so[0]]),
                zip(srcs, objs)))
        _nvcc(["-shared", "-o", tmp, *objs])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, out)  # atomic: parallel builders never see half a file
    return "".join(reports)


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; every listed C entry
    gets its argtypes and returns a CUDA error code (int)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                # nvcc and dlopen inside a stream capture: refuse, and name
                # the library the step reached before it was warmed up
                raise RuntimeError(
                    f"kernel library {name} is reached for the first time "
                    "inside a CUDA graph capture: build and load it with an "
                    "uncaptured call first (models/graphs.StepGraphs warms "
                    "every key on its capture stream before capturing)")
            build(name)
            lib = ctypes.CDLL(library_path(name)[1])
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.nt_error_string.argtypes = [ctypes.c_int]
            lib.nt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.nt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
