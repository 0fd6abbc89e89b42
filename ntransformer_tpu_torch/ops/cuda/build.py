"""Builds the CUDA kernels of `csrc/` at first use and binds them with ctypes.

Each source has a plain C interface. `nvcc` compiles it for sm_90a into a
shared library under `ntransformer_tpu_torch/_build/` (listed in
.gitignore), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here
runs at import time: a CPU-only machine without `nvcc` imports every
module of the port, and only a call on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
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


def library_path(name: str) -> tuple[str, str]:
    """(source, shared library) paths of kernel source `csrc/<name>.cu`."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless its library exists; returns nvcc's
    report (ptxas register and shared-memory use) or "" when cached."""
    src, out = library_path(name)
    if os.path.exists(out):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: parallel builders never see half a file
    return proc.stderr


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; every listed C entry
    gets its argtypes and returns a CUDA error code (int)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
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
