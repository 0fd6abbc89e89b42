"""Offline GGUF requantizer: rewrite a model's weight matrices to another
format (e.g. Q8_0 -> Q4_K), producing a standalone GGUF.

Port of tools/requant_gguf.py on the port's own dequantizer, quantizer and
GGUF writer (core/dequant.py, core/quant.py, core/gguf.py). Norms, vectors
and matrices whose rows do not fill whole 256-element blocks pass through
unchanged, as do matrices already in a lower format than the source set.

Usage: python -m ntransformer_tpu_torch.tools.requant_gguf -m in.gguf
       -o out.gguf [--to q4_k]
"""
from __future__ import annotations

import argparse

from ..core.dequant import dequantize
from ..core.dtypes import DType, block_info
from ..core.gguf import GGUFReader, GGUFWriter
from ..core.quant import quantize

# formats worth shrinking (higher-precision sources)
_SOURCES = {DType.F32, DType.F16, DType.Q8_0, DType.Q6_K, DType.Q5_K}
TARGETS = (DType.Q4_K, DType.Q4_0, DType.Q8_0, DType.Q6_K, DType.Q5_K)


def requant(in_path: str, out_path: str, target, progress=print,
            metadata: dict | None = None) -> dict:
    """Write in_path to out_path with every eligible matrix requantized.
    target: one DType for every matrix, or a function of the tensor name
    giving its DType (a per-name policy, such as presets.q4_k_m_policy; a
    policy that gives each matrix its own format copies the file).
    metadata: keys to add or replace. Returns the converted and kept
    counts and the bytes in and out."""
    policy = target if callable(target) else (lambda _name: target)
    stats = {"converted": 0, "kept": 0, "bytes_in": 0, "bytes_out": 0}
    with GGUFReader(in_path) as r:
        w = GGUFWriter(out_path, alignment=r.alignment)
        for k, v in {**r.metadata, **(metadata or {})}.items():
            try:
                w.add_meta(k, v)
            except TypeError:
                progress(f"skip metadata {k} (unsupported type)")
        for name in r.tensor_order:
            info = r.info(name)
            raw = bytes(r.raw_bytes(name))
            stats["bytes_in"] += len(raw)
            dt = policy(name)
            if len(info.shape) == 2:
                n, k = info.shape
                blk = block_info(dt).block_elems
                convertible = (info.dtype in _SOURCES and info.dtype != dt
                               and k % max(blk, 256) == 0
                               and "norm" not in name)
            else:
                convertible = False
            if convertible:
                out = quantize(dequantize(raw, info.dtype, n, k), dt)
                w.add_tensor(name, raw=out, shape=(n, k), dtype=dt)
                stats["converted"] += 1
                stats["bytes_out"] += len(out)
                progress(f"{name}: {info.dtype.name} -> {dt.name} "
                         f"({len(raw)} -> {len(out)} B)")
            else:
                w.add_tensor(name, raw=raw, shape=tuple(info.shape),
                             dtype=info.dtype)
                stats["kept"] += 1
                stats["bytes_out"] += len(raw)
        w.write()
    progress(f"wrote {out_path}: {stats['converted']} converted, "
             f"{stats['kept']} kept, {stats['bytes_in'] / 1e6:.1f} -> "
             f"{stats['bytes_out'] / 1e6:.1f} MB")
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--to", default="q4_k", choices=[d.value for d in TARGETS])
    args = ap.parse_args(argv)
    requant(args.model, args.output, DType(args.to))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
