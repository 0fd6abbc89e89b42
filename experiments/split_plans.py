#!/usr/bin/env python3
"""The split count of batched flash's split kernel ("f32" and "int8_s",
csrc/batched_attention.cu), swept on one card: the evidence behind
ops/cuda/batched_attention.py::split_plan.

    python3 experiments/split_plans.py

For each shape (8B widths: Hq 32, Hkv 8, D 128) and each split count in
its list, the wrapper runs with `split_plan` replaced by that count (one
cluster up to 8 splits, the combine pass past it) and the profiler gives
the device time of a call by kernel (chip_smoke.py's `profile_calls`); the
plan's own choice is printed beside it, and each result against the first
count's (the splits change only the order of f32 sums). Prints the card's
name and power limit, then one JSON line a (shape, form, count).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# label, B, S, T, int8 cache, positions, active, forms, split counts
CASES = (
    ("B=32 int8 S=1024", 32, 1024, 1, True,
     [512 + (37 * i) % 89 for i in range(32)], [i != 5 for i in range(32)],
     ("f32", "int8_s"), (1, 2, 4)),
    ("B=1 bf16 S=1024", 1, 1024, 1, False, [1000], [True], ("f32",),
     (4, 8)),
    ("B=1 bf16 S=4096", 1, 4096, 1, False, [4000], [True], ("f32",),
     (8, 17)),
    ("B=8 bf16 S=4096", 8, 4096, 1, False,
     [0, 7, 130, 1000, 2047, 2500, 3333, 4090], [True] * 8, ("f32",),
     (2, 3, 5, 8)),
    ("B=8 bf16 S=4096 T=4", 8, 4096, 4, False,
     [3, 64, 500, 1023, 2000, 2999, 3500, 4000], [i != 2 for i in range(8)],
     ("f32",), (2, 3, 5, 16)),
    ("B=4 int8 S=1024 T=8", 4, 1024, 8, True, [300, 512, 900, 1000],
     [True, True, False, True], ("f32",), (2, 5, 8)),
)


def main() -> int:
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from ntransformer_tpu_torch.ops.cuda import batched_attention as cb
    from ntransformer_tpu_torch.ops.cuda import build
    assert torch.cuda.is_available(), "this sweep needs a CUDA card"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    build.build(cb.NAME)
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    hq, hkv, dh = 32, 8, 128
    scale = 1.0 / math.sqrt(dh)
    plan = cb.split_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, b_n, s, t, int8, pos_l, act_l, forms, counts in CASES:
        shape = (2, b_n, hkv, s, dh)
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        act = torch.tensor(act_l, device="cuda").to(torch.int32)
        if int8:
            kc, vc = (torch.randint(-127, 128, shape, dtype=torch.int8,
                                    device="cuda", generator=g)
                      for _ in range(2))
            ks, vs = (torch.rand(shape[:-1], device="cuda", generator=g)
                      * 0.02 for _ in range(2))
            kn, vn = (torch.randint(-127, 128, (b_n, hkv, t, dh),
                                    dtype=torch.int8, device="cuda",
                                    generator=g) for _ in range(2))
            kns, vns = (torch.rand(b_n, hkv, t, device="cuda", generator=g)
                        * 0.02 for _ in range(2))
            kcache, vcache, knew, vnew = (kc, ks), (vc, vs), (kn, kns), \
                (vn, vns)
        else:
            kc, vc = (torch.randn(shape, device="cuda", generator=g).to(
                torch.bfloat16) for _ in range(2))
            kn, vn = (torch.randn(b_n, hkv, t, dh, device="cuda",
                                  generator=g) for _ in range(2))
            kcache, vcache, knew, vnew = kc, vc, kn, vn
        q = torch.randn((b_n, t, hq, dh), device="cuda", generator=g)
        for dot in forms:
            first = None
            for n in counts:
                cb.split_plan = (lambda _s, _b, _h, _sms, n=n:
                                 (n, n if n <= cb.MAX_CLUSTER else 0))
                try:
                    def call():
                        return cb.flash_verify_batched(
                            q, kcache, vcache, knew, vnew, pos, scale,
                            layer=1, active=act, dot_impl=dot)
                    o = call()
                    torch.cuda.synchronize()
                    first = o if first is None else first
                    prof = cs.profile_calls(torch, call)
                finally:
                    cb.split_plan = plan
                own = {k[:70]: v["ms"] for k, v in prof.items()
                       if "split_kernel" in k or "combine_kernel" in k}
                print(json.dumps({
                    "shape": label, "dot_impl": dot, "nsplit": n,
                    "plan": plan(s, b_n, hkv, sms),
                    "device_ms": sum(own.values()), "kernels": own,
                    "rel_to_first": float((o - first).abs().max()
                                          / first.abs().max())}),
                      flush=True)
        del kc, vc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
