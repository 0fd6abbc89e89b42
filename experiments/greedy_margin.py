#!/usr/bin/env python3
"""The top-2 logit margin of each greedy step of repolm512 on the CPU, as
a share of the step's largest |logit|: where it is below the spread
between the card's paths and the CPU (chip_smoke.py's teacher-forced
lists), a rounding anywhere can flip that step's token, and greedy
agreement ends there.

    python3 experiments/greedy_margin.py [FORMAT]

FORMAT is a requantization tag of chip_smoke.py's `REQUANT` (q4_k_m,
q4_k_m_v6, q5_k, q4_0), or q8_0 for the committed file as it is. The model
and prompt are chip_smoke.py's `real` / `qreal` phases' (32 greedy steps
after the prompt). Runs on the CPU; prints one line a step: the step, the
greedy token and the margin.
"""
from __future__ import annotations

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from ntransformer_tpu_torch.inference.engine import Engine
    tag = sys.argv[1] if len(sys.argv) > 1 else "q4_0"
    with tempfile.TemporaryDirectory() as tmp:
        path = cs.REPOLM
        if tag != "q8_0":
            path = os.path.join(tmp, f"repolm512_{tag}.gguf")
            cs.requantize(cs.REPOLM, path, tag)
        engine = Engine.load(path, device="cpu", fuse=True)
        ids = engine._encode(cs.PROMPT)
        toks, logits = cs.greedy_pass(engine, torch, ids, 32)
    for i, (tok, lg) in enumerate(zip(toks, logits)):
        top = torch.topk(lg, 2).values
        print(f"step {i} token {tok} margin/max|logit| "
              f"{float((top[0] - top[1]) / lg.abs().max()):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
