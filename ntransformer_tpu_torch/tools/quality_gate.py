"""One-command quality gate for a GGUF model: tokenizer conformance,
greedy goldens, and per-bit-width perplexity deltas.

Port of tools/quality_gate.py (the same suites, prompts, budgets and
fixture JSON). Given a GGUF path it runs, in order:
  1. tokenizer conformance: encode/decode round trips over a suite of
     tricky strings, and encode stability against the fixture;
  2. greedy goldens: fixed prompts decoded greedily on the quantized
     kernel path and compared with the fixture, and the prefill logits of
     the quantized path held against compute="bf16" (every matrix
     dequantized at load: a plain product);
  3. per-dtype PPL: the model requantized (tools/requant_gguf) to each
     requested dtype, its teacher-forced NLL over the corpus compared with
     the base's: |delta nll| must stay within the dtype's budget. "w4a8"
     rows load with --w4a8 and run decode-mode PPL (T = 1 steps, the path
     whose numerics W4A8 changes) against a decode-mode base; "w8a8" rows
     load with --w8a8 and run prefill-mode PPL.

The default corpus is the repository's README (any UTF-8 text works; the
deltas are corpus-stable because all dtypes share the tokenization).
Fixtures live next to the model (<model>.quality.json) or at --fixtures;
--update (re)writes them. Exit code 0 = pass; on a failure the report's
"failed" list names each sub-check that failed ("tokenizer", "goldens",
"ppl") and its "errors" say why.

Usage: python -m ntransformer_tpu_torch.tools.quality_gate -m model.gguf
       [--dtypes q6_k,q4_0] [--device cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys
import tempfile

TOKENIZER_SUITE = [
    "Hello, world!",
    "def forward(x):\n    return x @ w.T  # matmul",
    "  leading and trailing spaces  ",
    "tabs\tand\nnewlines\r\n",
    "números con acentos: àéîõü çñ",
    "emoji: \U0001F680\U0001F9E0 and CJK: 漢字カタカナ",
    "mixed 123 numbers 3.14159 and UPPER_CASE_IDENTS",
    "quotes 'single' \"double\" `back` and <tags>",
]

GOLDEN_PROMPTS = ["def ", "The ", "import ", "# "]

# |delta nll/token| budget against the base model, per requant target:
# wide enough for real quantization error, tight enough that a broken
# dequant chain (wrong scales, swapped planes) fails by orders of
# magnitude. "+w4a8" / "+w8a8" rows requantize the file and convert at
# load on top: the full double-quant chain.
PPL_BUDGET = {"q8_0": 0.02, "q6_k": 0.05, "q4_k_m": 0.15, "q4_0": 0.25,
              "w4a8": 0.25, "q6_k+w4a8": 0.3, "q4_k_m+w4a8": 0.35,
              "w8a8": 0.1, "q8_0+w8a8": 0.1, "q6_k+w8a8": 0.15,
              "q4_k_m+w8a8": 0.25}

README = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "README.md")
GOLDEN_LOGIT_RTOL = 2e-2  # quant against bf16 prefill logits, max-relative


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def _tokenizer(path: str):
    from ..core.gguf import GGUFReader
    from ..inference.tokenizer import Tokenizer
    with GGUFReader(path) as r:
        return Tokenizer.from_gguf_metadata(r.metadata)


def _tok_report(tok) -> dict:
    suite = {}
    ok = True
    for s in TOKENIZER_SUITE:
        ids = tok.encode(s, add_bos=False)
        rt = tok.decode(ids)
        suite[s] = {"ids_sha": hashlib.sha256(
            json.dumps(ids).encode()).hexdigest()[:16], "n": len(ids),
            "roundtrip": rt == s}
        ok = ok and rt == s
    return {"ok": ok, "suite": suite}


def _goldens(path: str, n_tokens: int, device) -> dict:
    """Greedy texts on the quantized kernel path (the fixture anchor) and
    the max relative prefill-logit deviation between the quantized and the
    bf16 compute paths. The cross-compute check is on logits, not on the
    greedy chain: a near-tie argmax may flip a chain between two correct
    compute paths, the logits must agree to rounding."""
    import numpy as np
    from ..inference.engine import Engine, GenerateConfig
    cfg = GenerateConfig(max_tokens=n_tokens, temperature=0.0,
                         repeat_penalty=1.0)
    out = {"quant": {}, "logit_rel_err": 0.0}
    logits = {}
    for compute in ("quant", "bf16"):
        eng = Engine.load(path, compute=compute, device=device)
        logits[compute] = {}
        for p in GOLDEN_PROMPTS:
            ids = eng._encode(p)
            lg, _, _ = eng._prefill(eng._make_kv(), ids)
            logits[compute][p] = lg[0].float().cpu().numpy()
            if compute == "quant":
                text, _ = eng.generate(p, cfg)
                out["quant"][p] = {"text": text, "prompt_ids": ids}
        del eng
    for p in GOLDEN_PROMPTS:
        a, b = logits["quant"][p], logits["bf16"][p]
        rel = float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))
        out["logit_rel_err"] = max(out["logit_rel_err"], rel)
    return out


def _ppl(path: str, ids, ctx: int, device, w4a8: bool = False,
         mode: str = "prefill", w8a8: bool = False) -> float:
    from ..models.loader import load_model
    from .perplexity import perplexity
    model = load_model(path, w4a8=w4a8, w8a8=w8a8, device=device)
    return float(perplexity(model, ids, ctx, mode=mode)["nll_per_token"])


def _requant_target(base_dt: str):
    from ..core.dtypes import DType
    # as the JAX gate: the "q4_k_m" row requantizes every matrix to Q4_K
    return DType.Q4_K if base_dt == "q4_k_m" else DType[base_dt.upper()]


def run_gate(model_path: str, corpus: str, dtypes: list[str],
             fixtures_path: str | None, update: bool, ctx: int = 256,
             windows: int = 8, golden_tokens: int = 24,
             device="cuda") -> dict:
    """Run the three checks; returns the report (the fixture's format,
    plus "failed": the sub-checks that failed, in order)."""
    from ..core.gguf import GGUFReader
    from ..models.config import ModelConfig
    from .requant_gguf import requant

    results = {"model": os.path.basename(model_path), "pass": True,
               "failed": [], "checks": {}}

    def fail(check, msg):
        results["pass"] = False
        if check not in results["failed"]:
            results["failed"].append(check)
        results["checks"][check]["ok"] = False
        results["checks"][check].setdefault("errors", []).append(msg)
        log(f"FAIL [{check}]: {msg}")

    fx_path = fixtures_path or model_path + ".quality.json"
    fixture = None
    if os.path.exists(fx_path) and not update:
        with open(fx_path) as f:
            fixture = json.load(f)

    # 1. tokenizer conformance
    log("tokenizer conformance")
    tok = _tokenizer(model_path)
    tk = _tok_report(tok)
    results["checks"]["tokenizer"] = {"ok": tk["ok"], "suite": tk["suite"]}
    if not tk["ok"]:
        bad = [s for s, v in tk["suite"].items() if not v["roundtrip"]]
        fail("tokenizer", f"roundtrip failed for {bad}")
    if fixture:
        for s, v in tk["suite"].items():
            want = fixture["checks"]["tokenizer"]["suite"].get(s)
            if want and want["ids_sha"] != v["ids_sha"]:
                fail("tokenizer", f"encode drifted for {s!r}")

    # 2. greedy goldens
    log("greedy goldens")
    g = _goldens(model_path, golden_tokens, device)
    ok = g["logit_rel_err"] < GOLDEN_LOGIT_RTOL
    results["checks"]["goldens"] = {"ok": ok, "outputs": g["quant"],
                                    "logit_rel_err": round(
                                        g["logit_rel_err"], 6)}
    if not ok:
        fail("goldens", "quant vs bf16 compute prefill logits diverged: "
             f"rel err {g['logit_rel_err']:.4f} >= {GOLDEN_LOGIT_RTOL}")
    if fixture:
        for p in GOLDEN_PROMPTS:
            want = fixture["checks"]["goldens"]["outputs"].get(p)
            if want and want["text"] != g["quant"][p]["text"]:
                fail("goldens", f"greedy output drifted for prompt {p!r}")

    # 3. per-dtype PPL deltas
    log(f"per-dtype PPL on {corpus} (ctx {ctx}, {windows} windows)")
    with open(corpus, encoding="utf-8", errors="replace") as f:
        ids = tok.encode(f.read(), add_bos=True)[: windows * ctx]
    nll0 = _ppl(model_path, ids, ctx, device)
    results["checks"]["ppl"] = {"ok": True, "base_nll": round(nll0, 5),
                                "deltas": {}}
    is_w4a8 = lambda d: d == "w4a8" or d.endswith("+w4a8")
    w4a8_rows = [d for d in dtypes if is_w4a8(d)]
    if w4a8_rows:
        # W4A8 needs K % 512 == 0; on an ineligible model the conversion
        # would keep every matrix and the rows would measure nothing
        with GGUFReader(model_path) as r:
            c = ModelConfig.from_gguf_metadata(r.metadata)
        if c.hidden_size % 512 or c.intermediate_size % 512:
            log(f"SKIP w4a8 rows: hidden={c.hidden_size} inter="
                f"{c.intermediate_size} not 512-divisible: the W4A8 "
                "format does not apply to this model")
            results["checks"].setdefault("ppl_skipped", {})["w4a8"] = \
                "shapes not 512-divisible"
            dtypes = [d for d in dtypes if d not in w4a8_rows]
    nll0_dec = None
    if any(is_w4a8(d) for d in dtypes):
        # decode-mode base: the w4a8 rows step T = 1 (their changed path)
        nll0_dec = _ppl(model_path, ids, ctx, device, mode="decode")
        results["checks"]["ppl"]["base_nll_decode"] = round(nll0_dec, 5)
        log(f"  base decode-mode nll {nll0_dec:.5f} (prefill {nll0:.5f})")
    with tempfile.TemporaryDirectory(prefix="qgate_") as tmpdir:
        for dt in dtypes:
            w4a8 = is_w4a8(dt)
            w8a8 = dt == "w8a8" or dt.endswith("+w8a8")
            base_dt = dt.removesuffix("+w4a8").removesuffix("+w8a8")
            if base_dt in ("w4a8", "w8a8"):
                path_dt = model_path  # the runtime format on the file
            else:
                path_dt = os.path.join(tmpdir, f"requant_{base_dt}.gguf")
                try:
                    requant(model_path, path_dt, _requant_target(base_dt),
                            progress=lambda _m: None)
                except (KeyError, ValueError, OSError) as e:
                    fail("ppl", f"requant to {dt} failed: {e}")
                    continue
            nll = _ppl(path_dt, ids, ctx, device, w4a8=w4a8, w8a8=w8a8,
                       mode="decode" if w4a8 else "prefill")
            delta = nll - (nll0_dec if w4a8 else nll0)
            results["checks"]["ppl"]["deltas"][dt] = round(delta, 5)
            log(f"  {dt}: nll {nll:.5f} (delta {delta:+.5f})")
            budget = PPL_BUDGET.get(dt, 0.25)
            if not math.isfinite(nll) or abs(delta) > budget:
                fail("ppl", f"{dt} delta nll {delta:+.5f} exceeds "
                     f"+-{budget}")
            if path_dt != model_path:
                os.unlink(path_dt)

    if update or not os.path.exists(fx_path):
        with open(fx_path, "w") as f:
            json.dump(results, f, indent=1)
        log(f"fixtures written to {fx_path}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--corpus", default=README,
                    help="UTF-8 text (default: the repository's README.md)")
    ap.add_argument("--dtypes",
                    default="q6_k,q4_k_m,q4_0,w4a8,q4_k_m+w4a8,q6_k+w4a8")
    ap.add_argument("--fixtures", default=None)
    ap.add_argument("--update", action="store_true",
                    help="(re)write the fixture file from this run")
    ap.add_argument("--ctx", type=int, default=256)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--golden-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    r = run_gate(args.model, args.corpus,
                 [d.strip() for d in args.dtypes.split(",") if d.strip()],
                 args.fixtures, args.update, args.ctx, args.windows,
                 args.golden_tokens, device=args.device)
    print(json.dumps({"pass": r["pass"], "failed": r["failed"],
                      "tokenizer_ok": r["checks"]["tokenizer"]["ok"],
                      "goldens_ok": r["checks"]["goldens"]["ok"],
                      "ppl": r["checks"]["ppl"]}, indent=1))
    return 0 if r["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
