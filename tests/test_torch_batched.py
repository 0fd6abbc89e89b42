"""Port parity for models/batched.py: batched_decode_step and
batched_verify_step against the JAX package's on the CPU, on both of each
package's paths (the port's "kernel" path runs its kernels' plain twins on
CPU tensors; "plain" is the JAX package's "jnp" path), from the same
mid-context cache (convert.batched_kv_from_numpy), for the tiny synthetic
Q8_0 model and the trained models/repolm512_q8.gguf.

Tolerances. Logits: LOGIT_RTOL of the largest logit (the whole stack's f32
sums run in other orders, and a rare bf16 flip of an activation grows
through the layers; measured up to 9.1e-4 for bf16 caches and 3.7e-3 for
int8, where a flipped int8 code moves a row by a whole step). An inactive
slot's logits, which no caller reads, are held to INACTIVE_RTOL and an
equal argmax: repolm512 turns a 1e-3 difference into 2e-2 to 4e-2 at its
fourth layer for every pair of paths (PERF.md, Findings), and an inactive slot
at a zero-padded position read 3.6e-2 once (int8, plain path), where the
JAX package's own two paths differ by up to 1.1e-2. Caches: every
row a step does not write is bit-equal, and layer 0's written rows agree
bit for bit but for a rare flip (measured 99.8% of the entries or more; the
deeper layers of the tiny model's random weights only 78-100%, as in
tests/test_torch_model.py). Within the port the kernel path and the plain
path write bit-equal bf16 caches, as the JAX suite asserts of its two
paths."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.models import batched as jb
from ntransformer_tpu.models import llama as jl
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu_torch.models import batched as pb
from ntransformer_tpu_torch.models import llama as pl
from ntransformer_tpu_torch.models.convert import (batched_kv_from_numpy,
                                                   weights_from_numpy)
from test_torch_model import jax_tree, one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(REPO, "models", "repolm512_q8.gguf")
LOGIT_RTOL = {False: 5e-3, True: 2e-2}   # by int8 cache
INACTIVE_RTOL = 5e-2
CACHE_EQUAL = 0.99
JIMPL = {"plain": "jnp", "kernel": "kernel"}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tiny = write_model(str(tmp_path_factory.mktemp("m") / "tiny_q8.gguf"),
                       "tiny", "q8_0", seed=17)
    out = {}
    for name, path in (("tiny", tiny), ("repolm512", REPOLM)):
        ref = jax_load_model(path, fuse=True)
        arch = pl.Arch(**dataclasses.asdict(ref.arch))
        out[name] = (ref, arch, weights_from_numpy(jax_tree(ref.weights),
                                                   arch, "cpu"))
    return out


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _pbits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _mid_context(ref, B: int, quant: bool, seed: int):
    """A JAX BatchedKV whose slots hold real prefills of different
    lengths, and the same cache in the port."""
    rng = np.random.default_rng(seed)
    lens = [9, 30, 17, 44][:B]
    bkv = jb.BatchedKV.create(ref.arch, B, quant=quant)
    for b, n in enumerate(lens):
        kv = jl.KVCache.create(ref.arch, quant=quant)
        ids = rng.integers(3, ref.arch.vocab_size, n).astype(np.int32)
        _, kv, _ = jl.forward(ref.arch, ref.weights, kv, jnp.asarray(ids), 0)
        bkv = bkv.insert(b, kv)
    port = batched_kv_from_numpy(*(None if a is None else np.asarray(a)
                                   for a in (bkv.k, bkv.v, bkv.ks, bkv.vs)),
                                 device="cpu")
    return bkv, port, np.array(lens, np.int32)


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _check_logits(got, want, active, quant: bool):
    """Active slots within LOGIT_RTOL, inactive ones within INACTIVE_RTOL
    with the same argmax."""
    for b, act in enumerate(active):
        lim = LOGIT_RTOL[quant] if act else INACTIVE_RTOL
        assert _rel(got[b], want[b]) <= lim, b
        if not act:
            np.testing.assert_array_equal(got[b].argmax(-1),
                                          want[b].argmax(-1))


def _mark(written, pos, active, t: int = 1, n_layers: int | None = None):
    """Mark the rows a step writes in the mask `written` [L, B, 1, S]."""
    for b in np.flatnonzero(active):
        written[:n_layers, b, :, pos[b]:pos[b] + t] = True
    return written


def _check_caches(port: pb.BatchedKV, ref, written):
    """Every row no step wrote (`written` false) is bit-equal; layer 0's
    written rows agree bit for bit but for a rare flip (CACHE_EQUAL of the
    codes or bf16 entries, f32 scales to 1e-4: a 1-ulp change of k changes
    a scale's bits); deeper layers see the flips of the layers before them
    and are held through the logits."""
    for got, want in zip((port.k, port.v, port.ks, port.vs),
                         (ref.k, ref.v, ref.ks, ref.vs)):
        if want is None:
            continue
        g, w = _pbits(got), _bits(want)
        mask = np.broadcast_to(written if g.ndim == 4 else written[..., None],
                               g.shape)
        np.testing.assert_array_equal(g[~mask], w[~mask])
        g0, w0 = g[0][mask[0]], w[0][mask[0]]
        if g.ndim == 4:  # f32 scales
            np.testing.assert_allclose(g0, w0, rtol=1e-4)
        else:
            assert (g0 == w0).mean() >= CACHE_EQUAL


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("which", ["tiny", "repolm512"])
def test_decode_step_matches_jax(models, which, impl, quant):
    """Three chained steps from a mid-context cache, B = 3 with slot 1
    inactive (its frozen rows attended, nothing written), the same tokens
    fed to both packages."""
    ref, arch, w = models[which]
    jkv, pkv, lens = _mid_context(ref, 3, quant, seed=1)
    active = np.array([True, False, True])
    toks = np.random.default_rng(2).integers(3, arch.vocab_size, (3, 3))
    written = np.zeros(pkv.k.shape[:4], bool)[:, :, :1]
    for step in range(3):
        pos = lens + step
        jlog, jkv = jb.batched_decode_step(
            ref.arch, ref.weights, jkv, jnp.asarray(toks[step], jnp.int32),
            jnp.asarray(pos), jnp.asarray(active), impl=JIMPL[impl])
        plog, pkv = pb.batched_decode_step(arch, w, pkv, toks[step], pos,
                                           active, impl=impl)
        assert tuple(plog.shape) == (3, arch.vocab_size)
        _check_logits(plog.numpy(), np.asarray(jlog), active, quant)
        _check_caches(pkv, jkv, _mark(written, pos, active))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_verify_step_matches_jax(models, impl, quant):
    """A T = 4 verify window per sequence from a mid-context cache, one
    slot inactive."""
    ref, arch, w = models["tiny"]
    jkv, pkv, lens = _mid_context(ref, 3, quant, seed=3)
    active = np.array([True, True, False])
    toks = np.random.default_rng(4).integers(3, arch.vocab_size, (3, 4))
    jlog, jkv = jb.batched_verify_step(
        ref.arch, ref.weights, jkv, jnp.asarray(toks, jnp.int32),
        jnp.asarray(lens), jnp.asarray(active), impl=JIMPL[impl])
    plog, pkv = pb.batched_verify_step(arch, w, pkv, toks, lens, active,
                                       impl=impl)
    assert tuple(plog.shape) == (3, 4, arch.vocab_size)
    _check_logits(plog.numpy(), np.asarray(jlog), active, quant)
    written = np.zeros(pkv.k.shape[:4], bool)[:, :, :1]
    _check_caches(pkv, jkv, _mark(written, lens, active, t=4))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_layer_prefix_step_matches_jax(models, impl):
    """n_layers: the first two layers only (a speculative draft); the
    deeper layers' caches stay untouched."""
    ref, arch, w = models["tiny"]
    jkv, pkv, lens = _mid_context(ref, 2, False, seed=5)
    active = np.array([True, True])
    deep = pkv.k[2:].clone()
    jlog, jkv = jb.batched_decode_step(
        ref.arch, ref.weights, jkv, jnp.asarray([5, 9], jnp.int32),
        jnp.asarray(lens), jnp.asarray(active), impl=JIMPL[impl], n_layers=2)
    plog, pkv = pb.batched_decode_step(arch, w, pkv, [5, 9], lens, active,
                                       impl=impl, n_layers=2)
    assert _rel(plog.numpy(), np.asarray(jlog)) <= LOGIT_RTOL[False]
    assert torch.equal(pkv.k[2:], deep)
    written = np.zeros(pkv.k.shape[:4], bool)[:, :, :1]
    _check_caches(pkv, jkv, _mark(written, lens, active, n_layers=2))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_kernel_path_matches_plain_path(models, quant):
    """Within the port: the deferred-write kernel path (stacked-cache
    attention, virtual rows, one bulk append; both append choices) and the
    plain path agree, an inactive slot with non-zero frozen rows included.
    bf16: logits to 1e-5 and bit-equal caches. int8: the plain path attends
    a bf16 dequant where the kernel folds the exact f32 scales, so the JAX
    suite's int8 limits hold (logits and dequantized caches to 2e-2), and
    the two append choices of the kernel path are bit-equal."""
    ref, arch, w = models["tiny"]
    _, base, lens = _mid_context(ref, 3, quant, seed=6)
    active = np.array([True, False, True])
    outs = {}
    for impl, append in (("plain", None), ("kernel", "kernel"),
                         ("kernel", "dus")):
        kv = pb.BatchedKV(*(None if t is None else t.clone()
                            for t in (base.k, base.v, base.ks, base.vs)))
        logits, kv = pb.batched_decode_step(arch, w, kv, [3, 7, 11], lens,
                                            active, impl=impl,
                                            kv_append=append)
        outs[(impl, append)] = (logits, kv)
    deq = lambda kv: [(c.float() * s[..., None]).numpy()
                      for c, s in ((kv.k, kv.ks), (kv.v, kv.vs))]
    for ref_key, key in ((("plain", None), ("kernel", "kernel")),
                         (("kernel", "kernel"), ("kernel", "dus"))):
        (l0, kv0), (lg, kv) = outs[ref_key], outs[key]
        exact = not quant or ref_key[0] == "kernel"
        assert _rel(lg.numpy(), l0.numpy()) <= (1e-5 if exact else 2e-2)
        if exact:
            for a, b in zip((kv.k, kv.v, kv.ks, kv.vs),
                            (kv0.k, kv0.v, kv0.ks, kv0.vs)):
                if a is not None:
                    assert torch.equal(a, b), key
        else:
            for a, b in zip(deq(kv), deq(kv0)):
                np.testing.assert_allclose(a, b, atol=2e-2)


@pytest.mark.parametrize("step,append", [("decode", "kernel"),
                                         ("decode", "dus"), ("verify", None)])
def test_kernel_path_refuses_other_cache_dtypes(models, step, append):
    """The kernel path takes bf16 or int8 caches only: an f16 cache raises,
    on the CPU too where the wrappers run their plain twins, and is left
    as it was; the step never falls back to the plain path."""
    _, arch, w = models["tiny"]
    shape = (arch.n_layers, 2, arch.n_kv_heads, arch.max_seq_len,
             arch.head_dim)
    kv = pb.BatchedKV(torch.zeros(shape, dtype=torch.float16),
                      torch.zeros(shape, dtype=torch.float16))
    with pytest.raises(ValueError, match="bf16 cache or int8"):
        if step == "verify":
            pb.batched_verify_step(arch, w, kv, [[3, 4], [5, 6]], [2, 7],
                                   [True, True], impl="kernel")
        else:
            pb.batched_decode_step(arch, w, kv, [3, 5], [2, 7],
                                   [True, True], impl="kernel",
                                   kv_append=append)
    assert not kv.k.any() and not kv.v.any()


def test_s_live_bucket_changes_nothing(models):
    """A live-prefix bucket covering every position: logits and caches
    bit-equal to the unbucketed step over a chained int8 run."""
    ref, arch, w = models["tiny"]
    _, a, lens = _mid_context(ref, 2, True, seed=7)
    b = pb.BatchedKV(*(t.clone() for t in (a.k, a.v, a.ks, a.vs)))
    act = np.array([True, True])
    for step in range(3):
        la, a = pb.batched_decode_step(arch, w, a, [3, 7], lens + step, act,
                                       impl="kernel")
        lb, b = pb.batched_decode_step(arch, w, b, [3, 7], lens + step, act,
                                       impl="kernel", s_live=128)
        assert torch.equal(la, lb)
    assert torch.equal(a.k, b.k) and torch.equal(a.ks, b.ks)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_insert_matches_jax(models, quant):
    """A single-sequence cache placed in a slot, in place (int8 scales go
    from [L, Hkv, S, 1] to the batched S-minor layout)."""
    ref, arch, _ = models["tiny"]
    rng = np.random.default_rng(8)
    jkv = jl.KVCache.create(ref.arch, quant=quant)
    single = jl.KVCache(*(None if a is None else jnp.asarray(
        rng.standard_normal(a.shape) * 50).astype(a.dtype)
        for a in (jkv.k, jkv.v, jkv.ks, jkv.vs)))
    want = jb.BatchedKV.create(ref.arch, 3, quant=quant).insert(1, single)
    conv = lambda a: None if a is None else torch.from_numpy(
        _bits(a).copy())
    pkv = pl.KVCache(*(conv(a) for a in (single.k, single.v, single.ks,
                                         single.vs)))
    if not quant:
        pkv = pl.KVCache(pkv.k.view(torch.bfloat16), pkv.v.view(
            torch.bfloat16))
    got = pb.BatchedKV.create(arch, 3, quant=quant, device="cpu")
    assert got.insert(1, pkv) is got
    for g, wnt in zip((got.k, got.v, got.ks, got.vs),
                      (want.k, want.v, want.ks, want.vs)):
        if wnt is not None:
            np.testing.assert_array_equal(_pbits(g), _bits(wnt))
    with pytest.raises(ValueError, match="quantization"):
        got.insert(0, pl.KVCache.create(arch, quant=not quant, device="cpu"))


def test_batched_step_matches_single_sequence(models):
    """B = 3 prompts of different lengths decode greedily exactly as three
    single-sequence forwards."""
    _, arch, w = models["tiny"]
    prompts = [[1, 5, 9], [7, 2], [3, 3, 3, 4]]
    kvs, firsts = [], []
    bkv = pb.BatchedKV.create(arch, 3, device="cpu")
    for b, ids in enumerate(prompts):
        kv = pl.KVCache.create(arch, device="cpu")
        logits, kv, _ = pl.forward(arch, w, kv, ids, 0)
        firsts.append(int(torch.argmax(logits[0])))
        bkv.insert(b, kv)
        kvs.append(kv)
    tokens, pos = list(firsts), np.array([len(p) for p in prompts])
    for step in range(4):
        logits, bkv = pb.batched_decode_step(arch, w, bkv, tokens, pos,
                                             [True] * 3, impl="kernel")
        nxt = torch.argmax(logits, -1).tolist()
        for b in range(3):
            lg, kvs[b], _ = pl.forward(arch, w, kvs[b], [tokens[b]], pos[b])
            assert int(torch.argmax(lg[0])) == nxt[b], (step, b)
        tokens, pos = nxt, pos + 1
