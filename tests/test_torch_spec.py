"""Port parity for speculative decoding on the CPU, against the live JAX
package on the same GGUF files (the tiny Q8_0 and Q4_K_M files of
tools/make_test_gguf.py and the trained repolm512):

- Engine.generate_speculative, generate_self_speculative and
  generate_self_speculative_fused: the JAX package's tokens and
  drafted/accepted counts, and the port's own plain greedy tokens;
- TieredEngine self-speculation (the resident prefix drafts) and
  separate-draft speculation, with the draft's cache in the tiered
  loader's reserve;
- the verify step of Engine, TieredEngine and CPEngine against the JAX
  twin (5e-3 of the largest logit, tests/test_torch_model.py's limit);
- self-speculative serving (BatchServer(spec_k)): the JAX server's tokens
  and counters, spec-off greedy serving's tokens, the accept round against
  the JAX package's _spec_accept_batched token for token, sampled
  rejection sampling unbiased and deterministic per seed, and the kernel
  path (each cache-dot form's plain twin on the CPU).

A draft that agrees with the target gives full acceptance (the full-accept
backfill of the draft's cache); a tiny model of another seed gives none
(the correction path); repolm512 drafting on 3 of its 6 layers gives a
partial acceptance."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntransformer_tpu.inference.engine import CPEngine as JCPEngine
from ntransformer_tpu.inference.engine import Engine as JEngine
from ntransformer_tpu.inference.engine import GenerateConfig as JGenConfig
from ntransformer_tpu.inference.engine import TieredEngine as JTieredEngine
from ntransformer_tpu.inference.sampler import BatchedSampler as JBatchedSampler
from ntransformer_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from ntransformer_tpu.inference.serve import BatchServer as JBatchServer
from ntransformer_tpu.inference.serve import Request as JRequest
from ntransformer_tpu.models import llama as jllama
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.parallel import cp as jcp
from ntransformer_tpu_torch.inference.engine import (CPEngine, Engine,
                                                     GenerateConfig,
                                                     TieredEngine)
from ntransformer_tpu_torch.inference.sampler import (BatchedSampler,
                                                      SamplerConfig)
from ntransformer_tpu_torch.inference.serve import BatchServer, Request
from ntransformer_tpu_torch.models import batched as pbatched
from ntransformer_tpu_torch.models import llama as pllama
from ntransformer_tpu_torch.models import tiered as ptiered
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.parallel.cp import make_cp_mesh
from test_torch_model import LOGIT_RTOL, one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(REPO, "models", "repolm512_q8.gguf")
GB = 1 << 30
PROMPT = {"tiny": "hello world",
          "repolm512": "def forward(arch, weights, kv, tokens, pos):\n"}
SERVE_PROMPTS = {"tiny": ["alpha beta", "gamma", "delta epsilon zeta", "eta"],
                 "repolm512": ["def forward(", "import jax\n",
                               "class Engine:\n    def __init__(self",
                               "from .ops import "]}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    return {"tiny": write_model(str(d / "tiny_q8.gguf"), "tiny", "q8_0",
                                seed=3),
            "tiny_q4_k_m": write_model(str(d / "tiny_q4km.gguf"), "tiny",
                                       "q4_k_m", seed=2),
            "draft": write_model(str(d / "draft_q8.gguf"), "tiny", "q8_0",
                                 seed=99),
            "repolm512": REPOLM}


class Recording:
    """A tokenizer that keeps the ids of the last decode: the generated
    tokens, to compare as ids rather than as text."""

    def __init__(self, tok):
        self.tok, self.ids = tok, None

    def decode(self, ids):
        self.ids = [int(t) for t in ids]
        return self.tok.decode(ids)

    def __getattr__(self, name):
        return getattr(self.tok, name)


def _configs(n: int, k: int):
    kw = dict(max_tokens=n, temperature=0.0, repeat_penalty=1.0, draft_k=k)
    return GenerateConfig(**kw), JGenConfig(**kw)


def _run(engine, method: str, prompt: str, cfg, **kw):
    """(generated ids, stats) of engine.<method>."""
    engine.tokenizer = Recording(engine.tokenizer)
    try:
        _, stats = getattr(engine, method)(prompt, cfg, **kw)
        return engine.tokenizer.ids, stats
    finally:
        engine.tokenizer = engine.tokenizer.tok


def _assert_greedy_prefix(spec: list[int], plain: list[int]):
    """Greedy speculation emits the plain greedy tokens; it may run past
    max_tokens by up to K tokens of one round."""
    n = min(len(spec), len(plain))
    assert n > 0 and spec[:n] == plain[:n], (spec, plain)


# ------------------------------------------------------------------ Engine
@pytest.mark.parametrize("which,method,k", [
    ("tiny", "generate_speculative", 3),
    ("tiny_q4_k_m", "generate_self_speculative", 2),
    ("tiny", "generate_self_speculative_fused", 3),
    ("repolm512", "generate_speculative", 3),
    ("repolm512", "generate_self_speculative", 3),
    ("repolm512", "generate_self_speculative_fused", 3),
    ("tiny_q4_k_m", "generate_self_speculative_fused", 4),
], ids=lambda v: str(v))
def test_engine_speculation_matches_jax_and_greedy(files, which, method, k):
    """The JAX package's tokens and drafted/accepted counts, and the port's
    plain greedy tokens. The tiny target's draft is a tiny model of another
    seed (nothing accepted); repolm512's draft is repolm512 itself
    (everything accepted: each round backfills the draft's cache);
    self-speculation drafts on half the layers."""
    path = files[which]
    prompt = PROMPT["repolm512" if which == "repolm512" else "tiny"]
    draft = files["draft"] if which == "tiny" else path
    kw = dict(max_seq_len=256)
    spec = method == "generate_speculative"
    jeng = JEngine(jax_load_model(path, **kw),
                   jax_load_model(draft, **kw) if spec else None)
    eng = Engine(load_model(path, device="cpu", **kw),
                 load_model(draft, device="cpu", **kw) if spec else None)
    cfg, jcfg = _configs(14, k)
    got, stats = _run(eng, method, prompt, cfg)
    want, jstats = _run(jeng, method, prompt, jcfg)
    assert got == want
    assert (stats.drafted, stats.accepted) == (jstats.drafted,
                                               jstats.accepted)
    assert stats.drafted > 0 and stats.decode_tokens == len(got)
    if spec and which == "repolm512":
        assert stats.accepted == stats.drafted  # the draft is the target
    plain, _ = _run(eng, "generate", prompt, _configs(14 + k + 1, k)[0])
    _assert_greedy_prefix(got, plain)
    if method == "generate_self_speculative_fused":
        assert len(got) == len(plain) - k - 1  # stops at max_tokens
    assert "speculative: " in stats.report()


def test_engine_speculation_refusals_match_jax(files):
    eng = Engine(load_model(files["tiny"], device="cpu"))
    jeng = JEngine(jax_load_model(files["tiny"]))
    with pytest.raises(ValueError) as e:
        eng.generate_speculative("x", GenerateConfig(max_tokens=2))
    with pytest.raises(ValueError) as je:
        jeng.generate_speculative("x", JGenConfig(max_tokens=2))
    assert str(e.value) == str(je.value) == "no draft model loaded"


def test_engine_load_takes_a_draft(files):
    """Engine.load(draft_path=) loads the draft first, with the same load
    keywords (the same device)."""
    eng = Engine.load(files["tiny"], draft_path=files["draft"],
                      device="cpu", max_seq_len=128)
    assert eng.draft is not None and eng.draft.device == eng.device
    assert eng.draft.arch.max_seq_len == eng.arch.max_seq_len == 128


def test_layer_subset_draft_matches_jax(files):
    """A draft layer prefix through forward (layer_sel) writes only its
    layers' cache rows and gives the JAX package's logits (the JAX
    package's test_model.py layer-subset case)."""
    path = files["tiny"]
    jm, pm = jax_load_model(path), load_model(path, device="cpu")
    toks = [2, 4, 9]
    jl, jkv, _ = jllama.forward(jm.arch, jm.weights,
                                jllama.KVCache.create(jm.arch),
                                jnp.asarray(toks, jnp.int32), 0,
                                layer_sel=jnp.asarray([0, 1], jnp.int32))
    pl, pkv, _ = pllama.forward(pm.arch, pm.weights,
                                pllama.KVCache.create(pm.arch, device="cpu"),
                                torch.tensor(toks), 0, layer_sel=[0, 1])
    assert pl.shape == (1, pm.arch.vocab_size)
    ref = np.asarray(jl, np.float32)
    assert np.abs(pl.numpy() - ref).max() <= LOGIT_RTOL * np.abs(ref).max()
    assert pkv.k[2:].abs().max() == 0 and pkv.k[:2].abs().max() > 0


# ------------------------------------------------------------- the verify
def _verify_inputs(eng):
    ids = eng.tokenizer.encode(PROMPT["tiny"], add_bos=True)
    return ids, [ids[-1], 7, 21, 300]


@pytest.mark.parametrize("which", ["engine", "tiered", "cp"])
def test_verify_logits_match_jax(files, which, tmp_path):
    """_verify's all-position logits over [anchor, d0, d1, d2] after a
    prefill, against the JAX engine's, within 5e-3 of the largest logit."""
    path = files["tiny"]
    if which == "engine":
        eng = Engine(load_model(path, device="cpu"))
        jeng = JEngine(jax_load_model(path))
    elif which == "tiered":
        tiers = dict(max_hbm_layers=2, max_ram_layers=1, hbm_bytes=64 * GB,
                     ram_bytes=64 * GB)
        p, jp = tmp_path / "p.gguf", tmp_path / "j.gguf"
        shutil.copy(path, p)
        shutil.copy(path, jp)
        eng = TieredEngine.load(str(p), device="cpu", **tiers)
        jeng = JTieredEngine.load(str(jp), **tiers)
    else:
        eng = CPEngine(load_model(path, device="cpu"),
                       make_cp_mesh(4, ("cpu",) * 4))
        jeng = JCPEngine(jax_load_model(path), jcp.make_cp_mesh(4))
    ids, window = _verify_inputs(eng)
    _, kv, _ = eng._prefill(eng._make_kv(), ids)
    _, jkv, _ = jeng._prefill(jeng._make_kv(), ids)
    got, _ = eng._verify(kv, torch.tensor(window), len(ids))
    want, _ = jeng._verify(jkv, jnp.asarray(window, jnp.int32), len(ids))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape == (4, eng.arch.vocab_size)
    assert np.abs(got.numpy() - want).max() <= LOGIT_RTOL * np.abs(want).max()
    if which == "tiered":
        eng.tm.close()


def test_cp_engine_speculation_refuses_the_draft_prefix(files):
    """CPEngine's fused self-speculation delegates to the host-driven
    protocol, whose draft prefix the CP forward does not take: the JAX
    CPEngine asserts, the port raises ValueError at the same step."""
    path = files["tiny"]
    eng = CPEngine(load_model(path, device="cpu"),
                   make_cp_mesh(2, ("cpu",) * 2))
    cfg, jcfg = _configs(4, 2)
    with pytest.raises(ValueError, match="draft layer prefix"):
        eng.generate_self_speculative_fused("alpha", cfg)
    with pytest.raises(AssertionError):
        JCPEngine(jax_load_model(path), jcp.make_cp_mesh(2)) \
            .generate_self_speculative_fused("alpha", jcfg)


# ------------------------------------------------------------------ tiered
@pytest.mark.parametrize("mode", ["self", "draft"])
def test_tiered_speculation_matches_jax_and_greedy(files, mode, tmp_path):
    """TieredEngine self-speculation (the 3 resident layers of repolm512
    draft) and separate-draft speculation (a resident tiny draft of another
    seed against a streamed tiny target): the JAX TieredEngine's tokens and
    counts, and the port's resident greedy tokens."""
    src = files["repolm512" if mode == "self" else "tiny"]
    tiers = (dict(max_hbm_layers=3, max_ram_layers=2) if mode == "self"
             else dict(max_hbm_layers=2, max_ram_layers=1))
    tiers.update(hbm_bytes=64 * GB, ram_bytes=64 * GB, max_seq_len=256)
    p, jp = tmp_path / "p.gguf", tmp_path / "j.gguf"
    shutil.copy(src, p)
    shutil.copy(src, jp)
    draft = None if mode == "self" else files["draft"]
    eng = TieredEngine.load(str(p), device="cpu", draft_path=draft, **tiers)
    jeng = JTieredEngine.load(str(jp), draft_path=draft, **tiers)
    assert eng.tm.tiers.n_streamed >= 1
    assert eng.tm.n_resident == jeng.tm.n_resident == tiers["max_hbm_layers"]
    method = ("generate_self_speculative" if mode == "self"
              else "generate_speculative")
    prompt = PROMPT["repolm512" if mode == "self" else "tiny"]
    cfg, jcfg = _configs(12, 3)
    got, stats = _run(eng, method, prompt, cfg)
    want, jstats = _run(jeng, method, prompt, jcfg)
    assert got == want
    assert (stats.drafted, stats.accepted) == (jstats.drafted,
                                               jstats.accepted)
    assert stats.drafted > 0
    fused, fstats = _run(eng, "generate_self_speculative_fused", prompt, cfg)
    if mode == "self":
        assert fused == got and fstats.accepted == stats.accepted
    resident = Engine(load_model(src, device="cpu", max_seq_len=256))
    plain, _ = _run(resident, "generate", prompt, _configs(16, 3)[0])
    _assert_greedy_prefix(got, plain)
    eng.tm.close()


def test_tiered_draft_reserve_accounted(files, monkeypatch):
    """The tiered loader subtracts reserve_extra_bytes (fewer resident
    layers under a large reserve), and TieredEngine.load(draft_path=)
    reserves the draft's bf16 cache: n_layers * n_kv_heads * max_seq_len *
    head_dim * 2 * 2 bytes, as the JAX TieredEngine."""
    tiny = files["tiny"]
    base = ptiered.load_model_tiered(tiny, hbm_bytes=1 * GB,
                                     ram_bytes=64 * GB, device="cpu")
    squeezed = ptiered.load_model_tiered(tiny, hbm_bytes=1 * GB,
                                         ram_bytes=64 * GB, device="cpu",
                                         reserve_extra_bytes=900 << 20)
    assert squeezed.tiers.n_hbm < base.tiers.n_hbm
    for tm in (base, squeezed):
        tm.close()
    seen = {}
    real = ptiered.load_model_tiered

    def spy(path, **kw):
        seen["extra"] = kw["reserve_extra_bytes"]
        return real(path, **kw)
    monkeypatch.setattr(ptiered, "load_model_tiered", spy)
    eng = TieredEngine.load(tiny, device="cpu", draft_path=files["draft"],
                            max_seq_len=128, hbm_bytes=64 * GB,
                            ram_bytes=64 * GB, max_hbm_layers=2)
    da = jax_load_model(files["draft"], max_seq_len=128).arch
    assert seen["extra"] == (da.n_layers * da.n_kv_heads * da.max_seq_len
                             * da.head_dim * 2 * 2) > 0
    assert eng.draft.arch.max_seq_len == 128
    eng.tm.close()


# ----------------------------------------------------------------- serving
def _serve(server_cls, request_cls, model, prompts, n=8, **kw):
    srv = server_cls(model, batch_size=2, **kw)
    reqs = [request_cls(prompt=p, max_tokens=n) for p in prompts]
    stats = srv.run(reqs)
    return [list(r.output_ids) for r in reqs], stats


def _counters(stats):
    return (stats.steps, stats.draft_steps, stats.spec_drafted,
            stats.spec_accepted)


@pytest.mark.parametrize("which,kv_quant,draft", [
    ("tiny", False, 2), ("tiny_q4_k_m", False, 3), ("repolm512", False, 3),
    ("repolm512", True, 3), ("tiny", False, 4)],
    ids=["tiny-bf16", "tiny_q4_k_m-bf16", "repolm512-bf16", "repolm512-int8",
         "tiny-full-draft"])
def test_spec_serving_matches_jax_and_plain(files, which, kv_quant, draft):
    """BatchServer(spec_k=2): the JAX server's tokens and step, draft,
    drafted and accepted counts, and the port's spec-off tokens; a draft of
    the whole stack accepts everything in fewer full-model steps. int8 on
    the trained model only (tests/test_torch_serve.py says why)."""
    path = files[which]
    prompts = SERVE_PROMPTS["repolm512" if which == "repolm512" else "tiny"]
    kw = dict(kv_quant=kv_quant)
    spec = dict(spec_k=2, spec_draft_layers=draft)
    jm = jax_load_model(path, max_seq_len=256, fuse=True)
    pm = load_model(path, max_seq_len=256, fuse=True, device="cpu")
    want, jst = _serve(JBatchServer, JRequest, jm, prompts,
                       sampler_cfg=JSamplerConfig(temperature=0.0),
                       **kw, **spec)
    got, st = _serve(BatchServer, Request, pm, prompts,
                     sampler_cfg=SamplerConfig(temperature=0.0), **kw,
                     **spec)
    plain, pst = _serve(BatchServer, Request, pm, prompts,
                        sampler_cfg=SamplerConfig(temperature=0.0), **kw)
    assert got == want == plain
    assert _counters(st) == _counters(jst) and st.spec_drafted > 0
    if draft == pm.arch.n_layers:
        assert st.spec_accepted == st.spec_drafted
        assert st.steps * 3 <= pst.steps + 3 * len(prompts)
    assert f"{st.draft_steps} draft steps" in st.report()


def test_spec_serving_refusals(files):
    pm = load_model(files["tiny"], device="cpu")
    for bad in (0, pm.arch.n_layers + 1):
        with pytest.raises(ValueError, match="spec_draft_layers"):
            BatchServer(pm, spec_k=2, spec_draft_layers=bad)


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_spec_accept_greedy_matches_jax(penalty):
    """Greedy slots: the longest argmax-matching prefix and the correction
    or bonus token, with the vocab_size sentinel after it, token for token
    as the JAX package's _spec_accept_batched (the repeat penalty's window
    advancing inside the round)."""
    rng = np.random.default_rng(0)
    B, K, V = 4, 3, 64
    vlogits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    targets = vlogits.argmax(-1)
    drafts = targets[:, :K].copy()
    drafts[0, 1] = (targets[0, 1] + 1) % V   # reject at j = 1
    drafts[2, 0] = (targets[2, 0] + 1) % V   # reject at j = 0
    drafts[3, 2] = targets[3, 1]             # a repeat inside the round
    active = np.array([True, True, True, False])
    cfg = dict(temperature=0.0, repeat_penalty=penalty)
    jbs = JBatchedSampler(JSamplerConfig(**cfg), V, B)
    want, jn = jbs.spec_accept(jnp.asarray(vlogits), jnp.asarray(drafts),
                               jnp.asarray(active))
    bs = BatchedSampler(SamplerConfig(**cfg), V, B, "cpu")
    got, n_acc = bs.spec_accept(torch.from_numpy(vlogits),
                                torch.from_numpy(drafts), active)
    assert got.tolist() == np.asarray(want).tolist()
    assert n_acc.tolist() == np.asarray(jn).tolist()
    if penalty == 1.0:
        assert n_acc.tolist() == [1, K, 0, 0]
        assert got[3].tolist() == [V] * (K + 1)  # the inactive slot
    assert bs.n.tolist() == (np.asarray(n_acc) + active).tolist()


def test_spec_accept_sampled_unbiased():
    """Greedy-draft rejection sampling is unbiased: over 512 slots the
    first emitted token's frequencies match the target distribution within
    4 sigma (+0.01), and some drafts are accepted, some rejected."""
    rng = np.random.default_rng(1)
    B, V = 512, 16
    cfg = SamplerConfig(temperature=1.0, top_k=V, top_p=1.0,
                        repeat_penalty=1.0, seed=7)
    row = (rng.standard_normal(V) * 1.5).astype(np.float32)
    p = np.exp(row - row.max())
    p /= p.sum()
    d = int(np.argmax(row))
    vlogits = torch.from_numpy(np.broadcast_to(row, (B, 2, V)).copy())
    bs = BatchedSampler(cfg, V, B, "cpu")
    toks, n_acc = bs.spec_accept(vlogits, torch.full((B, 1), d),
                                 np.ones(B, bool))
    freq = np.bincount(toks[:, 0], minlength=V)[:V] / B
    sigma = np.sqrt(p * (1 - p) / B)
    assert (np.abs(freq - p) < 4 * sigma + 0.01).all(), (freq, p)
    assert 0 < n_acc.sum() < B
    # a rejected slot's correction is never the draft; its bonus row is
    # the sentinel
    rej = n_acc == 0
    assert (toks[rej, 0] != d).all() and (toks[rej, 1] == V).all()


def test_spec_serving_sampled_is_deterministic(files):
    """Temperature > 0: speculative serving completes with a sane
    acceptance, and two runs give the same tokens (each slot's uniforms
    come from its request's generator)."""
    pm = load_model(files["repolm512"], max_seq_len=256, device="cpu")
    prompts = SERVE_PROMPTS["repolm512"][:3]
    runs = [_serve(BatchServer, Request, pm, prompts, spec_k=2,
                   spec_draft_layers=3,
                   sampler_cfg=SamplerConfig(temperature=0.9, seed=13))
            for _ in range(2)]
    assert runs[0][0] == runs[1][0]
    st = runs[0][1]
    assert 0 < st.spec_accepted < st.spec_drafted
    assert all(len(o) == 8 for o in runs[0][0])


@pytest.mark.parametrize("dot", ["f32", "bf16", "int8", "int8_s", "int8_v"])
def test_spec_serving_kernel_path_matches_plain(files, dot, monkeypatch):
    """The kernel path of the batched steps (each cache-dot form's twin on
    the CPU: the deferred writes, the verify window's causal rows, one
    s_live rung for the round) serves with speculation the tokens it
    serves without; with the "f32" form also the JAX server's kernel path
    (interpret mode), as the JAX package's own kernel-versus-jnp case."""
    pm = load_model(files["tiny"], max_seq_len=512, fuse=True, device="cpu")
    prompts = SERVE_PROMPTS["tiny"][:3]
    monkeypatch.setattr(pbatched, "kernels_enabled", lambda t: True)
    kw = dict(sampler_cfg=SamplerConfig(temperature=0.0), dot_impl=dot,
              kv_quant=dot not in ("f32", "bf16"))
    plain, _ = _serve(BatchServer, Request, pm, prompts, **kw)
    got, st = _serve(BatchServer, Request, pm, prompts, spec_k=2,
                     spec_draft_layers=2, **kw)
    assert got == plain and st.spec_drafted > 0
    if dot == "f32":
        monkeypatch.setenv("NT_BATCHED_FLASH", "on")
        jm = jax_load_model(files["tiny"], max_seq_len=512, fuse=True)
        want, jst = _serve(JBatchServer, JRequest, jm, prompts, spec_k=2,
                           spec_draft_layers=2,
                           sampler_cfg=JSamplerConfig(temperature=0.0))
        assert got == want and _counters(st) == _counters(jst)
