"""Port parity for pipeline parallelism (parallel/pp.py) on the CPU: the
GPipe decode step over S stages and M microbatches against the live JAX
package's make_pp_decode on the conftest's 8-device CPU mesh, and against
the port's own unsharded batched step, over three chained steps (the cases
of tests/test_pp.py:27-54), on the same tiny seeded Q8_0 weights in both
packages (the JAX loader's arrays, converted; against the JAX step every
layer a copy of layer 0, as `same_layers` says why).

Tolerances, and why:
  * against the JAX step: tests/test_torch_batched.py's limits for the
    batched step across the packages (LOGIT_RTOL of the largest logit,
    5e-3 bf16 and 2e-2 int8; the caches' unwritten rows bit-equal and layer
    0's written rows bit-equal but for a rare flip): the JAX suite holds
    its PP step bit-equal to its own one-device step, so the port's PP
    step meets what the port's one-device step meets;
  * against the port's unsharded step: bit for bit. Each microbatch's
    logits and cache are those of the unsharded step over its slots alone
    (the same kernels, or plain twins, at the same shapes), and at M = 1
    those of the whole batch's step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.parallel import pp as jpp
from ntransformer_tpu_torch.models import batched as pb
from ntransformer_tpu_torch.models import llama as pl
from ntransformer_tpu_torch.models.convert import weights_from_numpy
from ntransformer_tpu_torch.models.synth import synth_model
from ntransformer_tpu_torch.ops.cuda import kv_update
from ntransformer_tpu_torch.parallel import pp
from test_torch_batched import _check_caches, _check_logits, _mark
from test_torch_model import jax_tree, one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

B = 4
TOKENS = [3, 7, 11, 5]
ACTIVE = [True, True, False, True]
POS = lambda t: [t, t + 2, 1, t]  # noqa: E731


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = write_model(str(tmp_path_factory.mktemp("pp") / "pp_q8.gguf"),
                       "tiny", "q8_0", seed=17)
    ref = jax_load_model(path, max_seq_len=64)
    arch = pl.Arch(**dataclasses.asdict(ref.arch))
    return ref, arch, weights_from_numpy(jax_tree(ref.weights), arch, "cpu")


@pytest.fixture(scope="module")
def same_layers(tiny):
    """The tiny model with every layer a copy of layer 0, in both packages.
    The JAX make_pp_decode shards the layer stacks only where a leaf's tree
    path names "layers", which ModelWeights' flat pytree keys never do:
    every stage holds the whole stack and runs its first L/S layers. Its
    step is right only where the layers are equal, as in its own suite's
    constant synthetic weights (tests/test_pp.py); the port's stages run
    their own layers (test_pp_microbatch_bit_equal_to_unsharded_slots)."""
    ref, arch, _ = tiny
    layers = jax.tree.map(lambda x: jnp.broadcast_to(x[:1], x.shape),
                          ref.weights.layers)
    jw = dataclasses.replace(ref.weights, layers=layers)
    return jw, weights_from_numpy(jax_tree(jw), arch, "cpu")


def _stages(arch) -> int:
    return 2 if arch.n_layers % 4 else 4


def _cpu_mesh(n):
    return pp.make_pp_mesh(n, ["cpu"] * n)


@pytest.mark.parametrize("quant,n_micro", [(False, 1), (False, 2),
                                           (True, 2), (False, 4)])
def test_pp_decode_matches_jax_make_pp_decode(tiny, same_layers, quant,
                                             n_micro):
    ref, arch, _ = tiny
    jweights, w = same_layers
    n_st = _stages(arch)
    jmesh = Mesh(np.asarray(jax.devices()[:n_st]), (jpp.PP_AXIS,))
    jstep = jpp.make_pp_decode(jmesh, ref.arch, jweights,
                               n_micro=n_micro, quant=quant)
    jw, jkv = jpp.shard_pp_state(jmesh, ref.arch, jweights, B, quant=quant)
    mesh = _cpu_mesh(n_st)
    state = pp.shard_pp_state(mesh, arch, w, B, n_micro, quant)
    written = np.zeros((arch.n_layers, B, 1, arch.max_seq_len), bool)
    tokens = TOKENS
    for t in range(3):
        want, jkv = jstep(jw, jkv, jnp.asarray(tokens, jnp.int32),
                          jnp.asarray(POS(t), jnp.int32),
                          jnp.asarray(ACTIVE))
        got, state = pp.pp_decode_step(mesh, arch, state,
                                       torch.tensor(tokens),
                                       torch.tensor(POS(t)),
                                       torch.tensor(ACTIVE), n_micro)
        _check_logits(got.numpy(), np.asarray(want), ACTIVE, quant)
        _mark(written, np.asarray(POS(t)), np.asarray(ACTIVE))
        tokens = np.asarray(want).argmax(-1).tolist()
    _check_caches(pp.gather_kv(state, "cpu"), jkv, written)


@pytest.mark.parametrize("quant,stages,n_micro", [
    (False, 2, 2), (True, 2, 2), (False, 4, 2), (True, 4, 4), (False, 2, 1),
    (True, 4, 1)])
def test_pp_microbatch_bit_equal_to_unsharded_slots(tiny, quant, stages,
                                                    n_micro):
    """Each microbatch's logits and cache bit-equal to the unsharded
    batched step over its slots alone; at M = 1 that is the whole batch's
    step."""
    _, arch, w = tiny
    mesh = _cpu_mesh(stages)
    state = pp.shard_pp_state(mesh, arch, w, B, n_micro, quant)
    per = B // n_micro
    refs = [pb.BatchedKV.create(arch, per, quant, device="cpu")
            for _ in range(n_micro)]
    tokens = torch.tensor(TOKENS)
    for t in range(3):
        got, state = pp.pp_decode_step(mesh, arch, state, tokens,
                                       torch.tensor(POS(t)),
                                       torch.tensor(ACTIVE), n_micro)
        for m in range(n_micro):
            sl = slice(m * per, (m + 1) * per)
            want, refs[m] = pb.batched_decode_step(
                arch, w, refs[m], tokens[sl], torch.tensor(POS(t))[sl],
                torch.tensor(ACTIVE)[sl])
            assert torch.equal(got[sl], want), (t, m)
        tokens = got.argmax(-1)
    n_loc = arch.n_layers // stages
    for m in range(n_micro):
        for s in range(stages):
            for name in ("k", "v", "ks", "vs"):
                a = getattr(state.kv[s][m], name)
                b = getattr(refs[m], name)
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a, b[s * n_loc:(s + 1) * n_loc])


def test_pp_head_runs_once_per_microbatch(tiny, monkeypatch):
    """The last stage runs the final norm and head once per microbatch: M
    times a step (JAX runs it in every tick of every stage)."""
    _, arch, w = tiny
    calls = []
    head = pp._head
    monkeypatch.setattr(pp, "_head", lambda *a: calls.append(1) or head(*a))
    n_micro = 2
    mesh = _cpu_mesh(_stages(arch))
    state = pp.shard_pp_state(mesh, arch, w, B, n_micro)
    for t in range(2):
        pp.pp_decode_step(mesh, arch, state, TOKENS, POS(t), ACTIVE, n_micro)
    assert len(calls) == 2 * n_micro


def test_pp_stage_appends_all_its_layers_in_one_call(tiny, monkeypatch):
    """On the kernel path each stage writes its rows with the stacked
    append over its L/S layers (the stage's local arch), never the indexed
    write a layer prefix takes."""
    _, arch, w = tiny
    got = {"append": 0, "dus": 0}
    app, dus = kv_update.append_rows_stacked, \
        kv_update.append_rows_stacked_dus

    def count(name, fn):
        def run(caches, rows, *a, **k):
            if rows[0].shape[0] == arch.n_layers // n_st:
                got[name] += 1
            return fn(caches, rows, *a, **k)
        return run
    monkeypatch.setattr(kv_update, "append_rows_stacked",
                        count("append", app))
    monkeypatch.setattr(kv_update, "append_rows_stacked_dus",
                        count("dus", dus))
    monkeypatch.setattr(pp, "resolve_impl",
                        lambda *a: ("kernel", "kernel"))
    n_st, n_micro = _stages(arch), 2
    mesh = _cpu_mesh(n_st)
    state = pp.shard_pp_state(mesh, arch, w, B, n_micro)
    ref = pb.BatchedKV.create(arch, B, device="cpu")
    got_l, state = pp.pp_decode_step(mesh, arch, state, TOKENS, POS(0),
                                     ACTIVE, n_micro)
    assert got == {"append": n_st * n_micro, "dus": 0}
    want, ref = pb.batched_decode_step(arch, w, ref, TOKENS, POS(0), ACTIVE,
                                       impl="kernel", kv_append="kernel")
    assert torch.equal(pp.gather_kv(state, "cpu").k, ref.k)


def test_pp_stage_layers_are_views_on_their_device(tiny):
    _, arch, w = tiny
    state = pp.shard_pp_state(_cpu_mesh(2), arch, w, B, 2)
    n = arch.n_layers // 2
    for s, st in enumerate(state.stages):
        for nm, a in st.layers.wo.planes.items():
            src = w.layers.wo.planes[nm]
            assert a.data_ptr() == src[s * n].data_ptr()
        assert st.embed is state.stages[0].embed
    assert state.arch.n_layers == n


def test_pp_refusals_match_jax(tiny):
    """Sliding-window families (both packages' message), L % S and B % M."""
    _, arch, w = tiny
    cfg, sarch, sw = synth_model("tiny", "q8_0", max_seq_len=64,
                                 device="cpu")
    swa = dataclasses.replace(sarch, sliding_window=8, swa_pattern=2)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        pp.shard_pp_state(_cpu_mesh(2), swa, sw, B, 2)
    from ntransformer_tpu.models.synth import synth_model as jsynth
    _, jarch, jw = jsynth("tiny", "q8_0", max_seq_len=64)
    jswa = dataclasses.replace(jarch, sliding_window=8, swa_pattern=2)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        jpp.make_pp_decode(Mesh(np.asarray(jax.devices()[:2]),
                                (jpp.PP_AXIS,)), jswa, jw)
    bad = next(n for n in (3, 5, 6, 7) if arch.n_layers % n)
    with pytest.raises(ValueError, match="not divisible by .* pp stages"):
        pp.shard_pp_state(_cpu_mesh(bad), arch, w, B, 2)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        pp.shard_pp_state(_cpu_mesh(2), arch, w, B, 3)
    with pytest.raises(ValueError, match="a 3-way PP mesh needs 3"):
        pp.make_pp_mesh(3, ["cpu"])
