"""Port parity for the sharded continuous-batching server
(BatchServer(mesh=), parallel/dp.py) on the CPU, at tools/make_test_gguf.py's
tiny preset (Hkv = 2 caps tp at 2): over (dp, tp) meshes of CPU positions
the port's server gives the texts of the JAX package's sharded server on
the conftest's 8-device CPU mesh and of the port's one-device server, as
tests/test_serve_sharded.py holds the JAX server.

Tolerance: greedy texts are compared for equality (the JAX suite's own
check). Int8 caches are held to the port's one-device int8 server, as the
JAX suite holds its own: int8 moves near-tie argmaxes of this random model,
and the last prompt's fourth token is such a tie between the two packages'
one-device int8 servers already (tests/test_torch_serve.py holds those to
each other on repolm512 prompts with a margin). Sampled serving is held to
finishing and to determinism: each request's stream is keyed by (seed,
request id), so two runs give the same texts.
"""
import numpy as np
import pytest

from ntransformer_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from ntransformer_tpu.inference.serve import BatchServer as JBatchServer
from ntransformer_tpu.inference.serve import Request as JRequest
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu.parallel.multihost import make_mesh as jmake_mesh
from ntransformer_tpu_torch.inference.sampler import SamplerConfig
from ntransformer_tpu_torch.inference.serve import BatchServer, Request
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.parallel.multihost import make_mesh
from test_torch_model import one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

PROMPTS = ["alpha beta", "gamma", "delta epsilon zeta", "eta", "theta iota"]
GREEDY = SamplerConfig(temperature=0.0)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("m") / "srv_q8.gguf"),
                       "tiny", "q8_0", seed=21)


def cpu_mesh(dp, tp):
    return make_mesh(tp=tp, dp=dp, devices=["cpu"] * (dp * tp))


def serve(path, mesh=None, batch=2, n=6, prompts=PROMPTS, cfg=GREEDY, **kw):
    srv = BatchServer(load_model(path, device="cpu"), batch_size=batch,
                      mesh=mesh, sampler_cfg=cfg, **kw)
    reqs = [Request(prompt=p, max_tokens=n) for p in prompts]
    stats = srv.run(reqs)
    return [r.text for r in reqs], stats, srv


def jax_serve(path, mesh=None, batch=2, **kw):
    srv = JBatchServer(jax_load_model(path, device=mesh is None),
                       batch_size=batch, mesh=mesh,
                       sampler_cfg=JSamplerConfig(temperature=0.0), **kw)
    reqs = [JRequest(prompt=p, max_tokens=6) for p in PROMPTS]
    srv.run(reqs)
    return [r.text for r in reqs]


@pytest.fixture(scope="module")
def single(path):
    """The port's one-device greedy texts, bf16 and int8; the bf16 ones
    equal the JAX one-device server's."""
    bf16, _, _ = serve(path)
    assert bf16 == jax_serve(path)
    int8, _, _ = serve(path, kv_quant=True)
    return {"bf16": bf16, "int8": int8}


@pytest.mark.parametrize("dp,tp", [(4, 2), (8, 1)])
def test_sharded_server_matches_jax_and_single(path, single, dp, tp):
    got, stats, _ = serve(path, cpu_mesh(dp, tp), batch=dp)
    assert got == single["bf16"]
    assert got == jax_serve(path, jmake_mesh(tp=tp, dp=dp), batch=dp)
    assert stats.requests == len(PROMPTS) and stats.steps > 0
    assert stats.prefill_chunks >= len(PROMPTS)


@pytest.mark.parametrize("dp,tp", [(4, 1), (1, 2)], ids=["dp-only",
                                                         "tp-only"])
def test_one_axis_meshes_match_single(path, single, dp, tp):
    """A dp-only mesh (the replicated-weights branch) and a tp-only mesh
    (the whole batch on one tp row)."""
    mesh = cpu_mesh(dp, tp)
    assert mesh.axis_names == (("dp", "tp") if dp > 1 else ("tp",))
    got, _, _ = serve(path, mesh, batch=max(dp, 2))
    assert got == single["bf16"]


def test_int8_cache_matches_single_int8(path, single):
    got, stats, _ = serve(path, cpu_mesh(4, 2), batch=4, kv_quant=True)
    assert got == single["int8"] and stats.requests == len(PROMPTS)


def test_flagship_combo_matches_single_int8(path, single):
    """dp x tp + int8 cache + fused q|k|v and gate|up in one server, as
    the JAX suite's flagship test: the one-device int8 server's texts; the
    host weights are dropped."""
    got, _, srv = serve(path, cpu_mesh(4, 2), batch=4, kv_quant=True,
                        fuse=True)
    assert srv.model.weights is None
    assert srv.grid[0][0].layers.wqkv is not None
    assert got == single["int8"]


def test_fused_matches_jax_and_single(path, single):
    got, stats, _ = serve(path, cpu_mesh(4, 2), batch=4, fuse=True)
    assert got == single["bf16"] and stats.steps > 0
    assert got == jax_serve(path, jmake_mesh(tp=2, dp=4), batch=4,
                            fuse=True)


def test_non_greedy_runs_finish_and_repeat(path):
    cfg = SamplerConfig(temperature=0.8, seed=7)
    runs = [serve(path, cpu_mesh(4, 2), batch=4, n=5, prompts=PROMPTS[:3],
                  cfg=cfg)[0] for _ in range(2)]
    assert runs[0] == runs[1] and all(runs[0])


def test_spec_on_a_dp_mesh_matches_single(path, single):
    """Speculative serving on a dp mesh: the sharded draft and verify
    steps give the one-device spec-off server's greedy texts."""
    got, stats, _ = serve(path, cpu_mesh(2, 1), spec_k=2,
                          spec_draft_layers=2)
    assert got == single["bf16"]
    assert stats.spec_drafted > 0 and stats.draft_steps > 0


def test_sampled_spec_on_a_dp_mesh_finishes(path):
    cfg = SamplerConfig(temperature=0.9, seed=5)
    got, stats, _ = serve(path, cpu_mesh(2, 1), prompts=PROMPTS[:3], cfg=cfg,
                          spec_k=2, spec_draft_layers=2)
    assert all(got) and stats.spec_drafted > 0


def test_prefix_cache_on_a_mesh_matches_single(path, single):
    """The prefix cache keeps each admission's per-shard caches; a prompt
    sharing a long prefix with an earlier one reuses them."""
    prompts = [PROMPTS[2] * 3 + p for p in PROMPTS[:3]]
    want, _, _ = serve(path, prompts=prompts)
    got, stats, _ = serve(path, cpu_mesh(2, 2), prompts=prompts,
                          prefix_cache=4)
    assert got == want and stats.prefix_hits >= 1


@pytest.mark.parametrize("mesh", [object(), (("cpu",),)],
                         ids=["object", "tuple"])
def test_a_value_that_is_not_a_mesh_is_refused(path, mesh):
    with pytest.raises(TypeError, match="make_mesh"):
        BatchServer(load_model(path, device="cpu"), mesh=mesh)


def test_batch_that_does_not_divide_over_dp_is_refused(path):
    with pytest.raises(ValueError, match="does not divide over dp=4"):
        BatchServer(load_model(path, device="cpu"), batch_size=6,
                    mesh=cpu_mesh(4, 1))


def test_groups_share_the_weights_on_one_device(path):
    _, _, srv = serve(path, cpu_mesh(2, 2), batch=2, n=2,
                      prompts=PROMPTS[:1])
    assert srv.grid[0][0] is srv.grid[1][0]
    assert srv._attn_ladder == []
    assert np.all([w is not None for row in srv.grid for w in row])


def test_moe_serves_on_a_dp_mesh_and_refuses_tp(tmp_path):
    """DP replicates a mixture-of-experts model (the one-device server's
    texts); a tp axis is refused with the JAX message (item 14c shards
    the experts)."""
    moe = write_model(str(tmp_path / "moe_q8.gguf"), "moe", "q8_0", seed=5)
    want, _, _ = serve(moe, prompts=PROMPTS[:4], n=5)
    got, _, _ = serve(moe, cpu_mesh(2, 1), prompts=PROMPTS[:4], n=5)
    assert got == want
    with pytest.raises(NotImplementedError, match="shard the experts"):
        BatchServer(load_model(moe, device="cpu"), mesh=cpu_mesh(1, 2))
