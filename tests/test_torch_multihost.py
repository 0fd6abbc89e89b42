"""Port parity for the multi-process runtime and the (dp, tp) mesh
(parallel/multihost.py) on the CPU: make_mesh infers and refuses as the JAX
package's make_mesh does on the conftest's 8 CPU devices, and two
processes joined over gloo (each spawned with a free port and a timeout of
its own) serve as one program:

  * a TP forward with one shard in each process is bit-equal to the
    one-process forward(tp=) over the same two shards (the partials are
    all-gathered and summed in shard order in both processes);
  * the batch server at dp = 4 x tp = 2, with dp crossing the processes
    (four CPU positions in each), prints in both processes the texts of
    the one-process sharded server, greedy and at temperature 0.7 (each
    request's stream is keyed by (seed, request id), and both processes
    sample the same gathered logits), and so does a (1, 2) mesh whose tp
    row crosses them: equality, no tolerance;
  * with the backend query patched to NCCL (gloo carries the collectives)
    and a graph double that runs the program at capture and at each
    replay, the (1, 2) server captures its row: both processes issue the
    same collectives in the same order through warm-up, capture and
    replay, every collective inside a capture is on the row's group, and
    the gather of the logits over the world stays outside the graphs.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from ntransformer_tpu.parallel.multihost import make_mesh as jmake_mesh
from ntransformer_tpu_torch.inference.sampler import SamplerConfig
from ntransformer_tpu_torch.inference.serve import BatchServer, Request
from ntransformer_tpu_torch.models.llama import forward
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.parallel import multihost
from ntransformer_tpu_torch.parallel.multihost import Row, make_mesh
from ntransformer_tpu_torch.parallel.tp import (make_tp_kv, make_tp_mesh,
                                                shard_weights)
from test_torch_model import one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PROMPTS = ["alpha beta", "gamma", "delta epsilon", "zeta"]
TP_TOKENS = ([1, 5, 9, 3, 44, 2], [7])

WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    rank, port, gguf, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    temps = [float(t) for t in sys.argv[5].split(",")]
    import torch
    torch.set_num_threads(1)
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.llama import forward
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.parallel.multihost import (initialize,
                                                           make_mesh,
                                                           shutdown)
    from ntransformer_tpu_torch.parallel.tp import make_tp_kv, shard_weights
    initialize("127.0.0.1:" + port, 2, rank, backend="gloo")
    model = load_model(gguf, device="cpu")
    # one shard in each process: the row's psums cross the processes
    row = make_mesh(tp=2, devices=["cpu"]).row(0)
    assert row.owned == [rank]
    shards = shard_weights(model.weights, row, model.arch)
    kv = make_tp_kv(model.arch, row)
    logits = []
    pos = 0
    for toks in {tp_tokens!r}:
        lg, kv, _ = forward(model.arch, shards, kv, torch.tensor(toks), pos,
                            tp=row)
        logits.append(lg)
        pos += len(toks)
    torch.save(logits, out + ".tp%d.pt" % rank)
    mesh = make_mesh(tp=2, dp=4, devices=["cpu"] * 4)
    assert mesh.ranks[0] == (0, 0) and mesh.ranks[3] == (1, 1)
    runs = [(temp, mesh) for temp in temps]
    # and a tp row across the processes: the step's and the prefill's
    # sums cross them
    runs.append(("tp", make_mesh(tp=2, dp=1, devices=["cpu"])))
    for tag, mesh in runs:
        temp = 0.0 if tag == "tp" else tag
        srv = BatchServer(load_model(gguf, device="cpu"), batch_size=4,
                          mesh=mesh,
                          sampler_cfg=SamplerConfig(temperature=temp))
        reqs = [Request(prompt=p, max_tokens=5) for p in {prompts!r}]
        stats = srv.run(reqs)
        assert stats.requests == 4 and stats.steps > 0
        for r in reqs:
            print("SRV-TEXT %s %d %d %r" % (tag, rank, r.request_id, r.text),
                  flush=True)
    shutdown()
    print("SRV-OK", rank, flush=True)
""").format(repo=REPO, tp_tokens=TP_TOKENS, prompts=PROMPTS)


RECORD_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r})
    rank, port, gguf, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    import torch
    torch.set_num_threads(1)
    from ntransformer_tpu_torch.inference import serve as pserve
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models import graphs
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.parallel import multihost
    multihost.initialize("127.0.0.1:" + port, 2, rank, backend="gloo")
    # the backend query says NCCL, so the server captures its row; gloo
    # carries the collectives here
    multihost.backend_of = lambda group=None: "nccl"
    pserve._graphed = lambda device: True
    records, capturing = [], [False]

    class Graph:
        # the program at capture and again at each replay, its output
        # written in place
        def capture(self, fn, pool=None):
            records.append(["capture"])
            self.fn, capturing[0] = fn, True
            try:
                self.out = fn()
            finally:
                capturing[0] = False
            return self.out

        def replay(self):
            records.append(["replay"])
            self.out.copy_(self.fn())

        def pool(self):
            return None
    graphs.GRAPH = Graph
    mesh = multihost.make_mesh(tp=2, dp=1, devices=["cpu"])
    row = mesh.row(0)
    assert row.owned == [rank] and row.group is not None
    broadcast = multihost.broadcast

    def recorded(t, src, group=None):
        records.append(["row" if group is row.group else
                        "world" if group is None else "other", src,
                        list(t.shape), str(t.dtype), capturing[0]])
        return broadcast(t, src, group)
    multihost.broadcast = recorded
    srv = BatchServer(load_model(gguf, device="cpu"), batch_size=4,
                      mesh=mesh, sampler_cfg=SamplerConfig(temperature=0.0))
    reqs = [Request(prompt=p, max_tokens=5) for p in {prompts!r}]
    srv.run(reqs)
    with open(out + ".rec%d.json" % rank, "w") as f:
        json.dump({{"records": records, "texts": [r.text for r in reqs],
                   "replays": sum(sum(g.replays.values())
                                  for g in srv._ggraphs),
                   "admission_replays": sum(srv._adm[1].replays.values())}},
                  f)
    assert srv._ggraphs[0].captures > 0 and srv._adm[1].captures > 0
    multihost.shutdown()
    # shutdown drops the captured programs that hold the row's collectives
    # before it destroys the group (NCCL would wait for them)
    assert srv._ggraphs[0].captures == 0 and srv._adm[1].captures == 0
    print("REC-OK", rank, flush=True)
""").format(repo=REPO, prompts=PROMPTS)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(script: str, args: list) -> list:
    """script in two processes (argv: rank, a free port, *args) on the
    CPU, each with a 240 s timeout; both are stopped on the way out.
    Returns their output."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i), port,
                               *args],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=240)
            outs.append(o.decode())
    finally:
        for p in procs:
            p.kill()
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{o[-2000:]}"
    return outs


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("mh") / "mh_srv.gguf"),
                       "tiny", "q8_0", seed=77)


@pytest.fixture(scope="module")
def two_processes(gguf):
    """Both workers' output (one run: the TP forward, then greedy and
    sampled serving); each process has a 240 s timeout."""
    out = gguf + ".out"
    outs = _run_pair(WORKER, [gguf, out, "0.0,0.7"])
    for i, o in enumerate(outs):
        assert f"SRV-OK {i}" in o
    return out, outs


@pytest.fixture(scope="module")
def recorded_pair(gguf):
    """Both RECORD_WORKER processes' records, texts and replay counts."""
    out = gguf + ".rec"
    outs = _run_pair(RECORD_WORKER, [gguf, out])
    for i, o in enumerate(outs):
        assert f"REC-OK {i}" in o
    return [json.load(open(f"{out}.rec{i}.json")) for i in range(2)]


def test_captured_row_collectives_pair_off(gguf, recorded_pair):
    """A (1, 2) row across two processes on its graph path (the backend
    query patched to NCCL, a graph double): both processes capture the
    same keys and issue the same collectives in the same order through
    warm-up, capture and replay (a captured collective and an uncaptured
    one never meet on one communicator); every collective inside a
    capture is a broadcast over the row's group, and every gather of the
    logits over the world is issued outside a capture; both print the
    one-process server's texts; multihost.shutdown dropped both servers'
    captured programs before it destroyed the group."""
    a, b = recorded_pair
    assert a["records"] == b["records"]
    recs = [r for r in a["records"] if len(r) > 1]
    captured = [r for r in recs if r[4]]
    world = [r for r in recs if r[0] == "world"]
    assert captured and all(r[0] == "row" for r in captured)
    assert world and not any(r[4] for r in world)
    assert {r[0] for r in recs} == {"row", "world"}
    assert a["replays"] > 0 and a["admission_replays"] > 0
    assert a["replays"] == b["replays"]
    srv = BatchServer(load_model(gguf, device="cpu"), batch_size=4,
                      mesh=make_mesh(tp=2, dp=1, devices=["cpu"] * 2),
                      sampler_cfg=SamplerConfig(temperature=0.0))
    reqs = [Request(prompt=p, max_tokens=5) for p in PROMPTS]
    srv.run(reqs)
    assert a["texts"] == b["texts"] == [r.text for r in reqs]


def test_two_process_tp_forward_is_bit_equal(gguf, two_processes):
    out, _ = two_processes
    model = load_model(gguf, device="cpu")
    mesh = make_tp_mesh(2, ["cpu"] * 2)
    shards = shard_weights(model.weights, mesh, model.arch)
    kv = make_tp_kv(model.arch, mesh)
    want, pos = [], 0
    for toks in TP_TOKENS:
        lg, kv, _ = forward(model.arch, shards, kv, torch.tensor(toks), pos,
                            tp=mesh)
        want.append(lg)
        pos += len(toks)
    for rank in (0, 1):
        got = torch.load(f"{out}.tp{rank}.pt")
        assert all(torch.equal(a, b) for a, b in zip(got, want)), rank


@pytest.mark.parametrize("tag,dp", [(0.0, 4), (0.7, 4), ("tp", 1)],
                         ids=["greedy", "sampled", "tp-across"])
def test_two_process_batch_server(gguf, two_processes, tag, dp):
    """Continuous batching across two processes: both print the texts of
    the one-process server over the same mesh: (4, 2) with dp crossing the
    processes (greedy and sampled), and (1, 2) with the tp row across
    them (greedy)."""
    _, outs = two_processes
    temp = 0.0 if tag == "tp" else tag
    srv = BatchServer(load_model(gguf, device="cpu"), batch_size=4,
                      mesh=make_mesh(tp=2, dp=dp, devices=["cpu"] * 2 * dp),
                      sampler_cfg=SamplerConfig(temperature=temp))
    reqs = [Request(prompt=p, max_tokens=5) for p in PROMPTS]
    srv.run(reqs)
    for rank, o in enumerate(outs):
        for r in reqs:
            line = f"SRV-TEXT {tag} {rank} {r.request_id} {r.text!r}"
            assert line in o, f"process {rank}:\n{o[-2000:]}"


@pytest.mark.parametrize("tp,dp", [(2, None), (None, None), (1, 4), (2, 4),
                                   (8, 1), (2, 2)])
def test_make_mesh_infers_as_jax(tp, dp):
    """One axis given: the other covers every device; both given: a
    leading subset; dp = 1: a tp-only mesh."""
    want = jmake_mesh(tp=tp, dp=dp)
    got = make_mesh(tp=tp, dp=dp, devices=["cpu"] * 8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices[0][0] == torch.device("cpu")
    assert not got.multiprocess


@pytest.mark.parametrize("tp,dp", [(3, None), (2, 5)])
def test_make_mesh_refuses_what_jax_refuses(tp, dp):
    with pytest.raises(AssertionError):
        jmake_mesh(tp=tp, dp=dp)
    with pytest.raises(ValueError, match="n_devices"):
        make_mesh(tp=tp, dp=dp, devices=["cpu"] * 8)


def test_make_mesh_subset_refused_multiprocess(monkeypatch):
    """A leading-subset mesh could leave out every device of a process;
    across processes a mesh must cover them all. One process may take a
    subset."""
    local = [torch.device("cpu")] * 4
    monkeypatch.setattr(multihost, "_process_devices",
                        lambda devs: (0, [list(devs), list(devs)]))
    with pytest.raises(ValueError, match="multi-process"):
        make_mesh(tp=1, dp=4, devices=local)
    monkeypatch.undo()
    mesh = make_mesh(tp=1, dp=2, devices=local)
    assert mesh.shape == {"dp": 2, "tp": 1}


def test_rows_hold_their_owners():
    row = Row(["cpu", "cpu"], ranks=(0, 1), rank=1)
    assert row.owned == [1] and row.home == torch.device("cpu")
    assert multihost.owned(("cpu", "cpu")) == [0, 1]
    mesh = make_mesh(tp=2, dp=2, devices=["cpu"] * 4)
    assert mesh.row(1).owned == [0, 1] and mesh.touches(1)
    assert mesh.row(0) == (torch.device("cpu"),) * 2


def test_initialize_refuses_an_unknown_backend():
    with pytest.raises(ValueError, match="nccl"):
        multihost.initialize("127.0.0.1:1", 1, 0, backend="mpi")


def test_wall_clock_admission_is_refused_across_processes(gguf):
    """A mesh that spans processes admits by replicated state only: an
    arrival replay and the live inbox are refused with the JAX messages."""
    import queue
    import threading
    cpu = torch.device("cpu")
    mesh = multihost.Mesh(((cpu,), (cpu,)), ((0,), (1,)), rank=0)
    assert mesh.multiprocess and mesh.touches(0) and not mesh.touches(1)
    srv = BatchServer(load_model(gguf, device="cpu"), batch_size=2,
                      mesh=mesh)
    assert srv.grid[1][0] is None
    with pytest.raises(ValueError, match="arrival_s replay"):
        srv.run([Request(prompt="a", max_tokens=2, arrival_s=0.5)])
    with pytest.raises(NotImplementedError, match="run\\(\\) with the same"):
        srv.serve_forever(queue.Queue(), threading.Event())
