"""Whether a tp row whose shards span two NCCL processes replays as CUDA
graphs with its collectives inside them, and where the processes wait if
they do not.

A row across processes gathers its shards' partials and embedding slices
by one broadcast a shard over the row's process group
(parallel/multihost.gather_shards), in every layer; a (dp, tp) mesh
gathers its groups' logits over the whole world (gather_groups), outside
the graphs. Each variant runs in a fresh pair of processes, rank r owning
cuda:r, joined over NCCL at a free port, with NCCL_DEBUG=WARN, a timeout of
TIMEOUT_S each and faulthandler dumping every Python thread's stack from
DUMP_S on, so that a wait shows where both ranks stand:

  bcast_row:   a product, gather_shards over the (1, 2) mesh's row group
               (dist.new_group of both ranks) and a sum, captured into one
               CUDA graph on a capture stream after two uncaptured calls,
               then REPLAYS replays on new inputs, each against the
               uncaptured program, with an uncaptured broadcast over the
               world between them (two communicators over the same two
               cards); then a second capture after those;
  bcast_world: the same with the row's group the world's;
  step:        repolm512's batched decode step over that row (B = 4):
               dp.group_graphs' StepGraphs, REPLAYS teacher-forced steps
               replayed against the uncaptured steps on a twin cache, bit
               for bit, the logits gathered over the world outside;
  server:      repolm512's BatchServer over that (1, 2) mesh (greedy, 16
               tokens, chip_smoke.py's prompts), its texts against the
               one-process server over cuda:0 and cuda:1.

Every process writes each collective it issues through
parallel/multihost.broadcast (its group, src, shape, dtype, and whether a
capture was under way) and each capture's start and end to
chiprun_out/nccl_row/<variant>.rank<r>.log, a line as it happens; the
parent reports both logs' lengths, their first difference and their last
lines. The first variant that fails is run again with NCCL's graph buffer
registration off (NCCL_GRAPH_REGISTER=0) and with its connections made at
init (NCCL_RUNTIME_CONNECT=0), to tell those causes apart.

Run on a host with two cards or more (with fewer it prints so):

    python3 experiments/nccl_row.py [VARIANT ...]

It prints one JSON line and writes it to chiprun_out/nccl_row.json.
"""
from __future__ import annotations

import faulthandler
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPOLM = os.path.join(HERE, "models", "repolm512_q8.gguf")
OUT = os.path.join(HERE, "chiprun_out", "nccl_row")
VARIANTS = ("bcast_row", "step", "server", "bcast_world")
RETRIES = ({"NCCL_GRAPH_REGISTER": "0"}, {"NCCL_RUNTIME_CONNECT": "0"})
TIMEOUT_S = 60
DUMP_S = 30
REPLAYS = 8


class Log:
    """This process's log of collectives and captures, a line each."""

    def __init__(self, path: str):
        self.f = open(path, "w", buffering=1)

    def line(self, *parts) -> None:
        self.f.write(" ".join(str(p) for p in parts) + "\n")


def instrument(log: Log) -> None:
    """Route multihost.broadcast and the graph class through the log."""
    import torch
    import torch.distributed as dist
    from ntransformer_tpu_torch.models import graphs
    from ntransformer_tpu_torch.parallel import multihost
    orig = multihost.broadcast
    names: dict = {}

    def broadcast(t, src, group=None):
        if group is None or group is dist.group.WORLD:
            name = "world"
        else:   # the groups in the order this process first uses them
            name = names.setdefault(id(group), f"group{len(names)}")
        log.line("bcast", name, src, tuple(t.shape), str(t.dtype),
                 "captured" if torch.cuda.is_current_stream_capturing()
                 else "eager")
        return orig(t, src, group)
    multihost.broadcast = broadcast

    class Logged(graphs.CudaGraph):
        def capture(self, fn, pool=None):
            log.line("capture_begin")
            out = super().capture(fn, pool)
            log.line("capture_end")
            return out
    graphs.GRAPH = Logged


def worker(variant: str, rank: int, port: str) -> None:
    faulthandler.dump_traceback_later(DUMP_S, repeat=True)
    sys.path.insert(0, HERE)
    import torch
    from ntransformer_tpu_torch.parallel import multihost
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    os.makedirs(OUT, exist_ok=True)
    log = Log(os.path.join(OUT, f"{variant}.rank{rank}.log"))
    instrument(log)
    multihost.initialize("127.0.0.1:" + port, 2, rank, backend="nccl")
    mesh = multihost.make_mesh(tp=2, dp=1, devices=[dev])
    out = {"rank": rank}
    print("STAGE start", flush=True)
    if variant.startswith("bcast"):
        out.update(bcast(torch, multihost, mesh, dev, variant))
    elif variant == "step":
        out.update(step(torch, mesh, dev))
    else:
        out.update(server(mesh))
    print("STAGE done", flush=True)
    multihost.shutdown()
    print("NCCL-ROW " + json.dumps(out), flush=True)


def bcast(torch, multihost, mesh, dev, variant) -> dict:
    import torch.distributed as dist
    from ntransformer_tpu_torch.models import graphs
    row = mesh.row(0)
    if variant == "bcast_world":
        row = multihost.Row(row, row.ranks, row.rank, dist.group.WORLD)
    x = torch.zeros(1 << 16, device=dev)
    stream = torch.cuda.Stream(dev)

    def program():
        y = x * (row.rank + 2)
        parts = multihost.gather_shards(
            [y if s == row.rank else None for s in range(2)], row)
        return parts[0] + parts[1] * 3

    def fill(i):
        x.copy_(torch.arange(x.numel(), device=dev, dtype=torch.float32)
                * (i + 1) + row.rank)
    res = {}
    with graphs._on_stream(dev, stream):
        for i in range(2):
            fill(i)
            program()
        print("STAGE capture", flush=True)
        g = graphs.GRAPH()
        static = g.capture(program)
    print("STAGE replay", flush=True)
    ok = []
    for i in range(REPLAYS):
        fill(10 + i)
        g.replay()
        got = static.clone()
        ok.append(bool(torch.equal(got, program())))
        w = torch.full((8,), float(i), device=dev)
        multihost.broadcast(w, 0)
        torch.cuda.synchronize()
    res["replays_bit_equal"] = ok
    print("STAGE second capture", flush=True)
    with graphs._on_stream(dev, stream):
        program()
        g2 = graphs.GRAPH()
        static2 = g2.capture(program)
    fill(99)
    g2.replay()
    res["second_bit_equal"] = bool(torch.equal(static2.clone(), program()))
    torch.cuda.synchronize()
    return res


def step(torch, mesh, dev) -> dict:
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.parallel import dp
    m = load_model(REPOLM, device=dev)
    a, b_n = m.arch, 4
    grid_w, _ = dp.shard_server_state(mesh, a, m.weights, b_n,
                                      with_kv=False)
    ref = dp.make_server_kv(mesh, a, b_n)
    kv = dp.make_server_kv(mesh, a, b_n)
    print("STAGE graphs", flush=True)
    graphs = dp.group_graphs(mesh, a, grid_w, kv)
    plain = dp.make_batched_decode_sharded(mesh, a)
    replayed = dp.make_batched_decode_sharded(mesh, a, graphs=graphs)
    pos = torch.tensor([3, 7, 11, 0], device=dev)
    act = torch.ones(b_n, dtype=torch.bool, device=dev)
    tok = torch.tensor([5, 9, 13, 17], device=dev)
    ok = []
    for i in range(REPLAYS):
        print(f"STAGE step {i}", flush=True)
        want, ref = plain(grid_w, ref, tok, pos + i, act)
        got, kv = replayed(grid_w, kv, tok, pos + i, act)
        ok.append(bool(torch.equal(want, got)))
        tok = torch.argmax(want, -1)
    g = graphs[0]
    return {"steps_bit_equal": ok, "captures": g.captures,
            "replays": sum(g.replays.values())}


def prompts() -> list:
    sys.path.insert(0, HERE)
    import chip_smoke
    from ntransformer_tpu_torch.models.loader import load_model
    return [p.replace("\n", " ") for p in chip_smoke.serve_prompts(
        load_model(REPOLM, device="cpu").tokenizer)]


def serve(mesh, ps) -> tuple:
    from ntransformer_tpu_torch.inference.sampler import SamplerConfig
    from ntransformer_tpu_torch.inference.serve import BatchServer, Request
    from ntransformer_tpu_torch.models.loader import load_model
    srv = BatchServer(load_model(REPOLM, device="cpu"), batch_size=4,
                      mesh=mesh, sampler_cfg=SamplerConfig(temperature=0.0))
    reqs = [Request(prompt=p, max_tokens=16) for p in ps]
    srv.run(reqs)
    return [r.text for r in reqs], srv


def server(mesh) -> dict:
    texts, srv = serve(mesh, prompts())
    gs = [g for g in srv._ggraphs or [] if g is not None]
    return {"texts": texts, "captured": srv._ggraphs is not None,
            "replays": sum(sum(g.replays.values()) for g in gs),
            "admission_replays": (sum(srv._adm[1].replays.values())
                                  if srv._adm is not None else 0)}


def first_difference(a: list, b: list):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return [i, x, y]
    return None if len(a) == len(b) else [min(len(a), len(b)), None, None]


def run(variant: str, env_extra: dict) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, NCCL_DEBUG="WARN", **env_extra)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", variant,
         str(r), port], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=HERE, env=env) for r in range(2)]
    outs = [None, None]
    end = time.monotonic() + TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            try:
                outs[r], _ = p.communicate(
                    timeout=max(1.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r, p in enumerate(procs):
            if outs[r] is None:
                outs[r], _ = p.communicate()
    res = {"env": env_extra, "seconds": time.perf_counter() - t0,
           "exit_codes": [p.returncode for p in procs]}
    logs = []
    for r in range(2):
        path = os.path.join(OUT, f"{variant}.rank{r}.log")
        logs.append(open(path).read().splitlines()
                    if os.path.exists(path) else [])
        with open(os.path.join(OUT, f"{variant}{'_retry' if env_extra else ''}"
                               f".rank{r}.out"), "w") as f:
            f.write(outs[r])
    res["log_lines"] = [len(x) for x in logs]
    res["first_log_difference"] = first_difference(*logs)
    res["log_tails"] = [x[-3:] for x in logs]
    got = [json.loads(ln.split(" ", 1)[1]) for o in outs
           for ln in o.splitlines() if ln.startswith("NCCL-ROW ")]
    res["results"] = got
    res["stages"] = [[ln for ln in o.splitlines()
                      if ln.startswith("STAGE")][-2:] for o in outs]
    if any(res["exit_codes"]) or len(got) < 2:
        res["tails"] = [o[-3000:] for o in outs]
    return res


def verdict(variant: str, res: dict, want_texts) -> bool:
    got = res["results"]
    if any(res["exit_codes"]) or len(got) < 2:
        return False
    if variant.startswith("bcast"):
        return all(all(g["replays_bit_equal"]) and g["second_bit_equal"]
                   for g in got)
    if variant == "step":
        return all(all(g["steps_bit_equal"]) and g["replays"] > 0
                   for g in got)
    return all(g["texts"] == want_texts and g["replays"] > 0
               and g["admission_replays"] > 0 for g in got)


def main(names) -> int:
    sys.path.insert(0, HERE)
    import torch
    out = {"cards": torch.cuda.device_count(), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if out["cards"] < 2:
        out["result"] = "needs two cards"
        print(json.dumps(out))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120)
    out["card"] = smi.stdout.strip().splitlines()[0]
    v = torch.cuda.nccl.version()
    out["nccl"] = ".".join(map(str, v)) if isinstance(v, tuple) else str(v)
    from concurrent.futures import ThreadPoolExecutor
    from ntransformer_tpu_torch.ops.cuda import (attention, batched_attention,
                                                 build, kv_update, matmul)
    with ThreadPoolExecutor(4) as ex:  # before any worker: one build each
        list(ex.map(build.build, [m.NAME for m in (
            matmul, attention, batched_attention, kv_update)]))
    want = None
    if "server" in names:
        from ntransformer_tpu_torch.parallel.multihost import make_mesh
        want, _ = serve(make_mesh(tp=2, dp=1, devices=["cuda:0", "cuda:1"]),
                        prompts())
    os.makedirs(OUT, exist_ok=True)
    retried = False
    for name in names:
        res = run(name, {})
        res["ok"] = verdict(name, res, want)
        if not res["ok"] and not retried:
            retried = True
            res["retries"] = []
            for extra in RETRIES:
                r = run(name, extra)
                r["ok"] = verdict(name, r, want)
                res["retries"].append(r)
        out[name] = res
        print(json.dumps({name: res})[:4000], flush=True)
    line = json.dumps(out)
    with open(os.path.join(HERE, "chiprun_out", "nccl_row.json"), "w") as f:
        f.write(line + "\n")
    print(line[-20000:], flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
