"""Whether one CUDA graph capture can span two cards, through PyTorch.

The port's mesh paths launch every wrapper on its tensor's card's current
stream. A capture on the first card sees work on a second card only if that
card's stream joins the capture through an event recorded on the capturing
stream, and rejoins it through an event recorded there. This probe builds
the smallest program of that shape on cuda:0 and cuda:1:

    a = x0 * 2                (a kernel on cuda:0, the capturing stream)
    b = a.to(cuda:1)          (a cross-card copy on cuda:1's joined stream)
    c = b * w1 + 1            (a kernel on cuda:1, its output allocated there)
    out = c.to(cuda:0) + x0   (back on the capturing stream)

in three variants: "plain", the capture as models/graphs.py makes it;
"pool", with cuda:1's allocations inside the capture routed to a
torch.cuda.MemPool of their own (torch.cuda.use_mem_pool), as the capture
routes cuda:0's to the graph's pool; "pool_warm", the same after one
eager run routed to that pool, so the capture takes cached blocks and
allocates nothing new on cuda:1. Each variant runs in a process of its
own (a failed capture can abort the process). For each it checks, each
step reported on its own:

  * capture: capture_begin .. capture_end on cuda:0 with cuda:1's stream
    forked and joined by events;
  * replay: a replay equals the eager program bit for bit, and again after
    x0 is changed in place (the graph reads its input's address);
  * pool: the graph's cuda:1 intermediate is not handed to the next
    allocations on cuda:1. The caching allocator gives a capture a private
    pool on the capturing card only; a block that a capture took from
    cuda:1's ordinary pool goes back to it when the capture frees it, and
    a replay would then write into whatever took it next. The probe
    allocates tensors of c's size on cuda:1 after the capture, fills them
    with a sentinel, replays, and checks that they still hold it.

A variant "spans cards" when every check holds. Each step's error, if
any, is reported; nothing is retried. Run on a host with two cards or
more:

    python3 experiments/mesh_capture.py

It prints one JSON line and writes it to chiprun_out/mesh_capture.json.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys

import torch

N = 1 << 20            # elements of each tensor
SENTINEL = 12345.0
VARIANTS = ("plain", "pool", "pool_warm")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120).stdout.strip()
    return out.splitlines()[0] if out else torch.cuda.get_device_name(0)


def program(x0, w1, s1, pool=None):
    """The probe's program on the current stream of cuda:0, with cuda:1's
    work on s1 forked from it and joined back by events; pool: a MemPool
    that cuda:1's allocations are routed to."""
    d0, d1 = x0.device, w1.device
    s0 = torch.cuda.current_stream(d0)
    a = x0 * 2
    fork = torch.cuda.Event()
    fork.record(s0)
    routed = (torch.cuda.use_mem_pool(pool, d1) if pool is not None
              else contextlib.nullcontext())
    with torch.cuda.device(d1), torch.cuda.stream(s1), routed:
        s1.wait_event(fork)
        b = a.to(d1, non_blocking=True)
        c = b * w1 + 1
        join = torch.cuda.Event()
        join.record(s1)
    s0.wait_event(join)
    return c.to(d0, non_blocking=True) + x0, c


def variant(name: str) -> dict:
    """One variant's checks (the module docstring)."""
    use_pool = name != "plain"
    out = {}
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    g = torch.Generator(device=d0).manual_seed(0)
    x0 = torch.randn(N, device=d0, generator=g)
    w1 = torch.randn(N, generator=torch.Generator().manual_seed(1)).to(d1)
    s0 = torch.cuda.Stream(d0)
    s1 = torch.cuda.Stream(d1)
    pool = torch.cuda.MemPool() if use_pool else None
    with torch.cuda.stream(s0):
        want, _ = program(x0, w1, s1)        # the eager program, warm
        if name == "pool_warm":
            program(x0, w1, s1, pool)        # fills the pool's cache
    torch.cuda.synchronize(d0)
    torch.cuda.synchronize(d1)
    graph = torch.cuda.CUDAGraph()
    step = "capture"
    try:
        with torch.cuda.device(d0), torch.cuda.stream(s0):
            graph.capture_begin()
            try:
                static, c_static = program(x0, w1, s1, pool)
            finally:
                graph.capture_end()
        out["capture"] = "ok"
        step = "replay"
        graph.replay()
        torch.cuda.synchronize(d0)
        out["replay_bit_equal"] = bool(torch.equal(static, want))
        x0.mul_(-0.5)
        with torch.cuda.stream(s0):
            want2, _ = program(x0, w1, s1)
        torch.cuda.synchronize(d0)
        graph.replay()
        torch.cuda.synchronize(d0)
        out["replay_after_input_change_bit_equal"] = bool(
            torch.equal(static, want2))
        step = "pool"
        ptr = c_static.data_ptr()
        del c_static
        held = [torch.full((N,), SENTINEL, device=d1) for _ in range(4)]
        torch.cuda.synchronize(d1)
        out["allocation_took_the_graphs_block"] = any(
            t.data_ptr() == ptr for t in held)
        graph.replay()
        torch.cuda.synchronize(d0)
        torch.cuda.synchronize(d1)
        out["sentinel_intact_after_replay"] = all(
            bool((t == SENTINEL).all()) for t in held)
    except Exception as e:  # each step's failure is the probe's result
        out[step + "_error"] = f"{type(e).__name__}: {e}"[:600]
    out["result"] = ("spans cards" if out.get("replay_bit_equal")
                     and out.get("replay_after_input_change_bit_equal")
                     and out.get("sentinel_intact_after_replay")
                     else "does not span cards")
    print(json.dumps({name: out}), flush=True)
    return out


def main() -> int:
    out = {"cards": torch.cuda.device_count() if torch.cuda.is_available()
           else 0, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if out["cards"] < 2:
        out["result"] = "needs two cards"
        print(json.dumps(out))
        return 0
    out["card"] = card()
    for name in VARIANTS:
        r = subprocess.run([sys.executable, __file__, name],
                           capture_output=True, text=True, timeout=240)
        got = [json.loads(x)[name] for x in r.stdout.splitlines()
               if x.startswith(f'{{"{name}"')]
        out[name] = got[0] if got else {
            "result": "does not span cards", "exit_code": r.returncode,
            "stderr": r.stderr.strip()[-600:]}
        if got and r.returncode:
            out[name]["exit_code"] = r.returncode
            out[name]["stderr"] = r.stderr.strip()[:600]
    out["result"] = ("spans cards" if any(
        out[name]["result"] == "spans cards" for name in VARIANTS)
        else "does not span cards")
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "mesh_capture.json"), "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        variant(sys.argv[1])
        sys.exit(0)
    sys.exit(main())
