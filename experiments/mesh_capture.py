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

A variant "spans cards" when every check holds.

"per_card" is the probe's program as one graph a card, each captured on
its card's stream into that card's own pool, the two captures under way
together. A hand-off is made inside the graphs: the source card's graph
copies its tensor into a buffer on the other card (a cudaMemcpyAsync on
its own stream, a memcpy node) and records an external event
(torch.cuda.Event(external=True): an event record node); the other
card's graph waits for it (an event wait node). Besides the checks above
it asks what such a wait node waits for at replay N: before a replay the
source card's stream is stalled by a long kernel, so that its graph starts
late, the graphs launched in both orders, and the replay's output is held
against the eager program on an input changed since the last replay. A
wait that resolves at launch, to the record last enqueued, reads the last
replay's data; "stalled_source_bit_equal" tells. "per_stream" is the same
on one card: two streams of cuda:0 stand for the two cards, so the wait
nodes' semantics can be read on a one-card host.

"segments" is the form models/graphs.py keeps (CardGraph): one graph a
card for each stretch up to a hand-off (ops/layers.handoff), an external
event recorded at its end, the receiving card's graph waiting for it and
copying the tensor in (a memcpy node that reads the other card), the
graphs launched from the host in the order their stretches ended; the
same capture, replay, stalled-source and pool checks. "tp_pull" and
"tp_push" capture one layer of repolm512's TP forward over two cards as
a CardGraph (kernels off), the second with each copy made by the source
card into the receiver's memory before its event, and replay it on other
tokens than the capture's: each hand-off's buffer and the logits against
the uncaptured forward.

"pp_cards" is the pipeline step that parallel/pp.py keeps on the host
over several cards: repolm512's six layers at 2 stages and at 3 (one a
card, 2 microbatches of 2 slots, kernels on), captured as a CardGraph by
pp.captured_pp_step (the capture make_pp_decode makes on one card), and
PP_STEPS steps each replayed against pp_decode_step run uncaptured on a
twin state with the same inputs, the last steps after a long kernel on
the second card's stream. The uncaptured step keeps every hand-off's
value in order (a tape in ops/layers.CAPTURE's place: a plain .to that
records), which is the order of the CardGraph's plan, so after each
replay every hand-off is held to its tape entry: the source buffer the
copy read (`first_bad_source`: the first hand-off whose source already
differs, i.e. a stretch computed it wrongly) and the copy (`first_bad_copy`:
the first whose source is right and whose copy is not). Also the logits
and, at the end, every stage's cache bytes. "pp_cards_to" is the same
with pp_decode_step's moves made by PyTorch's own .to copies (the form that
replayed other logits at (4, 2) over four cards), which the CardGraph's plan
does not see. "pp_cards_8b" is pp_cards on chip_smoke.py's synthetic 8B Q8_0
at full width cut to PP_8B_LAYERS layers, at 2 and 4 stages, B = 8 from the
cache chip_smoke.pp_prefilled fills (meshcards' cell at 32 layers);
"pp_cards_8b_off" the same with the kernels off. Each stage count runs in a
process of its own. "pp_cards_8b_probe:N" (N stages) checks the caches after
a capture with no slot active, then replays a step with every card
synchronized after each stretch, one as CardGraph.replay launches it, and
one each with a pool of its own for every stretch and with the receiver's
stretch ended after each copy, each against the uncaptured step, with where
the caches differ. "pp_split_one" runs on one card: the 8B's (2, 2) PP step
with both stages on cuda:0, captured as a run of graphs cut at every move
between stages (OneCardSplit, in each of SPLIT_FORMS) or as one graph, each
replay against the uncaptured step, with the first attention call, product
and stage output whose values differ.

Each step's error, if any, is reported; nothing is retried. Run on a host
with two cards or more (with one, only "per_stream" runs):

    python3 experiments/mesh_capture.py [VARIANT]

It prints one JSON line and writes it to chiprun_out/mesh_capture.json.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys

import torch

N = 1 << 20            # elements of each tensor
SENTINEL = 12345.0
VARIANTS = ("plain", "pool", "pool_warm", "per_card", "segments",
            "tp_pull", "tp_push", "pp_cards", "pp_cards_to", "pp_cards_8b",
            "pp_cards_8b_off")
ONE_CARD = ("per_stream",)
STALL = 200_000_000     # cycles of torch.cuda._sleep: ~0.1 s


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


def _memcpy(dst, src, stream) -> None:
    """dst <- src (both dense, one size) by cuMemcpyAsync on `stream`,
    which infers a card-to-card copy from the addresses: inside a capture a
    memcpy node of that stream's graph."""
    lib = ctypes.CDLL("libcuda.so.1")
    with torch.cuda.device(stream.device):
        rc = lib.cuMemcpyAsync(ctypes.c_uint64(dst.data_ptr()),
                               ctypes.c_uint64(src.data_ptr()),
                               ctypes.c_size_t(src.numel()
                                               * src.element_size()),
                               ctypes.c_void_p(stream.cuda_stream))
    if rc:
        raise RuntimeError(f"cuMemcpyAsync returned CUresult {rc}")


def eager(x0, w1):
    """The probe's program with PyTorch's own cross-card copies."""
    return ((x0 * 2).to(w1.device) * w1 + 1).to(x0.device) + x0


def joined_program(x0, w1, s0, s1, buf1, buf0, ev_a, ev_c):
    """The program as each card's launches on its stream, the hand-offs a
    copy on the source card's stream into a buffer on the other card and
    an external event that the other card's stream waits for."""
    with torch.cuda.stream(s0):
        a = x0 * 2
        _memcpy(buf1, a, s0)
        ev_a.record(s0)
    with torch.cuda.stream(s1):
        s1.wait_event(ev_a)
        c = buf1 * w1 + 1
        _memcpy(buf0, c, s1)
        ev_c.record(s1)
    with torch.cuda.stream(s0):
        s0.wait_event(ev_c)
        return buf0 + x0, c


def _sync(*devs) -> None:
    for d in devs:
        torch.cuda.synchronize(d)


def _replay_checks(out, x0, w1, launch, streams) -> dict:
    """Replays against the eager program, each on an input changed since
    the last: in capture order, then with each card's stream stalled
    before the replay (its graph starts ~0.1 s late) in both launch
    orders. launch(first, stall) launches the graphs, card `first`'s
    first, after a long kernel on card `stall`'s stream (None: none)."""
    res = {}
    d0, d1 = x0.device, w1.device
    for name, first, stall in (("replay_bit_equal", 0, None),
                               ("replay_stalled_card1_bit_equal", 0, 1),
                               ("replay_stalled_card0_bit_equal", 1, 0),
                               ("replay_stalled_card1_card1_first", 1, 1),
                               ("replay_stalled_card0_card0_first", 0, 0)):
        x0.mul_(-0.5)
        want = eager(x0, w1)
        _sync(d0, d1)
        if stall is not None:
            with torch.cuda.stream(streams[stall]):
                torch.cuda._sleep(STALL)
        launch(first)
        _sync(d0, d1)
        res[name] = bool(torch.equal(out, want))
    res["stalled_source_bit_equal"] = all(
        v for k, v in res.items() if k.startswith("replay_stalled"))
    return res


def _pool_check(c_static, d1) -> tuple:
    """Whether the graphs' cuda:1 intermediate stays out of the next
    allocations there (the module docstring's pool check); c_static is
    dropped here."""
    ptr, n = c_static.data_ptr(), c_static.numel()
    del c_static
    held = [torch.full((n,), SENTINEL, device=d1) for _ in range(4)]
    torch.cuda.synchronize(d1)
    return {"allocation_took_the_graphs_block": any(
        t.data_ptr() == ptr for t in held)}, held


def joined(name: str) -> dict:
    """per_card (cuda:0, cuda:1) or per_stream (two streams of cuda:0):
    one graph a card joined by external events inside the graphs."""
    out = {}
    d0 = torch.device("cuda", 0)
    d1 = torch.device("cuda", 1 if name == "per_card" else 0)
    if d0 != d1:
        out["peer_access"] = [torch.cuda.can_device_access_peer(0, 1),
                              torch.cuda.can_device_access_peer(1, 0)]
    g = torch.Generator(device=d0).manual_seed(0)
    x0 = torch.randn(N, device=d0, generator=g)
    w1 = torch.randn(N, generator=torch.Generator().manual_seed(1)).to(d1)
    s0, s1 = torch.cuda.Stream(d0), torch.cuda.Stream(d1)
    buf1 = torch.zeros(N, device=d1)
    buf0 = torch.zeros(N, device=d0)
    ev_a = torch.cuda.Event(external=True)
    ev_c = torch.cuda.Event(external=True)
    eager(x0, w1)
    _sync(d0, d1)
    # kept uninstantiated until both captures end: CUDA refuses an
    # instantiation while another capture is under way
    g0 = torch.cuda.CUDAGraph(keep_graph=True)
    g1 = torch.cuda.CUDAGraph(keep_graph=True)
    step = "capture"
    try:
        with torch.cuda.stream(s0):
            g0.capture_begin()
        try:
            with torch.cuda.stream(s1):
                g1.capture_begin()
            try:
                static, c_static = joined_program(x0, w1, s0, s1, buf1, buf0,
                                                  ev_a, ev_c)
            finally:
                with torch.cuda.stream(s1):
                    g1.capture_end()
        finally:
            with torch.cuda.stream(s0):
                g0.capture_end()
        g0.instantiate()
        g1.instantiate()
        out["capture"] = "ok"
        step = "replay"
        graphs = ((g0, s0), (g1, s1))

        def launch(first):
            for gr, st in graphs[first:] + graphs[:first]:
                with torch.cuda.stream(st):
                    gr.replay()
        out.update(_replay_checks(static, x0, w1, launch, (s0, s1)))
        step = "pool"
        got, held = _pool_check(c_static, d1)
        out.update(got)
        launch(0)
        _sync(d0, d1)
        out["sentinel_intact_after_replay"] = all(
            bool((t == SENTINEL).all()) for t in held)
    except Exception as e:  # each step's failure is the probe's result
        out[step + "_error"] = f"{type(e).__name__}: {e}"[:600]
    out["result"] = _verdict(out)
    print(json.dumps({name: out}), flush=True)
    return out


def _verdict(out: dict) -> str:
    ok = (out.get("replay_bit_equal")
          and out.get("stalled_source_bit_equal", True)
          and out.get("sentinel_intact_after_replay"))
    return "spans cards" if ok else "does not span cards"


def segments() -> dict:
    """The probe's program through models/graphs.CardGraph, the form the
    port keeps: one graph a card a stretch between hand-offs, PyTorch's
    cross-card copies between their launches (ops/layers.handoff)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from ntransformer_tpu_torch.models import graphs
    from ntransformer_tpu_torch.ops.layers import handoff
    out = {}
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    g = torch.Generator(device=d0).manual_seed(0)
    x0 = torch.randn(N, device=d0, generator=g)
    w1 = torch.randn(N, generator=torch.Generator().manual_seed(1)).to(d1)
    cards = [d0, d1]
    streams = [torch.cuda.Stream(d) for d in cards]

    def program():
        c = handoff(x0 * 2, d1) * w1 + 1
        return handoff(c, d0) + x0, c
    with graphs._on_stream(cards, streams):
        program()
    _sync(d0, d1)
    step = "capture"
    try:
        graph = graphs.CardGraph(cards)
        with graphs._on_stream(cards, streams):
            static, c_static = graph.capture(program)
        out["capture"] = "ok"
        out["plan"] = [list(map(str, p)) for p in graph.plan]
        step = "replay"
        out.update(_replay_checks(static, x0, w1,
                                  lambda first: graph.replay(),
                                  [torch.cuda.current_stream(d)
                                   for d in cards]))
        step = "pool"
        got, held = _pool_check(c_static, d1)
        out.update(got)
        graph.replay()
        _sync(d0, d1)
        out["sentinel_intact_after_replay"] = all(
            bool((t == SENTINEL).all()) for t in held)
    except Exception as e:  # each step's failure is the probe's result
        out[step + "_error"] = f"{type(e).__name__}: {e}"[:600]
    out["result"] = _verdict(out)
    print(json.dumps({"segments": out}), flush=True)
    return out


def tp_layer(name: str) -> dict:
    """tp_pull / tp_push (the module docstring)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from ntransformer_tpu_torch.models import graphs, llama
    from ntransformer_tpu_torch.models.loader import load_model
    from ntransformer_tpu_torch.ops import linear
    from ntransformer_tpu_torch.parallel import tp as ptp
    if name == "tp_push":
        def handoff(self, t, dst):
            """The hand-off with the copy made by the source card, on its
            stream, into the receiver's memory, before the event."""
            key = (id(t), dst)
            if key in self.moved:
                return self.moved[key]
            x = t.contiguous()
            out = torch.empty_like(x, device=dst)
            with torch.cuda.device(x.device):
                rc = graphs._driver().cuMemcpyAsync(
                    ctypes.c_uint64(out.data_ptr()),
                    ctypes.c_uint64(x.data_ptr()),
                    ctypes.c_size_t(x.numel() * x.element_size()),
                    ctypes.c_void_p(torch.cuda.current_stream(
                        x.device).cuda_stream))
            if rc:
                raise RuntimeError(f"cuMemcpyAsync returned CUresult {rc}")
            ev = graphs.JOIN(t.device, dst)
            self.plan.append(("handoff", t.device, dst))
            self._end(t.device)
            self._begin(t.device)
            self.held += [t, x, out, ev]
            self.moved[key] = out
            return out
        graphs._CardCapture.handoff = handoff
    out = {}
    linear.KERNEL_MODE = "off"
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    m = load_model(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "models", "repolm512_q8.gguf"),
        device="cuda:0")
    a = m.arch
    mesh = ptp.make_tp_mesh(2, [d0, d1])
    w = ptp.shard_weights(m.weights, mesh, a)
    kv, ref = ptp.make_tp_kv(a, mesh), ptp.make_tp_kv(a, mesh)
    tok, pos = torch.tensor([5], device=d0), torch.tensor(0, device=d0)
    cards = [d0, d1]
    streams = [torch.cuda.Stream(d) for d in cards]

    def program():
        return llama.forward(a, w, kv, tok, pos, layer_sel=[0], tp=mesh)[0]
    step = "capture"
    try:
        with graphs._on_stream(cards, streams):
            program()
        _sync(d0, d1)
        graph = graphs.CardGraph(cards)
        with graphs._on_stream(cards, streams):
            static = graph.capture(program)
        out["capture"] = "ok"
        step = "replay"
        bufs, logits = [], []
        for t in (9, 5, 11):
            tok.fill_(t)
            graph.replay()
            _sync(d0, d1)
            held = graph._held
            bufs.append(all(bool(torch.equal(held[i].to(held[i + 2].device),
                                              held[i + 2]))
                            for i in range(0, len(held), 4)))
            want = llama.forward(a, w, ref, torch.tensor([t], device=d0),
                                 torch.tensor(0, device=d0), layer_sel=[0],
                                 tp=mesh)[0]
            _sync(d0, d1)
            logits.append(bool(torch.equal(static, want)))
        out["handoff_buffers_bit_equal"] = bufs
        out["logits_bit_equal"] = logits
    except Exception as e:  # each step's failure is the probe's result
        out[step + "_error"] = f"{type(e).__name__}: {e}"[:600]
    out["result"] = ("spans cards" if out.get("logits_bit_equal")
                     and all(out["logits_bit_equal"])
                     else "does not span cards")
    print(json.dumps({name: out}), flush=True)
    return out


PP_STEPS = 4            # pp_cards: steps, the last two after a stall
PP_8B_LAYERS = 8        # pp_cards_8b: the synthetic 8B's layers
PP_8B_STAGES = (2, 4)


class Tape:
    """ops/layers.CAPTURE's stand-in for an uncaptured run: every move
    between cards as .to makes it, with its value kept, deduplicated as
    the capture deduplicates (models/graphs.handoff_key)."""

    def __init__(self, graphs):
        self.key, self.moved, self.vals, self.held = \
            graphs.handoff_key, {}, [], []

    def handoff(self, t, dst):
        key = self.key(t, dst)
        if key in self.moved:
            return self.moved[key]
        out = t.to(dst)
        self.vals.append((str(t.device), str(dst), list(t.shape),
                          out.clone()))
        self.held.append(t)
        if key is not None:
            self.moved[key] = out
        return out


def pp_stages(n: int, model: str = "repolm512") -> dict:
    """One pp_cards case: n stages over cuda:0 .. n-1 (the module
    docstring). model "8b": chip_smoke.py's synthetic 8B Q8_0 cut to
    PP_8B_LAYERS layers (full width), B = 8 from chip_smoke.pp_prefilled's
    cache, as meshcards runs it at 32 layers."""
    from ntransformer_tpu_torch.models import graphs
    from ntransformer_tpu_torch.models.loader import LoadedModel, load_model
    from ntransformer_tpu_torch.ops import layers
    from ntransformer_tpu_torch.parallel import pp
    out = {"stages": n, "model": model}
    cards = [torch.device("cuda", i) for i in range(n)]
    if model == "8b":
        import chip_smoke as cs
        cfg, a, w, _ = cs.depth_cut(cs.build_synth(torch), PP_8B_LAYERS)
        bkv, tok = cs.pp_prefilled(torch, LoadedModel(
            cfg, a, w, None, None, cards[0]), False)
        pos0 = torch.tensor(cs.PP_LENS, device=cards[0])
    else:
        m = load_model(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "models", "repolm512_q8.gguf"),
            device=cards[0])
        a, w, bkv = m.arch, m.weights, None
        tok = torch.tensor([5, 9, 11, 3], device=cards[0])
        pos0 = torch.tensor([7, 20, 3, 12], device=cards[0])
    mesh, b_n, n_micro = pp.make_pp_mesh(n, cards), tok.numel(), 2
    ref = pp.shard_pp_state(mesh, a, w, b_n, n_micro)
    cap = pp.shard_pp_state(mesh, a, w, b_n, n_micro)
    if bkv is not None:
        cs.pp_fill(ref, bkv)
        cs.pp_fill(cap, bkv)
        del bkv
    step = pp.captured_pp_step(mesh, a, cap, n_micro)
    act = torch.ones(b_n, dtype=torch.bool, device=cards[0])
    stage = "capture"
    try:
        rows = []
        for i in range(PP_STEPS):
            tape = Tape(graphs)
            layers.CAPTURE = tape
            try:
                want = pp.pp_decode_step(mesh, a, ref, tok, pos0 + i, act,
                                         n_micro)[0]
            finally:
                layers.CAPTURE = None
            _sync(*cards)
            stalled = i >= PP_STEPS - 2
            if stalled and "graph" in out:
                with torch.cuda.device(cards[1]):
                    torch.cuda._sleep(STALL)
            got = step(tok, pos0 + i, act)
            _sync(*cards)
            if step.graph is not None and "graph" not in out:
                out["capture"] = "ok"
                out["graph"] = {"type": type(step.graph).__name__,
                                "segments": step.graph.segments,
                                "handoffs": step.graph.handoffs}
                stage = "replay"
            held = step.graph._held
            srcs, copies = held[1::4], held[2::4]
            bad_src, bad_copy = [], []
            for j, (x, y, (s, d, shape, v)) in enumerate(
                    zip(srcs, copies, tape.vals)):
                if not torch.equal(x.to(v.device), v):
                    bad_src.append([j, s, d, shape])
                elif not torch.equal(y, v):
                    bad_copy.append([j, s, d, shape])
            rows.append({
                "step": i, "stalled": stalled,
                "logits_bit_equal": bool(torch.equal(got, want)),
                "max_abs_dlogit": float((got - want).abs().max()),
                "handoffs_tape": len(tape.vals),
                "handoffs_graph": len(copies),
                "first_bad_source": bad_src[:1], "bad_sources": len(bad_src),
                "first_bad_copy": bad_copy[:1], "bad_copies": len(bad_copy)})
            tok = torch.argmax(want, -1)
        out["steps"] = rows
        stage = "caches"
        kr, kc = pp.gather_kv(ref, cards[0]), pp.gather_kv(cap, cards[0])
        out["caches_bit_equal"] = all(
            getattr(kr, f) is None or bool(torch.equal(getattr(kr, f),
                                                       getattr(kc, f)))
            for f in ("k", "v", "ks", "vs"))
    except Exception as e:  # each step's failure is the probe's result
        out[stage + "_error"] = f"{type(e).__name__}: {e}"[:600]
    out["result"] = ("spans cards" if out.get("steps") and all(
        r["logits_bit_equal"] for r in out["steps"])
        and out.get("caches_bit_equal") else "does not span cards")
    return out


def _cache_diff(torch, ref, cap) -> list:
    """Where two PP states' caches differ: [stage, microbatch, array,
    layers, slots, positions] for each (stage, microbatch) that does."""
    out = []
    for s, (rr, cr) in enumerate(zip(ref.kv, cap.kv)):
        for m, (a, b) in enumerate(zip(rr, cr)):
            for f in ("k", "v"):
                d = (getattr(a, f) != getattr(b, f))
                if d.any():
                    nz = d.nonzero()
                    out.append([s, m, f, sorted(set(nz[:, 0].tolist())),
                                sorted(set(nz[:, 1].tolist())),
                                sorted(set(nz[:, 3].tolist()))[:8]])
    return out


def pp_probe(n: int) -> dict:
    """pp_cards_8b_probe: the 8B at n stages, captured by a step with no
    slot active (the caches are then held to the uncaptured state's), one
    step replayed with every card synchronized after each stretch's
    launch, then one replayed as CardGraph.replay launches it; each
    against pp_decode_step on a twin state, with where the caches differ
    (_cache_diff)."""
    import chip_smoke as cs
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.parallel import pp
    cards = [torch.device("cuda", i) for i in range(n)]
    cfg, a, w, _ = cs.depth_cut(cs.build_synth(torch), PP_8B_LAYERS)
    bkv, tok = cs.pp_prefilled(torch, LoadedModel(cfg, a, w, None, None,
                                                  cards[0]), False)
    pos0 = torch.tensor(cs.PP_LENS, device=cards[0])
    mesh, b_n = pp.make_pp_mesh(n, cards), tok.numel()
    ref = pp.shard_pp_state(mesh, a, w, b_n, 2)
    cap = pp.shard_pp_state(mesh, a, w, b_n, 2)
    cs.pp_fill(ref, bkv)
    cs.pp_fill(cap, bkv)
    step = pp.captured_pp_step(mesh, a, cap, 2)
    act = torch.ones(b_n, dtype=torch.bool, device=cards[0])
    out, tok0 = {"stages": n}, tok
    step(tok, pos0, torch.zeros_like(act))
    _sync(*cards)
    out["after_capture_cache_diff"] = _cache_diff(torch, ref, cap)
    g = step.graph
    plain_replay = g.replay

    def serial():
        for seg in g._steps:
            seg.replay()
            _sync(*cards)
    rows = []
    for i, mode in enumerate(("serial", "as_launched")):
        g.replay = serial if mode == "serial" else plain_replay
        want = pp.pp_decode_step(mesh, a, ref, tok, pos0 + i, act, 2)[0]
        _sync(*cards)
        got = step(tok, pos0 + i, act)
        _sync(*cards)
        rows.append({"mode": mode,
                     "logits_bit_equal": bool(torch.equal(got, want)),
                     "max_abs_dlogit": float((got - want).abs().max()),
                     "cache_diff": _cache_diff(torch, ref, cap)})
        tok = torch.argmax(want, -1)
    out["steps"] = rows
    # the same with a pool of its own for every stretch (no stretch reuses
    # a block another stretch of its card freed during the capture), and
    # with the receiving card's stretch ended after each copy as well
    from ntransformer_tpu_torch.models import graphs
    begin, handoff = graphs._CardCapture._begin, graphs._CardCapture.handoff

    def fresh(self, card):
        self.pools.pop(card, None)
        begin(self, card)

    def cut_both(self, t, dst):
        got = handoff(self, t, dst)
        if dst in self.open:
            self._end(dst)
            self._begin(dst)
        return got
    for case, patch in (("fresh_pools", ("_begin", fresh)),
                        ("receiver_cut", ("handoff", cut_both))):
        cap2 = pp.shard_pp_state(mesh, a, w, b_n, 2)
        ref2 = pp.shard_pp_state(mesh, a, w, b_n, 2)
        cs.pp_fill(cap2, bkv)
        cs.pp_fill(ref2, bkv)
        setattr(graphs._CardCapture, *patch)
        try:
            step2 = pp.captured_pp_step(mesh, a, cap2, 2)
            tok = tok0
            for i in range(2):
                want = pp.pp_decode_step(mesh, a, ref2, tok, pos0 + i, act,
                                         2)[0]
                got = step2(tok, pos0 + i, act)
                _sync(*cards)
                out.setdefault(case, []).append(
                    {"logits_bit_equal": bool(torch.equal(got, want)),
                     "max_abs_dlogit": float((got - want).abs().max()),
                     "graphs": step2.graph.segments,
                     "cache_diff": _cache_diff(torch, ref2, cap2)})
                tok = torch.argmax(want, -1)
        except Exception as e:  # each case's failure is the probe's result
            out[case + "_error"] = f"{type(e).__name__}: {e}"[:600]
        finally:
            graphs._CardCapture._begin = begin
            graphs._CardCapture.handoff = handoff
        del cap2, ref2
    return out


class OneCardSplit:
    """parallel/pp.handoff's stand-in for pp_split_one: on one card, every
    move a stage makes (which there moves nothing) takes a contiguous copy
    of the tensor into a buffer of its own by cuMemcpyAsync (copy "clone":
    by a clone; "none": the contiguous tensor itself; "layout": the copy
    models/graphs.moved_like makes, with the tensor's own strides), after
    which the running graph ends and the next begins on the same stream
    and pool, kept uninstantiated until the pass ends as a CardGraph's
    stretches are (instant: each instantiated as it ends; cut off: one
    graph; hold off: the tensors not kept)."""

    def __init__(self, copy="memcpy", cut=True, instant=False, hold=True):
        self.pool, self.graphs, self.held = torch.cuda.graph_pool_handle(), \
            [], []
        self.copy, self.cut, self.instant = copy, cut, instant
        self.hold = hold
        self._begin()

    def _begin(self) -> None:
        g = torch.cuda.CUDAGraph(keep_graph=not self.instant)
        g.capture_begin(pool=self.pool)
        self.graphs.append(g)

    def _end(self) -> None:
        self.graphs[-1].capture_end()
        if not self.instant:
            return
        # capture_end instantiated it (keep_graph off)

    def handoff(self, t, dst):
        from ntransformer_tpu_torch.models import graphs
        if self.copy == "layout":
            x, out = graphs.moved_like(t, t.device)
        else:
            x = t.contiguous()
            out = torch.empty_like(x) if self.copy == "memcpy" else \
                x.clone() if self.copy == "clone" else x
        if self.copy in ("memcpy", "layout"):
            graphs.copy_on_stream(out, x)
        if self.hold:
            self.held += [t, x, out]
        if self.cut:
            self._end()
            self._begin()
        return out

    def finish(self) -> None:
        self._end()
        if not self.instant:
            for g in self.graphs:
                g.instantiate()

    def replay(self) -> None:
        for g in self.graphs:
            g.replay()


SPLIT_FORMS = {"split": {}, "split_no_copy": {"copy": "none"},
               "copy_no_cut": {"cut": False},
               "split_clone": {"copy": "clone"},
               "split_instant": {"instant": True},
               "hold_only": {"copy": "none", "cut": False},
               "copy_no_hold": {"cut": False, "hold": False},
               "split_layout": {"copy": "layout"}}


def pp_split_one() -> dict:
    """pp_split_one: the 8B's PP step at (2 stages, 2 microbatches) with
    both stages on cuda:0, captured as a run of graphs cut at every move
    between stages (OneCardSplit, in each of SPLIT_FORMS) after an
    uncaptured warm-up with no slot active, and replayed twice against
    pp_decode_step on a twin state: the logits, the slots that differ and
    where the caches differ, and the first attention call whose inputs or
    output differ (pos, active, q, new k and v rows, output: which, in
    which slots); the same captured as one graph (make_pp_decode's form on
    one card) beside them."""
    import chip_smoke as cs
    from ntransformer_tpu_torch.models import batched, graphs
    from ntransformer_tpu_torch.models.loader import LoadedModel
    from ntransformer_tpu_torch.parallel import pp
    card = torch.device("cuda", 0)
    cfg, a, w, _ = cs.depth_cut(cs.build_synth(torch), PP_8B_LAYERS)
    bkv, tok = cs.pp_prefilled(torch, LoadedModel(cfg, a, w, None, None,
                                                  card), False)
    pos0 = torch.tensor(cs.PP_LENS, device=card)
    mesh, b_n = pp.make_pp_mesh(2, [card, card]), tok.numel()
    act = torch.ones(b_n, dtype=torch.bool, device=card)
    stash = {"ref": [], "cap": []}
    attend = batched._attend_deferred

    def at(arch, q, k_t, v_t, bkv_, p_, a_, layer, *rest):
        att, rows = attend(arch, q, k_t, v_t, bkv_, p_, a_, layer, *rest)
        ts = (p_, a_, q, k_t, v_t, att)
        if torch.cuda.is_current_stream_capturing():
            stash["cap"].append(ts)
        elif stash.get("on"):
            stash["ref"].append(tuple(t.clone() for t in ts))
        return att, rows
    from ntransformer_tpu_torch.models import llama
    qm = batched.qmatmul

    def qmm(x, w, *args, **kw):
        y = qm(x, w, *args, **kw)
        ts = (x, y)
        if torch.cuda.is_current_stream_capturing():
            stash["qcap"].append(ts)
        elif stash.get("on"):
            stash["qref"].append(tuple(t.clone() for t in ts))
        return y
    batched.qmatmul = llama.qmatmul = qmm
    batched._attend_deferred = at
    step_layer, run_layers = batched._layer_step_deferred, pp._run_layers

    def snap(key, *ts):
        if torch.cuda.is_current_stream_capturing():
            stash["s" + key].append(tuple(t.clone() for t in ts))
            stash["live" + key].append(ts)
        elif stash.get("on"):
            stash["r" + key].append(tuple(t.clone() for t in ts))

    def sl(arch, x, *rest, **kw):
        y, rows = step_layer(arch, x, *rest, **kw)
        snap("layer", y)
        return y, rows

    def rl(arch, weights, kv, x, *rest):
        snap("in", x)
        y = run_layers(arch, weights, kv, x, *rest)
        snap("out", y)
        return y
    batched._layer_step_deferred, pp._run_layers = sl, rl
    out = {}
    try:
        for form, kw in list(SPLIT_FORMS.items()) + [("one_graph", None)]:
            stash.update(ref=[], cap=[], qref=[], qcap=[], on=False,
                         **{k + t: [] for k in ("s", "live", "r")
                            for t in ("layer", "in", "out")})
            ref = pp.shard_pp_state(mesh, a, w, b_n, 2)
            cap = pp.shard_pp_state(mesh, a, w, b_n, 2)
            cs.pp_fill(ref, bkv)
            cs.pp_fill(cap, bkv)
            st = [torch.zeros(b_n, dtype=torch.long, device=card),
                  torch.zeros(b_n, dtype=torch.long, device=card),
                  torch.zeros(b_n, dtype=torch.bool, device=card)]
            stream = torch.cuda.Stream(card)

            def direct():
                return pp.pp_decode_step(mesh, a, cap, *st, 2)[0]
            try:
                with torch.inference_mode(), \
                        graphs._on_stream(card, stream):
                    direct()
                    if kw is not None:
                        split = OneCardSplit(**kw)
                        handoff, pp.handoff = pp.handoff, split.handoff
                        try:
                            static = direct()
                        finally:
                            pp.handoff = handoff
                            split.finish()
                        run, n_graphs = split.replay, len(split.graphs)
                    else:
                        g = torch.cuda.CUDAGraph()
                        g.capture_begin()
                        try:
                            static = direct()
                        finally:
                            g.capture_end()
                        run, n_graphs = g.replay, 1
                rows, tk = [], tok
                for i in range(2):
                    with torch.inference_mode():
                        stash["on"] = i == 0
                        want = pp.pp_decode_step(mesh, a, ref, tk, pos0 + i,
                                                 act, 2)[0]
                        stash["on"] = False
                        for dst, src in zip(st, (tk, pos0 + i, act)):
                            dst.copy_(src)
                        run()
                    torch.cuda.synchronize()
                    row = {"logits_bit_equal": bool(torch.equal(static,
                                                                want)),
                           "max_abs_dlogit": float((static - want).abs()
                                                   .max()),
                           "slots_differ": [b for b in range(b_n) if not
                                            torch.equal(static[b], want[b])],
                           "cache_diff": _cache_diff(torch, ref, cap)}
                    if i == 0:
                        row["first_attend_diff"] = _first_diff(stash)
                        row["first_matmul_diff"] = _first_diff(
                            {"ref": stash["qref"], "cap": stash["qcap"]},
                            ("x", "y"))
                        for t in ("layer", "in", "out"):
                            row[f"first_{t}_snap_diff"] = _first_diff(
                                {"ref": stash["r" + t],
                                 "cap": stash["s" + t]}, (t,))
                            row[f"first_{t}_live_diff"] = _first_diff(
                                {"ref": stash["r" + t],
                                 "cap": stash["live" + t]}, (t,))
                    rows.append(row)
                    tk = torch.argmax(want, -1)
                out[form] = {"graphs": n_graphs, "steps": rows}
            except Exception as e:  # each form's failure is its result
                out[form] = {"error": f"{type(e).__name__}: {e}"[:600]}
            del ref, cap
    finally:
        batched._attend_deferred = attend
        batched.qmatmul = llama.qmatmul = qm
        batched._layer_step_deferred, pp._run_layers = step_layer, run_layers
    return out


def _first_diff(stash, names=("pos", "active", "q", "k_new", "v_new",
                               "out")):
    """The first call whose kept tensors differ between the uncaptured
    step and the replay: [call, calls kept, [tensor, slots, values], ...]."""
    for i, (r, c) in enumerate(zip(stash["ref"], stash["cap"])):
        bad = []
        for j, (u, v) in enumerate(zip(r, c)):
            if not torch.equal(u, v):
                d = (u != v).reshape(u.shape[0], -1).any(-1)
                bad.append([names[j], d.nonzero().flatten().tolist(),
                            u.reshape(u.shape[0], -1)[d][:, :3].tolist(),
                            v.reshape(v.shape[0], -1)[d][:, :3].tolist()])
        if bad:
            return [i, len(stash["ref"]), len(stash["cap"]), bad]
    return None


def pp_cards(name: str) -> dict:
    """pp_cards, pp_cards_to and pp_cards_8b (the module docstring): each
    stage count in a process of its own (a capture that fails can leave
    its card's capture under way), as pp_case runs it."""
    counts = PP_8B_STAGES if "8b" in name else (2, 3)
    out = {}
    for n in counts:
        if n > torch.cuda.device_count():
            continue
        r = subprocess.run([sys.executable, __file__, f"{name}:{n}"],
                           capture_output=True, text=True, timeout=300)
        got = [json.loads(x)[f"{name}:{n}"] for x in r.stdout.splitlines()
               if x.startswith(f'{{"{name}:{n}"')]
        out[f"stages_{n}"] = got[0] if got else {
            "result": "does not span cards", "exit_code": r.returncode,
            "stderr": r.stderr.strip()[-600:]}
    out["result"] = ("spans cards" if out and all(
        v["result"] == "spans cards" for v in out.values())
        else "does not span cards")
    print(json.dumps({name: out}), flush=True)
    return out


def pp_case(name: str, n: int) -> None:
    """One stage count of pp_cards (name) in this process: pp_cards_to
    moves by PyTorch's own .to, pp_cards_8b runs the 8B, kernels on, and
    pp_cards_8b_off the same with the kernels off."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from ntransformer_tpu_torch.ops import linear
    if name == "pp_cards_to":
        from ntransformer_tpu_torch.parallel import pp
        pp.handoff = lambda t, device, dtype=None: (
            t.to(device) if dtype is None else t.to(device, dtype))
    if name.endswith("_off"):
        linear.KERNEL_MODE = "off"
    out = (pp_probe(n) if name.endswith("_probe") else
           pp_stages(n, "8b" if "8b" in name else "repolm512"))
    print(json.dumps({f"{name}:{n}": out}), flush=True)


def run_variant(name: str) -> None:
    if name in ("per_card", "per_stream"):
        joined(name)
    elif name == "segments":
        segments()
    elif name.startswith("tp_"):
        tp_layer(name)
    elif name == "pp_split_one":
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        print(json.dumps({name: pp_split_one()}), flush=True)
    elif name.startswith("pp_cards") and ":" in name:
        pp_case(name.split(":")[0], int(name.split(":")[1]))
    elif name.startswith("pp_cards"):
        pp_cards(name)
    else:
        variant(name)


def main() -> int:
    out = {"cards": torch.cuda.device_count() if torch.cuda.is_available()
           else 0, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    if out["cards"] < 1:
        out["result"] = "needs a card"
        print(json.dumps(out))
        return 0
    out["card"] = card()
    names = ONE_CARD + (VARIANTS if out["cards"] >= 2 else ())
    for name in names:
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
        out[name]["result"] == "spans cards" for name in VARIANTS
        if name in out) else "does not span cards")
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "mesh_capture.json"), "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run_variant(sys.argv[1])
        sys.exit(0)
    sys.exit(main())
