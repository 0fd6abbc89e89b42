"""Meshes over several cards as captured programs (models/graphs.py
CardGraph, check_capturable), on the CPU.

A mesh over several cards is captured as one CUDA graph a card for each
stretch of its launches between two of its hand-offs to another card
(ops/layers.handoff), the graphs joined inside by external events. Here the
capture's pieces (the segment graph, the in-graph copy, the event join) are
recording doubles, and the second card of every mesh is the meta device: a
capture pass runs the real mesh forward with every tensor of the second
card on meta, and every move between the two goes through the capture's
hand-off (a plain move out of meta would raise). The plan it records (which
card hands what to which, and where each card's stretch ends) is held to
the hand-offs the forward's structure makes, for TP, CP, CP x TP, EP and
a (dp, tp) row. The capture's bookkeeping, the refusals (a row across
processes refused over a real single-process gloo group and taken with
the backend query patched to NCCL, a (dp, tp) mesh over NCCL processes
taken, pipeline stages over several CUDA cards taken and over devices
that are not all cards kept on the host path), make_pp_decode's capture
over two cards and handoff outside a capture (t.to, bit for bit) are
checked directly. tests/test_torch_mesh_graphs.py holds each mesh
forward to its JAX twin; nothing here compares values across packages."""
import gc
import socket

import pytest
import torch
import torch.distributed as dist

from ntransformer_tpu_torch.models import batched as pb
from ntransformer_tpu_torch.models import graphs
from ntransformer_tpu_torch.models import llama as pl
from ntransformer_tpu_torch.models.loader import load_model
from ntransformer_tpu_torch.ops import layers
from ntransformer_tpu_torch.ops.layers import handoff
from ntransformer_tpu_torch.parallel import cp as pcp
from ntransformer_tpu_torch.parallel import dp as pdp
from ntransformer_tpu_torch.parallel import ep as pep
from ntransformer_tpu_torch.parallel import multihost
from ntransformer_tpu_torch.parallel import pp as ppp
from ntransformer_tpu_torch.parallel import tp as ptp
from ntransformer_tpu_torch.parallel.multihost import Row, make_mesh
from tools.make_test_gguf import write_model

CPU, META = torch.device("cpu"), torch.device("meta")
CARDS = [CPU, META]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cg")
    return {"tiny": write_model(str(d / "tiny.gguf"), "tiny", "q8_0",
                                seed=13),
            "moe": write_model(str(d / "moe.gguf"), "moe", "q8_0", seed=122)}


class RecordingSegment:
    """A card's stretch: records its card, the pool it was given and
    whether it ended; `empty` names the stretches that launched nothing."""
    made: list = []
    empty: set = set()

    def __init__(self, card, pool=None):
        self.card, self.given, self.ended = card, pool, False
        self.index = len(RecordingSegment.made)
        RecordingSegment.made.append(self)

    @staticmethod
    def new_pool():
        return ("pool", len(RecordingSegment.made))

    def end(self) -> bool:
        self.ended = True
        return self.index not in RecordingSegment.empty

    def instantiate(self) -> None:
        self.instantiated = True


@pytest.fixture
def doubles(monkeypatch):
    """The capture's segment, copy and join as doubles; returns the list
    of (src, dst) joins made."""
    monkeypatch.setattr(RecordingSegment, "made", [])
    monkeypatch.setattr(RecordingSegment, "empty", set())
    monkeypatch.setattr(graphs, "SEGMENT", RecordingSegment)
    monkeypatch.setattr(graphs, "COPY", lambda dst, src: None)
    joins = []
    monkeypatch.setattr(graphs, "JOIN",
                        lambda s, d: joins.append((s, d)) or ("event", s, d))
    return joins


def _count(plan, *entry) -> int:
    return sum(p == entry for p in plan)


def _check_plan(g: graphs.CardGraph, joins: list) -> None:
    """The plan's invariants: every hand-off is followed at once by the
    end of its source card's stretch, is joined by one event from its
    source to its destination, and the program ends with the stretches
    still open; no capture is left under way."""
    plan = g.plan
    hand = [i for i, p in enumerate(plan) if p[0] == "handoff"]
    for i in hand:
        assert plan[i + 1] == ("graph", plan[i][1])
    assert joins == [plan[i][1:] for i in hand]
    assert g.segments == sum(p[0] == "graph" for p in plan)
    assert g.handoffs == len(hand)
    assert all(s.ended for s in RecordingSegment.made)
    assert layers.CAPTURE is None


def _capture(fn, cards=CARDS):
    g = graphs.CardGraph(cards)
    out = g.capture(fn)
    return g, out


# ---------------------------------------------------------------- refusals
@pytest.fixture
def gloo_group():
    """A real process group of this process alone, over gloo."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield dist.new_group([0])
    finally:
        dist.destroy_process_group()


def test_cards_taken_rows_across_processes_refused(files, gloo_group,
                                                   monkeypatch):
    """check_capturable / one_card take meshes over several CUDA cards
    (TP, CP, a (cp, tp) grid, a (dp, tp) mesh's rows) and refuse a mesh
    over devices that are not all cards; a row across processes, and a
    (dp, tp) mesh over processes, are refused over gloo (the real group's
    backend) and taken over NCCL (the query patched): the row's
    collectives are then captured."""
    four = ("cuda:0", "cuda:1", "cuda:2", "cuda:3")
    grid = (("cuda:0", "cuda:1"), ("cuda:2", "cuda:3"))
    for mesh in (four, grid, four[:2] * 2):
        graphs.check_capturable(mesh)
        assert graphs.one_card(mesh, None)
    assert not graphs.one_card(("cuda:0", "cpu"))
    row = Row(("cpu", "cpu"), ranks=(0, 0), rank=0, group=gloo_group)
    assert multihost.backend_of(gloo_group) == "gloo"
    with pytest.raises(ValueError, match="spans processes"):
        graphs.check_capturable(row)
    m = load_model(files["tiny"], device="cpu")
    a = m.arch
    shards = ptp.shard_weights(m.weights, Row(("cpu", "cpu")), a)
    with pytest.raises(ValueError, match="spans processes"):
        graphs.StepGraphs(a, shards, [None, None], row)
    mesh = pdp.Mesh((("cpu",), ("cpu",)), ((0,), (1,)), 0, (None, None))
    assert not pdp.captured(mesh)
    rows = pdp.Mesh((("cpu", "cpu"),), ((0, 1),), 0, (gloo_group,))
    assert not pdp.captured(rows)
    with pytest.raises(ValueError, match="host path"):
        pdp.group_graphs(rows, a, [[None, None]], [[None, None]])
    monkeypatch.setattr(multihost, "backend_of", lambda group=None: "nccl")
    assert pdp.captured(mesh) and pdp.captured(rows)
    graphs.check_capturable(row)
    assert graphs.one_card(row, rows)
    cards = Row(("cuda:0", "cuda:1"), ranks=(0, 1), rank=0,
                group=gloo_group)
    assert graphs.one_card(cards)
    with pytest.raises(ValueError, match="spans cards"):
        graphs.check_capturable(Row(("cpu", "cpu", "meta", "meta"),
                                    ranks=(0, 0, 0, 1), rank=0,
                                    group=gloo_group))


def test_cards_of_a_mesh_from_labels(monkeypatch):
    """The cards a program runs on, home first, each once, from device
    labels alone: TP with two shards a card, a (cp, tp) grid, a Row of
    which this process owns one card, PP stages."""
    d = [torch.device("cuda", i) for i in range(4)]
    assert graphs._cards("cuda:1", ("cuda:0", "cuda:1") * 2) == [d[1], d[0]]
    grid = (("cuda:0", "cuda:1"), ("cuda:2", "cuda:3"))
    assert graphs._cards("cuda:0", grid, grid[0]) == d
    row = Row(("cuda:0", "cuda:1", "cuda:2", "cuda:3"), ranks=(0, 0, 1, 1),
              rank=1)
    assert graphs._cards("cuda:2", row) == [d[2], d[3]]
    assert graphs._cards("cuda:0", ("cuda:0", "cuda:0")) == [d[0]]
    monkeypatch.setattr(graphs, "GRAPH", list)   # a graph class's double
    assert graphs.new_graph([d[0]]) == []
    assert isinstance(graphs.new_graph(d[:2]), graphs.CardGraph)


# ----------------------------------------------------------------- handoff
def test_handoff_outside_a_capture_is_to():
    """Outside a capture handoff is t.to(device[, dtype]): t itself on its
    own device, the same bits cast, and a move to another device."""
    t = torch.randn(4, 8).to(torch.bfloat16)
    assert handoff(t, "cpu") is t
    assert torch.equal(handoff(t, CPU, torch.float32), t.to(torch.float32))
    moved = handoff(t, META)
    assert moved.device == META and moved.shape == t.shape \
        and moved.dtype == t.dtype
    assert layers.CAPTURE is None


def test_capture_bookkeeping(doubles):
    """A hand-off ends its source card's stretch and opens the next in
    the card's pool; a tensor handed to a card twice moves once; stretches
    that launched nothing are dropped; the garbage collector waits while
    the capture is under way; a hand-off to a card outside the program
    raises, and the capture is cleared either way."""
    x = torch.ones(3)
    RecordingSegment.empty = {3}       # meta's stretch after the first cut

    def program():
        assert not gc.isenabled()    # no graph is collected mid-capture
        a = handoff(x, META)
        assert handoff(x, META) is a
        b = handoff(a * 2, CPU)
        return b + 1
    g, out = _capture(program)
    assert gc.isenabled()
    assert out.device == CPU
    _check_plan(g, doubles)
    assert g.plan == [("handoff", CPU, META), ("graph", CPU),
                      ("handoff", META, CPU), ("graph", META),
                      ("graph", CPU)]
    segs = RecordingSegment.made
    assert [s.card for s in segs] == [CPU, META, CPU, META]
    assert [s.given for s in segs] == [("pool", 0), ("pool", 1),
                                       ("pool", 0), ("pool", 1)]
    g2 = graphs.CardGraph(CARDS)
    g2.capture(lambda: handoff(x, META), pool=g.pool())
    assert [s.given for s in RecordingSegment.made[4:]] == [
        ("pool", 0), ("pool", 1), ("pool", 0)]
    with pytest.raises(ValueError, match="captured over"):
        graphs.CardGraph([CPU, torch.device("cuda", 3)]).capture(
            lambda: handoff(x, META))
    assert layers.CAPTURE is None


def test_handoff_again_after_a_write_moves_again(doubles):
    """A tensor handed to a card again moves once while nothing wrote it
    (its version counter unchanged), and anew after an in-place write, so
    the second copy reads the new value where the uncaptured .to would;
    an inference tensor, which keeps no version counter, moves at every
    hand-off."""
    x = torch.ones(3)
    with torch.inference_mode():
        y = torch.ones(3)

    def program():
        a = handoff(x, META)
        assert handoff(x, META) is a
        x.add_(1)
        b = handoff(x, META)
        assert b is not a and handoff(x, META) is b
        c = handoff(y, META)
        assert handoff(y, META) is not c
        return b
    g, _ = _capture(program)
    _check_plan(g, doubles)
    assert g.handoffs == 4
    assert graphs.handoff_key(y, META) is None
    assert graphs.handoff_key(x, META) == (id(x), x._version, META)


def test_handoff_keeps_the_layout(doubles, monkeypatch):
    """A hand-off in a capture gives the receiving card a buffer with the
    tensor's own strides where it is dense (the embedding's transposed
    rows, whose layout the ops after it keep and by which a reduction
    orders its sums, as t.to(device) keeps them), the bytes copied as one
    span from the tensor itself; a tensor with gaps moves as a contiguous
    copy."""
    t = torch.randn(256, 4).t()           # dense, transposed
    gaps = torch.randn(4, 512)[:, ::2]    # not dense
    copied = []
    monkeypatch.setattr(graphs, "COPY",
                        lambda dst, src: copied.append((dst, src)))

    def program():
        return handoff(t, META), handoff(gaps, META)
    g, (a, b) = _capture(program)
    _check_plan(g, doubles)
    assert a.stride() == t.stride() == t.to(META).stride() == (1, 4)
    assert b.is_contiguous() and b.shape == gaps.shape
    assert copied[0][1] is t and copied[1][1].is_contiguous()
    assert [dst for dst, _ in copied] == [a, b]


def test_pipeline_refusal():
    """No refusal is left for pipeline stages: check_capturable takes PP
    stages over several CUDA cards as it takes them on one (its pipeline
    keyword is gone), and refuses stages over devices that are not all
    cards, as it refuses any mesh so placed."""
    two = ("cuda:0", "cuda:1")
    graphs.check_capturable(("cuda:0",) * 4)
    graphs.check_capturable(two)
    graphs.check_capturable(("cuda:0", "cuda:1", "cuda:2", "cuda:3"))
    assert graphs.one_card(two) and graphs.one_card(("cuda:1", "cuda:1"))
    with pytest.raises(TypeError):
        graphs.check_capturable(two, pipeline=True)
    with pytest.raises(ValueError, match="spans cards"):
        graphs.check_capturable(("cuda:0", "cpu"))


# -------------------------------------------------------- the mesh plans
def _tiny(files):
    m = load_model(files["tiny"], device="cpu")
    return m, m.arch


TOK, POS = torch.tensor([3]), torch.tensor(5)


def test_tp_plan(files, doubles):
    """TP over two cards, the T = 1 step: the tokens and pos go to the
    second card once, then per layer h out and its wo partial back, hf
    out and its w_down partial back; the embedding's slice comes home
    once, and the head's rows go out and its partial logits come back."""
    m, a = _tiny(files)
    mesh = ptp.make_tp_mesh(2, CARDS)
    w, kv = ptp.shard_weights(m.weights, mesh, a), ptp.make_tp_kv(a, mesh)
    g, out = _capture(lambda: pl.forward(a, w, kv, TOK, POS, tp=mesh)[0])
    assert out.shape == (1, a.vocab_size) and out.device == CPU
    _check_plan(g, doubles)
    n = a.n_layers
    hand = [p[1:] for p in g.plan if p[0] == "handoff"]
    assert hand[:3] == [(CPU, META), (META, CPU), (CPU, META)]
    assert hand[3:3 + 4 * n] == [(CPU, META), (META, CPU)] * 2 * n
    assert hand[3 + 4 * n:] == [(CPU, META), (META, CPU)]


@pytest.mark.parametrize("prefill", [False, True])
def test_cp_plan(files, doubles, prefill):
    """CP over two cards: pos (and a prefill's n_valid) out once for the
    write plan; per layer the new k and v rows and q out, the max over
    shards back and out, the two sums back (T = 1 and a 64-token
    padded chunk, which the CPU runs through the plain combine)."""
    m, a = _tiny(files)
    mesh = pcp.make_cp_mesh(2, CARDS)
    kv = pcp.make_cp_kv(a, mesh)
    if prefill:
        toks = torch.arange(64) % 100 + 3
        nv = torch.tensor(60)
    else:
        toks, nv = TOK, None
    g, _ = _capture(lambda: pl.forward(a, m.weights, kv, toks, POS,
                                       n_valid=nv, cp=mesh)[0])
    _check_plan(g, doubles)
    n = a.n_layers
    assert _count(g.plan, "handoff", CPU, META) == 4 * n + 1 + prefill
    assert _count(g.plan, "handoff", META, CPU) == 3 * n


@pytest.mark.parametrize("layout", ["tp_over_cards", "cp_over_cards"])
def test_cp_tp_plan(files, doubles, layout):
    """CP x TP (2, 2): the TP shards on two cards (each CP column on one
    card: TP's hand-offs alone), or the TP row on one card and the CP
    slices over two (CP's hand-offs, for each TP shard's column)."""
    m, a = _tiny(files)
    devs = CARDS * 2 if layout == "tp_over_cards" else [CPU, CPU, META, META]
    mesh = pcp.make_cp_tp_mesh(2, 2, devs)
    w = ptp.shard_weights(m.weights, mesh[0], a)
    kv = pcp.make_cp_tp_kv(a, mesh)
    g, _ = _capture(lambda: pl.forward(a, w, kv, TOK, POS, cp=mesh,
                                       tp=mesh[0])[0])
    _check_plan(g, doubles)
    n = a.n_layers
    if layout == "tp_over_cards":
        want = (2 * n + 3, 2 * n + 2)
    else:
        # pos once; per layer and TP shard: k, v, q and the max out, the
        # max and two sums back
        want = (8 * n + 1, 6 * n)
    assert (_count(g.plan, "handoff", CPU, META),
            _count(g.plan, "handoff", META, CPU)) == want


def test_ep_plan(files, doubles):
    """EP over two cards, the T = 1 step: per layer hf, the K routing
    weights and the local expert ids out, the expert sum back."""
    m = load_model(files["moe"], device="cpu")
    a = m.arch
    mesh = pep.make_ep_mesh(2, CARDS)
    w = pep.shard_weights_ep(m.weights, mesh, a)
    kv = pl.KVCache.create(a, device="cpu")
    g, _ = _capture(lambda: pl.forward(a, w, kv, TOK, POS, ep=mesh)[0])
    _check_plan(g, doubles)
    n = a.n_layers
    assert _count(g.plan, "handoff", CPU, META) == 3 * n
    assert _count(g.plan, "handoff", META, CPU) == n


def test_pp_over_cards_keeps_the_host_path(files, monkeypatch):
    """make_pp_decode runs pp_decode_step from the host where the stages
    span devices that are not all CUDA cards (here the CPU and meta, the
    device test patched): no graph is made."""
    m, a = _tiny(files)
    made = []
    monkeypatch.setattr(ppp, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "GRAPH", lambda: made.append(1))
    mesh = ppp.make_pp_mesh(2, CARDS)
    state = ppp.shard_pp_state(mesh, a, m.weights, 4, 2)
    step = ppp.make_pp_decode(mesh, a, state, 2)
    assert not hasattr(step, "replays") and made == []


class ReplayingCardGraph(graphs.CardGraph):
    """A CardGraph whose capture pass runs with the doubles and whose
    replay runs the program again uncaptured, writing its output in
    place."""

    def capture(self, fn, pool=None):
        self.fn = fn
        self.out = super().capture(fn, pool)
        return self.out

    def replay(self) -> None:
        self.out.copy_(self.fn())


def test_pp_over_cards_is_captured(files, doubles, monkeypatch):
    """make_pp_decode over two cards asks check_capturable about the stage
    mesh alone and, taken, returns captured_pp_step's step: its first call
    warms the schedule, captures it as a CardGraph over both cards (each
    microbatch's activation, pos, active and rope rows handed to the
    second stage) and replays it; every call's logits and the caches equal
    pp_decode_step's on a twin state. The second card is cpu:0, a CPU
    device another label names, so the uncaptured program runs here."""
    m, a = _tiny(files)
    two = [CPU, torch.device("cpu", 0)]
    asked = []
    monkeypatch.setattr(ppp, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "one_card",
                        lambda *meshes: asked.append(meshes) or True)
    monkeypatch.setattr(graphs, "COPY", lambda dst, src: dst.copy_(src))
    monkeypatch.setattr(graphs, "CardGraph", ReplayingCardGraph)
    mesh = ppp.make_pp_mesh(2, two)
    state = ppp.shard_pp_state(mesh, a, m.weights, 4, 2)
    twin = ppp.shard_pp_state(mesh, a, m.weights, 4, 2)
    step = ppp.make_pp_decode(mesh, a, state, 2)
    assert asked == [(tuple(mesh),)]
    assert step.replays == 0 and step.graph is None
    tok, pos = torch.tensor([1, 2, 3, 4]), torch.tensor([0, 1, 2, 3])
    act = torch.tensor([True, True, False, True])
    for i in range(3):
        got = step(tok, pos + i, act).clone()
        want, _ = ppp.pp_decode_step(mesh, a, twin, tok, pos + i, act, 2)
        assert torch.equal(got, want)
        tok = torch.argmax(want, -1)
    g = step.graph
    assert isinstance(g, graphs.CardGraph) and step.replays == 3
    _check_plan(g, doubles)
    assert [p[1:] for p in g.plan if p[0] == "handoff"] == \
        [(CPU, two[1])] * 10
    for f in ("k", "v"):
        assert torch.equal(getattr(ppp.gather_kv(state, CPU), f),
                           getattr(ppp.gather_kv(twin, CPU), f))


def test_pp_plan(files, doubles):
    """pp_decode_step at (2 stages, 2 microbatches) over two cards, as
    captured_pp_step would capture it: for each microbatch the activation,
    pos, active and the two rope tables out to the second stage, and its
    output home for the head; the host path's moves are the same calls."""
    m, a = _tiny(files)
    mesh = ppp.make_pp_mesh(2, CARDS)
    state = ppp.shard_pp_state(mesh, a, m.weights, 4, 2)
    g, out = _capture(lambda: ppp.pp_decode_step(
        mesh, a, state, torch.tensor([1, 2, 3, 4]),
        torch.tensor([0, 1, 2, 3]), torch.ones(4, dtype=torch.bool), 2)[0])
    assert out.shape == (4, a.vocab_size) and out.device == CPU
    _check_plan(g, doubles)
    hand = [p[1:] for p in g.plan if p[0] == "handoff"]
    assert hand == ([(CPU, META)] * 5 + [(META, CPU)]) * 2


def test_dp_tp_row_plan(files, doubles):
    """A (1, 2) mesh's row over two cards, the batched decode step: the
    tokens and each shard's pos, active and positions out, per layer x
    out and its partial back, hf out and its partial back; the
    embedding's slice home, the head's rows out and its logits back."""
    m, a = _tiny(files)
    mesh = make_mesh(tp=2, dp=1, devices=CARDS)
    grid, _ = pdp.shard_server_state(mesh, a, m.weights, 4, with_kv=False)
    bkv = pdp.make_server_kv(mesh, a, 4)
    g, out = _capture(lambda: pb.batched_decode_step_tp(
        a, grid[0], bkv[0], torch.tensor([1, 2, 3, 4]),
        torch.zeros(4, dtype=torch.long), torch.ones(4, dtype=torch.bool),
        mesh.row(0))[0])
    assert out.shape == (4, a.vocab_size)
    _check_plan(g, doubles)
    n = a.n_layers
    assert _count(g.plan, "handoff", CPU, META) == 2 * n + 5
    assert _count(g.plan, "handoff", META, CPU) == 2 * n + 2
