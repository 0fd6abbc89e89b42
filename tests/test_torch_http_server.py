"""Port parity for the HTTP front end (inference/http_server.py) on the
CPU: the cases of tests/test_http_server.py and the HTTP cases of
tests/test_chat.py, driven over a loopback socket against the port's
BatchServer, with the greedy texts held equal to the JAX package's
BatchServer.run on the same GGUF (the tiny model's bf16 cache and Q8_0
products give the JAX argmax chain on the CPU, tests/test_torch_serve.py).
"""
import json
import queue
import threading
import time
import urllib.error
import urllib.request

import pytest

from ntransformer_tpu.inference.chat import LLAMA3 as JLLAMA3
from ntransformer_tpu.inference.chat import encode_chat as jencode_chat
from ntransformer_tpu.inference.sampler import SamplerConfig as JSamplerConfig
from ntransformer_tpu.inference.serve import BatchServer as JBatchServer
from ntransformer_tpu.inference.serve import Request as JRequest
from ntransformer_tpu.models.loader import load_model as jax_load_model
from ntransformer_tpu_torch.inference.chat import LLAMA3, encode_chat
from ntransformer_tpu_torch.inference.http_server import HttpFrontend
from ntransformer_tpu_torch.inference.sampler import SamplerConfig
from ntransformer_tpu_torch.inference.serve import BatchServer, Request
from ntransformer_tpu_torch.models.loader import load_model
from tools.make_test_gguf import write_model
from test_torch_model import one_torch_thread  # noqa: F401

PROMPTS = ["alpha beta", "gamma delta", "epsilon"]
MSGS = [{"role": "system", "content": "be brief"},
        {"role": "user", "content": "hello world"}]
GREEDY = SamplerConfig(temperature=0.0)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("http")
    return {"plain": write_model(str(d / "http_q8.gguf"), "tiny", "q8_0",
                                 seed=33),
            "chat": write_model(str(d / "chat_q8.gguf"), "tiny", "q8_0",
                                seed=44, chat="llama3")}


@pytest.fixture(scope="module")
def expected(paths):
    """The JAX BatchServer.run's greedy texts: the completion prompts (6
    tokens), and the chat messages rendered through the template (6 and 5
    tokens), each once."""
    srv = JBatchServer(jax_load_model(paths["plain"]), batch_size=2,
                       sampler_cfg=JSamplerConfig(temperature=0.0))
    reqs = [JRequest(prompt=p, max_tokens=6) for p in PROMPTS]
    srv.run(reqs)
    out = {p: r.text for p, r in zip(PROMPTS, reqs)}
    jm = jax_load_model(paths["chat"])
    ids = jencode_chat(jm.tokenizer, JLLAMA3, MSGS)
    for n in (6, 5):
        srv = JBatchServer(jm, batch_size=2,
                           sampler_cfg=JSamplerConfig(temperature=0.0))
        r = JRequest(prompt="", max_tokens=n, prompt_ids=list(ids))
        srv.run([r])
        out[("chat", n)] = r.text
    out["chat_ids"] = ids
    return out


@pytest.fixture(scope="module")
def model(paths):
    return load_model(paths["plain"], device="cpu")


@pytest.fixture(scope="module")
def chat_model(paths):
    return load_model(paths["chat"], device="cpu")


def start(model, **kw):
    fe = HttpFrontend(BatchServer(model, batch_size=2, sampler_cfg=GREEDY,
                                  **kw), port=0, request_timeout_s=120.0)
    fe.start()
    return fe


@pytest.fixture()
def frontend(model):
    fe = start(model)
    yield fe
    fe.stop()


@pytest.fixture()
def chat_frontend(chat_model):
    fe = start(chat_model)
    yield fe
    fe.stop()


def _post(port, body, path="/v1/completions", timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _sse(port, body, path="/v1/completions"):
    """(content type, data payloads before [DONE], whether [DONE] came)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    pieces, done = [], False
    with urllib.request.urlopen(req, timeout=120) as resp:
        ctype = resp.headers["Content-Type"]
        for line in resp:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                done = True
                break
            pieces.append(json.loads(payload))
    return ctype, pieces, done


def _status(port, path, body=None):
    """The HTTP status of a request expected to fail."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type":
                                          "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    return e.value.code


def test_health(frontend):
    body = _get(frontend.port, "/health")
    assert body["status"] == "ok" and body["slots"] == 2
    assert body["chat_format"] is None


def test_concurrent_completions_match_jax_run(frontend, expected):
    """3 clients against 2 slots: continuous batching over HTTP gives the
    JAX batch loop's greedy texts."""
    results = {}

    def client(p):
        status, body = _post(frontend.port, {"prompt": p, "max_tokens": 6})
        assert status == 200
        results[p] = body

    threads = [threading.Thread(target=client, args=(p,)) for p in PROMPTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "HTTP client thread hung"
    for p in PROMPTS:
        body = results[p]
        assert body["object"] == "text_completion"
        assert body["choices"][0]["text"] == expected[p], p
        assert body["usage"]["completion_tokens"] == 6
        assert body["usage"]["prompt_tokens"] > 0


def test_streaming_sse(frontend, expected):
    """stream=true: chunked SSE pieces concatenate to the non-stream text."""
    ctype, pieces, done = _sse(frontend.port, {"prompt": PROMPTS[0],
                                               "max_tokens": 6,
                                               "stream": True})
    assert ctype == "text/event-stream" and done
    assert "".join(p["text"] for p in pieces) == expected[PROMPTS[0]]


@pytest.mark.parametrize("body", [
    {}, {"prompt": 7}, [1, 2], "x", 3, {"prompt": "hi", "max_tokens": "abc"},
    {"prompt": "hi", "temperature": "hot"}],
    ids=["empty", "int-prompt", "list", "str", "int", "bad-max-tokens",
         "bad-temperature"])
def test_bad_requests_400(frontend, body):
    assert _status(frontend.port, "/v1/completions", body) == 400


def test_unknown_paths_404(frontend):
    assert _status(frontend.port, "/nope") == 404
    assert _status(frontend.port, "/v1/nope", {"prompt": "x"}) == 404


def test_timeout_504_frees_the_slot(model):
    """A request that outlives request_timeout_s answers 504 and is
    cancelled, so its slot frees at the next step boundary."""
    srv = BatchServer(model, batch_size=1, sampler_cfg=GREEDY)
    srv.warmup()  # before the serving thread: not the request's time
    fe = HttpFrontend(srv, port=0, request_timeout_s=0.05)
    fe.start()
    try:
        assert _status(fe.port, "/v1/completions",
                       {"prompt": PROMPTS[0], "max_tokens": 400}) == 504
        deadline = time.time() + 60
        while time.time() < deadline and srv.snapshot().get(
                "slots_active", 1):
            time.sleep(0.05)
        assert srv.snapshot()["slots_active"] == 0
        assert srv.snapshot()["tokens"] < 400
    finally:
        fe.stop()


def test_stop_drains_in_flight(model, expected):
    """stop() after submit: the in-flight request still completes."""
    srv = BatchServer(model, batch_size=2, sampler_cfg=GREEDY)
    inbox: queue.Queue = queue.Queue()
    stop = threading.Event()
    done = threading.Event()
    r = Request(prompt=PROMPTS[0], max_tokens=6,
                on_done=lambda _r: done.set())
    inbox.put(r)
    t = threading.Thread(target=srv.serve_forever, args=(inbox, stop))
    t.start()
    stop.set()  # at once: the inbox still holds the request
    t.join(timeout=120)
    assert not t.is_alive()
    assert done.is_set() and r.text == expected[PROMPTS[0]]


def test_frontend_stop_drains_in_flight(model, expected):
    """HttpFrontend.stop() while a client waits: the request finishes with
    the JAX text before the serving thread exits."""
    fe = start(model)
    got = {}

    def client():
        got["body"] = _post(fe.port, {"prompt": PROMPTS[1],
                                      "max_tokens": 6})[1]

    t = threading.Thread(target=client)
    t.start()
    deadline = time.time() + 60
    while time.time() < deadline and not fe.server.snapshot().get(
            "requests"):
        time.sleep(0.01)
    fe.stop()
    t.join(timeout=120)
    assert not t.is_alive()
    assert got["body"]["choices"][0]["text"] == expected[PROMPTS[1]]
    assert not any(th.is_alive() for th in threading.enumerate()
                   if th.name in ("nt-serve-loop", "nt-http"))


def test_cancelled_request_frees_slot(model):
    """Request.cancelled mid-decode retires the slot at the next step
    boundary, and a queued request then takes the freed slot."""
    srv = BatchServer(model, batch_size=1, sampler_cfg=GREEDY)
    big = Request(prompt=PROMPTS[0], max_tokens=400)
    seen = []

    def on_tok(piece):
        seen.append(piece)
        if len(seen) == 3:
            big.cancelled = True
    big.on_token = on_tok
    follow = Request(prompt=PROMPTS[1], max_tokens=4)
    stats = srv.run([big, follow])
    assert big.finished_at > 0 and follow.finished_at > 0
    assert 3 <= len(big.output_ids) <= 4
    assert len(follow.output_ids) == 4
    assert stats.tokens < 30


def test_stats_endpoint(frontend):
    base = _get(frontend.port, "/stats")
    assert base["slots"] == 2
    _post(frontend.port, {"prompt": PROMPTS[0], "max_tokens": 4})
    after = _get(frontend.port, "/stats")
    assert after["running"] is True
    assert after["requests"] >= 1 and after["tokens"] >= 4
    assert after["ttft_p50_ms"] is not None


def test_per_request_sampling_over_http(model, expected):
    """A sampled server honours per-request sampling: a top_k=1 request
    gives the greedy text while a hot request runs in the same batch."""
    srv = BatchServer(model, batch_size=2,
                      sampler_cfg=SamplerConfig(temperature=0.9, top_k=40,
                                                repeat_penalty=1.0))
    fe = HttpFrontend(srv, port=0, request_timeout_s=120.0)
    fe.start()
    try:
        results = {}

        def client(name, body):
            status, got = _post(fe.port, body)
            assert status == 200
            results[name] = got["choices"][0]["text"]

        ts = [threading.Thread(target=client, args=("det", {
                  "prompt": PROMPTS[0], "max_tokens": 6, "top_k": 1})),
              threading.Thread(target=client, args=("hot", {
                  "prompt": PROMPTS[1], "max_tokens": 6,
                  "temperature": 4.0}))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
            assert not t.is_alive()
        assert results["det"] == expected[PROMPTS[0]]
        assert "hot" in results
    finally:
        fe.stop()


def test_http_chat_completion_matches_jax(chat_model, chat_frontend,
                                          expected):
    """The chat endpoint renders the messages through the template (the
    JAX ids) and answers the JAX server's greedy text."""
    ids = encode_chat(chat_model.tokenizer, LLAMA3, MSGS)
    assert ids == expected["chat_ids"]
    status, body = _post(chat_frontend.port, {"messages": MSGS,
                                              "max_tokens": 6},
                         path="/v1/chat/completions")
    assert status == 200 and body["object"] == "chat.completion"
    msg = body["choices"][0]["message"]
    assert msg["role"] == "assistant"
    assert msg["content"] == expected[("chat", 6)]
    assert body["usage"]["prompt_tokens"] == len(ids)


def test_http_chat_health(chat_frontend):
    assert _get(chat_frontend.port, "/health")["chat_format"] == "llama3"


@pytest.mark.parametrize("bad", [
    {}, {"messages": []}, {"messages": "x"}, {"messages": [{"role": "user"}]},
    {"messages": [{"role": "user<|eot_id|>", "content": "x"}]}],
    ids=["empty", "no-messages", "str", "no-content", "smuggled-role"])
def test_http_chat_bad_requests_400(chat_frontend, bad):
    assert _status(chat_frontend.port, "/v1/chat/completions", bad) == 400


def test_http_chat_501_without_template(frontend):
    assert _status(frontend.port, "/v1/chat/completions",
                   {"messages": MSGS}) == 501


def test_http_chat_streaming_deltas(chat_frontend, expected):
    _, pieces, done = _sse(chat_frontend.port,
                           {"messages": MSGS, "max_tokens": 5,
                            "stream": True}, path="/v1/chat/completions")
    assert done and pieces
    assert ("".join(p["delta"]["content"] for p in pieces)
            == expected[("chat", 5)])
