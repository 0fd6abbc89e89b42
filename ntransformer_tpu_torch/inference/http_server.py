"""HTTP front end over the live continuous-batching server (stdlib only).

Port of ntransformer_tpu/inference/http_server.py: an OpenAI-completions-
style endpoint where concurrent clients' requests join the in-flight batch
mid-flight through BatchServer.serve_forever. The HTTP handler threads only
encode prompts, enqueue Requests and write to sockets; all torch work (the
kernels' launches included) stays on the one serving thread, whose
on_token / on_done callbacks only enqueue.

Endpoints:
  GET  /health                -> {"status", "model", "slots", "chat_format"}
  GET  /stats                 -> BatchServer.snapshot()
  POST /v1/completions        -> {"prompt", "max_tokens", "stream"}
       stream=false: one JSON body with choices[0].text + usage
       stream=true : SSE frames `data: {"text": piece}` per sampled
                     token piece, then `data: [DONE]`, chunked framing
  POST /v1/chat/completions   -> {"messages": [{"role", "content"}], ...}
       messages render through the model's own chat template
       (inference/chat.py; 501 when the model has no recognized one).
       Scaffold tokens parse specials; message CONTENT never does.
       stream=true emits `data: {"delta": {"content": piece}}` frames.
Malformed bodies answer 400, unknown paths 404, a request that outlives
request_timeout_s 504 (its slot is freed: the request is cancelled).

Sampling: the server's SamplerConfig sets the defaults; request bodies may
override temperature / top_k / top_p / repeat_penalty / seed per request
(BatchedSampler holds per-slot parameters). A server started greedy
(temperature 0) ignores overrides: that mode is the reproducible one.
"""
from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .serve import BatchServer, Request

_DONE = object()


class HttpFrontend:
    """Owns the serving thread (BatchServer.serve_forever) and the
    threaded HTTP listener. `port=0` binds an ephemeral port (tests);
    read the bound port from `.port` after start()."""

    def __init__(self, server: BatchServer, host: str = "127.0.0.1",
                 port: int = 8000, request_timeout_s: float = 600.0):
        from .chat import detect_format
        self.server = server
        self.host = host
        self.port = port
        self.request_timeout_s = request_timeout_s
        self.inbox: queue.Queue = queue.Queue()
        self.stop_event = threading.Event()
        self._httpd: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []
        # /v1/chat/completions is live iff the model's template is known
        self.chat_format = detect_format(server.model.config.metadata,
                                         server.tokenizer)

    @staticmethod
    def _sampling_overrides(body: dict) -> dict | None:
        """Per-request sampling fields (applied at slot admission when the
        server runs non-greedy; greedy servers are the bit-reproducible
        mode and ignore them). Raises ValueError on non-numeric values."""
        out = {}
        for k, cast in (("temperature", float), ("top_p", float),
                        ("repeat_penalty", float), ("top_k", int),
                        ("seed", int)):
            if k in body:
                out[k] = cast(body[k])
        return out or None

    def _encode_messages(self, messages) -> list:
        """Chat messages → templated token ids (scaffold parses specials,
        content never does). Raises ValueError on malformed messages."""
        from .chat import encode_chat
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list")
        return encode_chat(self.server.tokenizer, self.chat_format,
                           messages)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def do_GET(self):
                if self.path == "/health":
                    fmt = frontend.chat_format
                    frontend._json(self, 200, {
                        "status": "ok",
                        "model": frontend.server.model_name,
                        "slots": frontend.server.B,
                        "chat_format": fmt.name if fmt else None,
                    })
                elif self.path == "/stats":
                    frontend._json(self, 200, frontend.server.snapshot())
                else:
                    frontend._json(self, 404, {"error": "not found"})

            def do_POST(self):
                if self.path not in ("/v1/completions",
                                     "/v1/chat/completions"):
                    frontend._json(self, 404, {"error": "not found"})
                    return
                chat = self.path.endswith("/chat/completions")
                if chat and frontend.chat_format is None:
                    frontend._json(self, 501, {
                        "error": "model has no recognized chat template; "
                                 "use /v1/completions with a raw prompt"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    # non-dict JSON (lists, strings) must 400, not crash
                    max_tokens = int(body.get("max_tokens", 128))
                    sampling = frontend._sampling_overrides(body)
                    if chat:
                        prompt_ids = frontend._encode_messages(
                            body["messages"])
                        prompt = ""
                    else:
                        prompt = body["prompt"]
                        prompt_ids = []
                except (AttributeError, KeyError, TypeError,
                        ValueError) as e:
                    # AttributeError: .get on a non-dict JSON body
                    frontend._json(self, 400, {"error": f"bad request: {e}"})
                    return
                if not chat and not isinstance(prompt, str):
                    frontend._json(self, 400,
                                   {"error": "prompt must be a string"})
                    return
                if body.get("stream", False):
                    frontend._stream(self, prompt, max_tokens,
                                     prompt_ids=prompt_ids, chat=chat,
                                     sampling=sampling)
                else:
                    frontend._complete(self, prompt, max_tokens,
                                       prompt_ids=prompt_ids, chat=chat,
                                       sampling=sampling)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]  # resolve port=0
        t_serve = threading.Thread(
            target=self.server.serve_forever,
            args=(self.inbox, self.stop_event), daemon=True,
            name="nt-serve-loop")
        t_http = threading.Thread(target=self._httpd.serve_forever,
                                  daemon=True, name="nt-http")
        self._threads = [t_serve, t_http]
        t_serve.start()
        t_http.start()

    def stop(self) -> None:
        """Stop accepting, drain in-flight sequences, join both threads."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.stop_event.set()
        for t in self._threads:
            t.join(timeout=self.request_timeout_s)
        self._threads = []

    # -- request handling (HTTP handler threads) ---------------------------

    @staticmethod
    def _json(handler, code: int, obj: dict) -> None:
        data = json.dumps(obj).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    def _complete(self, handler, prompt: str, max_tokens: int,
                  prompt_ids: list | None = None, chat: bool = False,
                  sampling: dict | None = None) -> None:
        done = threading.Event()
        r = Request(prompt=prompt, max_tokens=max_tokens,
                    prompt_ids=list(prompt_ids or []), sampling=sampling,
                    on_done=lambda _r: done.set())
        self.inbox.put(r)
        if not done.wait(self.request_timeout_s):
            # free the batch slot — an abandoned request must not keep
            # decoding to max_tokens
            r.cancelled = True
            self._json(handler, 504, {"error": "request timed out"})
            return
        choice = ({"index": 0, "finish_reason": "stop",
                   "message": {"role": "assistant", "content": r.text}}
                  if chat else
                  {"index": 0, "text": r.text, "finish_reason": "stop"})
        self._json(handler, 200, {
            "object": "chat.completion" if chat else "text_completion",
            "model": self.server.model_name,
            "choices": [choice],
            "usage": {"prompt_tokens": len(r.prompt_ids),
                      "completion_tokens": len(r.output_ids),
                      "total_tokens": len(r.prompt_ids) + len(r.output_ids)},
        })

    def _stream(self, handler, prompt: str, max_tokens: int,
                prompt_ids: list | None = None, chat: bool = False,
                sampling: dict | None = None) -> None:
        pieces: queue.Queue = queue.Queue()
        # on_token/on_done run on the serving thread: enqueue only, never
        # block — the handler thread does all socket writes
        r = Request(prompt=prompt, max_tokens=max_tokens,
                    prompt_ids=list(prompt_ids or []), sampling=sampling,
                    on_token=pieces.put,
                    on_done=lambda _r: pieces.put(_DONE))
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        # SSE has no length; HTTP/1.1 keep-alive needs chunked framing
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()

        def chunk(payload: bytes) -> None:
            handler.wfile.write(f"{len(payload):x}\r\n".encode()
                                + payload + b"\r\n")

        self.inbox.put(r)
        try:
            while True:
                try:
                    piece = pieces.get(timeout=self.request_timeout_s)
                except queue.Empty:
                    r.cancelled = True
                    break
                if piece is _DONE:
                    chunk(b"data: [DONE]\n\n")
                    break
                if piece:  # '' while a multi-byte char is incomplete
                    payload = ({"delta": {"content": piece}} if chat
                               else {"text": piece})
                    chunk(b"data: " + json.dumps(payload).encode()
                          + b"\n\n")
            chunk(b"")  # terminal zero-length chunk
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            # client disconnected mid-stream: release its batch slot
            r.cancelled = True


def serve_http(server: BatchServer, host: str = "127.0.0.1",
               port: int = 8000) -> None:
    """CLI entry: run until interrupted (SIGINT drains and exits)."""
    fe = HttpFrontend(server, host, port)
    fe.start()
    print(f"listening on http://{fe.host}:{fe.port} "
          f"(POST /v1/completions; {server.B} slots)", flush=True)
    try:
        fe.stop_event.wait()
    except KeyboardInterrupt:
        print("draining...", flush=True)
    finally:
        fe.stop()
