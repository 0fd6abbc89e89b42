"""C-API-shaped embedding interface (ref: include/ntransformer.h:15-38).

Port of ntransformer_tpu/api.py: nt_engine_create/destroy/load/generate/
vocab_size/n_layers/hidden_size and nt_free on opaque integer handles, so
a ctypes-style caller can wrap it or a program embed it directly. An
engine loads onto the card unless nt_engine_load is given device="cpu".
"""
from __future__ import annotations

import threading

_engines: dict[int, object] = {}
_next_handle = 1
_lock = threading.Lock()

NT_OK = 0
NT_ERROR = -1


def nt_engine_create() -> int:
    """Returns an opaque engine handle (ntransformer.h:15)."""
    global _next_handle
    with _lock:
        h = _next_handle
        _next_handle += 1
        _engines[h] = None
    return h


def nt_engine_load(handle: int, model_path: str, max_ctx: int = 4096,
                   streaming: bool = False, device="cuda") -> int:
    """Load a GGUF into the engine (ntransformer.h:20): resident, or
    streamed through TieredEngine with streaming=True. Returns NT_OK or
    NT_ERROR."""
    from .inference.engine import Engine, TieredEngine
    if handle not in _engines:
        return NT_ERROR
    try:
        cls = TieredEngine if streaming else Engine
        eng = cls.load(model_path, max_seq_len=max_ctx, device=device)
    except Exception:  # the C boundary reports failure as a code
        return NT_ERROR
    with _lock:
        _engines[handle] = eng
    return NT_OK


def nt_engine_generate(handle: int, prompt: str, max_tokens: int = 128,
                       temperature: float = 0.8) -> str | None:
    """Generate a completion (ntransformer.h:25). None on error."""
    from .inference.engine import GenerateConfig
    eng = _engines.get(handle)
    if eng is None:
        return None
    cfg = GenerateConfig(max_tokens=max_tokens, temperature=temperature)
    text, _ = eng.generate(prompt, cfg)
    return text


def _prop(handle: int, name: str) -> int:
    eng = _engines.get(handle)
    return getattr(eng.arch, name) if eng is not None else NT_ERROR


def nt_engine_vocab_size(handle: int) -> int:
    return _prop(handle, "vocab_size")


def nt_engine_n_layers(handle: int) -> int:
    return _prop(handle, "n_layers")


def nt_engine_hidden_size(handle: int) -> int:
    return _prop(handle, "hidden_size")


def nt_engine_destroy(handle: int) -> int:
    """Release the engine (ntransformer.h:17); a tiered engine closes its
    streamer."""
    with _lock:
        eng = _engines.pop(handle, None)
    tm = getattr(eng, "tm", None)
    if tm is not None:
        tm.close()
    return NT_OK


def nt_free(obj) -> None:
    """No-op parity shim (ntransformer.h:38): Python owns the memory."""
