"""Port parity for the C-shaped API (api.py) on the CPU: handles, the
property calls, greedy text equal to the JAX api's and to the port's
Engine.generate on the same GGUF, the tiered engine (streaming=True) equal
to the resident one, and NT_ERROR / None on bad handles and failed loads
(a load on the default device, CUDA, fails on a machine without it)."""
import shutil

import pytest
import torch

from ntransformer_tpu import api as japi
from ntransformer_tpu_torch import api
from ntransformer_tpu_torch.inference.engine import Engine, GenerateConfig
from tools.make_test_gguf import write_model
from test_torch_model import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("api") / "tiny_q8.gguf"),
                       "tiny", "q8_0", seed=6)


@pytest.fixture(scope="module")
def jax_text(tiny_gguf):
    h = japi.nt_engine_create()
    assert japi.nt_engine_load(h, tiny_gguf, max_ctx=256) == japi.NT_OK
    text = japi.nt_engine_generate(h, "hi", max_tokens=5, temperature=0.0)
    japi.nt_engine_destroy(h)
    return text


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["resident", "tiered"])
def test_c_api_roundtrip_matches_jax(tiny_gguf, jax_text, streaming,
                                     tmp_path):
    path = tiny_gguf
    if streaming:  # the tiered loader writes its pack beside the model
        path = str(tmp_path / "tiny_q8.gguf")
        shutil.copy(tiny_gguf, path)
    h = api.nt_engine_create()
    assert api.nt_engine_load(h, path, max_ctx=256, streaming=streaming,
                              device="cpu") == api.NT_OK
    assert api.nt_engine_vocab_size(h) == 512
    assert api.nt_engine_n_layers(h) == 4
    assert api.nt_engine_hidden_size(h) == 256
    text = api.nt_engine_generate(h, "hi", max_tokens=5, temperature=0.0)
    assert isinstance(text, str) and text == jax_text
    assert api.nt_engine_destroy(h) == api.NT_OK
    assert api.nt_engine_generate(h, "hi") is None  # destroyed
    api.nt_free(text)


def test_c_api_text_equals_engine_generate(tiny_gguf):
    h = api.nt_engine_create()
    assert api.nt_engine_load(h, tiny_gguf, max_ctx=256,
                              device="cpu") == api.NT_OK
    want, _ = Engine.load(tiny_gguf, max_seq_len=256, device="cpu").generate(
        "hello", GenerateConfig(max_tokens=6, temperature=0.0))
    assert api.nt_engine_generate(h, "hello", max_tokens=6,
                                  temperature=0.0) == want
    api.nt_engine_destroy(h)


def test_c_api_bad_handle():
    assert api.nt_engine_load(99999, "nope.gguf", device="cpu") == \
        api.NT_ERROR
    assert api.nt_engine_generate(99999, "hi") is None
    assert api.nt_engine_vocab_size(99999) == api.NT_ERROR
    assert api.nt_engine_n_layers(99999) == api.NT_ERROR
    assert api.nt_engine_hidden_size(99999) == api.NT_ERROR


def test_c_api_failed_loads(tiny_gguf, tmp_path):
    """A missing file, and (without CUDA) the default device, fail as
    NT_ERROR; the handle stays valid and empty."""
    h = api.nt_engine_create()
    assert api.nt_engine_load(h, str(tmp_path / "nope.gguf"),
                              device="cpu") == api.NT_ERROR
    if not torch.cuda.is_available():
        assert api.nt_engine_load(h, tiny_gguf) == api.NT_ERROR
    assert api.nt_engine_generate(h, "hi") is None
    assert api.nt_engine_vocab_size(h) == api.NT_ERROR
    assert api.nt_engine_destroy(h) == api.NT_OK


def test_c_api_handles_are_distinct():
    hs = [api.nt_engine_create() for _ in range(3)]
    assert len(set(hs)) == 3
    for h in hs:
        assert api.nt_engine_destroy(h) == api.NT_OK
