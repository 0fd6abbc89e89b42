"""Port hygiene, each check in a fresh interpreter: the port imports no JAX
and nothing of the JAX package, its entry points default to CUDA and raise
without it, its kernel modules import without nvcc, and chip_smoke.py
refuses to run without a card or outside the repository."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ntransformer_tpu_torch")


def _port_modules() -> list[str]:
    mods = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py") and f != "__main__.py":
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def _run(code: str, env_extra=None, cwd=REPO):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    assert "ntransformer_tpu_torch.ops.cuda.matmul" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ntransformer_tpu' or m.startswith('ntransformer_tpu.')]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("call", [
    "from ntransformer_tpu_torch.models.loader import load_model\n"
    "load_model('models/repolm512_q8.gguf')",
    "from ntransformer_tpu_torch.models.synth import synth_model\n"
    "synth_model('tiny', 'q8_0')",
    "from ntransformer_tpu_torch.inference.engine import Engine\n"
    "Engine.load('models/repolm512_q8.gguf')",
])
def test_entry_points_default_to_cuda_and_raise_without_it(call):
    r = _run("import torch\nassert not torch.cuda.is_available()\n" + call)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr, r.stderr


def test_cli_defaults_to_cuda_and_raises_without_it():
    r = _run("from ntransformer_tpu_torch.cli import main\n"
             "main(['-m', 'models/repolm512_q8.gguf', '-n', '2'])")
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_kernel_modules_import_without_nvcc(tmp_path):
    """With no nvcc anywhere, importing the kernel modules and computing on
    CPU tensors works; asking for a build raises."""
    code = (
        "import torch\n"
        "from ntransformer_tpu_torch.ops.cuda import attention, build, matmul\n"
        "x = torch.zeros(1, 32)\n"
        "y = matmul.quant_matmul_cuda(x, torch.zeros(32, 16, dtype=torch.int8),"
        " torch.zeros(1, 16, dtype=torch.int16))\n"
        "assert y.shape == (1, 16) and matmul.launches == 0\n"
        "try:\n"
        "    build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    print('REFUSED', e)\n")
    r = _run(code, {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert "REFUSED nvcc not found" in r.stdout


def test_chip_smoke_fails_without_a_card():
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, cwd=tmp_path, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_and_port_sources_name_no_jax():
    """A static check beside the import test: no source line imports jax or
    the JAX package."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, fs in os.walk(PKG):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            for line in f:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert mod.split(".")[0] not in ("jax", "jaxlib",
                                                     "ntransformer_tpu"), \
                        f"{path}: {s}"
