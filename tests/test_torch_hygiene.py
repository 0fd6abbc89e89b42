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
    "from ntransformer_tpu_torch.models.synth import synth_model\n"
    "synth_model('tiny', 'q4_k_m')",
    "from ntransformer_tpu_torch.inference.engine import Engine\n"
    "Engine.load('models/repolm512_q8.gguf')",
    "from ntransformer_tpu_torch.models.synth import synth_model\n"
    "synth_model('tiny512', 'w4a8')",
    "from ntransformer_tpu_torch.inference.engine import Engine\n"
    "Engine.load('models/repolm512_q8.gguf', w8a8=True)",
    "from ntransformer_tpu_torch.models.tiered import load_model_tiered\n"
    "load_model_tiered('models/repolm512_q8.gguf', max_hbm_layers=1)",
    "from ntransformer_tpu_torch.inference.engine import TieredEngine\n"
    "TieredEngine.load('models/repolm512_q8.gguf', max_hbm_layers=1)",
    "from ntransformer_tpu_torch.memory.tiers import TierConfig\n"
    "TierConfig.compute(4, 1 << 20, 0)",
    "from ntransformer_tpu_torch.inference.engine import CPEngine\n"
    "CPEngine.load('models/repolm512_q8.gguf', cp=1)",
    "from ntransformer_tpu_torch.parallel.cp import make_cp_mesh\n"
    "make_cp_mesh(1)",
    "from ntransformer_tpu_torch.inference.engine import TPEngine\n"
    "TPEngine.load('models/repolm512_q8.gguf', tp=1)",
    "from ntransformer_tpu_torch.parallel.tp import make_tp_mesh\n"
    "make_tp_mesh(1)",
    "from ntransformer_tpu_torch.inference.engine import TPEngine\n"
    "TPEngine.load('models/repolm512_q8.gguf', tp=2, device='cuda:0')",
    "from ntransformer_tpu_torch.models.tiered import load_model_tiered\n"
    "load_model_tiered('models/repolm512_q8.gguf', mesh=('cuda',) * 2)",
    "from ntransformer_tpu_torch.inference.engine import EPEngine\n"
    "EPEngine.load('models/repolm512_q8.gguf', ep=2)",
    "from ntransformer_tpu_torch.parallel.ep import make_ep_mesh\n"
    "make_ep_mesh(1)",
    "from ntransformer_tpu_torch.parallel.pp import make_pp_mesh\n"
    "make_pp_mesh(1)",
    "from ntransformer_tpu_torch.parallel.cp import make_cp_tp_mesh\n"
    "make_cp_tp_mesh(1, 2)",
    "from ntransformer_tpu_torch.inference.engine import CPEngine\n"
    "CPEngine.load('models/repolm512_q8.gguf', cp=2, tp=2)",
    "from ntransformer_tpu_torch.tools.perplexity import main\n"
    "main(['-m', 'models/repolm512_q8.gguf', '-f', 'README.md'])",
    "from ntransformer_tpu_torch.tools.quality_gate import run_gate\n"
    "run_gate('models/repolm512_q8.gguf', 'README.md', [], "
    "'/nonexistent/fx.json', False)",
])
def test_entry_points_default_to_cuda_and_raise_without_it(call):
    r = _run("import torch\nassert not torch.cuda.is_available()\n" + call)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr, r.stderr


def test_cli_defaults_to_cuda_and_raises_without_it():
    r = _run("from ntransformer_tpu_torch.cli import main\n"
             "main(['-m', 'models/repolm512_q8.gguf', '-n', '2'])")
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_cli_serve_defaults_to_cuda_and_raises_without_it(tmp_path):
    prompts = tmp_path / "p.txt"
    prompts.write_text("def f(x):\n")
    r = _run("from ntransformer_tpu_torch.cli import main\n"
             f"main(['-m', 'models/repolm512_q8.gguf', '--serve', "
             f"{str(prompts)!r}])")
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


@pytest.mark.parametrize("flags", [["--http", "0"], ["--chat"]],
                         ids=lambda f: f[0])
def test_cli_http_and_chat_default_to_cuda_and_raise_without_it(flags):
    r = _run("from ntransformer_tpu_torch.cli import main\n"
             f"main(['-m', 'models/repolm512_q8.gguf'] + {flags!r})")
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


@pytest.mark.parametrize("flags", [["--tp", "2"],
                                   ["--tp", "2", "--streaming"],
                                   ["--ep", "2"], ["--cp", "2", "--tp", "2"]],
                         ids=["tp", "tp-streaming", "ep", "cp-tp"])
def test_cli_tp_defaults_to_cuda_and_raises_without_it(flags):
    r = _run("from ntransformer_tpu_torch.cli import main\n"
             f"main(['-m', 'models/repolm512_q8.gguf', '-n', '2'] + "
             f"{flags!r})")
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


@pytest.mark.parametrize("flags", [["--serve", "p.txt", "--dp", "2"],
                                   ["--serve", "p.txt", "--tp", "2",
                                    "--dp", "2"],
                                   ["--http", "0", "--dp", "2"]],
                         ids=["serve-dp", "serve-tp-dp", "http-dp"])
def test_cli_sharded_serve_defaults_to_cuda_and_raises_without_it(flags):
    r = _run("from ntransformer_tpu_torch.cli import main\n"
             f"main(['-m', 'models/repolm512_q8.gguf'] + {flags!r})")
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_make_mesh_defaults_to_cuda_and_raises_without_it():
    r = _run("from ntransformer_tpu_torch.parallel.multihost import "
             "make_mesh\nmake_mesh(tp=1, dp=2)")
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_cli_streaming_defaults_to_cuda_and_raises_without_it():
    r = _run("from ntransformer_tpu_torch.cli import main\n"
             "main(['-m', 'models/repolm512_q8.gguf', '--streaming', "
             "'-n', '2'])")
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_port_imports_no_ml_dtypes():
    """The pack writes bf16 without ml_dtypes (a JAX dependency the machine
    with the card does not have): no port module imports it."""
    mods = _port_modules()
    assert "ntransformer_tpu_torch.memory.pack" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'ml_dtypes' not in sys.modules\n")
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr


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
        "from ntransformer_tpu_torch.ops.cuda import batched_attention, "
        "kv_update\n"
        "c = torch.zeros(1, 1, 1, 8, 64, dtype=torch.bfloat16)\n"
        "o = batched_attention.flash_decode_batched(torch.zeros(1, 2, 64), c,"
        " c, torch.zeros(1, 1, 64), torch.zeros(1, 1, 64), torch.tensor([3]),"
        " 0.125, layer=0)\n"
        "kv_update.append_rows_stacked((c,), (torch.ones(1, 1, 1, 64),), "
        "torch.tensor([2]), torch.tensor([True]))\n"
        "assert o.shape == (1, 2, 64) and float(c[0, 0, 0, 2].sum()) == 64\n"
        "assert batched_attention.launches == kv_update.launches == 0\n"
        "from ntransformer_tpu_torch.ops.cuda import w4a8, w8a8\n"
        "y = w8a8.w8a8_matmul_cuda(torch.ones(3, 32), torch.ones(32, 16, "
        "dtype=torch.int8), torch.ones(1, 16))\n"
        "assert y.shape == (3, 16) and float(y[0, 0]) == 32.0\n"
        "from ntransformer_tpu_torch.core.dtypes import DType\n"
        "from ntransformer_tpu_torch.models.synth import synth_qlinear\n"
        "ql = synth_qlinear(16, 512, DType.W4A8, device='cpu')\n"
        "y = w4a8.w4a8_decode_cuda(torch.ones(1, 512), ql.planes)\n"
        "assert y.shape == (1, 16) and bool(torch.isfinite(y).all())\n"
        "assert w8a8.launches == w4a8.launches == 0\n"
        "try:\n"
        "    build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    print('REFUSED', e)\n")
    r = _run(code, {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert "REFUSED nvcc not found" in r.stdout


def test_kquant_file_load_defaults_to_cuda_and_raises_without_it(tmp_path):
    from tools.make_test_gguf import write_model
    path = write_model(str(tmp_path / "q4km.gguf"), "tiny", "q4_k_m", seed=2)
    r = _run("from ntransformer_tpu_torch.models.loader import load_model\n"
             f"load_model({path!r})")
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_nibble_kernel_module_runs_on_cpu_without_nvcc(tmp_path):
    """With no nvcc anywhere, the nibble-format wrapper on CPU tensors is
    its plain twin and launches nothing."""
    code = (
        "import torch\n"
        "from ntransformer_tpu_torch.core.dtypes import DType\n"
        "from ntransformer_tpu_torch.models.synth import synth_qlinear\n"
        "from ntransformer_tpu_torch.ops.cuda import nibble_matmul as nm\n"
        "for dt in nm.KERNELS:\n"
        "    # W4A8 takes this path at T > 1 only, on whole 512-unit K\n"
        "    t, k = (2, 512) if dt == DType.W4A8 else (1, 256)\n"
        "    ql = synth_qlinear(64, k, dt, device='cpu')\n"
        "    y = nm.nibble_matmul_cuda(torch.ones(t, k), ql.planes, dt)\n"
        "    assert y.shape == (t, 64) and bool(torch.isfinite(y).all())\n"
        "assert all(k.launches == 0 for k in nm.KERNELS.values())\n"
        "print('OK')\n")
    r = _run(code, {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout


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


def test_kernel_launches_run_on_their_tensors_card():
    """A static check: every C entry a wrapper calls through ctypes runs
    inside `with torch.cuda.device(...)`, since a ctypes launch (and the
    default stream's handle, 0) goes to the current card, not to the card
    of the tensors (a context-parallel shard on cuda:1, say)."""
    import ast
    cuda_dir = os.path.join(PKG, "ops", "cuda")
    launches = 0
    for name in sorted(os.listdir(cuda_dir)):
        if not name.endswith(".py") or name in ("__init__.py", "build.py"):
            continue
        tree = ast.parse(open(os.path.join(cuda_dir, name)).read())
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    ast.unparse(it.context_expr).startswith(
                        "torch.cuda.device(") for it in node.items):
                guarded.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = ast.unparse(node.func)
            if (fn.startswith("lib.") or fn.startswith("getattr(lib")) \
                    and fn != "lib.nt_error_string":
                launches += 1
                assert id(node) in guarded, \
                    f"ops/cuda/{name}:{node.lineno}: {fn} outside " \
                    "torch.cuda.device"
    assert launches >= 8


@pytest.mark.parametrize("path,func", [
    ("ops/dequant_torch.py", "quantize_rows_torch"),
    ("ops/dequant_torch.py", "requant_w8a8_torch"),
    ("ops/dequant_torch.py", "requant_w4a8_torch"),
    ("ops/dequant_torch.py", "quantize_activations_torch"),
    ("models/llama.py", "quantize_rows"),
])
def test_quantizers_divide_by_tensors(path, func):
    """A static check: the quantizers the card runs divide by no Python
    number. PyTorch on CUDA divides a tensor by a Python scalar through the
    scalar's reciprocal, which moves ~5% of the scales one ulp from the
    IEEE division of the JAX package (core/w8a8.quantize_rows and its
    kin); a tensor divisor (torch.full_like) divides exactly."""
    import ast
    tree = ast.parse(open(os.path.join(PKG, path)).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    divs = [n for n in ast.walk(fn)
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Div)]
    assert divs, f"{func} divides nothing"
    for n in divs:
        assert not (isinstance(n.right, ast.Constant)
                    and isinstance(n.right.value, (int, float))), \
            f"{path}:{n.lineno}: {ast.unparse(n)} divides by a Python number"
