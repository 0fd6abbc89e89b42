"""The port's native staging engine (memory/native.py over its own build of
csrc/ntstage.cpp): the JAX suite's cases (tests/test_native.py) on the
port's library, which has no Python fallback: concurrent reads and copies,
a failed open, aligned buffers, O_DIRECT reads with every precondition
failure read through the page cache (and counted), and a ThreadSanitizer
build of the port's source."""
import os
import subprocess
import tempfile

import numpy as np
import pytest

from ntransformer_tpu_torch.memory import native
from ntransformer_tpu_torch.memory.native import (DIRECT_ALIGN, StagePool,
                                                  aligned_empty)
import test_native


@pytest.fixture
def data_file():
    rng = np.random.default_rng(1)
    n = 64 * 4096 + 512  # an unaligned tail, like a pack's last bytes
    data = rng.integers(0, 255, n, dtype=np.uint8)
    f = tempfile.NamedTemporaryFile(delete=False)
    f.write(data.tobytes())
    f.close()
    yield f.name, data
    os.unlink(f.name)


def test_library_is_built_from_the_port_source():
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.SRC.endswith(os.path.join("ntransformer_tpu_torch", "csrc",
                                            "ntstage.cpp"))
    assert native.build() == path and os.path.exists(path)


def test_stagepool_concurrent_stress():
    """Many overlapping reads and copies across jobs land exactly."""
    pool = StagePool(8)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 255, 1 << 22, dtype=np.uint8)  # 4 MB
    f = tempfile.NamedTemporaryFile(delete=False)
    f.write(data.tobytes())
    f.close()
    try:
        dests = [np.zeros(1 << 20, np.uint8) for _ in range(8)]
        jobs = []
        for i, d in enumerate(dests):
            off = (i % 4) << 20
            jobs.append((pool.read(f.name, off, 1 << 20, d), off, d))
        copies = [np.zeros(1 << 20, np.uint8) for _ in range(4)]
        cjobs = [pool.copy(data[i << 20:], c, 1 << 20)
                 for i, c in enumerate(copies)]
        for h, off, d in jobs:
            pool.wait(h)
            np.testing.assert_array_equal(d, data[off: off + (1 << 20)])
        for i, h in enumerate(cjobs):
            pool.wait(h)
            np.testing.assert_array_equal(
                copies[i], data[i << 20: (i + 1) << 20])
    finally:
        os.unlink(f.name)
        pool.close()


def test_stagepool_read_error():
    """A failed open raises; there is no Python fallback to hide it."""
    pool = StagePool(2)
    dest = np.zeros(4096, np.uint8)
    with pytest.raises(OSError):
        pool.read("/nonexistent/file/path", 0, 4096, dest)
    with pytest.raises(ValueError):
        pool.read("/nonexistent/file/path", 0, 8192, dest)
    pool.close()


def test_stagepool_short_read_raises(data_file):
    """A read past the end of the file reports its error at wait()."""
    path, data = data_file
    pool = StagePool(2)
    dest = np.zeros(8192, np.uint8)
    h = pool.read(path, data.size - 100, 8192, dest)
    with pytest.raises(OSError):
        pool.wait(h)
    pool.close()


@pytest.mark.parametrize("size", [1, 4095, 4096, 1 << 20])
def test_aligned_empty_alignment(size):
    a = aligned_empty(size)
    assert a.ctypes.data % 4096 == 0
    assert a.nbytes == size
    a[:] = 7  # writable, base kept alive
    assert int(a[0]) == 7


def test_stagepool_direct_read_correct_and_falls_back(data_file):
    """Aligned offset, aligned buffer and an extent inside the file read
    directly (where the filesystem takes O_DIRECT); every failed
    precondition reads through the page cache, exactly, and is counted."""
    path, data = data_file
    n = data.size
    pool = StagePool(4)
    dest = aligned_empty(8 * 4096)
    pool.wait(pool.read(path, 4096, 8 * 4096, dest, direct=True))
    np.testing.assert_array_equal(dest, data[4096: 9 * 4096])
    direct_ok = pool.direct_reads == 1
    assert pool.direct_reads + pool.buffered_reads == 1

    before = pool.buffered_reads
    # unaligned offset
    dest2 = aligned_empty(4096)
    pool.wait(pool.read(path, 100, 4096, dest2, direct=True))
    np.testing.assert_array_equal(dest2, data[100: 100 + 4096])
    # unaligned destination
    dest3 = np.empty(4096 + 1, np.uint8)[1:]
    if dest3.ctypes.data % DIRECT_ALIGN == 0:
        dest3 = np.empty(4096 + 3, np.uint8)[3:]
    pool.wait(pool.read(path, 4096, 4096, dest3, direct=True))
    np.testing.assert_array_equal(dest3, data[4096: 2 * 4096])
    # the rounded extent past the end of the file
    tail_off = (n // 4096) * 4096
    dest4 = aligned_empty(4096)
    pool.wait(pool.read(path, tail_off, n - tail_off, dest4, direct=True))
    np.testing.assert_array_equal(dest4[:n - tail_off], data[tail_off:])
    assert pool.buffered_reads == before + 3
    assert pool.direct_reads == (1 if direct_ok else 0)
    pool.close()


def test_pack_file_padded_for_direct(tmp_path):
    """The port's PackWriter pads the file end to 4096 so every layer's
    rounded O_DIRECT extent stays inside the file."""
    from ntransformer_tpu_torch.core.gguf import GGUFReader
    from ntransformer_tpu_torch.memory.pack import PackWriter
    from tools.make_test_gguf import write_model
    g = str(tmp_path / "tiny.gguf")
    write_model(g, "tiny", "q8_0", seed=2)
    pack = PackWriter(GGUFReader(g)).write(str(tmp_path / "t.ntp"))
    assert os.path.getsize(pack.path) % 4096 == 0
    for j in range(pack.n_layers):
        meta = pack.layer_meta(j)
        assert meta["offset"] % 4096 == 0
        rounded = (meta["size"] + 4095) // 4096 * 4096
        assert meta["offset"] + rounded <= os.path.getsize(pack.path)


def test_ntstage_tsan(tmp_path):
    """The port's source under -fsanitize=thread, hammered by the JAX
    suite's stress program: TSAN aborts on a data race."""
    drv = tmp_path / "stress.cpp"
    exe = tmp_path / "stress"
    drv.write_text(test_native.TSAN_DRIVER)
    try:
        subprocess.run(
            ["g++", "-O1", "-g", "-std=c++17", "-pthread",
             "-fsanitize=thread", native.SRC, str(drv), "-o", str(exe)],
            check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        pytest.skip(f"tsan build unavailable: {e.stderr.decode()[:200]}")
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1 exitcode=66")
    r = subprocess.run([str(exe)], capture_output=True, env=env, timeout=120)
    assert r.returncode == 0, (r.stderr.decode()[-800:] or r.stdout.decode())
    assert b"TSAN-OK" in r.stdout
