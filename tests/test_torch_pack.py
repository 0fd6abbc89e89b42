"""Port parity for tier sizing and the NTP1 pack (memory/tiers.py,
memory/pack.py): the port's TierConfig against the JAX package's on the
same budgets, and the port's pack against the JAX package's PackWriter,
byte for byte, for Q8_0, Q4_K_M, Q6_K, Q6_K requantized to Q4_K, and float
matrices. Either package's PackReader reads the other's pack; the runtime
tier-B requant is byte-equal to the JAX one and to the offline requant."""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from ntransformer_tpu.core.dtypes import DType as JDType
from ntransformer_tpu.core.gguf import GGUFReader as JReader
from ntransformer_tpu.memory import pack as jpack
from ntransformer_tpu.memory.tiers import TierConfig as JTierConfig
from ntransformer_tpu_torch.core.dtypes import DType
from ntransformer_tpu_torch.core.gguf import GGUFReader
from ntransformer_tpu_torch.memory import pack as ppack
from ntransformer_tpu_torch.memory.tiers import TierConfig
from test_torch_model import one_torch_thread  # noqa: F401
from tools.make_test_gguf import write_model

GB = 1 << 30
FORMATS = ["q8_0", "q4_k_m", "q6_k", "q6_k+requant", "f32", "f16"]


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("packs")
    out = {}
    for fmt in ("q8_0", "q4_k_m", "q6_k", "f32", "f16"):
        out[fmt] = write_model(str(d / f"tiny_{fmt}.gguf"), "tiny", fmt,
                               seed=5)
    return out


def _source(ggufs, fmt):
    base = fmt.split("+")[0]
    requant = "+requant" in fmt
    return ggufs[base], requant


# --- tier sizing --------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # n_layers, layer_bytes, reserve, hbm, ram, max_hbm, max_ram, ram_layer
    (80, GB, 2 * GB, 16 * GB, 40 * GB, None, None, None),
    (10, GB, 0, 64 * GB, 64 * GB, 2, 3, None),
    (32, 150 << 20, 6 * GB, 80 * GB, 96 * GB, 8, 16, None),
    (32, 150 << 20, 6 * GB, 4 * GB, 7 * GB, None, None, None),
    (40, GB, GB, 8 * GB, 30 * GB, None, None, 690 << 20),
    (4, 0, 0, GB, GB, None, None, None),
])
def test_tier_config_matches_jax(case):
    n, lb, res, hbm, ram, mh, mr, rlb = case
    got = TierConfig.compute(n, lb, res, hbm_bytes=hbm, ram_bytes=ram,
                             max_hbm_layers=mh, max_ram_layers=mr,
                             ram_layer_bytes=rlb)
    want = JTierConfig.compute(n, lb, res, hbm_bytes=hbm, ram_bytes=ram,
                               max_hbm_layers=mh, max_ram_layers=mr,
                               ram_layer_bytes=rlb)
    assert (got.n_hbm, got.n_ram, got.n_disk) == \
        (want.n_hbm, want.n_ram, want.n_disk)
    assert got.describe(lb) == want.describe(lb)
    assert [got.tier_of(i) for i in range(n)] == \
        [want.tier_of(i) for i in range(n)]


def test_tier_config_auto_table():
    """The JAX suite's table (tests/test_tiered.py::test_tier_config_auto)."""
    tc = TierConfig.compute(80, 1 * GB, reserve_bytes=2 * GB,
                            hbm_bytes=16 * GB, ram_bytes=40 * GB)
    assert 0 < tc.n_hbm <= 14 and tc.n_ram > 0
    assert tc.n_hbm + tc.n_ram + tc.n_disk == 80
    assert tc.tier_of(0) == "hbm" and tc.tier_of(79) in ("ram", "disk")


def test_tier_config_needs_a_budget_without_cuda():
    """No 16 GiB guess: without CUDA and without hbm_bytes, sizing raises."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TierConfig.compute(4, GB, 0, ram_bytes=GB)


# --- the pack -----------------------------------------------------------------

def test_bf16_bits_match_ml_dtypes():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(50000).astype(np.float32),
        np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 1e-40,
                  -1e-42, 3.4e38, -3.4e38], np.float32),
        rng.integers(0, 2 ** 32, 100000, dtype=np.uint64).astype(
            np.uint32).view(np.float32)])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(ppack.bf16_bits(x), want)


def _write_both(ggufs, fmt, d):
    path, requant = _source(ggufs, fmt)
    key = ppack.gguf_content_key(path)
    assert key == jpack.gguf_content_key(path)
    p = ppack.PackWriter(GGUFReader(path),
                         DType.Q4_K if requant else None).write(
        os.path.join(d, "port.ntp"), src_key=key)
    j = jpack.PackWriter(JReader(path),
                         JDType.Q4_K if requant else None).write(
        os.path.join(d, "jax.ntp"), src_key=key)
    return p, j


@pytest.mark.parametrize("fmt", FORMATS)
def test_pack_bytes_equal_jax(ggufs, fmt, tmp_path):
    p, j = _write_both(ggufs, fmt, str(tmp_path))
    with open(p.path, "rb") as f:
        got = f.read()
    with open(j.path, "rb") as f:
        want = f.read()
    assert len(got) == len(want) and got == want
    assert len(got) % ppack.ALIGN == 0


def _jax_planes(jlw, name):
    q = getattr(jlw, name)
    return q.dtype.name, {nm: np.asarray(v) for nm, v in q.planes.items()}


def _port_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _jax_bits(a: np.ndarray) -> np.ndarray:
    if a.dtype == ml_dtypes.bfloat16 or a.dtype == np.uint16:
        return a.view(np.int16)
    return a


@pytest.mark.parametrize("fmt", FORMATS)
def test_packs_cross_read(ggufs, fmt, tmp_path):
    """The port reads the JAX pack and the JAX package reads the port's,
    plane for plane, and both equal the loaders' planes of the GGUF."""
    p, j = _write_both(ggufs, fmt, str(tmp_path))
    port_reads_jax = ppack.PackReader(j.path)
    jax_reads_port = jpack.PackReader(p.path)
    for layer in (0, 3):
        plw = port_reads_jax.layer_weights(
            layer, port_reads_jax.read_layer(layer))
        jlw = jax_reads_port.layer_weights(
            layer, jax_reads_port.read_layer(layer))
        for name in ppack.LAYER_TENSORS:
            dt, planes = _jax_planes(jlw, name)
            pq = getattr(plw, name)
            assert pq.dtype.name == dt
            assert set(pq.planes) == set(planes)
            for nm, arr in planes.items():
                np.testing.assert_array_equal(_port_bits(pq.planes[nm]),
                                              _jax_bits(arr))
        for name in ("attn_norm", "ffn_norm"):
            np.testing.assert_array_equal(getattr(plw, name).numpy(),
                                          np.asarray(getattr(jlw, name)))


def test_runtime_requant_byte_equal(ggufs, tmp_path):
    """requant_layer_meta / requant_layer_blob of a Q6_K layer equal the
    JAX package's, and the offline requant pack's layer."""
    path = ggufs["q6_k"]
    plain = ppack.PackWriter(GGUFReader(path)).write(
        str(tmp_path / "plain.ntp"))
    offline = ppack.PackWriter(GGUFReader(path), DType.Q4_K).write(
        str(tmp_path / "rq.ntp"))
    for layer in range(plain.n_layers):
        meta = plain.layer_meta(layer)
        new_meta = ppack.requant_layer_meta(meta, DType.Q4_K)
        jmeta = jpack.requant_layer_meta(meta, JDType.Q4_K)
        assert new_meta == jmeta
        assert new_meta["size"] < meta["size"]
        blob = plain.read_layer(layer)
        got = ppack.requant_layer_blob(meta, blob, new_meta, DType.Q4_K)
        want = jpack.requant_layer_blob(meta, blob, jmeta, JDType.Q4_K)
        np.testing.assert_array_equal(got, want)
        om = offline.layer_meta(layer)
        assert {k: v for k, v in om.items() if k != "offset"} == new_meta
        np.testing.assert_array_equal(got, offline.read_layer(layer))


def test_ensure_pack_builds_once_and_rebuilds_stale(ggufs, tmp_path):
    src = ggufs["q8_0"]
    path = str(tmp_path / "m.gguf")
    with open(src, "rb") as f, open(path, "wb") as g:
        g.write(f.read())
    p1 = ppack.ensure_pack(GGUFReader(path), path)
    assert p1.path == ppack.pack_path_for(path)
    mtime = os.path.getmtime(p1.path)
    p2 = ppack.ensure_pack(GGUFReader(path), path)
    assert p2.path == p1.path and os.path.getmtime(p2.path) == mtime
    assert p1.header["src_key"] == ppack.gguf_content_key(path)
    # a same-size edit of the tensor data (the tail is sampled) rebuilds
    with open(path, "r+b") as g:
        g.seek(-1, os.SEEK_END)
        last = g.read(1)
        g.seek(-1, os.SEEK_END)
        g.write(bytes([last[0] ^ 0xFF]))
    p3 = ppack.ensure_pack(GGUFReader(path), path)
    assert p3.header["src_key"] == ppack.gguf_content_key(path) \
        != p1.header["src_key"]
    assert ppack.pack_path_for(path, DType.Q4_K).endswith(
        ".requant_q4_k.ntp")


def test_unpack_copies_misaligned_planes(ggufs):
    """A plane whose address is not 16-byte aligned is copied, never
    handed out as a misaligned view; the values are the same."""
    pr = ppack.PackReader(ppack.ensure_pack(
        GGUFReader(ggufs["q4_k_m"]), ggufs["q4_k_m"]).path)
    meta = pr.layer_meta(1)
    blob = torch.from_numpy(pr.read_layer(1))
    aligned, n0 = ppack.unpack_layer(blob, meta)
    assert n0 == 0
    shifted = torch.empty(blob.numel() + 16, dtype=torch.uint8)
    base = (-shifted.data_ptr()) % 16 + 3   # 3 bytes past an aligned address
    shifted[base: base + blob.numel()] = blob
    mis, n1 = ppack.unpack_layer(shifted[base: base + blob.numel()], meta)
    assert n1 > 0
    for name in ppack.LAYER_TENSORS:
        a, b = getattr(aligned, name), getattr(mis, name)
        for nm in a.planes:
            assert b.planes[nm].data_ptr() % ppack.PLANE_ALIGN == 0
            assert torch.equal(a.planes[nm], b.planes[nm])


def test_pack_refuses_moe(tmp_path):
    """An MoE pack without per-expert sub-ranges (as a pack from before the
    format's version 5 would be) is refused by the tiered MoE loader with
    the JAX package's exception and message."""
    from ntransformer_tpu_torch.models.tiered_moe import \
        load_model_tiered_moe
    path = write_model(str(tmp_path / "moe.gguf"), "moe", "q8_0", seed=1)

    class NoExperts(ppack.PackWriter):
        def _layer_meta(self, i):
            meta = super()._layer_meta(i)
            meta.pop("experts")
            meta["size"] = max(m["off"] + ppack.plane_nbytes(m) for m in
                               [*meta["norms"].values(),
                                *(pm for t in meta["tensors"].values()
                                  for pm in t["planes"].values())])
            return meta
    NoExperts(GGUFReader(path)).write(ppack.pack_path_for(path),
                                      src_key=ppack.gguf_content_key(path))
    with pytest.raises(RuntimeError, match="no per-expert ranges"):
        load_model_tiered_moe(path, device="cpu")


@pytest.mark.parametrize("fmt", ["q8_0", "f32", "q4_k_m"])
def test_pack_moe_bytes_equal_jax(fmt, tmp_path):
    """An MoE file's pack: byte for byte the JAX PackWriter's (each expert's
    planes at a 4096-aligned sub-range), read by either package; one
    expert read alone equals its slice of the layer's blob."""
    from ntransformer_tpu.models.presets import PRESETS
    with pytest.MonkeyPatch.context() as mp:  # Q4_K wants K % 256
        mp.setitem(PRESETS, "moe256",
                   dict(PRESETS["moe"], hidden=256, inter=512))
        path = write_model(str(tmp_path / f"moe_{fmt}.gguf"),
                           "moe256" if fmt == "q4_k_m" else "moe", fmt,
                           seed=9)
    mine, theirs = str(tmp_path / "p.ntp"), str(tmp_path / "j.ntp")
    pr = ppack.PackWriter(GGUFReader(path)).write(mine, src_key="k")
    jpack.PackWriter(JReader(path)).write(theirs, src_key="k")
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    jr = jpack.PackReader(mine)
    for j in range(pr.n_layers):
        assert pr.n_experts(j) == jr.n_experts(j) == 4
        blob = pr.read_layer(j)
        for e in range(4):
            em = pr.expert_meta(j, e)
            assert em["off"] % 4096 == 0
            assert pr.expert_nbytes(j, e) == jr.expert_nbytes(j, e)
            one = pr.read_expert(j, e)
            np.testing.assert_array_equal(
                one, blob[em["off"]: em["off"] + em["size"]])
            whole = pr.expert_weights(j, e, blob)
            alone = pr.expert_weights(j, e, one, whole_layer=False)
            ref = jr.expert_weights(j, e, jr.read_layer(j))
            for key, ql in whole.items():
                for nm, a in ql.planes.items():
                    assert torch.equal(a, alone[key].planes[nm])
                    want = np.asarray(ref[key].planes[nm])
                    got = a.view(torch.int16) if a.dtype == torch.bfloat16 \
                        else a
                    np.testing.assert_array_equal(
                        got.numpy().view(want.dtype), want)
