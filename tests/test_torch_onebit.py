"""Onebit kernels and codec of the PyTorch port against the JAX package.

The port's plain pack / unpack / merge (the versions its wrappers run on
CPU tensors) are held against the Pallas kernels run in interpret mode,
as tests/test_pallas_kernels.py runs them.  Words and decompressed values
must be bit-exact (sign * scale is exact and the merge adds ranks in the
same order); the scale, an L1 sum taken in another order, to rtol 1e-6.
The merge is also held on ``chip_smoke.merge_inputs`` (a zero scale and
mixed magnitudes), on which two wrong merges must differ in bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.compression import create as jax_create
from byteps_tpu.ops import pallas_kernels as pk
from byteps_tpu_torch.compression import registry as port_registry
from byteps_tpu_torch.ops import build as port_build
from byteps_tpu_torch.ops import onebit_kernels as ok
from chip_smoke import merge_controls, merge_inputs

# ragged sizes, and the three smallest chunk sizes of the ResNet-50 slice
NUMELS = [100, 4096, 50000, 16384, 24576, 36864]


def _x(numel, seed, specials=False):
    x = np.random.RandomState(seed).randn(numel).astype(np.float32)
    if specials:
        # NaN packs as 0, -0.0 as 1, and both feed the scale
        x[::7] = -0.0
        x[3] = np.nan
        x[5] = 0.0
    return x


def _pallas_pack(x):
    L = pk.padded_lanes(len(x))
    x2d = jnp.pad(jnp.asarray(x), (0, 32 * L - len(x))).reshape(32, L)
    words, abs_sum = pk.onebit_pack(x2d, interpret=True)
    return np.array(words), np.float32(abs_sum)


def _u32(t):
    return t.numpy().view(np.uint32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_padded_lanes_match():
    for n in [1, 31, 32, 4095, 4096, 4097, 50000, 1024000]:
        assert ok.padded_lanes(n) == pk.padded_lanes(n)


@pytest.mark.parametrize("specials", [False, True], ids=["randn", "nan-negzero"])
@pytest.mark.parametrize("numel", NUMELS)
def test_pack_matches_pallas(numel, specials):
    x = _x(numel, seed=1, specials=specials)
    ref_words, ref_abs = _pallas_pack(x)
    words, sums = ok.onebit_pack_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(_u32(words), ref_words)
    np.testing.assert_allclose(sums[0].item(), ref_abs, rtol=1e-6)
    np.testing.assert_allclose(sums[1].item(), ref_abs / numel, rtol=1e-6)
    # padding elements are +0.0 and pack as 1 bits: the padded lanes of
    # the last row are not zero words
    L = ok.padded_lanes(numel)
    if 32 * L > numel:
        assert _u32(words)[-1] & (1 << 31)


@pytest.mark.parametrize("numel", NUMELS)
def test_unpack_matches_pallas(numel):
    x = _x(numel, seed=2, specials=True)
    words, _ = _pallas_pack(x)
    scale = np.float32(0.375)
    ref = np.asarray(pk.onebit_unpack(jnp.asarray(words), jnp.float32(scale),
                                      interpret=True)).reshape(-1)[:numel]
    got = ok.onebit_unpack_plain(
        torch.from_numpy(words.view(np.int32)), torch.tensor(scale), numel)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def _pallas_unpack_sum(words, scales, numel):
    return np.asarray(pk.onebit_unpack_sum(
        jnp.asarray(words.view(np.uint32)), jnp.asarray(scales),
        interpret=True)).reshape(-1)[:numel]


def _plain_unpack_sum(words, scales, numel):
    return ok.onebit_unpack_sum_plain(torch.from_numpy(words),
                                      torch.from_numpy(scales), numel)


@pytest.mark.parametrize("R", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("numel", NUMELS)
def test_unpack_sum_matches_pallas(numel, R):
    """Two merges of R ranks: the packs of R random chunks with their own
    scales, and ``merge_inputs`` (independent random words, rank 0's scale
    0.0, the others of mixed magnitude)."""
    words, scales = [], []
    for r in range(R):
        w, a = _pallas_pack(_x(numel, seed=10 + r))
        words.append(w)
        scales.append(a / numel)
    packed = (np.stack(words).view(np.int32), np.asarray(scales, np.float32))
    for words, scales in (packed,
                          merge_inputs(R, ok.padded_lanes(numel), numel + R)):
        ref = _pallas_unpack_sum(words, scales, numel)
        got = _plain_unpack_sum(words, scales, numel)
        if R == 1 and scales[0] == 0.0:
            # +0.0 + (+-0.0) is +0.0 everywhere, as the port adds; XLA
            # folds the interpret run's zeros + product to the product
            # (-0.0 where a bit is 0), so that run is held to the values
            assert not _bits(got).any()
            np.testing.assert_array_equal(got.numpy(), ref)
            continue
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("R,control", [
    (1, "rank 0's product as the start"), (4, "reversed order"),
    (5, "reversed order"), (8, "reversed order")])
@pytest.mark.parametrize("numel", NUMELS)
def test_unpack_sum_controls_differ_in_bits(numel, R, control):
    """On ``merge_inputs`` a merge that adds the ranks in reverse order, or
    starts from rank 0's product instead of +0.0, differs in bits from the
    plain merge (and so from a kernel that is right), so the card checks,
    which use the same inputs, can see either fault."""
    words, scales = merge_inputs(R, ok.padded_lanes(numel), numel + R)
    ref = _bits(_plain_unpack_sum(words, scales, numel))
    bad = merge_controls(ok, torch.from_numpy(words),
                         torch.from_numpy(scales), numel)[control]
    assert (_bits(bad) != ref).any()


def test_cpu_wrappers_take_the_plain_version():
    ok.reset_launches()
    x = torch.from_numpy(_x(5000, seed=3))
    w, s = ok.onebit_pack(x)
    w2, s2 = ok.onebit_pack_plain(x)
    assert torch.equal(w, w2) and torch.equal(s, s2)
    assert torch.equal(ok.onebit_unpack(w, s[1], 5000),
                       ok.onebit_unpack_plain(w, s[1], 5000))
    ws, ss = torch.stack([w, w]), torch.stack([s[1], s[1]])
    assert torch.equal(ok.onebit_unpack_sum(ws, ss, 5000),
                       ok.onebit_unpack_sum_plain(ws, ss, 5000))
    # no kernel ran
    assert ok.launches == {"onebit_pack": 0, "onebit_unpack": 0,
                           "onebit_unpack_sum": 0}


@pytest.mark.parametrize("kwargs", [
    {"compressor": "onebit"},
    {"compressor": "onebit", "ef": "vanilla"},
    {"compressor": "onebit", "scaling": "false"},
], ids=["onebit", "onebit-ef", "onebit-noscale"])
def test_codec_chain_matches_jax(kwargs):
    """Three steps of the codec chain (error feedback threads its residual
    through them): payloads and decompressions agree with the JAX codec."""
    numel = 7000
    jc = jax_create(dict(kwargs), numel)
    pc = port_registry.create(dict(kwargs), numel)
    jstate, pstate = jc.init_state(), pc.init_state(torch.device("cpu"))
    for step in range(3):
        x = _x(numel, seed=20 + step)
        jp, jstate = jc.compress(jnp.asarray(x), jstate)
        pp, pstate = pc.compress(torch.from_numpy(x), pstate)
        np.testing.assert_array_equal(_u32(pp["words"]),
                                      np.asarray(jp["words"]))
        np.testing.assert_allclose(float(pp["scale"]), float(jp["scale"]),
                                   rtol=1e-6)
        # same payload in, bit-identical values out
        jd = np.asarray(jc.decompress(jp))
        pd = pc.decompress({"words": pp["words"],
                            "scale": torch.tensor(np.float32(jp["scale"]))})
        np.testing.assert_array_equal(_bits(pd), _bits(jd))
        if "ef" in kwargs:
            np.testing.assert_allclose(pstate["error"].numpy(),
                                       np.asarray(jstate["error"]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("numel", NUMELS)
def test_wire_frames_byte_identical_and_cross_decode(numel):
    kw = {"compressor": "onebit", "ef": "vanilla"}
    jc, pc = jax_create(dict(kw), numel), port_registry.create(dict(kw),
                                                               numel)
    words, abs_sum = _pallas_pack(_x(numel, seed=4))
    scale = np.float32(abs_sum / numel)
    jframe = jc.wire_encode({"words": jnp.asarray(words),
                             "scale": jnp.float32(scale)})
    pframe = pc.wire_encode({"words": torch.from_numpy(words.view(np.int32)),
                             "scale": torch.tensor(scale)})
    assert pframe == jframe
    from_jax = pc.wire_decode(jframe)
    np.testing.assert_array_equal(_u32(from_jax["words"]), words)
    assert float(from_jax["scale"]) == float(scale)
    from_port = jc.wire_decode(pframe)
    np.testing.assert_array_equal(np.asarray(from_port["words"]), words)
    assert float(from_port["scale"]) == float(scale)
    with pytest.raises(ValueError, match="expected"):
        port_registry.create(dict(kw), numel + 5000).wire_decode(jframe)


def test_registry_names_what_is_registered():
    with pytest.raises(ValueError, match=r"registered: compressors \['onebit'\]"):
        port_registry.create({"compressor": "topk"}, 100)
    with pytest.raises(ValueError, match="unknown ef"):
        port_registry.create({"compressor": "onebit", "ef": "vanila"}, 100)
    with pytest.raises(ValueError, match="not ported"):
        port_registry.create({"compressor": "onebit",
                              "momentum": "nesterov"}, 100)
    assert port_registry.create(None, 100).name == "identity"


@pytest.mark.parametrize("kernel", ["onebit_pack", "onebit_unpack",
                                    "onebit_unpack_sum"])
@pytest.mark.parametrize("numel", [1, 31, 100, 4097, 16384, 24576, 36864,
                                   131072, 311296, 589824, 1024000,
                                   1024000 - 12345, 32 * 128 + 3])
def test_launch_geometry_covers_every_word_once(numel, kernel):
    """pack, unpack and unpack_sum launch ``blocks`` tiles of ``4 * vw``
    words; block b's thread t takes words 4 (b vw + t % vw) .. +3 and rows
    (t // vw) * r .. +r-1 (r = 32 vw / 256), as csrc/onebit.cu does."""
    L = ok.padded_lanes(numel)
    vw, blocks = ok.launch_geometry(L, kernel)
    assert vw in ok.VECTOR_WIDTHS and blocks * 4 * vw == L
    if kernel in ("onebit_unpack", "onebit_unpack_sum"):
        assert vw == ok.UNPACK_VW
    else:   # the widest tile that gives PACK_MIN_BLOCKS, else the narrowest
        wider = [w for w in ok.VECTOR_WIDTHS if w > vw]
        assert all(L // (4 * w) < ok.PACK_MIN_BLOCKS for w in wider)
        assert blocks >= ok.PACK_MIN_BLOCKS or vw == min(ok.VECTOR_WIDTHS)
    t = np.arange(256)
    rpt = 32 * vw // 256
    cells = np.zeros((32, L), np.int64)
    for b in range(blocks):
        j = (b * vw + t % vw) * 4
        for c in range(4):
            for k in range(rpt):
                np.add.at(cells, ((t // vw) * rpt + k, j + c), 1)
    assert (cells == 1).all()


def test_aligned_picks_the_16_byte_instance():
    store = torch.zeros(4100, dtype=torch.float32)
    assert ok._aligned(store) == (store.data_ptr() % 16 == 0)
    base = store[(-store.data_ptr() // 4) % 4:][:4096]   # 16-byte aligned
    assert ok._aligned(base)
    assert not ok._aligned(base[1:])                     # 4 bytes in
    assert ok._aligned(base[4:], base[8:])
    assert not ok._aligned(base[4:], base[2:])


def test_workspace_is_kept_per_device_and_stream():
    """One zeroed workspace per (device, stream), reused while it is large
    enough and replaced by a larger zeroed one when it is not."""
    cpu = torch.device("cpu")
    ok._workspaces.clear()
    try:
        a = ok._workspace(cpu, 11, 250)
        assert a.dtype == torch.int32 and a.numel() >= ok.WS_HEAD + 2 * 250
        assert not a.any()
        assert ok._workspace(cpu, 11, 1000) is a         # room for 1000
        assert ok._workspace(cpu, 12, 250) is not a      # another stream
        a[0] = 7                                         # a tag in use
        big = ok._workspace(cpu, 11, 5000)
        assert big is not a and big.numel() >= ok.WS_HEAD + 2 * 5000
        assert not big.any()
        assert ok._workspace(cpu, 11, 10) is big
        assert len(ok._workspaces) == 2
    finally:
        ok._workspaces.clear()


def test_build_without_nvcc_raises(monkeypatch):
    """No silent fallback: a missing toolchain is an error."""
    monkeypatch.setattr(port_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(port_build, "DEFAULT_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        port_build.nvcc_path()
