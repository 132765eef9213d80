"""Tests of the PyTorch port that need an NVIDIA card; they skip elsewhere.

This file imports neither jax nor the JAX package, so it runs where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each CUDA kernel is held against its plain version on the same inputs:
the onebit kernels bit-exact in words and values, their scale (an L1 sum
taken in another order) to rtol 1e-6, the merge (unpack_sum) in its bits
on ``chip_smoke.merge_inputs``, which a merge in another order or from
rank 0's product cannot pass; the flash kernels to the
tolerances stated in ``test_flash_kernels_match_plain``, which are
``chip_smoke.py``'s (its ``row_share`` and ``FLASH_BF16_TOL``).
"""

import numpy as np
import pytest
import torch

from byteps_tpu_torch.ops import onebit_kernels as ok
from chip_smoke import (FLASH_BF16_TOL, merge_inputs, row_share,
                        same_bits)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _x(numel, seed, device):
    x = np.random.RandomState(seed).randn(numel).astype(np.float32)
    x[::7] = -0.0
    x[3] = np.nan
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("numel", [100, 4097, 50000, 1024000])
def test_kernels_match_plain(card, numel):
    x = _x(numel, 5, card)
    w, s = ok.onebit_pack(x)
    w0, s0 = ok.onebit_pack_plain(x)
    assert torch.equal(w, w0)
    torch.testing.assert_close(s, s0, rtol=1e-6, atol=0, equal_nan=True)
    x[3] = 1.0                              # a finite scale for the rest
    w, s = ok.onebit_pack(x)
    scale = s[1:]
    assert torch.equal(ok.onebit_unpack(w, scale, numel),
                       ok.onebit_unpack_plain(w, scale[0], numel))
    for R in (1, 8):
        ws = torch.stack([torch.roll(w, r) for r in range(R)])
        ss = torch.rand(R, generator=torch.Generator().manual_seed(R)).to(card)
        assert torch.equal(ok.onebit_unpack_sum(ws, ss, numel),
                           ok.onebit_unpack_sum_plain(ws, ss, numel))
    torch.cuda.synchronize()


# ragged sizes: one word, under a word, a word past a tile of 4096 floats,
# a tail row of 3 elements (32 * 128 + 3: L = 256, numel % 4 = 3), and a
# partition cut short (not a multiple of 4)
RAGGED = [1, 31, 4097, 32 * 128 + 3, 1024000 - 12345]


def _resnet_chunk_sizes():
    """The distinct chunk sizes of chip_smoke's ResNet-50 slice."""
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.common.partitioner import chunk_bounds
    from byteps_tpu_torch.models import resnet
    from chip_smoke import resnet_chunks
    return sorted(set(resnet_chunks(torch, resnet, Config(), chunk_bounds)))


def _specials(numel, seed, device):
    """randn with -0.0, 0.0 and NaN (packs as 1, 1 and 0) spread over it;
    the scale is then NaN, as the plain version's."""
    x = np.random.RandomState(seed).randn(numel).astype(np.float32)
    x[::7] = -0.0
    x[1::11] = 0.0
    x[2::13] = np.nan
    x[-1] = -0.0
    return torch.from_numpy(x).to(device)


def _pack_unpack_bit_exact(x, numel):
    w, s = ok.onebit_pack(x)
    w0, s0 = ok.onebit_pack_plain(x)
    assert torch.equal(w, w0), numel
    torch.testing.assert_close(s, s0, rtol=1e-6, atol=0, equal_nan=True)
    scale = torch.tensor([0.375], device=x.device)
    assert torch.equal(ok.onebit_unpack(w, scale, numel),
                       ok.onebit_unpack_plain(w, scale[0], numel)), numel


@pytest.mark.parametrize("numel", RAGGED)
def test_pack_unpack_bit_exact_at_ragged_sizes(card, numel):
    _pack_unpack_bit_exact(_specials(numel, numel % 1000, card), numel)
    torch.cuda.synchronize()


@pytest.mark.parametrize("vw", [None, *ok.VECTOR_WIDTHS])
def test_pack_unpack_bit_exact_at_resnet_chunk_sizes(card, monkeypatch, vw):
    """Every chunk size of the ResNet-50 slice (13 sizes, 16,384 to
    1,024,000 floats), with launch_geometry's tile width (None) and with
    each tile width forced."""
    sizes = _resnet_chunk_sizes()
    assert len(sizes) == 13
    if vw is not None:
        monkeypatch.setattr(ok, "launch_geometry",
                            lambda L, kernel: (vw, L // (4 * vw)))
    for numel in sizes:
        _pack_unpack_bit_exact(_specials(numel, 9, card), numel)
    torch.cuda.synchronize()


def _device_kernels(calls):
    """Run ``calls`` under one torch.profiler session; the names of the
    device kernels they ran, in order."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)]


@pytest.mark.parametrize("numel", [4097, 311296])
def test_misaligned_views_take_the_scalar_instance(card, numel):
    """An input one element into its storage is not 16-byte aligned: pack
    and unpack run their scalar-access instance (``<vw, false>``), one
    device kernel per call, and stay bit-exact; aligned inputs run
    ``<vw, true>``."""
    x = _specials(numel, 3, card)
    x[2::13] = 1.5                                   # a finite scale
    xv = torch.empty(numel + 1, device=card)[1:].copy_(x)
    w0, s0 = ok.onebit_pack_plain(x)
    wv = torch.empty(w0.numel() + 1, dtype=torch.int32,
                     device=card)[1:].copy_(w0)
    assert xv.data_ptr() % 16 != 0 and wv.data_ptr() % 16 != 0
    scale = s0[1:]
    want = ok.onebit_unpack_plain(w0, scale[0], numel)
    L = ok.padded_lanes(numel)
    pvw, _ = ok.launch_geometry(L, "onebit_pack")
    uvw, _ = ok.launch_geometry(L, "onebit_unpack")
    ok.onebit_pack(x)              # the stream's workspace, made outside
    torch.cuda.synchronize()
    got = {}
    names = _device_kernels([
        lambda: got.update(pack=ok.onebit_pack(xv)),
        lambda: got.update(aligned=ok.onebit_pack(x)),
        lambda: got.update(unpack=ok.onebit_unpack(wv, scale, numel)),
        lambda: got.update(unpack_aligned=ok.onebit_unpack(w0, scale,
                                                           numel))])
    assert len(names) == 4, names
    for name, kernel in zip(names, (f"pack_kernel<{pvw}, false>",
                                    f"pack_kernel<{pvw}, true>",
                                    f"unpack_kernel<{uvw}, false>",
                                    f"unpack_kernel<{uvw}, true>")):
        assert kernel in name, names
    for key in ("pack", "aligned"):
        assert torch.equal(got[key][0], w0)
        torch.testing.assert_close(got[key][1], s0, rtol=1e-6, atol=0)
    assert torch.equal(got["unpack"], want)
    assert torch.equal(got["unpack_aligned"], want)


def test_pack_scale_is_repeatable(card):
    """The L1 sum is added in an order fixed by the chunk's size: two packs
    of one input give the same scale bits."""
    x = _x(1024000, 8, card)
    x[3] = 0.25
    w1, s1 = ok.onebit_pack(x)
    w2, s2 = ok.onebit_pack(x)
    assert torch.equal(w1, w2) and torch.equal(s1, s2)


def test_packs_on_two_streams_at_once(card):
    """Packs issued on two streams run at the same time; each stream has
    its own ticket and partials, so each result is bit-exact."""
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    xs = [_x(1024000, 20 + i, card) for i in range(2)]
    for x in xs:
        x[3] = -2.0
    want = [ok.onebit_pack_plain(x) for x in xs]
    torch.cuda.synchronize()
    got = [[], []]
    for s in streams:
        with torch.cuda.stream(s):
            torch.cuda._sleep(1000000)           # line both streams up
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(ok.onebit_pack(xs[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for w, s in got[i]:
            assert torch.equal(w, want[i][0])
            torch.testing.assert_close(s, want[i][1], rtol=1e-6, atol=0)
            assert torch.equal(s, got[i][0][1])


MERGE_RANKS = [1, 2, 3, 4, 5, 8, 16]


def _merge(numel, R, seed, device):
    L = ok.padded_lanes(numel)
    return [torch.from_numpy(a).to(device)
            for a in merge_inputs(R, L, seed)]


def _unpack_sum_bit_exact(numel, R, device):
    ws, ss = _merge(numel, R, numel + R, device)
    assert same_bits(ok.onebit_unpack_sum(ws, ss, numel),
                     ok.onebit_unpack_sum_plain(ws, ss, numel)), (numel, R)


@pytest.mark.parametrize("vw", [None, *ok.VECTOR_WIDTHS])
def test_unpack_sum_bit_exact_at_resnet_chunk_sizes(card, monkeypatch, vw):
    """The merge at every chunk size of the ResNet-50 slice and R = 1, 2,
    3, 4, 5, 8 and 16 (R = 3 and 5 leave a rank group part full), on
    merge_inputs, with launch_geometry's tile width (None) and each tile
    width forced: the same bits as the plain merge."""
    sizes = _resnet_chunk_sizes()
    assert len(sizes) == 13
    if vw is not None:
        monkeypatch.setattr(ok, "launch_geometry",
                            lambda L, kernel: (vw, L // (4 * vw)))
    for numel in sizes:
        for R in MERGE_RANKS:
            _unpack_sum_bit_exact(numel, R, card)
    torch.cuda.synchronize()


@pytest.mark.parametrize("numel", RAGGED)
def test_unpack_sum_bit_exact_at_ragged_sizes(card, numel):
    """Tail rows that straddle numel, at every R of MERGE_RANKS."""
    for R in MERGE_RANKS:
        _unpack_sum_bit_exact(numel, R, card)
    torch.cuda.synchronize()


@pytest.mark.parametrize("numel", [4097, 311296])
def test_unpack_sum_misaligned_words_take_the_scalar_instance(card, numel):
    """Words one element into their storage are not 16-byte aligned: the
    merge runs its scalar-access instance (``<vw, false>``), one device
    kernel per call, with the same bits; aligned words run ``<vw,
    true>``."""
    ws, ss = _merge(numel, 5, 3, card)
    wv = torch.empty(ws.numel() + 1, dtype=torch.int32,
                     device=card)[1:].view(ws.shape).copy_(ws)
    assert wv.is_contiguous() and wv.data_ptr() % 16 != 0
    want = ok.onebit_unpack_sum_plain(ws, ss, numel)
    vw, _ = ok.launch_geometry(ok.padded_lanes(numel), "onebit_unpack_sum")
    torch.cuda.synchronize()
    got = {}
    names = _device_kernels([
        lambda: got.update(misaligned=ok.onebit_unpack_sum(wv, ss, numel)),
        lambda: got.update(aligned=ok.onebit_unpack_sum(ws, ss, numel))])
    assert len(names) == 2, names
    for name, kernel in zip(names, (f"unpack_sum_kernel<{vw}, false>",
                                    f"unpack_sum_kernel<{vw}, true>")):
        assert kernel in name, names
    assert same_bits(got["misaligned"], want)
    assert same_bits(got["aligned"], want)


def test_unpack_sum_is_repeatable(card):
    """Each output element is one thread's sum in rank order: two runs of
    one merge give the same bits."""
    ws, ss = _merge(1024000, 8, 30, card)
    assert same_bits(ok.onebit_unpack_sum(ws, ss, 1024000),
                     ok.onebit_unpack_sum(ws, ss, 1024000))


def test_merges_on_two_streams_at_once(card):
    """Merges issued on two streams run at the same time; each result has
    the plain merge's bits."""
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    inputs = [_merge(1024000, 4 * (i + 1), 40 + i, card) for i in range(2)]
    want = [ok.onebit_unpack_sum_plain(ws, ss, 1024000) for ws, ss in inputs]
    torch.cuda.synchronize()
    got = [[], []]
    for s in streams:
        with torch.cuda.stream(s):
            torch.cuda._sleep(1000000)           # line both streams up
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(ok.onebit_unpack_sum(*inputs[i], 1024000))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(same_bits(out, want[i]) for out in got[i])


@pytest.mark.parametrize("numel", [16384, 262144, 1024000])
def test_back_to_back_kernels_keep_stream_order(card, numel):
    """Queued behind a sleep, pack -> unpack -> unpack_sum of the pack's
    own words and scale run back to back, each launch overlapping the end
    of the one before (programmatic stream serialization).  Each must
    still read what the kernel before it wrote: every unpack and merge
    equals the plain version's on the words and scale the pack left."""
    g = torch.Generator().manual_seed(numel)
    xs = [torch.randn(numel, generator=g).to(card) for _ in range(48)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)       # the whole chain queued behind it
    got = []
    for x in xs:
        w, s = ok.onebit_pack(x)
        got.append((w, s, ok.onebit_unpack(w, s[1:], numel),
                    ok.onebit_unpack_sum(w[None], s[1:], numel)))
    torch.cuda.synchronize()
    for x, (w, s, out, merged) in zip(xs, got):
        w0, s0 = ok.onebit_pack_plain(x)
        assert torch.equal(w, w0)
        torch.testing.assert_close(s, s0, rtol=1e-6, atol=0)
        assert same_bits(out, ok.onebit_unpack_plain(w, s[1], numel))
        assert same_bits(merged,
                         ok.onebit_unpack_sum_plain(w[None], s[1:], numel))


def test_wrappers_count_and_reject(card):
    ok.reset_launches()
    w, s = ok.onebit_pack(torch.ones(1000, device=card))
    ok.onebit_unpack(w, s[1:], 1000)
    ok.onebit_unpack_sum(w[None], s[1:], 1000)
    assert ok.launches == {"onebit_pack": 1, "onebit_unpack": 1,
                           "onebit_unpack_sum": 1}
    with pytest.raises(TypeError):
        ok.onebit_pack(torch.ones(1000, device=card, dtype=torch.float16))
    with pytest.raises(ValueError):
        ok.onebit_unpack(w, s[1:], 5000)
    ws = torch.stack([w, w])
    for words, scales, numel, error in (
            (ws, s[1:], 1000, ValueError),             # 2 ranks, 1 scale
            (ws, torch.ones(2, device=card), 5000, ValueError),  # not its L
            (w, s[1:], 1000, ValueError),              # not (R, L)
            (ws.float(), torch.ones(2, device=card), 1000, TypeError),
            (ws, torch.ones(2, device=card, dtype=torch.float64), 1000,
             TypeError),
            (torch.stack([w, w], 1).t(), torch.ones(2, device=card), 1000,
             ValueError)):                             # not contiguous
        with pytest.raises(error):
            ok.onebit_unpack_sum(words, scales, numel)
    assert ok.launches["onebit_unpack_sum"] == 1


def test_engine_push_pull_on_card(card):
    """init() on the card forms a world of one over NCCL; a compressed
    push_pull goes through all three kernels and matches the same codec
    run on the CPU (its plain versions)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.compression import registry
    from byteps_tpu_torch.core import api

    kw = {"compressor": "onebit", "ef": "vanilla"}
    bps.init(Config(partition_bytes=1 << 18))
    try:
        x = _x(200000, 7, card)
        x[3] = 0.5
        ok.reset_launches()
        out = api.push_pull(x, "g", compression=kw)
        plain = api.push_pull(x[:1000], "small")           # below cutoff
        torch.cuda.synchronize()
        ctx = api.engine().registry.get("g")
        n = len(ctx.chunk_bounds)
        assert n > 1 and ok.launches == {
            "onebit_pack": 2 * n, "onebit_unpack": 3 * n,
            "onebit_unpack_sum": n}
        torch.testing.assert_close(plain, x[:1000], rtol=0, atol=0)
        ref = []
        xc = x.cpu()
        for off, ln in ctx.chunk_bounds:
            wc = registry.create(kw, ln)
            sc = registry.create(kw, ln, for_server=True)
            p, _ = wc.compress(xc[off:off + ln], wc.init_state("cpu"))
            y = wc.decompress_sum({k: v[None] for k, v in p.items()})
            p2, _ = sc.compress(y, sc.init_state("cpu"))
            ref.append(sc.decompress(p2))
        torch.testing.assert_close(out.cpu(), torch.cat(ref), rtol=1e-5,
                                   atol=0)
    finally:
        bps.shutdown()


# --- flash attention -------------------------------------------------------

FLASH_CASES = [   # (bh, tq, tk, d, causal, kv_len)
    (3, 128, 128, 64, True, 128), (2, 100, 100, 48, False, 100),
    (2, 100, 100, 48, True, 100), (2, 72, 72, 32, True, 72),
    (2, 64, 256, 64, True, 256), (2, 130, 70, 128, False, 70),
    (2, 100, 100, 48, False, 37), (2, 64, 256, 64, True, 200),
]


def _flash_inputs(card, bh, tq, tk, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(bh, tq, d, generator=g) for _ in range(2))
    k, v = (torch.randn(bh, tk, d, generator=g) for _ in range(2))
    return [t.to(card, dtype) for t in (q, k, v, do)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,tq,tk,d,causal,kv_len", FLASH_CASES)
def test_flash_kernels_match_plain(card, dtype, bh, tq, tk, d, causal,
                                   kv_len):
    """Each kernel against its plain version on the same inputs; the bf16
    forward's is ``flash_fwd_plain(..., block_k=FWD_BLOCK_K)``, which
    rounds P against the running max of each key tile as the kernel does.
    f32: the JAX tests' tolerances (2e-5 forward and lse, 5e-4 gradients;
    sums in another order); bf16 lse to rtol 1e-5, atol 1e-4.  bf16
    outputs (FLASH_BF16_TOL): each row of each output is held against that
    row's max-abs (no smaller than 2**-10 of the tensor's, so that a row of
    cancellation noise is held to the tensor's scale), so a row of small
    values cannot hide behind a large one elsewhere: two bf16 steps of the
    row's max.  The kernels sum on tensor cores in another order, so P and
    dS can round the other way; at most 2**-6 of each output's elements
    may differ at all, and the control, the plain versions with P and dS
    left in f32 (the forward's tiled as well), must differ on more."""
    _check_flash(card, dtype, bh, tq, tk, d, causal, tk - tq, kv_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_at_ring_offset(card, dtype):
    """A ring step's runtime mask: q_off = 32, not a multiple of the
    64-row tile, so the diagonal crosses two K tiles, and kv_len = 100
    cuts the second; the same bounds."""
    _check_flash(card, dtype, 3, 128, 128, 64, True, 32, 100)


def _check_flash(card, dtype, bh, tq, tk, d, causal, q_off, kv_len):
    from byteps_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(card, bh, tq, tk, d, dtype, tq + d)
    scale = 1.0 / np.sqrt(d)
    args = (scale, causal, q_off, kv_len)
    bf16 = dtype == torch.bfloat16
    o, lse = fa.flash_fwd(q, k, v, *args)
    o0, lse0 = fa.flash_fwd_plain(q, k, v, *args)
    ref, ref_lse = (fa.flash_fwd_plain(q, k, v, *args, block_k=fa.FWD_BLOCK_K)
                    if bf16 else (o0, lse0))
    dl = fa.delta(do, o0)
    bwd = (q, k, v, do, lse0, dl, *args)
    got = [o, *fa.flash_bwd_dkv(*bwd), fa.flash_bwd_dq(*bwd)]
    want = [ref, *fa.flash_bwd_dkv_plain(*bwd), fa.flash_bwd_dq_plain(*bwd)]
    torch.cuda.synchronize()
    assert all(g.dtype == dtype and g.shape == w.shape
               for g, w in zip(got, want))
    if not bf16:
        torch.testing.assert_close(lse, lse0, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-5)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-4)
        return
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    f32 = [t.float() for t in (q, k, v, do)]
    fbwd = (*f32, lse0, dl, *args)
    ctl = [fa.flash_fwd_plain(*f32[:3], *args, block_k=fa.FWD_BLOCK_K)[0],
           *fa.flash_bwd_dkv_plain(*fbwd), fa.flash_bwd_dq_plain(*fbwd)]
    for i, (g, w, c) in enumerate(zip(got, want, ctl)):
        share, frac = row_share(g, w), float((g != w).float().mean())
        rs_tol, frac_tol = FLASH_BF16_TOL[i > 0]
        assert share <= rs_tol and frac <= frac_tol, (i, share, frac)
        c = c.to(dtype)
        assert float((c != w).float().mean()) > frac_tol, i


def test_flash_forward_and_backward_are_repeatable(card):
    """Two runs of each bf16 kernel (the forward's O and lse, dK/dV, dQ)
    give the same bits: no atomics, no order that changes between runs."""
    from byteps_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(card, 8, 512, 512, 128, torch.bfloat16, 12)
    args = (1.0 / np.sqrt(128), True, 0, 512)
    o, lse = fa.flash_fwd(q, k, v, *args)
    assert all(torch.equal(a, b)
               for a, b in zip((o, lse), fa.flash_fwd(q, k, v, *args)))
    bwd = (q, k, v, do, lse, fa.delta(do, o), *args)
    first = fa.flash_bwd(*bwd)
    assert all(torch.equal(a, b) for a, b in zip(first, fa.flash_bwd(*bwd)))


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_forward_rejects_misaligned_bf16(card, which):
    """The bf16 forward copies tiles 16 bytes at a time (cp.async) and
    stores O 16 bytes a lane, so its [BH, T, D] tensors must be 16-byte
    aligned: a contiguous view one element into its storage is refused
    with a RuntimeError, before any launch."""
    from byteps_tpu_torch.ops import flash_attention as fa

    bh, t, d = 2, 64, 64
    xs = {n: torch.randn(bh, t, d, device=card, dtype=torch.bfloat16)
          for n in "qkv"}
    store = torch.empty(bh * t * d + 1, device=card, dtype=torch.bfloat16)
    xs[which] = store[1:].view(bh, t, d).copy_(xs[which])
    assert xs[which].is_contiguous() and xs[which].data_ptr() % 16 != 0
    fa.reset_launches()
    with pytest.raises(RuntimeError, match="flash_fwd kernel launch failed"):
        fa.flash_fwd(xs["q"], xs["k"], xs["v"], 0.125, True, 0, t)
    assert fa.launches["flash_fwd"] == 0


def test_flash_wrappers_count_and_reject(card):
    from byteps_tpu_torch.ops import flash_attention as fa

    fa.reset_launches()
    q = torch.randn(2, 64, 4, 64, device=card, requires_grad=True)
    fa.flash_attention(q, q, q, causal=True).sum().backward()
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dkv": 1,
                           "flash_bwd_dq": 1}
    h = torch.randn(2, 64, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="not supported"):
        fa.flash_fwd(h, h, h, 0.125, True, 0, 64)
    x = torch.randn(2, 64, 64, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(x.transpose(1, 2), x, x, 0.125, False, 0, 64)
    with pytest.raises(ValueError, match="head sizes"):
        y = torch.randn(2, 64, 160, device=card)
        fa.flash_fwd(y, y, y, 0.1, False, 0, 64)
    for kv_len in (0, 65):
        with pytest.raises(ValueError, match="kv_len"):
            fa.flash_fwd(x, x, x, 0.125, False, 0, kv_len)
    assert fa.launches["flash_fwd"] == 1
