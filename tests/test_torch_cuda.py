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


def _grouped_run(card, group_size, n_tensors=8, numel=1000):
    """Push ``n_tensors`` one-chunk gradients made on a side stream (queued
    behind a sleep, so they are still being written when pushed), each
    with its own ready event, with dispatch paused so that they group;
    returns (outputs, inputs, engine stats)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.core import api

    bps.init(Config(group_size=group_size, partition_bytes=4096,
                    partition_pinned=False))
    try:
        eng = api.engine()
        side = torch.cuda.Stream(card)
        base = torch.from_numpy(np.random.RandomState(5).randn(
            n_tensors, numel).astype(np.float32)).to(card)
        torch.cuda.synchronize()
        eng.pause_dispatch()
        with torch.cuda.stream(side):
            torch.cuda._sleep(50_000_000)        # the producer is late
            xs = [base[i] * 3 - 1 for i in range(n_tensors)]
            hs = [api.push_pull_async(x, f"side/{i}")
                  for i, x in enumerate(xs)]
        eng.resume_dispatch()
        outs = [h.wait(timeout=60) for h in hs]
        torch.cuda.synchronize()
        return ([o.cpu() for o in outs], [x.cpu() for x in xs],
                {k: eng.stats[k] for k in ("dispatches", "chunks")})
    finally:
        bps.shutdown()


def test_grouped_side_stream_producers_keep_bits(card):
    """Tensors produced on a side stream, pushed and grouped into one
    collective: the engine stream waits on each producer's event before
    the first copy-in, so the results have the bits of group_size=1,
    which are the inputs' (a world of one)."""
    outs1, xs1, stats1 = _grouped_run(card, 1)
    outs, xs, stats = _grouped_run(card, -1)
    assert stats1 == {"dispatches": 8, "chunks": 8}
    assert stats == {"dispatches": 1, "chunks": 8}
    for o, o1, x in zip(outs, outs1, xs):
        assert torch.equal(o.view(torch.int32), o1.view(torch.int32))
        assert torch.equal(o.view(torch.int32), x.view(torch.int32))


def test_group_results_outlive_the_other_handles(card):
    """A group's results are views of one buffer: after the other handles
    and results of the group are dropped and their memory is reused, the
    kept result still holds its values."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.core import api

    bps.init(Config(group_size=-1))
    try:
        eng = api.engine()
        xs = [torch.full((1 << 16,), float(i + 1), device=card)
              for i in range(4)]
        eng.pause_dispatch()
        hs = [api.push_pull_async(x, f"keep/{i}") for i, x in enumerate(xs)]
        eng.resume_dispatch()
        outs = [h.wait(timeout=60) for h in hs]
        assert (eng.stats["dispatches"], eng.stats["chunks"]) == (1, 4)
        keep = outs[2]
        del outs, hs
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        junk = [torch.full((1 << 16,), -7.0, device=card) for _ in range(16)]
        torch.cuda.synchronize()
        assert torch.equal(keep, xs[2]) and len(junk) == 16
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


# ------------------------------------------------ codecs and the wrappers

CARD_CODECS = {
    "topk": {"compressor": "topk", "k": "0.01", "ef": "vanilla"},
    "randomk": {"compressor": "randomk", "k": "0.01", "ef": "vanilla"},
    "dithering": {"compressor": "dithering", "k": "16"},
    "dithering_sparse_u16": {"compressor": "dithering", "k": "16",
                             "sparse_ratio": "0.05", "ef": "vanilla"},
    "dithering_l2": {"compressor": "dithering", "k": "16",
                     "partition": "natural", "normalize": "l2",
                     "sparse_ratio": "0.05", "ef": "vanilla"},
    "powersgd": {"compressor": "powersgd", "rank": "4", "ef": "vanilla"},
    "nesterov": {"compressor": "onebit", "ef": "vanilla",
                 "momentum": "nesterov"},
}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _to(device, tree):
    return {k: _to(device, v) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.parametrize("numel", [60000, 1024000])
@pytest.mark.parametrize("codec", list(CARD_CODECS))
def test_codecs_on_card_match_cpu(card, codec, numel):
    """Each codec on the card against the same codec on the CPU, three
    steps, each from the CPU's state of the step before: payload, new
    state and decompression bit for bit, except the sums taken in
    another order, held to chip_smoke's tolerances (onebit's scale rtol
    1e-6; the l2 norm rtol 1e-6 and at most L2_CODE_SHARE of the codes
    and residuals off; PowerSGD PSGD_CARD_TOL of the max-abs)."""
    from byteps_tpu_torch.compression import registry
    from chip_smoke import L2_CODE_SHARE, PSGD_CARD_TOL, max_share, off_share

    kw = CARD_CODECS[codec]
    c = registry.create(kw, numel)
    sc = c.init_state("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    for step in range(3):
        x = _x(numel, 40 + step, "cpu")
        x[3] = 0.25
        pg, sg = c.compress(x.to(card), _to(card, sc))
        pc, sc = c.compress(x, sc)
        dg, dc = c.decompress(pg).cpu(), c.decompress(pc)
        leaves = {**{f"p/{k}": (v, pc[k]) for k, v in pg.items()},
                  **{f"s/{k}": (v, _leaves(sc)[k])
                     for k, v in _leaves(sg).items()}}
        for k, (g, want) in leaves.items():
            g = g.cpu()
            assert g.dtype == want.dtype and g.shape == want.shape, k
            if codec == "powersgd":
                assert max_share(g, want) <= PSGD_CARD_TOL, k
            elif k in ("p/scale", "p/norm"):
                torch.testing.assert_close(g, want, rtol=1e-6, atol=0)
            elif codec == "nesterov" and k == "s/inner/error":
                torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6)
            elif codec == "dithering_l2" and k == "s/error":
                assert off_share(g, want) <= L2_CODE_SHARE, k
            elif codec == "dithering_l2" and k in ("p/codes", "p/idx"):
                assert (g != want).float().mean() <= L2_CODE_SHARE, k
            else:
                assert torch.equal(g, want), k
        if codec in ("topk", "randomk", "dithering",
                     "dithering_sparse_u16"):
            assert same_bits(dg, dc)
        if codec == "dithering_sparse_u16" and numel <= 0xFFFF:
            assert pg["idx"].dtype == torch.int16


def test_dithering_sparse_payload_gathers_over_nccl(card):
    """uint16 indices (held as int16) cross NCCL as bytes: the compressed
    push_pull of a 60,000-element chunk equals the codec chain on the
    CPU."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm import compressed
    from byteps_tpu_torch.compression import registry
    from byteps_tpu_torch.core import api

    kw = CARD_CODECS["dithering_sparse_u16"]
    bps.init()
    try:
        comm = api.engine().comm
        wc = registry.create(kw, 60000)
        sc = registry.create(kw, 60000, for_server=True)
        x = _x(60000, 8, "cpu")
        x[3] = 1.0
        p, _ = wc.compress(x.to(card), wc.init_state(card))
        g = compressed._all_gather(comm, p["idx"])
        assert g.dtype == torch.int16 and g.shape == (1,) + p["idx"].shape
        assert torch.equal(g[0], p["idx"])
        n = compressed._all_gather(comm, p["norm"])
        assert n.shape == (1,) and same_bits(n[0:1], p["norm"].reshape(1))
        out, _, _ = compressed.fused_compressed_push_pull(
            comm, x.to(card), wc, sc, wc.init_state(card),
            sc.init_state(card))
        ps, _ = wc.compress(x, wc.init_state("cpu"))
        y = wc.decompress_sum({k: v[None] for k, v in ps.items()})
        p2, _ = sc.compress(y, sc.init_state("cpu"))
        assert same_bits(out.cpu(), sc.decompress(p2))
    finally:
        bps.shutdown()


def _mlp(card):
    torch.manual_seed(3)
    return torch.nn.Sequential(torch.nn.Linear(256, 512), torch.nn.ReLU(),
                               torch.nn.Linear(512, 10)).to(card)


@pytest.mark.parametrize("wrapper", ["optimizer", "ddp", "cross_barrier",
                                     "half", "autotune"])
def test_wrappers_at_a_world_of_one_on_card(card, wrapper):
    """Each wrapper over NCCL at a world of one, uncompressed: two steps
    end at the parameters of plain SGD on the card, bit for bit (the
    all-reduce over one rank is the identity).  The autotune arm lets the
    ladder own the tensors: its losses must stay finite."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config

    x = torch.randn(16, 256, generator=torch.Generator().manual_seed(1))
    y = torch.arange(16) % 10
    x, y = x.to(card), y.to(card)
    half = wrapper == "half"
    ref = _mlp(card)
    model = _mlp(card)
    if half:
        ref.half()
        model.half()
        x = x.half()
    ref_masters = [p.detach().float().requires_grad_()
                   for p in ref.parameters()]
    ref_opt = torch.optim.SGD(ref_masters if half else ref.parameters(),
                              lr=0.1, momentum=0.9)
    ce = torch.nn.functional.cross_entropy
    for _ in range(2):
        ref_opt.zero_grad()
        (ce(ref(x).float(), y) * (1024.0 if half else 1.0)).backward()
        if half:
            for p, m in zip(ref.parameters(), ref_masters):
                m.grad = p.grad.float().mul_(1.0 / 1024.0)
                p.grad = None
        ref_opt.step()
        if half:
            with torch.no_grad():
                for p, m in zip(ref.parameters(), ref_masters):
                    p.copy_(m.to(p.dtype))
    bps.init(Config(compress_autotune=True, min_compress_bytes=4096)
             if wrapper == "autotune" else None)
    try:
        if half:
            masters = [p.detach().float().requires_grad_()
                       for p in model.parameters()]
            opt = bps.HalfPrecisionDistributedOptimizer(
                torch.optim.SGD(masters, lr=0.1, momentum=0.9),
                fp16_params=list(model.parameters()), fp32_params=masters)
        inner = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        if wrapper in ("optimizer", "autotune"):
            opt = bps.DistributedOptimizer(
                inner, named_parameters=model.named_parameters())
        elif wrapper == "ddp":
            fwd = bps.DistributedDataParallel(model)
        elif wrapper == "cross_barrier":
            xb = bps.CrossBarrier(model, inner)
        for _ in range(2 if wrapper != "autotune" else 24):
            if wrapper == "ddp":
                inner.zero_grad()
                ce(fwd(x), y).backward()
                inner.step()
            elif wrapper == "cross_barrier":
                ce(model(x), y).backward()
                xb.step()
            elif half:
                opt.zero_grad()
                opt.scale_loss(ce(model(x).float(), y)).backward()
                opt.step()
            else:
                opt.zero_grad()
                loss = ce(model(x), y)
                assert torch.isfinite(loss)
                loss.backward()
                opt.step()
        if wrapper == "cross_barrier":
            xb.synchronize()
        torch.cuda.synchronize()
    finally:
        bps.shutdown()
    if wrapper == "autotune":
        return
    for p, q in zip(model.parameters(), ref.parameters()):
        assert torch.equal(p, q)


# -------------------------------------------------- sharded update and ZeRO

def _slot_trajectory(device, opt, n, dtype, steps=3):
    """``opt`` of the sharded worker on one slot at a world of one, pushed
    through the engine on ``device`` (the card: an engine; the CPU: the
    same optimizer on the whole tensor, which is what a slot at one rank
    computes)."""
    from tests import torch_sharded_worker as SW
    from byteps_tpu_torch.core import api
    cls, hyper = SW.OPTIMIZERS[opt]
    hyper = dict(hyper, foreach=False)      # one implementation on both
    p0 = torch.from_numpy(SW.init_param(7, n)).to(dtype)
    grads = [torch.from_numpy(SW.rows(SW.grad_seed(opt, "w", s), 1, n)[0])
             .to(dtype) for s in range(steps)]
    if device.type == "cpu":
        m = p0.float()
        o = cls([m], **hyper)
        for g in grads:
            m.grad = g.float()
            o.step()
        return m.to(dtype)
    name = f"card/{opt}/{n}/{dtype}"
    api.declare_update(name, (n,), dtype, optimizer=(cls, hyper),
                       init_value=p0.to(device))
    for g in grads:
        out = api.push_pull_update(g.to(device), name)
    return out.cpu()


def test_sharded_slot_on_card_matches_cpu(card):
    """Slots on the card (the scatter accumulator, the parts fallback, a
    bf16 tensor) against the same optimizer on the CPU: SGD with momentum
    bit for bit, Adam to 1e-6 (the card's elementwise kernels may
    contract a multiply-add the CPU's round twice)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.config import Config

    bps.init(Config(sharded_update=True, partition_bytes=4096))
    try:
        for opt, n, dtype in (("momentum", 3001, torch.float32),
                              ("momentum", 37, torch.float32),
                              ("adam", 3001, torch.float32),
                              ("adamw", 3001, torch.bfloat16)):
            got = _slot_trajectory(card, opt, n, dtype)
            want = _slot_trajectory(torch.device("cpu"), opt, n, dtype)
            if opt == "momentum":
                assert torch.equal(got, want), (opt, n)
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=0, atol=1e-6 if dtype ==
                                           torch.float32 else 2**-7)
    finally:
        bps.shutdown()


def test_zero_steps_on_card_match_cpu(card):
    """ZeRO-1 and FSDP at a world of one on the card against the same
    steps on the CPU (no collective at one rank): losses and masters to
    1e-5 (cuBLAS and the CPU's BLAS sum the MLP's products in other
    orders)."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.comm.mesh import CommContext
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.parallel import zero
    from tests import torch_sharded_worker as SW

    def run(comm, kind):
        dev = comm.device
        model = SW.TinyMLP(SW.mlp_params()).to(dev)
        zs = zero.init_zero_state(
            comm, model, lambda ps: torch.optim.AdamW(ps, **SW.ZERO_ADAMW))
        step = (zero.make_zero_train_step(comm, model, SW.mse)
                if kind == "zero1" else
                zero.make_fsdp_train_step(comm, model, SW.mse))
        losses = []
        for s in range(SW.ZERO_STEPS):
            x, y = SW.mlp_batch(s, 1)
            losses.append(step(zs, (torch.from_numpy(x).to(dev),
                                    torch.from_numpy(y).to(dev))).item())
        return losses, zs.master.cpu()

    cpu = CommContext(rank=0, size=1, local_rank=0, local_size=1,
                      num_nodes=1, device=torch.device("cpu"),
                      backend="gloo")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    bps.init()
    try:
        for kind in ("zero1", "fsdp"):
            got = run(api.engine().comm, kind)
            want = run(cpu, kind)
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
            torch.testing.assert_close(got[1], want[1], rtol=1e-5,
                                       atol=1e-6)
    finally:
        bps.shutdown()
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------- async parameter server

def _onebit_wires(numel, steps, seed):
    from byteps_tpu_torch.compression import registry
    wc = registry.create(ONEBIT_EF_KW, numel)
    st = wc.init_state(torch.device("cpu"))
    rng = np.random.RandomState(seed)
    wires = []
    for _ in range(steps):
        x = torch.from_numpy(rng.randn(numel).astype(np.float32))
        payload, st = wc.compress(x, st)
        wires.append(wc.wire_encode(payload))
    return wires


ONEBIT_EF_KW = {"compressor": "onebit", "ef": "vanilla"}


def test_store_decodes_on_card_like_cpu(card):
    """The same onebit frames pushed to a store on the card (decoded by
    the unpack kernel) and to one on the CPU (the plain version): the
    stored sums bit for bit; the ServerEngine's re-encode of the merge on
    the card: the same words, the scale to rtol 1e-6."""
    from byteps_tpu_torch.server import KVStore, ServerEngine
    numel = 50000
    wires = _onebit_wires(numel, 3, 0)
    values, pulled = {}, {}
    for dev in ("cuda", "cpu"):
        ok.reset_launches()
        s = KVStore(device=dev)
        s.init_key("c", torch.zeros(numel))
        s.register_compression("c", ONEBIT_EF_KW, numel)
        for i, w in enumerate(wires):
            s.push_delta_wire("c", w, worker_id=0, seq=i + 1)
        values[dev] = s.pull("c")
        eng = ServerEngine(num_threads=2, device=dev)
        try:
            eng.register_compression("c", ONEBIT_EF_KW, numel)
            for w, wire in enumerate(wires[:2]):
                eng.push_compressed("c", wire, worker_id=w, num_workers=2)
            pulled[dev] = eng.pull_compressed("c", timeout=10)
        finally:
            eng.shutdown()
        if dev == "cuda":
            # store 3 decodes, engine 2 decodes + 1 EF residual, 1 pack
            assert ok.launches["onebit_unpack"] == 6
            assert ok.launches["onebit_pack"] == 1
    assert same_bits(values["cuda"], values["cpu"])
    g, w = pulled["cuda"], pulled["cpu"]
    assert len(g) == len(w) and g[:4] == w[:4] and g[8:] == w[8:]
    np.testing.assert_allclose(np.frombuffer(g[4:8], "<f4"),
                               np.frombuffer(w[4:8], "<f4"), rtol=1e-6)


def _async_run(device, compression=None, steps=3):
    from byteps_tpu_torch import AsyncDistributedOptimizer, KVStore
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(300, 40, generator=gen), torch.randn(40,
                                                             generator=gen)]
    store = KVStore(device=device)
    workers = []
    for w in range(2):
        ps = [torch.nn.Parameter(t.clone().to(device)) for t in init]
        inner = torch.optim.SGD(ps, lr=0.1, momentum=0.9, foreach=False)
        workers.append((AsyncDistributedOptimizer(
            inner, named_parameters=[("w", ps[0]), ("b", ps[1])],
            store=store, compression=compression, worker_id=w), ps))
    for s in range(steps):
        for w, (opt, ps) in enumerate(workers):
            g = torch.Generator().manual_seed(10 * w + s)
            for p in ps:
                p.grad = torch.randn(p.shape, generator=g).to(device)
            opt.step()
    return store, [[p.detach().cpu() for p in ps] for _, ps in workers]


def test_async_step_on_card_matches_cpu(card):
    """Two workers through one store on the card and on the CPU, the same
    gradients: SGD with momentum (foreach off, one implementation on
    both) bit for bit; with onebit + EF the same wire bytes."""
    s_card, p_card = _async_run("cuda")
    s_cpu, p_cpu = _async_run("cpu")
    for a, b in zip(p_card, p_cpu):
        for x, y in zip(a, b):
            assert same_bits(x, y)
    for k in s_cpu.keys():
        assert same_bits(s_card.pull(k), s_cpu.pull(k))
    ok.reset_launches()
    s_card, _ = _async_run("cuda", compression=ONEBIT_EF_KW)
    assert ok.launches["onebit_pack"] == 12       # 2 tensors x 2 x 3
    s_cpu, _ = _async_run("cpu", compression=ONEBIT_EF_KW)
    assert s_card.wire_bytes == s_cpu.wire_bytes > 0


# ------------------------------------- the quantized parameter leg, tracing

def _param_leg(device, spec, steps=4, n=300_000):
    """A world of one: a slot under ``spec`` (SGD with momentum, foreach
    off on both devices), the same seeded gradients; the emitted
    parameters of every step, on the host, and the onebit launches."""
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.core import api

    api.init(Config(sharded_update=True, sharded_param_codec=spec,
                    min_compress_bytes=0), device=device)
    try:
        g = torch.Generator().manual_seed(0)
        p0 = torch.randn(n, generator=g)
        api.declare_update("w", (n,), torch.float32,
                           optimizer=(torch.optim.SGD,
                                      {"lr": 0.1, "momentum": 0.9,
                                       "foreach": False}),
                           init_value=p0.to(device))
        ok.reset_launches()
        outs = [api.push_pull_update(torch.randn(n, generator=g).to(device),
                                     "w").cpu() for _ in range(steps)]
        torch.cuda.synchronize()
        return outs, dict(ok.launches)
    finally:
        api.shutdown()


@pytest.mark.parametrize("spec", ["onebit", "topk:0.25", "randomk:0.25",
                                  "dithering:16"])
def test_param_leg_on_card_matches_cpu(card, spec):
    """The parameter leg on the card against the same chain on the CPU:
    topk, randomk and max-norm dithering bit for bit; onebit's scale is
    an L1 sum in another order (ROADMAP Queue C 6), so its parameters
    agree to 1e-6 after 4 steps, its signs exactly.  Onebit launches one
    pack and one unpack per step at one rank."""
    got, launches = _param_leg("cuda", spec)
    want, _ = _param_leg("cpu", spec)
    for a, b in zip(got, want):
        if spec == "onebit":
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        else:
            assert same_bits(a, b)
    if spec == "onebit":
        assert launches["onebit_pack"] == 4
        assert launches["onebit_unpack"] == 4


def test_traced_engine_run_on_card_validates(card, tmp_path):
    """A sampled (1/1) engine run on the card: the flushed trace has a
    ``queued`` and a ``push_pull`` span per chunk and paired flows, and
    the port's bps_trace validates it with 0 errors."""
    import json
    import os

    from byteps_tpu_torch.common import tracing
    from byteps_tpu_torch.common.config import Config
    from byteps_tpu_torch.core import api
    from byteps_tpu_torch.tools import bps_trace

    tracing.set_tracer(None)
    api.init(Config(trace_sample="1/1", trace_dir=str(tmp_path),
                    partition_bytes=4096))
    try:
        for s in range(3):
            hs = [api.push_pull_async(torch.full((3000,), float(s),
                                                 device=card), "w"),
                  api.push_pull_async(torch.ones(37, device=card), "b")]
            for h in hs:
                h.wait()
    finally:
        api.shutdown()
        tracing.set_tracer(None)
    files = [f for f in os.listdir(tmp_path)
             if f.startswith("bps_trace_rank")]
    with open(tmp_path / files[0]) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert sum(e["name"] == "queued" for e in spans) == 3 * (3 + 1)
    assert sum(e["name"] == "push_pull" for e in spans) == 3 * (3 + 1)
    merged = bps_trace.merge(bps_trace.load_trace_files(str(tmp_path)))
    assert bps_trace.validate(merged) == []
