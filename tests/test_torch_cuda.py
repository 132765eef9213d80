"""Tests of the PyTorch port that need an NVIDIA card; they skip elsewhere.

This file imports neither jax nor the JAX package, so it runs where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each CUDA kernel is held against its plain version on the same inputs:
the onebit kernels bit-exact in words and values, their scale (an L1 sum
taken in another order) to rtol 1e-6; the flash kernels to the
tolerances stated in ``test_flash_kernels_match_plain``, which are
``chip_smoke.py``'s (its ``row_share`` and ``FLASH_BF16_TOL``).
"""

import numpy as np
import pytest
import torch

from byteps_tpu_torch.ops import onebit_kernels as ok
from chip_smoke import FLASH_BF16_TOL, row_share

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
