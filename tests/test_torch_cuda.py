"""Tests of the PyTorch port that need an NVIDIA card; they skip elsewhere.

This file imports neither jax nor the JAX package, so it runs where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each CUDA kernel is held against its plain version on the same inputs:
bit-exact words and values; the scale (an L1 sum taken in another order)
to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from byteps_tpu_torch.ops import onebit_kernels as ok

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
