"""The port's flash attention (``byteps_tpu_torch/ops/flash_attention.py``)
against the JAX package's Pallas kernels and exact attention.

The same seeded numpy inputs go through ``byteps_tpu.ops.flash_attention``
in interpret mode (the Pallas kernels, run as the JAX package's own tests
run them on the CPU) and through the port, whose wrappers run their plain
versions for CPU tensors.  Tolerances are the JAX package's own flash
tests': 2e-5 for the forward and lse, 5e-4 for gradients (f32; the two
sides sum in other orders, and the gradients chain more of those sums).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops.flash_attention import _bwd_impl, _delta, _fwd
from byteps_tpu.ops.flash_attention import flash_attention as jax_flash
from byteps_tpu.parallel import full_attention as jax_full_attention
from byteps_tpu_torch.ops import flash_attention as fa
from byteps_tpu_torch.parallel.sequence import full_attention

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)

CASES = {   # name: (b, tq, tk, h, d, causal)
    "t128": (2, 128, 128, 4, 64, False),
    "t128_causal": (2, 128, 128, 4, 64, True),
    "t256": (1, 256, 256, 2, 64, False),
    "t256_causal": (1, 256, 256, 2, 64, True),
    "ragged_t100_d48": (2, 100, 100, 3, 48, False),
    "ragged_t100_d48_causal": (2, 100, 100, 3, 48, True),
    "ragged_t72_d32_causal": (1, 72, 72, 2, 32, True),
    "decode_tq64_tk256": (1, 64, 256, 2, 64, True),
}
_runs = {}


def _inputs(seed, b, tq, tk, h, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k, v = (rng.randn(b, tk, h, d).astype(np.float32) for _ in range(2))
    w = rng.randn(b, tq, h, d).astype(np.float32)   # downstream cotangent
    return q, k, v, w


def _run(name):
    """Output and gradients of sum(attn * w) on both sides, once per case."""
    if name not in _runs:
        b, tq, tk, h, d, causal = CASES[name]
        q, k, v, w = _inputs(sorted(CASES).index(name), b, tq, tk, h, d)
        out, vjp = jax.vjp(lambda q, k, v: jax_flash(
            q, k, v, causal=causal, interpret=True),
            *map(jnp.asarray, (q, k, v)))
        jax_grads = [np.asarray(g) for g in vjp(jnp.asarray(w))]
        tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_()
                         for x in (q, k, v))
        got = fa.flash_attention(tq_, tk_, tv_, causal=causal)
        (got * torch.from_numpy(w)).sum().backward()
        exact = full_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal)
        _runs[name] = dict(
            jax_out=np.asarray(out), jax_grads=jax_grads,
            out=got.detach().numpy(), exact=exact.numpy(),
            grads=[t.grad.numpy() for t in (tq_, tk_, tv_)])
    return _runs[name]


@pytest.mark.parametrize("name", CASES)
def test_forward_matches_jax_flash(name):
    r = _run(name)
    assert r["out"].shape == r["jax_out"].shape
    np.testing.assert_allclose(r["out"], r["jax_out"], **FWD_TOL)
    np.testing.assert_allclose(r["out"], r["exact"], **FWD_TOL)


@pytest.mark.parametrize("name", CASES)
def test_gradients_match_jax_flash(name):
    r = _run(name)
    for got, want, what in zip(r["grads"], r["jax_grads"], "qkv"):
        np.testing.assert_allclose(got, want, err_msg=f"d{what}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("b", [1, 2])
def test_kernel_inputs_are_contiguous(monkeypatch, b):
    """The kernels take contiguous [BH, T, D] tensors only: flash_attention
    hands them such tensors even for q, k, v sliced out of a fused qkv
    projection (GPT's layout), where B == 1 makes the reshape a view."""
    seen = []

    def recording(real):
        def fn(*args):
            seen.extend(a.is_contiguous() for a in args
                        if isinstance(a, torch.Tensor))
            return real(*args)
        return fn

    for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        monkeypatch.setattr(fa, name, recording(getattr(fa, name)))
    qkv = torch.randn(b, 40, 3, 2, 32, requires_grad=True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert len(seen) == 3 + 6 + 6 and all(seen)


def test_causal_rejects_tq_gt_tk():
    q, k, v, _ = _inputs(6, 1, 256, 64, 2, 64)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        jax_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                  interpret=True)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_matches_autograd_of_full_attention(causal):
    """The entry points on [BH, T, D] (flash_fwd, delta, flash_bwd) against
    torch.autograd through the exact attention."""
    b, t, h, d = 2, 96, 2, 32
    q, k, v, w = _inputs(7, b, t, t, h, d)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (full_attention(*leaves, causal=causal)
     * torch.from_numpy(w)).sum().backward()

    def to3(x):
        return torch.from_numpy(x).transpose(1, 2).reshape(b * h, -1, d)

    q3, k3, v3, do3 = map(to3, (q, k, v, w))
    args = (1.0 / math.sqrt(d), causal, 0, t)
    o3, lse = fa.flash_fwd(q3, k3, v3, *args)
    dq, dk, dv = fa.flash_bwd(q3, k3, v3, do3, lse, fa.delta(do3, o3),
                              *args)
    for got, leaf in zip((dq, dk, dv), leaves):
        np.testing.assert_allclose(got.numpy(), to3(leaf.grad.numpy()),
                                   **GRAD_TOL)


def test_entry_points_match_jax_kernels_at_runtime_offsets():
    """flash_fwd / flash_bwd with a causal offset and a kv tail, as a ring
    step passes them, against the JAX package's ``_fwd`` and
    ``_bwd_impl`` (its lse and delta are lane-broadcast there)."""
    bh, t, d, q_off, kv_len = 3, 128, 64, 32, 100
    rng = np.random.RandomState(8)
    q, k, v, do = (rng.randn(bh, t, d).astype(np.float32) for _ in range(4))
    scale = 0.2
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = _fwd(jq, jk, jv, scale, True, q_off, kv_len, 64, 64, True)
    jdelta = _delta(jdo, jo)
    jdq, jdk, jdv = _bwd_impl(jq, jk, jv, jdo, jlse, jdelta, scale, True,
                              q_off, kv_len, 64, 64, True)

    tq_, tk_, tv_, tdo = map(torch.from_numpy, (q, k, v, do))
    args = (scale, True, q_off, kv_len)
    o, lse = fa.flash_fwd(tq_, tk_, tv_, *args)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               **FWD_TOL)
    dlt = fa.delta(tdo, o)
    np.testing.assert_allclose(dlt.numpy(), np.asarray(jdelta)[..., 0],
                               **FWD_TOL)
    got = fa.flash_bwd(tq_, tk_, tv_, tdo, lse, dlt, *args)
    for g, want, what in zip(got, (jdq, jdk, jdv), "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   err_msg=f"d{what}", **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(causal):
    q, k, v, _ = _inputs(9, 2, 48, 80, 3, 16)
    if causal:
        q = q[:, :32]
    got = full_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want = jax_full_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("d,kd", [(16, 32), (32, 32), (48, 64), (64, 64),
                                  (100, 128), (128, 128)])
def test_kernel_head_size_padding_is_exact(d, kd):
    """The CUDA path pads D to the kernel's size with zero columns; on the
    plain version that padding changes no value."""
    assert fa.kernel_dim(d) == kd
    q, k, v, w = (torch.from_numpy(x.reshape(3, 40, d))
                  for x in _inputs(10, 1, 40, 40, 3, d))
    args = (0.3, True, 0, 40)
    o, lse = fa.flash_fwd_plain(q, k, v, *args)
    _, padded = fa._padded(q, k, v, w)
    assert all(t.shape[-1] == kd for t in padded)
    op, lsep = fa.flash_fwd_plain(*padded[:3], *args)
    np.testing.assert_allclose(op[..., :d].numpy(), o.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not op[..., d:].any()
    np.testing.assert_allclose(lsep.numpy(), lse.numpy(), rtol=1e-6)


@pytest.mark.parametrize("kv_len", [0, 41])
def test_entry_points_reject_kv_len_outside_keys(kv_len):
    """kv_len must leave at least one key and name no key past Tk, on the
    CPU as on the card (where kernels skip tiles past kv_len)."""
    q, k, v, do = (torch.from_numpy(x.reshape(3, 40, 16))
                   for x in _inputs(11, 1, 40, 40, 3, 16))
    args = (0.25, False, 0, kv_len)
    lse, dlt = torch.zeros(3, 40), torch.zeros(3, 40)
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_fwd(q, k, v, *args)
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_bwd_dkv(q, k, v, do, lse, dlt, *args)
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_bwd_dq(q, k, v, do, lse, dlt, *args)


def test_kernel_dim_rejects_large_heads():
    with pytest.raises(ValueError, match="head sizes up to 128"):
        fa.kernel_dim(129)
