"""The port's flash attention (``byteps_tpu_torch/ops/flash_attention.py``)
against the JAX package's Pallas kernels and exact attention.

The same seeded numpy inputs go through ``byteps_tpu.ops.flash_attention``
in interpret mode (the Pallas kernels, run as the JAX package's own tests
run them on the CPU) and through the port, whose wrappers run their plain
versions for CPU tensors.  Tolerances are the JAX package's own flash
tests': 2e-5 for the forward and lse, 5e-4 for gradients (f32; the two
sides sum in other orders, and the gradients chain more of those sums).
In bf16 the two sides are held to the rounding points instead (see
``test_bf16_rounding_points_match_jax_kernels``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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


# name: (bh, tq, tk, d, causal, q_off, kv_len)
BF16_CASES = {
    "t128": (4, 128, 128, 64, False, 0, 128),
    "t128_causal": (4, 128, 128, 64, True, 0, 128),
    "ragged_t100_d48_causal": (3, 100, 100, 48, True, 0, 100),
    "ragged_t72_d32_causal": (2, 72, 72, 32, True, 0, 72),
    "decode_tq64_tk256": (2, 64, 256, 64, True, 192, 256),
    "ring_qoff32_kvlen100": (3, 128, 128, 64, True, 32, 100),
}


@pytest.mark.parametrize("name", BF16_CASES)
def test_bf16_rounding_points_match_jax_kernels(name):
    """bf16 inputs through the JAX package's ``_fwd`` and ``_bwd_impl``
    (interpret mode, 64-row blocks, T zero-padded to them) and through
    ``flash_fwd_plain(..., block_k=64)``, ``flash_bwd_dkv_plain`` and
    ``flash_bwd_dq_plain``, the backward fed JAX's lse and delta.  Both
    round P to dO's (and V's) type against the same running max of each
    64-wide key block, and dS to Q's and K's, before the products that use
    them, sum in f32, and round the outputs; they differ only in sum order.

    Tolerances, with ``chip_smoke.row_share`` (each row's max |diff| over
    its max |JAX|, no smaller than 2**-10 of the tensor's max-abs, which
    holds causal query row 0, whose dQ is cancellation noise, to the
    tensor's scale): the forward's O to 2**-7 with at most 2**-8 of its
    elements differing (read: up to 9.8e-4), its lse to 1e-5 (read: up to
    4.8e-7); the gradients to 2**-7 (read: up to 3.8e-3), with at most
    2**-6 of their elements differing (read: up to 3.3e-3).  The controls,
    the plain versions on f32 inputs (P and dS left in f32; the forward's
    tiled as well), must differ on at least 25 % of the elements of O
    (read: 34-38 %) and of the gradients (read: 32-42 %), so a missing
    rounding point shows.  The exact softmax, which rounds P against the
    global row max, differs from the JAX kernel on up to 29 % of O's
    elements, so it is not the bf16 forward's reference."""
    bh, tq, tk, d, causal, q_off, kv_len = BF16_CASES[name]
    rng = np.random.RandomState(20 + sorted(BF16_CASES).index(name))
    q, do = (rng.randn(bh, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(bh, tk, d).astype(np.float32) for _ in range(2))
    scale, block = 1.0 / math.sqrt(d), 64

    def to_jax(x):
        t = -(-x.shape[1] // block) * block
        return jnp.asarray(np.pad(x, ((0, 0), (0, t - x.shape[1]), (0, 0))),
                           jnp.bfloat16)

    def to_torch(x, t):   # unpadded rows, f32 values of the bf16 result
        return torch.from_numpy(np.asarray(x[:, :t].astype(jnp.float32)))

    jq, jk, jv, jdo = map(to_jax, (q, k, v, do))
    jo, jlse = _fwd(jq, jk, jv, scale, causal, q_off, kv_len, block, block,
                    True)
    jdelta = _delta(jdo, jo)
    jdq, jdk, jdv = _bwd_impl(jq, jk, jv, jdo, jlse, jdelta, scale, causal,
                              q_off, kv_len, block, block, True)

    tq_, tk_, tv_, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                          for x in (q, k, v, do))
    args = (scale, causal, q_off, kv_len)
    lse = to_torch(jlse, tq)[..., 0].contiguous()
    dlt = to_torch(jdelta, tq)[..., 0].contiguous()
    assert fa.FWD_BLOCK_K == block
    o, o_lse = fa.flash_fwd_plain(tq_, tk_, tv_, *args, block_k=block)
    jo_t = to_torch(jo, tq)
    assert o.dtype == torch.bfloat16 and o.shape == jo_t.shape
    assert chip_smoke.row_share(o, jo_t) <= 2**-7
    assert float((o.float() != jo_t).float().mean()) <= 2**-8
    np.testing.assert_allclose(o_lse.numpy(), lse.numpy(), rtol=1e-5,
                               atol=1e-5)
    f32 = [t.float() for t in (tq_, tk_, tv_, tdo)]
    o_ctl, _ = fa.flash_fwd_plain(*f32[:3], *args, block_k=block)
    o_ctl = o_ctl.to(torch.bfloat16).float()
    assert float((o_ctl != jo_t).float().mean()) >= 0.25
    bwd = (tq_, tk_, tv_, tdo, lse, dlt, *args)
    got = [*fa.flash_bwd_dkv_plain(*bwd), fa.flash_bwd_dq_plain(*bwd)]
    fbwd = (*f32, lse, dlt, *args)
    ctl = [*fa.flash_bwd_dkv_plain(*fbwd), fa.flash_bwd_dq_plain(*fbwd)]
    want = [to_torch(jdk, tk), to_torch(jdv, tk), to_torch(jdq, tq)]
    for g, w, c, what in zip(got, want, ctl, ("dk", "dv", "dq")):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, what
        g = g.float()
        assert chip_smoke.row_share(g, w) <= 2**-7, what
        assert float((g != w).float().mean()) <= 2**-6, what
        c = c.to(torch.bfloat16).float()
        assert float((c != w).float().mean()) >= 0.25, what


def test_chip_smoke_bf16_checks_hold_cancellation_rows():
    """``chip_smoke.check_bf16`` on the plain versions at a small causal
    shape with q_off = 0.  The stand-in for a kernel is the plain versions
    run over a permuted head dimension (the same values summed in another
    order, as a kernel sums them); the forward's plain version is the
    tiled one, as on the card.  Causal query row 0 sees one key, so its
    dS = P (dP - delta) subtracts two sums of the same products and its dQ
    is rounding noise, whose two orders disagree: without the floor of
    ``row_share`` that row reads as inf; with it the check passes.  The
    control, P and dS left in f32, fails the same check."""
    got, want, ctl = _bf16_check_inputs()
    dq, dq0 = got["flash_bwd_dq"][0], want["flash_bwd_dq"][0]
    assert not torch.equal(dq, dq0)
    assert math.isinf(chip_smoke.row_share(dq, dq0, floor=0.0))
    chip_smoke.check_bf16("permuted D", {k: (got[k], want[k]) for k in got},
                          ctl)
    with pytest.raises(RuntimeError, match="differs from its plain version"):
        chip_smoke.check_bf16(
            "control", {k: ([c.to(torch.bfloat16) for c in ctl[k]],
                            want[k]) for k in ctl}, ctl)


@pytest.mark.parametrize("fault", ["kernel_is_control", "control_passes"])
def test_chip_smoke_bf16_check_sees_forward_without_p_rounding(fault):
    """``chip_smoke.check_bf16`` on the forward alone.  A forward that left
    P in f32 (the tiled plain version on f32 inputs, rounded only at the
    end) is refused by the element bound; and a control that the bound
    would let pass (here the reference itself) is refused too, so the check
    cannot run blind."""
    got, want, ctl = _bf16_check_inputs()
    fwd_ctl = ctl["flash_fwd"][0]
    if fault == "kernel_is_control":
        pairs = {"flash_fwd": ([fwd_ctl.to(torch.bfloat16)],
                               want["flash_fwd"])}
        match = "differs from its plain version"
    else:
        pairs = {"flash_fwd": (got["flash_fwd"], want["flash_fwd"])}
        ctl = {"flash_fwd": want["flash_fwd"]}
        match = "does not see"
    _, frac = chip_smoke.bf16_errors(fwd_ctl.to(torch.bfloat16),
                                     want["flash_fwd"][0])
    assert frac > 0.25
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.check_bf16(fault, pairs, ctl)


def _bf16_check_inputs():
    """(got, want, ctl) of ``chip_smoke.check_bf16`` per kernel at a small
    causal shape: the stand-in kernels are the plain versions over a
    permuted head dimension; the controls leave P and dS in f32."""
    rng = np.random.RandomState(0)
    bh, t, d = 4, 128, 64
    q, k, v, do = (torch.from_numpy(rng.randn(bh, t, d).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    args = (1.0 / math.sqrt(d), True, 0, t)
    perm = torch.from_numpy(np.random.RandomState(1).permutation(d))
    inv = torch.argsort(perm)

    def permuted(fn, xs, *rest):   # xs: the [BH, T, D] inputs
        out = fn(*(x[..., perm].contiguous() for x in xs), *rest)
        return [o[..., inv] for o in (out if isinstance(out, tuple)
                                      else (out,))]

    def fwd(*a):                   # the bf16 forward's plain version
        return fa.flash_fwd_plain(*a, block_k=fa.FWD_BLOCK_K)[0]

    o0, lse = fa.flash_fwd_plain(q, k, v, *args)
    dlt = fa.delta(do, o0)
    bwd = (q, k, v, do, lse, dlt, *args)
    f32 = [x.float() for x in (q, k, v, do)]
    fbwd = (*f32, lse, dlt, *args)
    want = {"flash_fwd": [fwd(q, k, v, *args)],
            "flash_bwd_dkv": list(fa.flash_bwd_dkv_plain(*bwd)),
            "flash_bwd_dq": [fa.flash_bwd_dq_plain(*bwd)]}
    got = {"flash_fwd": permuted(fwd, (q, k, v), *args),
           "flash_bwd_dkv": permuted(fa.flash_bwd_dkv_plain, bwd[:4],
                                     *bwd[4:]),
           "flash_bwd_dq": permuted(fa.flash_bwd_dq_plain, bwd[:4],
                                    *bwd[4:])}
    ctl = {"flash_fwd": [fwd(*f32[:3], *args)],
           "flash_bwd_dkv": list(fa.flash_bwd_dkv_plain(*fbwd)),
           "flash_bwd_dq": [fa.flash_bwd_dq_plain(*fbwd)]}
    return got, want, ctl
