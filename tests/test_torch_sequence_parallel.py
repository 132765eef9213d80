"""The port's sequence-parallel attentions (``byteps_tpu_torch/parallel/
sequence.py``) against the JAX package's, on the same seeded inputs:
the JAX side on a ``(1, sp)`` mesh of the conftest's CPU devices, the
port at 2 and 4 gloo ranks (``tests/torch_sp_worker.py``), rank r holding
the sequence shard r.

- ``make_sp_attention`` for ``ring`` and ``striped`` at sp 2 and 4,
  ``ulysses`` at sp 2, causal and not; ``striped_attention`` itself on
  striped shards; the ring with its shift forced through the all-to-all
  path (the one a gloo group takes on the card): the output shard and
  the gradients of ``sum(out * w)`` for q, k and v against JAX's
  ``make_sp_attention``, f32, to 1e-5 (rtol and atol; the JAX ring
  differentiates through its online softmax, the port's backward is the
  Dao backward from the saved log-sum-exp: sums in another order).  The
  outputs are also held against ``full_attention``.
- ``stripe_batch`` / ``unstripe_batch`` round trip, against JAX's.
- ``resolve_sp_attention`` takes every JAX kind, and the local kinds
  refuse ``sp > 1``.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from byteps_tpu.parallel import sequence as jseq
from byteps_tpu_torch.ops.flash_attention import flash_attention
from byteps_tpu_torch.parallel import mesh_util, sequence

from . import torch_sp_worker as W

B, T, H, D = 2, 32, 4, 16
TOL = 1e-5
CASES = (
    [{"type": "attn", "name": f"{kind}_sp{n}_{'c' if causal else 'n'}",
      "kind": kind, "causal": causal, "sp": n, "worlds": [n]}
     for kind, sps in (("ring", (2, 4)), ("striped", (2, 4)),
                       ("ulysses", (2,)))
     for n in sps for causal in (True, False)]
    + [{"type": "attn", "name": f"striped_direct_sp{n}", "kind": "striped",
        "layout": "striped", "causal": True, "sp": n, "worlds": [n]}
       for n in (2, 4)]
    + [{"type": "attn", "name": "ring_a2a_sp2_c", "kind": "ring",
        "causal": True, "sp": 2, "path": "all_to_all", "worlds": [2]}])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return {f"attn/{k}": rng.randn(B, T, H, D).astype(np.float32)
            for k in "qkvw"}


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """The port's ranks at sp 2 and 4, started in the background;
    calling the value waits: {world: [npz by rank]}."""
    tmp = tmp_path_factory.mktemp("torch_sp")
    path, cases = str(tmp / "inputs.npz"), str(tmp / "cases.json")
    np.savez(path, **inputs)
    with open(cases, "w") as f:
        json.dump(CASES, f)
    pool = ThreadPoolExecutor(2)
    futures = {n: pool.submit(W.spawn, n, path, cases, str(tmp))
               for n in (2, 4)}
    done = {}

    def results():
        if not done:
            for n, f in futures.items():
                done[n] = [dict(np.load(o)) for o in f.result()]
        return done

    yield results
    pool.shutdown(wait=True)


def _jax_attn(inputs, kind, causal, n):
    """JAX's make_sp_attention on a (1, n) mesh: (out, dq, dk, dv)."""
    mesh = jseq.make_sp_mesh(jax.devices()[:n], n_sp=n)
    sh = NamedSharding(mesh, P(jseq.DP_AXIS, jseq.SP_AXIS))
    q, k, v, w = (jax.device_put(jnp.asarray(inputs[f"attn/{x}"]), sh)
                  for x in "qkvw")
    attn = jseq.make_sp_attention(mesh, kind, causal=causal)

    @jax.jit
    def run(q, k, v, w):
        out, vjp = jax.vjp(attn, q, k, v)
        return (out,) + vjp(w)

    return tuple(np.asarray(a) for a in run(q, k, v, w))


def _gather(ranks, name, what, layout=None, n=None):
    """The global array from the ranks' sequence shards."""
    x = np.concatenate([r[f"{name}/{what}"] for r in ranks], axis=1)
    if layout == "striped":
        x = np.asarray(jseq.unstripe_batch(jnp.asarray(x), n))
    return x


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_attention_matches_jax(inputs, port, case):
    n, causal = case["sp"], case["causal"]
    want = _jax_attn(inputs, case["kind"], causal, n)
    ranks = port()[n]
    for what, w in zip(("out", "dq", "dk", "dv"), want):
        got = _gather(ranks, case["name"], what, case.get("layout"), n)
        np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL,
                                   err_msg=f"{case['name']} {what}")
    # and the exact single-device oracle
    oracle = jseq.full_attention(*(jnp.asarray(inputs[f"attn/{x}"])
                                   for x in "qkv"), causal=causal)
    np.testing.assert_allclose(
        _gather(ranks, case["name"], "out", case.get("layout"), n),
        np.asarray(oracle), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["ring", "striped"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_of_one_is_full_attention(kind, causal):
    """At sp 1 the ring is one block: output and gradients equal exact
    attention's (autograd through full_attention), f32 to 1e-5."""
    axis = mesh_util.MeshAxis("sp", 1, 0, None, (0,))
    fn = sequence.resolve_sp_attention(kind, axis=axis, causal=causal)
    gen = torch.Generator().manual_seed(3)
    q, k, v, w = (torch.randn(2, 12, 3, 8, generator=gen) for _ in range(4))
    got, want = [], []
    for f, out in ((fn, got), (sequence.full_attention, want)):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        o = f(*qkv) if f is fn else f(*qkv, causal=causal)
        (o * w).sum().backward()
        out += [o.detach()] + [x.grad for x in qkv]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_stripe_round_trip_matches_jax(n):
    x = np.arange(2 * 16 * 3, dtype=np.float32).reshape(2, 16, 3)
    s = sequence.stripe_batch(torch.from_numpy(x), n)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jseq.stripe_batch(jnp.asarray(x), n)))
    np.testing.assert_array_equal(
        sequence.unstripe_batch(s, n).numpy(), x)
    # rank r's contiguous shard of the striped sequence is {r, r+n, ...}
    if n > 1:
        t = s.shape[1] // n
        np.testing.assert_array_equal(s[:, t:2 * t].numpy(), x[:, 1::n])
    with pytest.raises(ValueError, match="not divisible"):
        sequence.stripe_batch(torch.zeros(1, 15), 4)


def test_resolve_every_jax_kind():
    axis = mesh_util.MeshAxis("sp", 2, 0, None, (0, 1))
    for kind in ("ring", "striped", "ring_flash", "ulysses",
                 "ulysses_flash"):
        fn = sequence.resolve_sp_attention(kind, axis=axis, causal=True)
        assert fn.keywords["axis"] is axis and fn.keywords["causal"]
    one = mesh_util.MeshAxis("sp", 1, 0, None, (0,))
    assert sequence.resolve_sp_attention("flash", axis=one).func is \
        flash_attention
    with pytest.raises(ValueError, match="needs sp=1"):
        sequence.resolve_sp_attention("flash", axis=axis)
    with pytest.raises(ValueError, match="pass axis"):
        sequence.resolve_sp_attention("ring")
    with pytest.raises(ValueError, match="unknown"):
        sequence.resolve_sp_attention("bogus", axis=axis)


def test_ulysses_needs_heads_divisible():
    axis = mesh_util.MeshAxis("sp", 4, 0, None, (0, 1, 2, 3))
    q = torch.zeros(1, 4, 6, 8)
    with pytest.raises(ValueError, match="divisible by sp"):
        sequence.ulysses_attention(q, q, q, axis)
