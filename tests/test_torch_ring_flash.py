"""The port's ring-flash attention (``byteps_tpu_torch/parallel/
ring_flash.py``) and Ulysses with the flash kernels as its local
attention, against the JAX package's on the same seeded inputs: the JAX
side on a ``(1, sp)`` mesh of the conftest's CPU devices with its Pallas
flash kernels in interpret mode, the port at 2 and 4 gloo ranks
(``tests/torch_sp_worker.py``), where the flash entry points run their
plain versions (CPU tensors).

Cases: ``ring_flash`` at sp 2 and 4, causal and not; ragged shards (T/sp
= 26, D = 48: the JAX module pads both to Mosaic's tiles, the port's
kernels take them as they are); the ring with its shift forced through
the all-to-all path (the one a gloo group takes on the card);
``ulysses_flash`` at sp 2.  The output shard and the gradients of
``sum(out * w)`` for q, k and v against JAX's ``make_sp_attention``,
f32, to 1e-5 (rtol and atol), and the output against ``full_attention``
to the same bound.
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
from byteps_tpu_torch.parallel import mesh_util, ring_flash, sequence

from . import torch_sp_worker as W

TOL = 1e-5
SHAPES = {"attn": (2, 32, 4, 32), "ragged": (2, 52, 2, 48),
          "ragged4": (1, 104, 2, 48)}
CASES = (
    [{"type": "attn", "name": f"ring_flash_sp{n}_{'c' if causal else 'n'}",
      "kind": "ring_flash", "causal": causal, "sp": n, "worlds": [n]}
     for n in (2, 4) for causal in (True, False)]
    + [{"type": "attn", "name": "ring_flash_ragged_sp2", "input": "ragged",
        "kind": "ring_flash", "causal": True, "sp": 2, "worlds": [2]},
       {"type": "attn", "name": "ring_flash_ragged_sp4", "input": "ragged4",
        "kind": "ring_flash", "causal": True, "sp": 4, "worlds": [4]},
       {"type": "attn", "name": "ring_flash_a2a_sp4_c", "kind": "ring_flash",
        "causal": True, "sp": 4, "path": "all_to_all", "worlds": [4]}]
    + [{"type": "attn", "name": f"ulysses_flash_sp2_{'c' if causal else 'n'}",
        "kind": "ulysses_flash", "causal": causal, "sp": 2, "worlds": [2]}
       for causal in (True, False)])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(1)
    return {f"{pre}/{k}": rng.randn(*shape).astype(np.float32)
            for pre, shape in SHAPES.items() for k in "qkvw"}


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """The port's ranks at sp 2 and 4, started in the background;
    calling the value waits: {world: [npz by rank]}."""
    tmp = tmp_path_factory.mktemp("torch_rf")
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


def _jax_attn(inputs, pre, kind, causal, n):
    mesh = jseq.make_sp_mesh(jax.devices()[:n], n_sp=n)
    sh = NamedSharding(mesh, P(jseq.DP_AXIS, jseq.SP_AXIS))
    q, k, v, w = (jax.device_put(jnp.asarray(inputs[f"{pre}/{x}"]), sh)
                  for x in "qkvw")
    attn = jseq.make_sp_attention(mesh, kind, causal=causal)

    @jax.jit
    def run(q, k, v, w):
        out, vjp = jax.vjp(attn, q, k, v)
        return (out,) + vjp(w)

    return tuple(np.asarray(a) for a in run(q, k, v, w))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_matches_jax_and_full_attention(inputs, port, case):
    n, causal, pre = case["sp"], case["causal"], case.get("input", "attn")
    want = _jax_attn(inputs, pre, case["kind"], causal, n)
    ranks = port()[n]
    got = {what: np.concatenate([r[f"{case['name']}/{what}"] for r in ranks],
                                axis=1)
           for what in ("out", "dq", "dk", "dv")}
    for what, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[what], w, rtol=TOL, atol=TOL,
                                   err_msg=f"{case['name']} {what}")
    oracle = jseq.full_attention(*(jnp.asarray(inputs[f"{pre}/{x}"])
                                   for x in "qkv"), causal=causal)
    np.testing.assert_allclose(got["out"], np.asarray(oracle), rtol=TOL,
                               atol=TOL)


def test_merge_weights_a_masked_block_out():
    """A block that comes back fully masked (lse ~ -1e30) leaves the
    accumulator as it was; two real blocks combine by their lse."""
    o = torch.randn(2, 5, 4)
    lse = torch.randn(2, 5)
    o2, lse2 = ring_flash._merge(o, lse, torch.randn(2, 5, 4),
                                 torch.full((2, 5), -1e30))
    torch.testing.assert_close(o2, o)
    torch.testing.assert_close(lse2, lse)
    ob = torch.randn(2, 5, 4)
    o3, lse3 = ring_flash._merge(o, lse, ob, lse)
    torch.testing.assert_close(o3, (o + ob) / 2)
    torch.testing.assert_close(lse3, lse + np.log(2.0))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_of_one_is_flash_attention(causal):
    """At sp 1 the ring is the flash entry points on one block (q_off 0):
    output and gradients equal ``flash_attention``'s, f32 to 1e-5."""
    axis = mesh_util.MeshAxis("sp", 1, 0, None, (0,))
    fn = sequence.resolve_sp_attention("ring_flash", axis=axis,
                                       causal=causal)
    gen = torch.Generator().manual_seed(5)
    q, k, v, w = (torch.randn(2, 20, 3, 32, generator=gen)
                  for _ in range(4))
    res = []
    for f in (fn, lambda *a: sequence.flash_attention(*a, causal=causal)):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        o = f(*qkv)
        (o * w).sum().backward()
        res.append([o.detach()] + [x.grad for x in qkv])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
