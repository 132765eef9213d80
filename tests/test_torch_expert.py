"""The port's expert parallelism (``byteps_tpu_torch/parallel/expert.py``)
against the JAX package's, on the same seeded inputs: the JAX side on the
conftest's CPU devices, the port in this process and at 2 and 4 gloo
ranks (``tests/torch_sp_worker.py``), rank r holding token shard r.

- ``switch_dispatch``, index ops, against the JAX one-hot einsum form,
  with capacity overflow and tied logits (zero tokens tie every expert;
  a duplicated router column ties two): the kept tokens and their slots
  exactly, the dispatched block exactly (one term per element), the
  gates and the aux loss to rtol 1e-6 (softmax in another order);
- ``moe_mlp`` at ``(1, 2)`` and ``(2, 2)`` against ``moe_mlp_reference``
  of both packages on each rank's shard with the full stacks: output and
  aux, and the gradients of ``sum(out * w) + aux`` (tokens, the router
  and the rank's experts, whose gradient is the sum over the shards of
  its ep group) to rtol and atol 1e-5;
- ``make_dp_ep_train_step`` for 3 SGD steps at ``(1, 2)`` and ``(2, 2)``
  against the JAX step: losses rtol 1e-5, each rank's parameters atol
  2e-5.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from byteps_tpu.parallel import expert as jexp
from byteps_tpu_torch.parallel import expert

from . import torch_sp_worker as W

H, F, E = 16, 32, 8
N_TOK = 24                        # tokens a shard
CF = 1.5
STEPS, LR, AUX_W = 3, 0.1, 0.01
TOL = 1e-5
LAYOUTS = ((1, 2), (2, 2))        # (dp, ep)
KEYS = ("router", "w1", "b1", "w2", "b2")


def _full_params(seed):
    p = jexp.init_moe_params(jax.random.PRNGKey(seed), H, F, E)
    rng = np.random.RandomState(seed)
    out = {k: np.array(v, np.float32) for k, v in p.items()}
    # biases non-zero, so their gradients and updates show
    out["b1"] = (rng.randn(E, F) * 0.1).astype(np.float32)
    out["b2"] = (rng.randn(E, H) * 0.1).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(7)
    inp = {f"moe/params/{k}": v for k, v in _full_params(0).items()}
    inp["moe/x"] = rng.randn(4, N_TOK, H).astype(np.float32)
    inp["moe/w"] = rng.randn(4, N_TOK, H).astype(np.float32)
    inp["ep/x"] = rng.randn(4, N_TOK, H).astype(np.float32)
    inp["ep/y"] = np.tanh(inp["ep/x"][:, :, ::-1]).copy()
    return inp


def _cases():
    out = []
    for dp, ep in LAYOUTS:
        w = dp * ep
        out.append({"type": "moe_mlp", "name": f"moe_{dp}x{ep}", "ep": ep,
                    "experts": E, "capacity": CF, "worlds": [w]})
        out.append({"type": "dp_ep", "name": f"dp_ep_{dp}x{ep}", "ep": ep,
                    "experts": E, "capacity": CF, "steps": STEPS, "lr": LR,
                    "aux_weight": AUX_W, "worlds": [w]})
    return out


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ep")
    path, cpath = str(tmp / "inputs.npz"), str(tmp / "cases.json")
    np.savez(path, **inputs)
    with open(cpath, "w") as f:
        json.dump(_cases(), f)
    pool = ThreadPoolExecutor(2)
    futures = {n: pool.submit(W.spawn, n, path, cpath, str(tmp))
               for n in (2, 4)}
    done = {}

    def results():
        if not done:
            for n, f in futures.items():
                done[n] = [dict(np.load(o)) for o in f.result()]
        return done

    yield results
    pool.shutdown(wait=True)


# --- dispatch ------------------------------------------------------------------

def _dispatch_inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(40, H).astype(np.float32)
    x[::7] = 0.0                      # every expert tied: the first wins
    router = rng.randn(H, E).astype(np.float32)
    router[:, 5] = router[:, 2]       # experts 2 and 5 tied: 2 wins
    return x, router


@pytest.mark.parametrize("capacity", [2, 4, 40])
def test_switch_dispatch_matches_jax_einsum_form(capacity):
    x, router = _dispatch_inputs()
    combine, dispatched, aux = jexp.switch_dispatch(
        jnp.asarray(x), jnp.asarray(router), E, capacity)
    combine = np.asarray(combine)
    d = expert.switch_dispatch(torch.from_numpy(x), torch.from_numpy(router),
                               E, capacity)
    expert_id, slot = d.expert.numpy(), d.slot.numpy()
    keep, gate = d.keep.numpy(), d.gate.numpy()
    assert (expert_id[::7] == 0).all()
    assert 5 not in expert_id
    if capacity < 40:
        assert not keep.all()             # the overflow is exercised
    for n in range(len(x)):
        nz = np.argwhere(combine[n] != 0)
        if keep[n]:
            assert nz.tolist() == [[expert_id[n], slot[n]]], n
            np.testing.assert_allclose(gate[n], combine[n][tuple(nz[0])],
                                       rtol=1e-6)
        else:
            assert len(nz) == 0, n
    np.testing.assert_array_equal(d.dispatched.numpy(), np.asarray(dispatched))
    np.testing.assert_allclose(d.aux.item(), float(aux), rtol=1e-6)


def test_dropped_tokens_give_zero_rows():
    x, router = _dispatch_inputs()
    full = {k: torch.from_numpy(v) for k, v in _full_params(1).items()}
    full["router"] = torch.from_numpy(router)
    out, _ = expert.moe_mlp_reference(torch.from_numpy(x), full, E, 0.125)
    d = expert.switch_dispatch(torch.from_numpy(x), full["router"], E,
                               expert.capacity_of(0.125, len(x), E))
    zero = (out.abs().sum(1) == 0).numpy()
    np.testing.assert_array_equal(zero, ~d.keep.numpy())


# --- moe_mlp over ep ---------------------------------------------------------------

def _jax_ref_grads(x, w, full):
    """The JAX reference on one shard: out, aux and the gradients of
    sum(out * w) + aux for the tokens and the full parameters."""
    def f(x, p):
        out, aux = jexp.moe_mlp_reference(x, p, E, CF)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (out, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(x), full)
    return (np.asarray(out), float(aux), np.asarray(gx),
            {k: np.asarray(v) for k, v in gp.items()})


@pytest.mark.parametrize("dp,ep", LAYOUTS)
def test_moe_mlp_matches_both_references(inputs, port, dp, ep):
    full = {k: jnp.asarray(inputs[f"moe/params/{k}"]) for k in KEYS}
    tfull = {k: torch.from_numpy(inputs[f"moe/params/{k}"]) for k in KEYS}
    world = dp * ep
    refs = [_jax_ref_grads(inputs["moe/x"][r], inputs["moe/w"][r], full)
            for r in range(world)]
    ranks = port()[world]
    name = f"moe_{dp}x{ep}"
    e_loc = E // ep
    for r, res in enumerate(ranks):
        out, aux, gx, gp = refs[r]
        np.testing.assert_allclose(res[f"{name}/out"], out, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(res[f"{name}/aux"], aux, rtol=TOL)
        tout, taux = expert.moe_mlp_reference(
            torch.from_numpy(inputs["moe/x"][r]), tfull, E, CF)
        np.testing.assert_allclose(res[f"{name}/out"], tout.numpy(),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res[f"{name}/aux"], taux.item(),
                                   rtol=TOL)
        np.testing.assert_allclose(res[f"{name}/dx"], gx, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(res[f"{name}/grad/router"],
                                   gp["router"], rtol=TOL, atol=TOL)
        # this rank's experts gather the cotangents of its ep group
        d, e = divmod(r, ep)
        group = range(d * ep, (d + 1) * ep)
        for k in ("w1", "b1", "w2", "b2"):
            want = sum(refs[g][3][k] for g in group)[e * e_loc:
                                                     (e + 1) * e_loc]
            np.testing.assert_allclose(res[f"{name}/grad/{k}"], want,
                                       rtol=TOL, atol=TOL, err_msg=k)


# --- the (dp, ep) step ----------------------------------------------------------

@pytest.mark.parametrize("dp,ep", LAYOUTS)
def test_dp_ep_step_matches_jax(inputs, port, dp, ep):
    world = dp * ep
    mesh = jexp.make_ep_mesh(jax.devices()[:world], n_ep=ep)
    full = {k: jnp.asarray(inputs[f"moe/params/{k}"]) for k in KEYS}
    tx = optax.sgd(LR)

    def shard_loss(out, batch):
        return jnp.mean((out - batch["y"]) ** 2)

    step = jexp.make_dp_ep_train_step(mesh, E, CF, tx, shard_loss,
                                      aux_weight=AUX_W, donate=False)
    p = jexp.shard_moe_params(mesh, full)
    o = jax.jit(tx.init)(p)
    sh = NamedSharding(mesh, P((jexp.DP_AXIS, jexp.EP_AXIS)))
    batch = jax.device_put(
        {k: jnp.asarray(inputs[f"ep/{k}"][:world].reshape(-1, H))
         for k in ("x", "y")}, sh)
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))
    p = {k: np.asarray(v) for k, v in jax.device_get(p).items()}
    name = f"dp_ep_{dp}x{ep}"
    e_loc = E // ep
    for r, res in enumerate(port()[world]):
        np.testing.assert_allclose(res[f"{name}/loss"], losses, rtol=TOL)
        e = r % ep
        for k in KEYS:
            want = p[k] if k == "router" else p[k][e * e_loc:(e + 1) * e_loc]
            np.testing.assert_allclose(res[f"{name}/param/{k}"], want,
                                       rtol=0, atol=2e-5, err_msg=k)
