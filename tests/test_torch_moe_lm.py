"""The port's MoE GPT (``byteps_tpu_torch/models/gpt.py``, ``moe_experts >
0``) and its ``(dp, ep)`` training step (``parallel/moe_lm.py``) against
the JAX package's, on the same flax parameters and batch: the JAX side on
the conftest's CPU devices, the port in this process and at 2 gloo ranks
(``tests/torch_sp_worker.py``), rank r holding its rows of the batch.

- the MoE GPT (``gpt_tiny`` width, 4 layers, 4 experts, a switch block
  every 2nd) on one rank against the JAX model through
  ``load_flax_gpt``: logits and each block's aux loss, f32, rtol and atol
  1e-5; a bf16 config builds and gives f32 logits; a dense config keeps
  the dense parameter tree;
- ``make_moe_lm_train_step`` at ``(1, 2)``: each rank's first logits and
  aux against the single-device model on its own rows with the full
  expert stacks (routing is shard-local), then 3 SGD steps against the
  JAX step: losses rtol 1e-5, each rank's parameters atol 2e-5;
- the expert-leaf rule (dense and router leaves summed over the world,
  expert leaves over dp alone): a control that sums the expert leaves
  over ep too must miss the JAX step.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from byteps_tpu.parallel.moe_lm import (make_ep_mesh, make_moe_lm_train_step,
                                        shard_moe_lm_batch,
                                        shard_moe_lm_params)
from byteps_tpu_torch.models import gpt

from . import torch_sp_worker as W
from .test_torch_long_context import _torch_name, flat

STEPS, LR, AUX_W = 3, 0.1, 0.01
TOL, PARAM_ATOL = 1e-5, 2e-5
B, T = 4, 16


def _jcfg(dtype=jnp.float32, experts=4):
    return JGPTConfig(vocab_size=256, hidden_size=64, num_layers=4,
                      num_heads=4, intermediate_size=128, max_position=512,
                      dtype=dtype, moe_experts=experts, moe_every=2)


def _pcfg(dtype=torch.float32, experts=4):
    return dataclasses.replace(gpt.gpt_tiny(), num_layers=4, dtype=dtype,
                               moe_experts=experts, moe_every=2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = _jcfg()
    rng = np.random.RandomState(11)
    ids = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    labels[1, 3:9] = -1                 # uneven valid counts across ranks
    batch = {"input_ids": ids, "labels": labels}
    # the parameters alone: init's output also carries the moe_aux values
    # it sowed, and an apply on it would append to them
    variables = {"params": JGPT(cfg).init(
        jax.random.PRNGKey(3), jnp.asarray(ids[:1]))["params"]}
    inp = flat(variables["params"], "moe_gpt/")
    inp.update({f"batch/{k}": v for k, v in batch.items()})
    tmp = tmp_path_factory.mktemp("torch_moe_lm")
    path, cpath = str(tmp / "inputs.npz"), str(tmp / "cases.json")
    np.savez(path, **inp)
    base = {"type": "moe_lm", "config": "moe_gpt_tiny_f32",
            "params": "moe_gpt", "batch": "batch", "ep": 2, "steps": STEPS,
            "lr": LR, "aux_weight": AUX_W, "worlds": [2]}
    with open(cpath, "w") as f:
        json.dump([dict(base, name="moe_lm_1x2"),
                   dict(base, name="moe_lm_ep_sum", control="ep_sum")], f)
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(W.spawn, 2, path, cpath, str(tmp))
    done = []

    def results():
        if not done:
            done.extend(dict(np.load(o)) for o in fut.result())
        return done

    yield cfg, variables, batch, results
    pool.shutdown(wait=True)


def _jax_forward(cfg, variables, ids):
    logits, sown = JGPT(cfg).apply(variables, jnp.asarray(ids),
                                   mutable=["moe_aux"])
    aux = [float(sown["moe_aux"][f"h{i}"]["moe"]["aux"][0])
           for i in range(cfg.num_layers) if f"h{i}" in sown["moe_aux"]]
    return np.asarray(logits), np.array(aux)


def test_moe_gpt_matches_jax_on_one_rank(setup):
    cfg, variables, batch, _ = setup
    model = gpt.load_flax_gpt(gpt.GPT(_pcfg()),
                              jax.device_get(variables["params"]))
    assert [i for i, b in enumerate(model.h) if hasattr(b, "moe")] == [1, 3]
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["input_ids"]).long())
    want_logits, want_aux = _jax_forward(cfg, variables, batch["input_ids"])
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose([a.item() for a in model.moe_aux_losses()],
                               want_aux, rtol=TOL)


def test_bf16_moe_gpt_builds_and_gives_f32_logits():
    model = gpt.GPT(_pcfg(dtype=torch.bfloat16, experts=8))
    assert model.h[1].moe.w1.dtype == torch.float32     # f32 parameters
    assert model.h[1].moe.w1.shape == (8, 64, 128)
    logits = model(torch.zeros(2, 8, dtype=torch.long))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="moe_every"):
        gpt.GPTConfig(moe_experts=4, moe_every=0)


def test_dense_config_keeps_dense_parameter_tree():
    cfg = _jcfg(experts=0)
    v = JGPT(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    want = {_torch_name(k): tuple(a.shape)
            for k, a in flat(v["params"], "").items()}
    model = gpt.GPT(_pcfg(experts=0))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert not any(".moe." in n for n in got)
    assert model.moe_aux_losses() == []


def _jax_steps(cfg, variables, batch):
    mesh = make_ep_mesh(jax.devices()[:2], n_ep=2)
    tx = optax.sgd(LR)
    p = shard_moe_lm_params(mesh, variables)
    o = jax.jit(tx.init)(p)
    step = make_moe_lm_train_step(mesh, cfg, tx, aux_weight=AUX_W,
                                  donate=False)
    b = shard_moe_lm_batch(mesh, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, b)
        losses.append(float(loss))
    return np.array(losses), flat(jax.device_get(p)["params"], "")


def _rank_slice(k, v, rank, ep=2):
    """What ep rank ``rank`` holds of the full leaf ``k``."""
    if "/moe/" in k and not k.endswith("router"):
        e_loc = v.shape[0] // ep
        return v[rank * e_loc:(rank + 1) * e_loc]
    return v


def test_forward_per_rank_matches_full_stack_model(setup):
    cfg, variables, batch, results = setup
    rows = B // 2
    for r, res in enumerate(results()):
        want_logits, want_aux = _jax_forward(
            cfg, variables, batch["input_ids"][r * rows:(r + 1) * rows])
        np.testing.assert_allclose(res["moe_lm_1x2/logits"], want_logits,
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res["moe_lm_1x2/aux"], want_aux,
                                   rtol=TOL)


def test_moe_lm_step_matches_jax(setup):
    cfg, variables, batch, results = setup
    losses, want = _jax_steps(cfg, variables, batch)
    for r, res in enumerate(results()):
        np.testing.assert_allclose(res["moe_lm_1x2/loss"], losses,
                                   rtol=TOL)
        for k, v in want.items():
            np.testing.assert_allclose(
                res[f"moe_lm_1x2/param/{_torch_name(k)}"],
                _rank_slice(k, v, r), rtol=0, atol=PARAM_ATOL, err_msg=k)


def test_expert_leaves_summed_over_ep_miss_jax(setup):
    """The control sums the expert gradients over the world: each token's
    cotangent reaches its expert twice, and the experts move off the
    JAX trajectory, while the dense leaves keep to it on the first
    step."""
    cfg, variables, batch, results = setup
    _, want = _jax_steps(cfg, variables, batch)
    res = results()[0]
    worst = {k: np.abs(res[f"moe_lm_ep_sum/param/{_torch_name(k)}"]
                       - _rank_slice(k, v, 0)).max()
             for k, v in want.items()}
    expert_keys = [k for k in worst if "/moe/w" in k]
    assert expert_keys
    assert max(worst[k] for k in expert_keys) > 10 * PARAM_ATOL, worst
