"""The port's GPipe ``(dp, pp)`` step (``byteps_tpu_torch/parallel/
pipeline.py``) against the JAX package's ``make_dp_pp_train_step``, on the
same flax parameters and batch: the JAX side on the conftest's CPU
devices, the port over gloo ranks (``tests/torch_mp_worker.py``), each
rank holding its stage's blocks and whole embedding and head.

Cases on ``gpt_tiny`` at 4 layers, f32, each 3 steps of SGD 0.1:
``(dp 1, pp 2)`` with M = 1, 2 and 4 microbatches, ``(dp 2, pp 2)`` with
M = 2 and ``(dp 1, pp 4)`` with M = 4.  The JAX tests' tolerances: each
step's loss rtol 1e-5 / atol 1e-6, every parameter of every rank (every
stage's copy of the embedding and head included) rtol 2e-4 / atol 2e-5.
Each stage runs M stage forwards a step (the bubbles are skipped).  A
control summing the embedding and head gradients over dp only, not over
the ``(dp, pp)`` plane, must miss.  The restack (``init_pipeline_params``)
is held against the JAX function's arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models.gpt import gpt_tiny
from byteps_tpu.parallel import pipeline as jpp
from byteps_tpu_torch.models import gpt as tgpt
from byteps_tpu_torch.parallel import pipeline as tpp

from . import torch_mp_worker as W

STEPS, LR = 3, 0.1
CASES = [(1, 2, 1), (1, 2, 2), (1, 2, 4), (2, 2, 2), (1, 4, 4)]
CFG = dataclasses.replace(gpt_tiny(), dtype=jnp.float32, num_layers=4)


def make_inputs():
    batch = W.lm_batch(1, CFG.vocab_size)
    pp_params = jpp.init_pipeline_params(
        CFG, jax.random.PRNGKey(1), jnp.asarray(batch["input_ids"][:1]))
    params = jpp.pipeline_params_to_gpt(CFG, pp_params)["params"]
    inp = W.flax_flat(params, "gpt/")
    inp.update({f"batch/{k}": v for k, v in batch.items()})
    return inp, pp_params, batch


def cases():
    base = {"type": "pp", "config": "gpt_tiny4_f32", "params": "gpt",
            "batch": "batch", "steps": STEPS, "lr": LR}
    out = [dict(base, name=f"pp_{dp}x{pp}_m{m}", mesh=[dp, pp],
                microbatches=m, worlds=[dp * pp]) for dp, pp, m in CASES]
    out.append(dict(base, name="pp_2x2_m2_ends_control", mesh=[2, 2],
                    microbatches=2, control="ends_over_dp", worlds=[4]))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    inp, pp_params, batch = make_inputs()
    results, pool = W.start(tmp_path_factory.mktemp("torch_pp"), inp,
                            cases(), sorted({dp * pp for dp, pp, _ in CASES}))
    yield pp_params, batch, results
    pool.shutdown(wait=True)


def jax_steps(pp_params, batch, dp, pp, m):
    mesh = jpp.make_pp_mesh(jax.devices()[:dp * pp], n_pp=pp)
    tx = optax.sgd(LR)
    p = jpp.shard_pipeline_params(mesh, pp_params)
    o = jax.jit(tx.init)(p)
    step = jpp.make_dp_pp_train_step(mesh, CFG, tx, num_microbatches=m,
                                     donate=False)
    b = jpp.shard_pp_batch(mesh, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, b)
        losses.append(float(loss))
    got = jpp.pipeline_params_to_gpt(CFG, jax.device_get(p))["params"]
    return np.array(losses), W.port_names(got)


@pytest.mark.parametrize("dp,pp,m", CASES)
def test_dp_pp_step_matches_jax(setup, dp, pp, m):
    pp_params, batch, results = setup
    losses, want = jax_steps(pp_params, batch, dp, pp, m)
    ranks = results()[dp * pp]
    name = f"pp_{dp}x{pp}_m{m}"
    assert W.compare(ranks, name, losses, want) == []
    assert [int(r[f"{name}/stage_forwards"]) for r in ranks] == \
        [m] * (dp * pp)


def test_ends_summed_over_dp_only_misses(setup):
    """Stage 0 alone holds the embedding's gradient and the last stage
    the head's: summed over dp only, the other stages' copies drift from
    the JAX step's."""
    pp_params, batch, results = setup
    losses, want = jax_steps(pp_params, batch, 2, 2, 2)
    bad = W.compare(results()[4], "pp_2x2_m2_ends_control", losses, want)
    assert any("wte.embedding" in b for b in bad), bad
    assert any("lm_head.kernel" in b for b in bad), bad


def test_restack_matches_jax_and_round_trips():
    cfg = CFG
    ids = jnp.zeros((1, 8), jnp.int32)
    want = jpp.init_pipeline_params(cfg, jax.random.PRNGKey(0), ids)
    flax = jpp.pipeline_params_to_gpt(cfg, want)["params"]
    tcfg = dataclasses.replace(tgpt.gpt_tiny(), dtype=torch.float32,
                               num_layers=4)
    got = tpp.init_pipeline_params(tcfg, params=jax.device_get(flax))
    w_flat, g_flat = W.flax_flat(want, ""), W.flax_flat(
        {k: {kk: _np(vv) for kk, vv in v.items()} for k, v in got.items()},
        "")
    assert sorted(w_flat) == sorted(g_flat)
    for k in w_flat:
        np.testing.assert_array_equal(g_flat[k], w_flat[k], err_msg=k)
    assert g_flat["blocks/attn/qkv/kernel"].shape[0] == cfg.num_layers
    back = W.flax_flat(tpp.pipeline_params_to_gpt(tcfg, got)["params"], "")
    for k, v in W.flax_flat(flax, "").items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # from a generator: the restack of the seeded GPT's own parameters
    gen = tpp.init_pipeline_params(tcfg, torch.Generator().manual_seed(2))
    model = tgpt.GPT(tcfg, generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(
        gen["blocks"]["mlp_in"]["kernel"][3].numpy(),
        model.h[3].mlp_in.kernel.detach().numpy())


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


def test_moe_configs_refused():
    cfg = dataclasses.replace(tgpt.gpt_tiny(), moe_experts=4, num_layers=4)
    with pytest.raises(ValueError, match="homogeneous"):
        tpp.init_pipeline_params(cfg, torch.Generator().manual_seed(0))
