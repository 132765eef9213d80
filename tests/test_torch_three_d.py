"""The port's ``(dp, pp, tp)`` composite step (``byteps_tpu_torch/
parallel/three_d.py``) against the JAX package's
``make_dp_pp_tp_train_step``, on the same flax parameters and batch: the
JAX side on the conftest's CPU devices, the port over 4 gloo ranks
(``tests/torch_mp_worker.py``), each rank holding its stage's blocks laid
out over tp, and the embedding and head sliced on the vocabulary over tp
and whole over pp.

The case: ``gpt_tiny`` at 4 layers, f32 (the JAX composite's CPU tests
run f32: XLA's CPU compiler aborts on its bf16 form), ``(dp 1, pp 2, tp
2)`` with M = 2, 3 steps of SGD 0.1; each step's loss rtol 1e-5 / atol
1e-6, every parameter slice of every rank rtol 2e-4 / atol 2e-5.
``shard_3d_params`` is held against the slices the laid-out stages draw
themselves.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models.gpt import gpt_tiny
from byteps_tpu.parallel import pipeline as jpp
from byteps_tpu.parallel import three_d as j3d
from byteps_tpu_torch.models import gpt as tgpt
from byteps_tpu_torch.parallel import pipeline as tpp
from byteps_tpu_torch.parallel import three_d as t3d
from byteps_tpu_torch.parallel.mesh_util import Mesh, MeshAxis

from . import torch_mp_worker as W

STEPS, LR = 3, 0.1
DP, PP, TP, M = 1, 2, 2, 2
CFG = dataclasses.replace(gpt_tiny(), dtype=jnp.float32, num_layers=4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    batch = W.lm_batch(2, CFG.vocab_size)
    pp_params = jpp.init_pipeline_params(
        CFG, jax.random.PRNGKey(2), jnp.asarray(batch["input_ids"][:1]))
    params = jpp.pipeline_params_to_gpt(CFG, pp_params)["params"]
    inp = W.flax_flat(params, "gpt/")
    inp.update({f"batch/{k}": v for k, v in batch.items()})
    case = {"type": "3d", "name": "3d_1x2x2_m2", "mesh": [DP, PP, TP],
            "microbatches": M, "config": "gpt_tiny4_f32", "params": "gpt",
            "batch": "batch", "steps": STEPS, "lr": LR}
    results, pool = W.start(tmp_path_factory.mktemp("torch_3d"), inp,
                            [case], [DP * PP * TP])
    yield pp_params, batch, results
    pool.shutdown(wait=True)


def test_dp_pp_tp_step_matches_jax(setup):
    pp_params, batch, results = setup
    mesh = j3d.make_3d_mesh(jax.devices()[:DP * PP * TP], n_pp=PP, n_tp=TP)
    tx = optax.sgd(LR)
    p = j3d.shard_3d_params(mesh, pp_params)
    o = j3d.init_3d_opt_state(tx, p)
    step = j3d.make_dp_pp_tp_train_step(mesh, CFG, tx, num_microbatches=M,
                                        donate=False)
    b = j3d.shard_3d_batch(mesh, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, b)
        losses.append(float(loss))
    want = W.port_names(
        jpp.pipeline_params_to_gpt(CFG, jax.device_get(p))["params"])
    ranks = results()[DP * PP * TP]
    assert W.compare(ranks, "3d_1x2x2_m2", np.array(losses), want) == []
    assert [int(r["3d_1x2x2_m2/stage_forwards"]) for r in ranks] == [M] * 4
    # tp slices the stage's heads and the vocabulary
    qkv = ranks[0]["3d_1x2x2_m2/param/h.0.attn.qkv.kernel"]
    assert qkv.shape[2] * TP == CFG.num_heads
    assert ranks[3]["3d_1x2x2_m2/bounds/wte.embedding"][0].tolist() == \
        [CFG.vocab_size // 2, CFG.vocab_size]


def _fake_3d(rank):
    comm = types.SimpleNamespace(size=DP * PP * TP, rank=rank,
                                 device=torch.device("cpu"))
    d, rest = divmod(rank, PP * TP)
    s, t = divmod(rest, TP)
    return Mesh(comm, (MeshAxis("dp", DP, d, None, ()),
                       MeshAxis("pp", PP, s, None, ()),
                       MeshAxis("tp", TP, t, None, ())))


def test_shard_3d_params_is_the_stages_slices():
    cfg = dataclasses.replace(tgpt.gpt_tiny(), dtype=torch.float32,
                              num_layers=4)
    restacked = tpp.init_pipeline_params(cfg,
                                         torch.Generator().manual_seed(5))
    for rank in range(DP * PP * TP):
        mesh = _fake_3d(rank)
        stage = tgpt.GPT(cfg, tp_axis=mesh.axis("tp"),
                         layers=tpp.stage_layers(mesh, cfg.num_layers),
                         generator=torch.Generator().manual_seed(5))
        got = t3d.shard_3d_params(mesh, restacked)
        own = dict(stage.named_parameters())
        assert sorted(got) == sorted(own)
        for n, p in own.items():
            assert torch.equal(got[n], p.detach()), (rank, n)
