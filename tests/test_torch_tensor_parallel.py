"""The port's ``(dp, tp)`` GPT step (``byteps_tpu_torch/parallel/
tensor_parallel.py``) against the JAX package's ``make_dp_tp_train_step``,
on the same flax parameters and batch: the JAX side on the conftest's CPU
devices, the port over gloo ranks (``tests/torch_mp_worker.py``), each
rank holding its slices.

Cases, each 3 steps of SGD 0.1 (SGD shows a wrong gradient scale, which
Adam would hide) in f32 on ``gpt_tiny`` (4 heads, ffn 128, vocab 256):
``(dp 1, tp 2)`` and ``(dp 2, tp 2)``.  The JAX tests' tolerances: each
step's loss rtol 1e-5 / atol 1e-6, every parameter slice of every rank
rtol 2e-4 / atol 2e-5.  A control adding the row-parallel biases (``out``,
``mlp_out``) on every tp rank, before the sum over tp, must miss.  The
rule table, the slicing of a whole state and the guard against a model
holding whole parameters are pinned in process.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.models.gpt import GPT, gpt_tiny
from byteps_tpu.parallel import tensor_parallel as jtp
from byteps_tpu_torch.models import gpt as tgpt
from byteps_tpu_torch.parallel import tensor_parallel as ttp
from byteps_tpu_torch.parallel.mesh_util import Mesh2D, MeshAxis
from byteps_tpu_torch.parallel.tp_layers import param_placements, take

from . import torch_mp_worker as W

STEPS, LR = 3, 0.1
LAYOUTS = [(1, 2), (2, 2)]
CFG = dataclasses.replace(gpt_tiny(), dtype=jnp.float32)


def make_inputs():
    batch = W.lm_batch(0, CFG.vocab_size)
    params = GPT(CFG).init(jax.random.PRNGKey(0),
                           jnp.asarray(batch["input_ids"][:1]))["params"]
    inp = W.flax_flat(params, "gpt/")
    inp.update({f"batch/{k}": v for k, v in batch.items()})
    return inp, params, batch


def cases():
    out = [{"type": "tp", "name": f"tp_{dp}x{tp}", "mesh": [dp, tp],
            "config": "gpt_tiny_f32", "params": "gpt", "batch": "batch",
            "steps": STEPS, "lr": LR, "worlds": [dp * tp]}
           for dp, tp in LAYOUTS]
    out.append({"type": "tp", "name": "tp_1x2_bias_control",
                "mesh": [1, 2], "config": "gpt_tiny_f32", "params": "gpt",
                "batch": "batch", "steps": STEPS, "lr": LR,
                "control": "bias_every_rank", "worlds": [2]})
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    inp, params, batch = make_inputs()
    results, pool = W.start(tmp_path_factory.mktemp("torch_tp"), inp,
                            cases(), sorted({dp * tp for dp, tp in LAYOUTS}))
    yield params, batch, results
    pool.shutdown(wait=True)


def jax_steps(params, batch, dp, tp):
    mesh = jtp.make_tp_mesh(jax.devices()[:dp * tp], n_tp=tp)
    tx = optax.sgd(LR)
    p = jtp.shard_gpt_params(mesh, {"params": params})
    o = jtp.init_tp_opt_state(tx, p)
    step = jtp.make_dp_tp_train_step(mesh, CFG, tx, donate=False)
    b = jtp.shard_tp_batch(mesh, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, b)
        losses.append(float(loss))
    return np.array(losses), W.port_names(jax.device_get(p)["params"])


@pytest.mark.parametrize("dp,tp", LAYOUTS)
def test_dp_tp_step_matches_jax(setup, dp, tp):
    params, batch, results = setup
    losses, want = jax_steps(params, batch, dp, tp)
    assert W.compare(results()[dp * tp], f"tp_{dp}x{tp}", losses,
                     want) == []


def test_row_parallel_bias_control_misses(setup):
    params, batch, results = setup
    losses, want = jax_steps(params, batch, 1, 2)
    bad = W.compare(results()[2], "tp_1x2_bias_control", losses, want)
    assert any("losses" in b for b in bad), bad
    assert any("mlp_out.bias" in b or "attn.out.bias" in b for b in bad), bad


def test_rules_equal_the_jax_table():
    paths = ["h0/attn/qkv/kernel", "h0/attn/qkv/bias", "h1/attn/out/kernel",
             "h1/attn/out/bias", "h0/mlp_in/kernel", "h0/mlp_in/bias",
             "h1/mlp_out/kernel", "h1/mlp_out/bias", "wte/embedding",
             "wpe/embedding", "lm_head/kernel", "lm_head/bias",
             "ln_f/scale", "h0/ln1/bias"]
    for path in paths:
        assert ttp.tp_spec_for(path) == tuple(jtp.tp_spec_for(path)), path


def _fake_mesh(dp, tp, rank=0):
    """A mesh of ``dp x tp`` axes seen from ``rank``, without groups (for
    what needs no collective)."""
    comm = types.SimpleNamespace(size=dp * tp, rank=rank,
                                 device=torch.device("cpu"))
    o, i = divmod(rank, tp)
    return Mesh2D(comm, (MeshAxis("dp", dp, o, None, ()),
                         MeshAxis("tp", tp, i, None, ())))


def test_shard_gpt_params_is_the_models_slices():
    cfg = dataclasses.replace(tgpt.gpt_tiny(), dtype=torch.float32)
    whole = tgpt.GPT(cfg, generator=torch.Generator().manual_seed(4))
    state = whole.state_dict()
    for rank in range(2):
        mesh = _fake_mesh(1, 2, rank)
        model = tgpt.GPT(cfg, tp_axis=mesh.axis("tp"),
                         generator=torch.Generator().manual_seed(4))
        got = ttp.shard_gpt_params(mesh, state)
        places = param_placements(model)
        for n, p in model.named_parameters():
            assert torch.equal(got[n], p.detach()), n
            assert torch.equal(take(state[n], places[n]), p.detach()), n
        assert model.h[0].attn.qkv.kernel.shape[2] * 2 == cfg.num_heads
        assert model.h[0].ln1.scale.shape == (cfg.hidden_size,)


def test_unsharded_params_rejected():
    """A model holding whole parameters (built without the mesh's tp
    axis) raises, as fresh init output does in the JAX step."""
    cfg = dataclasses.replace(tgpt.gpt_tiny(), dtype=torch.float32)
    mesh = _fake_mesh(1, 2)
    model = tgpt.GPT(cfg)
    step = ttp.make_dp_tp_train_step(
        mesh, model, torch.optim.SGD(model.parameters(), lr=LR))
    batch = W.lm_batch(0, cfg.vocab_size)
    with pytest.raises(ValueError, match="not mesh-sharded"):
        step({k: torch.from_numpy(v).long() for k, v in batch.items()})
    other = _fake_mesh(1, 2)
    laid = tgpt.GPT(cfg, tp_axis=other.axis("tp"))
    step = ttp.make_dp_tp_train_step(
        mesh, laid, torch.optim.SGD(laid.parameters(), lr=LR))
    with pytest.raises(ValueError, match="different mesh"):
        step({k: torch.from_numpy(v).long() for k, v in batch.items()})
