"""The port's ``(dp, sp)`` training step (``byteps_tpu_torch/parallel/
long_context.py``) against the JAX package's ``make_dp_sp_train_step``, on
the same flax parameters and batch: the JAX side on the conftest's CPU
devices, the port at 2 gloo ranks (``tests/torch_sp_worker.py``), each
rank taking its (rows, sequence) shard.  ``test_torch_long_context_2x2.py``
runs the same cases at ``(dp 2, sp 2)``.

Cases, each 3 steps of SGD (lr 0.1: SGD shows a wrong gradient scale,
which Adam would hide), f32 compute:
- ``gpt_tiny`` at ``(1, 2)`` with every sequence-parallel kind (``ring``,
  ``striped`` through ``shard_lm_batch(..., striped=True)``,
  ``ring_flash``, ``ulysses``, ``ulysses_flash``);
- ``llama_tiny_f32`` with ``ring_flash``: RoPE at the shards' absolute
  positions;
- the uneven-mask batch (ROADMAP Queue C 4): the second half of the
  sequence mostly ignored, so the sp ranks hold different valid counts.
  The port's step (global count) matches the JAX step; a control that
  trains the old per-rank mean (each rank's own ``lm_loss``, gradients
  averaged) must miss it.

Each step's loss to rtol 1e-5 and every parameter after the 3 steps to
atol 2e-5 (the attentions sum in another order; SGD's update is one FMA
in torch and two roundings in optax, ROADMAP Queue C 10).
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from byteps_tpu.models.gpt import GPT, gpt_tiny
from byteps_tpu.models.llama import Llama, llama_tiny_f32
from byteps_tpu.parallel import (make_dp_sp_train_step, make_sp_mesh,
                                 shard_lm_batch)
from byteps_tpu.parallel.long_context import replicate

from . import torch_sp_worker as W

KINDS = ("ring", "striped", "ring_flash", "ulysses", "ulysses_flash")
STEPS, LR = 3, 0.1
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
B, T = 4, 32


def flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def lm_batch(seed, vocab, uneven=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, T)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    if uneven:
        # most of the second half ignored, unevenly across rows
        mask = rng.rand(B, T) < 0.85
        mask[:, :T // 2] = False
        labels = np.where(mask, -1, labels).astype(np.int32)
    return {"input_ids": ids, "labels": labels}


def make_inputs():
    """The JAX models' parameters and the batches, flattened for the npz;
    and the JAX side's (config, params, batch) by name."""
    gcfg = dataclasses.replace(gpt_tiny(), dtype=jnp.float32)
    lcfg = llama_tiny_f32()
    batches = {"batch": lm_batch(0, gcfg.vocab_size),
               "uneven": lm_batch(1, gcfg.vocab_size, uneven=True),
               "lbatch": lm_batch(2, lcfg.vocab_size)}
    gp = GPT(gcfg).init(jax.random.PRNGKey(0),
                        jnp.asarray(batches["batch"]["input_ids"][:1]))
    lp = Llama(lcfg).init(jax.random.PRNGKey(1),
                          jnp.asarray(batches["lbatch"]["input_ids"][:1]))
    inp = {}
    inp.update(flat(gp["params"], "gpt/"))
    inp.update(flat(lp["params"], "llama/"))
    for name, b in batches.items():
        inp.update({f"{name}/{k}": v for k, v in b.items()})
    models = {"gpt": (gcfg, gp), "llama": (lcfg, lp)}
    return inp, models, batches


def cases(dp, sp):
    world = dp * sp
    out = [{"type": "lc", "name": f"gpt_{k}_{dp}x{sp}", "config":
            "gpt_tiny_f32", "params": "gpt", "batch": "batch", "kind": k,
            "sp": sp, "steps": STEPS, "lr": LR, "worlds": [world]}
           for k in KINDS]
    if (dp, sp) == (1, 2):
        out += [
            {"type": "lc", "name": "llama_ring_flash_1x2",
             "config": "llama_tiny_f32", "params": "llama",
             "batch": "lbatch", "kind": "ring_flash", "sp": 2,
             "steps": STEPS, "lr": LR, "worlds": [2]},
            {"type": "lc", "name": "uneven_ring_1x2", "config":
             "gpt_tiny_f32", "params": "gpt", "batch": "uneven",
             "kind": "ring", "sp": 2, "steps": STEPS, "lr": LR,
             "worlds": [2]},
            {"type": "lc", "name": "uneven_control_1x2", "config":
             "gpt_tiny_f32", "params": "gpt", "batch": "uneven",
             "kind": "ring", "sp": 2, "steps": STEPS, "lr": LR,
             "control": "per_rank_mean", "worlds": [2]}]
    return out


def start_port(tmp, inp, dp, sp):
    """The port's ranks in the background; returns a callable waiting for
    them: [npz by rank]."""
    path, cpath = str(tmp / "inputs.npz"), str(tmp / "cases.json")
    np.savez(path, **inp)
    with open(cpath, "w") as f:
        json.dump(cases(dp, sp), f)
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(W.spawn, dp * sp, path, cpath, str(tmp))
    done = []

    def results():
        if not done:
            done.extend(dict(np.load(o)) for o in fut.result())
        return done

    return results, pool


def jax_steps(cfg, params, batch, kind, dp, sp):
    """The JAX step's losses and final parameters (flattened)."""
    mesh = make_sp_mesh(jax.devices()[:dp * sp], n_sp=sp)
    tx = optax.sgd(LR)
    step = make_dp_sp_train_step(mesh, cfg, tx, attention=kind,
                                 donate=False)
    p, o = replicate(mesh, params), replicate(mesh, tx.init(params))
    b = shard_lm_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()},
                       striped=kind == "striped")
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, b)
        losses.append(float(loss))
    return np.array(losses), flat(jax.device_get(p)["params"], "")


def check(got, name, want_losses, want_params, param_atol=PARAM_ATOL):
    np.testing.assert_allclose(got[f"{name}/loss"], want_losses,
                               rtol=LOSS_RTOL, err_msg=f"{name} loss")
    for k, v in want_params.items():
        np.testing.assert_allclose(got[f"{name}/param/{_torch_name(k)}"], v,
                                   rtol=0, atol=param_atol,
                                   err_msg=f"{name} {k}")


def _torch_name(flax_path):
    """flax ``h3/attn/qkv/kernel`` -> the port's ``h.3.attn.qkv.kernel``."""
    parts = flax_path.split("/")
    if parts[0][:1] == "h" and parts[0][1:].isdigit():
        parts[0] = "h." + parts[0][1:]
    return ".".join(parts)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    inp, models, batches = make_inputs()
    results, pool = start_port(tmp_path_factory.mktemp("torch_lc"), inp,
                               1, 2)
    yield models, batches, results
    pool.shutdown(wait=True)


@pytest.mark.parametrize("kind", KINDS)
def test_gpt_step_matches_jax(setup, kind):
    models, batches, results = setup
    cfg, params = models["gpt"]
    losses, want = jax_steps(cfg, params, batches["batch"], kind, 1, 2)
    for r in results():
        check(r, f"gpt_{kind}_1x2", losses, want)


def test_llama_ring_flash_rope_at_shard_offsets(setup):
    models, batches, results = setup
    cfg, params = models["llama"]
    losses, want = jax_steps(cfg, params, batches["lbatch"], "ring_flash",
                             1, 2)
    for r in results():
        check(r, "llama_ring_flash_1x2", losses, want)


def test_uneven_mask_global_count_closes_queue_c4(setup):
    """Queue C 4: the sp ranks hold different valid-token counts; the
    port's step normalizes by the world's count as the JAX step does,
    and the old per-rank mean misses the JAX step."""
    models, batches, results = setup
    cfg, params = models["gpt"]
    b = batches["uneven"]
    counts = [(b["labels"][:, i * T // 2:(i + 1) * T // 2] != -1).sum()
              for i in range(2)]
    assert counts[0] > 2 * counts[1] > 0
    losses, want = jax_steps(cfg, params, b, "ring", 1, 2)
    ranks = results()
    for r in ranks:
        check(r, "uneven_ring_1x2", losses, want)
    ctl = ranks[0]
    assert not np.allclose(ctl["uneven_control_1x2/loss"], losses,
                           rtol=LOSS_RTOL)
    worst = max(np.abs(ctl[f"uneven_control_1x2/param/{_torch_name(k)}"]
                       - v).max() for k, v in want.items())
    assert worst > 10 * PARAM_ATOL, worst
