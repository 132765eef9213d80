"""The port's ZeRO-1 and flat FSDP steps (``parallel/zero.py``) against
the JAX package's and against the port's replicated step.

Multi-rank results come from tests/torch_sharded_worker.py (the MLP of
``TinyMLP``, this rank's batch of the seeded global batch, AdamW, 3
steps), spawned over gloo at one node of two ranks, two nodes of two and
one node of four.

Tolerances:
- against JAX ``make_zero_train_step`` / ``make_fsdp_train_step`` on two
  CPU devices: the reference's own ``rtol 1e-4, atol 1e-5`` on losses
  and parameters (torch's and XLA's f32 matmuls and AdamW round
  differently);
- against the port's replicated step (``DistributedOptimizer`` + AdamW):
  bit for bit where the two sum the ranks' gradients in one order: at
  two ranks, and under HSDP (``"ici"``) at 2x2, where the replicated
  path's reduce-scatter in the node and all-reduce across nodes are
  ZeRO's own; at four ranks under ``"all"`` the world reduce-scatter
  adds the four in another order than the two-level all-reduce, so
  ``REPLICATED_ATOL`` (1e-7: a few f32 ulps of parameters under 0.5,
  through 3 steps; measured 7.5e-9);
- the clip: ``rtol 1e-5`` against a replicated clip computed here, and a
  control that sums the HSDP norm over the world (each shard counted
  twice) must over-clip by more than 10x that.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.comm.mesh import CommContext as JaxComm
from byteps_tpu.comm.mesh import _build_mesh
from byteps_tpu.parallel.zero import (init_zero_state as jax_init_zero,
                                      make_fsdp_train_step as jax_fsdp,
                                      make_zero_train_step as jax_zero1,
                                      zero_params as jax_zero_params)

from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.core import api
from byteps_tpu_torch.parallel import zero

from . import torch_sharded_worker as W

LAYOUTS = ("node_of_2", "2x2", "1x4")
REPLICATED_ATOL = 1e-7
KEYS = sorted(W.mlp_params())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_zero"))
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        futures = {name: pool.submit(W.spawn, name, "cpu", tmp, "zero")
                   for name in LAYOUTS}
        outs = {name: f.result() for name, f in futures.items()}
    return {name: [dict(np.load(o)) for o in files]
            for name, files in outs.items()}


def _jax_run(kind, R=2):
    comm = JaxComm(mesh=_build_mesh(jax.devices()[:R], 1), n_dcn=1, n_ici=R)
    tx = optax.adamw(W.ZERO_ADAMW["lr"],
                     weight_decay=W.ZERO_ADAMW["weight_decay"])
    params = {k: jnp.asarray(v) for k, v in W.mlp_params().items()}

    def loss_fn(p, batch):
        h = jax.nn.relu(batch["x"] @ p["w1"] + p["b1"])
        return jnp.mean((h @ p["w2"] + p["b2"] - batch["y"]) ** 2)

    zs = jax_init_zero(comm, tx, params)
    if kind == "zero1":
        step = jax_zero1(comm, loss_fn, tx, donate=False)
    else:
        step = jax_fsdp(comm, loss_fn, tx, params_template=params,
                        donate=False)
    losses = []
    p = params
    for s in range(W.ZERO_STEPS):
        x, y = W.mlp_batch(s, R)
        batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        if kind == "zero1":
            p, zs, loss = step(p, zs, batch)
        else:
            zs, loss = step(zs, batch)
        losses.append(float(loss))
    out = jax_zero_params(comm, zs, params)
    return losses, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["zero1", "fsdp"])
def test_matches_jax_at_two_ranks(results, kind):
    losses, params = _jax_run(kind)
    for res in results["node_of_2"]:
        np.testing.assert_allclose(res[f"zero/all/{kind}/losses"], losses,
                                   rtol=1e-4, atol=1e-5)
        for k in KEYS:
            np.testing.assert_allclose(res[f"zero/all/{kind}/{k}"],
                                       params[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("kind", ["zero1", "fsdp"])
@pytest.mark.parametrize("layout,axes", [("node_of_2", "all"),
                                         ("2x2", "ici"), ("2x2", "all"),
                                         ("1x4", "all")])
def test_matches_replicated_step(results, layout, axes, kind):
    exact = layout == "node_of_2" or axes == "ici"
    for res in results[layout]:
        for k in KEYS:
            got, want = res[f"zero/{axes}/{kind}/{k}"], res[f"replicated/{k}"]
            if exact:
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=REPLICATED_ATOL, err_msg=k)


@pytest.mark.parametrize("layout,axes", [("node_of_2", "all"),
                                         ("2x2", "all"), ("2x2", "ici"),
                                         ("1x4", "all")])
def test_shard_layout(results, layout, axes):
    """The master and both AdamW moments hold padded/shards elements per
    rank: 276 parameters pad to 512 (a multiple of shards * 128)."""
    hosts, local = W.LAYOUTS[layout]
    shards = hosts * local if axes == "all" else local
    n = sum(v.size for v in W.mlp_params().values())
    padded = zero.padded_size(n, shards)
    assert padded == 512
    for res in results[layout]:
        for kind in ("zero1", "fsdp"):
            assert res[f"zero/{axes}/{kind}/shard_lengths"].tolist() == \
                [padded // shards] * 3


def test_clip_by_global_norm_hsdp_sgd(results):
    """At 2x2 with SGD (which, unlike Adam, sees a wrong norm): the clip
    under "all" and under "ici" matches the replicated clip; the control,
    an "ici" step whose clip sums over the world, over-clips."""
    losses, want = W.replicated_mlp(
        4, W.ZERO_STEPS,
        lambda ps: torch.optim.SGD(ps, lr=W.CLIP_SGD_LR), W.CLIP_MAX_NORM)
    for res in results["2x2"]:
        for tag in ("all", "ici"):
            np.testing.assert_allclose(res[f"zero/clip/{tag}/losses"],
                                       losses, rtol=1e-5)
            for k in KEYS:
                np.testing.assert_allclose(res[f"zero/clip/{tag}/{k}"],
                                           want[k], rtol=1e-5, atol=1e-7,
                                           err_msg=(tag, k))
        worst = max(np.abs(res[f"zero/clip/control/{k}"] - want[k]).max()
                    / np.abs(want[k]).max() for k in KEYS)
        assert worst > 1e-4, worst


def test_clip_by_global_norm_local():
    """With no comm: the plain global norm of one tensor."""
    g = torch.tensor([3.0, 4.0])
    torch.testing.assert_close(zero.clip_by_global_norm(1.0)(g),
                               torch.tensor([0.6, 0.8]))
    torch.testing.assert_close(zero.clip_by_global_norm(10.0)(g), g)


@pytest.fixture
def one_rank():
    api.init(Config(), device="cpu")
    yield api.engine().comm
    api.shutdown()


def _batch(s):
    x, y = W.mlp_batch(s, 1)
    return torch.from_numpy(x), torch.from_numpy(y)


def _f32_master_reference(dtype, steps, template=torch.bfloat16):
    """A plain step with f32 masters: a master per parameter from the
    ``template``-dtype parameters, the model in ``dtype`` copied from the
    masters, AdamW on the masters."""
    template_model = W.TinyMLP(W.mlp_params()).to(template)
    masters = [p.detach().float().clone()
               for p in template_model.parameters()]
    model = W.TinyMLP(W.mlp_params()).to(dtype)
    with torch.no_grad():
        for m, p in zip(masters, model.parameters()):
            p.copy_(m)
    opt = torch.optim.AdamW(masters, **W.ZERO_ADAMW)
    losses = []
    for s in range(steps):
        model.zero_grad()
        x, y = _batch(s)
        loss = W.mse(model, (x.to(dtype), y.to(dtype)))
        loss.backward()
        for m, p in zip(masters, model.parameters()):
            m.grad = p.grad.float()
        opt.step()
        with torch.no_grad():
            for m, p in zip(masters, model.parameters()):
                p.copy_(m)
        losses.append(loss.item())
    return losses, dict(zip(sorted(W.mlp_params()), masters))


def test_zero1_bf16_template_f32_master(one_rank):
    comm = one_rank
    model = W.TinyMLP(W.mlp_params()).to(torch.bfloat16)
    zs = zero.init_zero_state(
        comm, model, lambda ps: torch.optim.AdamW(ps, **W.ZERO_ADAMW))
    assert zs.master.dtype == torch.float32
    step = zero.make_zero_train_step(
        comm, model,
        lambda m, b: W.mse(m, (b[0].bfloat16(), b[1].bfloat16())))
    losses = [step(zs, _batch(s)).item() for s in range(W.ZERO_STEPS)]
    want_losses, masters = _f32_master_reference(torch.bfloat16,
                                                 W.ZERO_STEPS)
    assert losses == want_losses
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    got = zero.zero_params(comm, zs, W.TinyMLP(W.mlp_params()))
    for k in KEYS:
        assert torch.equal(got[k], masters[k]), k
        assert torch.equal(dict(model.named_parameters())[k],
                           masters[k].bfloat16()), k


def test_fsdp_bf16_compute_releases_parameters(one_rank):
    comm = one_rank
    model = W.TinyMLP(W.mlp_params())
    zs = zero.init_zero_state(
        comm, model, lambda ps: torch.optim.AdamW(ps, **W.ZERO_ADAMW))
    step = zero.make_fsdp_train_step(
        comm, model,
        lambda m, b: W.mse(m, (b[0].bfloat16(), b[1].bfloat16())),
        compute_dtype=torch.bfloat16)
    losses = [step(zs, _batch(s)).item() for s in range(W.ZERO_STEPS)]
    # between steps only the master persists
    assert all(p.numel() == 0 and p.grad is None
               for p in model.parameters())
    want_losses, masters = _f32_master_reference(
        torch.bfloat16, W.ZERO_STEPS, template=torch.float32)
    assert losses == want_losses
    got = zero.zero_params(comm, zs, step.views)
    bf = zero.zero_params(comm, zs, step.views, torch.bfloat16)
    for k in KEYS:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], masters[k]), k
        assert torch.equal(bf[k], masters[k].bfloat16()), k


def test_resolve_axes_validation(one_rank):
    with pytest.raises(ValueError, match="shard_axes"):
        zero.init_zero_state(one_rank, W.TinyMLP(W.mlp_params()),
                             lambda ps: torch.optim.SGD(ps, lr=1),
                             shard_axes="dcn")
