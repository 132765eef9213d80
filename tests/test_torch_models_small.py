"""The port's small vision models against the JAX package's: the MLP
(``models/mlp.py``), ResNet-18 at width 8, and VGG with a short
configuration at 32x32 (``models/resnet.py``), each with the JAX model's
parameters loaded through its flax loader.

Tolerances, f32 on the CPU (XLA and torch sum the products in another
order): logits, losses and BatchNorm statistics rtol 1e-5 (atol 1e-5 for
logits near 0; ResNet-18's logits and gradients to 4e-5 and 4e-4 of
their max-abs, see ``RESNET18_LOGIT_TOL``), gradients to 1e-4 of each
tensor's max-abs.  VGG's
bf16 arm holds logits to 2**-5 of their max-abs (a bf16 value can round
the other way after a product summed in another order).  VGG flattens
NHWC as flax does; a port that flattened NCHW would give other logits
(the control).  Dropout is checked on a seeded ``torch.Generator``:
the kept share within 3 sigma of 0.5, kept values exactly twice the
input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import mlp as jmlp
from byteps_tpu.models import resnet as jres
from byteps_tpu_torch.models import mlp as pmlp
from byteps_tpu_torch.models import resnet as pres

VGG_CFG = (8, "M", 16, 16, "M")
# eight blocks of train-mode BatchNorm, the last stage's over 4 values a
# channel, amplify the convolutions' rounding: read 1.0e-5 of the max-abs
RESNET18_LOGIT_TOL = 4e-5
RESNET18_GRAD_TOL = 4e-4          # read 1.0e-4 (blocks.6.proj.weight)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_mlp_logits_loss_and_gradients_match_jax():
    model = jmlp.mnist_mlp()
    rng = np.random.RandomState(0)
    x = rng.randn(6, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, 6)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jloss(p):
        return jmlp.softmax_cross_entropy(model.apply({"params": p}, x), y)

    loss, grads = jax.value_and_grad(jloss)(params)
    port = pmlp.load_flax_mlp(pmlp.mnist_mlp(), _np_tree(params))
    logits = port(torch.from_numpy(x))
    np.testing.assert_allclose(
        logits.detach().numpy(), np.asarray(model.apply({"params": params},
                                                        x)),
        rtol=1e-5, atol=1e-5)
    got = pmlp.softmax_cross_entropy(logits, torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    got.backward()
    want = _flat(_np_tree(grads))
    for n, p in port.named_parameters():
        g = p.grad.numpy()
        assert np.abs(g - want[n]).max() <= 1e-4 * np.abs(want[n]).max(), n


def test_mlp_loader_rejects_a_wrong_tree():
    port = pmlp.MLP(4, features=(16, 10))
    with pytest.raises(ValueError, match="differ"):
        pmlp.load_flax_mlp(port, {"dense_0": {"kernel": np.zeros((4, 16)),
                                              "bias": np.zeros(16)}})


@pytest.fixture(scope="module")
def resnet18_pair():
    jm = jres.ResNet(stage_sizes=(2, 2, 2, 2), block=jres.BasicBlock,
                     num_classes=10, width=8, compute_dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((2, 32, 32, 3)),
                        train=False)
    return jm, variables


def _resnet18_w8(**kw):
    """ResNet-18's stages and blocks (``resnet18``'s) at width 8."""
    return pres.ResNet((2, 2, 2, 2), pres.BasicBlock, num_classes=10,
                       width=8, **kw)


def test_resnet18_geometry_matches_jax():
    jm = jres.resnet18(num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    port = pres.resnet18(num_classes=1000)
    assert len(port.blocks) == 8
    for tree, module in ((shapes["params"], port), (shapes["batch_stats"],
                                                     None)):
        n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree))
        n_port = (sum(p.numel() for p in port.parameters()) if module
                  else sum(b.numel() for b in port.buffers()))
        assert n_port == n_jax


def test_resnet18_train_step_matches_jax(resnet18_pair):
    jm, variables = resnet18_pair
    rng = np.random.RandomState(2)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 4)

    def jloss(p):
        logits, mut = jm.apply({"params": p,
                                "batch_stats": variables["batch_stats"]},
                               x, train=True, mutable=["batch_stats"])
        return jres.softmax_cross_entropy(logits, y), (logits, mut)

    (loss, (logits, mut)), grads = jax.value_and_grad(
        jloss, has_aux=True)(variables["params"])
    port = _resnet18_w8(compute_dtype=torch.float32)
    pres.load_flax_resnet(port, _np_tree(variables["params"]),
                          _np_tree(variables["batch_stats"]))
    port.train()
    out = port(torch.from_numpy(x))
    want_logits = np.asarray(logits)
    share = (np.abs(out.detach().numpy() - want_logits).max()
             / np.abs(want_logits).max())
    assert share <= RESNET18_LOGIT_TOL, share
    got = pres.softmax_cross_entropy(out, torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    got.backward()
    want = dict(pres.load_flax_resnet(_resnet18_w8(), _np_tree(grads))
                .named_parameters())
    worst = {}
    for n, p in port.named_parameters():
        w = want[n].detach().numpy()
        worst[n] = np.abs(p.grad.numpy() - w).max() / np.abs(w).max()
    assert max(worst.values()) <= RESNET18_GRAD_TOL, max(worst, key=worst.get)
    stats = dict(pres.load_flax_resnet(
        _resnet18_w8(), _np_tree(variables["params"]),
        _np_tree(mut["batch_stats"])).named_buffers())
    for n, b in port.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def _vgg_pair(cfg_dtype):
    jdt, pdt = cfg_dtype
    jm = jres.VGG(cfg=VGG_CFG, num_classes=10, compute_dtype=jdt)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((2, 32, 32, 3)),
                     train=False)["params"]
    port = pres.VGG(cfg=VGG_CFG, num_classes=10, compute_dtype=pdt,
                    image_size=32)
    pres.load_flax_vgg(port, _np_tree(params))
    return jm, params, port


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_vgg_eval_logits_match_jax(dname):
    dt = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dname]
    jm, params, port = _vgg_pair(dt)
    x = np.random.RandomState(4).randn(3, 32, 32, 3).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, x, train=False))
    got = port.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (3, 10)
    share = np.abs(got - want).max() / np.abs(want).max()
    assert share <= (1e-5 if dname == "float32" else 2**-5), share


def test_vgg_flattens_in_flax_order():
    """The first dense layer sees the last feature map flattened NHWC: the
    port's logits match flax's, and the same weights read by a model
    that flattens NCHW (its first kernel's rows taken in NCHW order) do
    not."""
    jm, params, port = _vgg_pair((jnp.float32, torch.float32))
    x = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, x, train=False))
    port.eval()
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    c, hw = 16, 8                        # the last feature map: 8x8x16
    nchw_of_nhwc = (np.arange(c * hw * hw).reshape(c, hw, hw)
                    .transpose(1, 2, 0).reshape(-1))
    with torch.no_grad():
        k = port.dense[0].kernel
        k.copy_(k[torch.from_numpy(nchw_of_nhwc)])
    ctl = port(torch.from_numpy(x)).detach().numpy()
    assert not np.allclose(ctl, want, rtol=1e-3, atol=1e-3)


def test_vgg16_geometry_matches_jax():
    jm = jres.vgg16(num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree.leaves(shapes["params"]))
    port = pres.vgg16(device="meta", generator=torch.Generator())
    assert sum(p.numel() for p in port.parameters()) == n_jax == 138357544


def test_vgg_dropout_keeps_half_and_doubles():
    port = pres.VGG(cfg=VGG_CFG, num_classes=10, compute_dtype=torch.float32,
                    image_size=32,
                    dropout_generator=torch.Generator().manual_seed(7))
    x = torch.randn(64, 4096, generator=torch.Generator().manual_seed(8))
    y = port._dropout(x)
    kept = y != 0
    n = x.numel()
    assert abs(kept.float().mean().item() - 0.5) <= 3 * (0.25 / n) ** 0.5
    assert torch.equal(y[kept], x[kept] * 2)
    # train mode draws fresh masks from the generator; eval draws none
    port.train()
    img = torch.randn(2, 32, 32, 3)
    a, b = port(img), port(img)
    assert not torch.equal(a, b)
    port.eval()
    assert torch.equal(port(img), port(img))
    again = pres.VGG(cfg=VGG_CFG, num_classes=10,
                     compute_dtype=torch.float32, image_size=32,
                     dropout_generator=torch.Generator().manual_seed(7))
    assert torch.equal(again._dropout(x), y)


def test_cross_replica_bn_at_one_rank_is_flax_fast_variance():
    """A group of one: no collective, flax's statistics (E[x^2] - E[x]^2)
    against the JAX BatchNorm run with an axis name over one device."""
    import torch.distributed as dist
    from byteps_tpu_torch.comm.mesh import free_port
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        bn = pres.BatchNorm(5, group=dist.group.WORLD).train()
        x = np.random.RandomState(6).randn(4, 5, 3, 3).astype(np.float32) + 3
        y = bn(torch.from_numpy(x))
        jbn = jax.vmap(lambda v: _flax_bn(v, "i"), axis_name="i")
        want_y, want_stats = jbn(jnp.asarray(x.transpose(0, 2, 3, 1))[None])
        np.testing.assert_allclose(y.detach().numpy(),
                                   np.asarray(want_y[0]).transpose(0, 3, 1,
                                                                   2),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.var.numpy(),
                                   np.asarray(want_stats["var"][0]),
                                   rtol=1e-6)
    finally:
        dist.destroy_process_group()


def _flax_bn(x, axis_name):
    import flax.linen as nn
    m = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                     axis_name=axis_name)
    v = m.init(jax.random.PRNGKey(0), x)
    y, mut = m.apply(v, x, mutable=["batch_stats"])
    return y, mut["batch_stats"]


def test_vision_trainer_picks_the_step_by_model():
    """make_vision_trainer trains a ResNet through the with-state step (its
    buffers move) and a VGG through the plain one, at one gloo rank."""
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.core import api
    bps.init(device="cpu")
    try:
        comm = api.engine().comm
        for model in (pres.resnet_tiny(),
                      pres.VGG(cfg=VGG_CFG, num_classes=10,
                               compute_dtype=torch.float32, image_size=32)):
            opt = torch.optim.SGD(model.parameters(), lr=1e-3)
            step = pres.make_vision_trainer(comm, model, opt)
            before = [b.clone() for b in model.buffers()]
            g = torch.Generator().manual_seed(9)
            batch = {"images": torch.randn(4, 32, 32, 3, generator=g),
                     "labels": torch.randint(0, 10, (4,), generator=g)}
            params = [p.detach().clone() for p in model.parameters()]
            losses = [step(batch).item() for _ in range(2)]
            assert all(np.isfinite(losses))
            assert all(not torch.equal(a, b)
                       for a, b in zip(params, model.parameters()))
            # the ResNet's running statistics move; the VGG has none
            assert bool(before) == isinstance(model, pres.ResNet)
            assert all(not torch.equal(a, b)
                       for a, b in zip(before, model.buffers()))
    finally:
        bps.shutdown()
