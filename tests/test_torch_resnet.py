"""The port's ResNet against the JAX package's flax ResNet.

flax ``resnet_tiny(compute_dtype=f32)`` variables are carried into the
port's ``resnet_tiny`` with ``load_flax_resnet``; both see the same NHWC
batch in train mode.  Tolerances, f32 on the CPU with the convolutions
summed in another order by XLA and by torch: logits and BatchNorm
statistics rtol 1e-5, gradients rtol 1e-4.  Spatial sizes 16 and 17 put
both parities through the strided SAME layers (7x7/2 stem, 3x3/2
max-pool, 3x3/2 conv), where XLA pads on the high side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import resnet as jax_resnet
from byteps_tpu_torch.models import resnet as port_resnet


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_step(model, variables, x, labels):
    def loss_fn(params):
        logits, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, train=True, mutable=["batch_stats"])
        return (jax_resnet.softmax_cross_entropy(logits, labels),
                (logits, mut["batch_stats"]))
    (loss, (logits, stats)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    return float(loss), np.asarray(logits), _np_tree(grads), _np_tree(stats)


@pytest.fixture(scope="module")
def flax_tiny():
    model = jax_resnet.resnet_tiny(compute_dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((2, 16, 16, 3)), train=False)
    # non-trivial running statistics, so eval mode reads real values
    rng = np.random.RandomState(9)
    variables = {
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape),
                                  jnp.float32),
            variables["batch_stats"])}
    return model, variables


def _port_tiny(variables, with_stats=True):
    m = port_resnet.resnet_tiny()
    return port_resnet.load_flax_resnet(
        m, _np_tree(variables["params"]),
        _np_tree(variables["batch_stats"]) if with_stats else None)


@pytest.mark.parametrize("size", [16, 17])
def test_train_step_matches_flax(flax_tiny, size):
    model, variables = flax_tiny
    rng = np.random.RandomState(size)
    x = rng.randn(4, size, size, 3).astype(np.float32)
    labels = rng.randint(0, 10, size=4)
    loss, logits, grads, stats = _jax_step(model, variables, jnp.asarray(x),
                                           jnp.asarray(labels))

    port = _port_tiny(variables).train()
    out = port(torch.from_numpy(x))
    port_loss = torch.nn.functional.cross_entropy(out, torch.from_numpy(labels))
    port_loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port_loss.item(), loss, rtol=1e-5)

    # the JAX gradient tree, carried through the same name mapping
    want = dict(port_resnet.load_flax_resnet(
        port_resnet.resnet_tiny(), grads).named_parameters())
    names = [n for n, _ in port.named_parameters()]
    assert len(names) == len(want) == len(jax.tree_util.tree_leaves(grads))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want[name].detach().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)

    # the running statistics after one train-mode forward
    ref = _port_tiny({"params": variables["params"], "batch_stats": stats})
    for (name, b), (_, r) in zip(port.named_buffers(), ref.named_buffers()):
        np.testing.assert_allclose(b.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("size", [16, 17])
def test_eval_logits_match_flax(flax_tiny, size):
    model, variables = flax_tiny
    x = np.random.RandomState(100 + size).randn(3, size, size, 3) \
        .astype(np.float32)
    logits = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    port = _port_tiny(variables).eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), logits, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,window,stride", [
    (16, 3, 2), (17, 3, 2), (15, 7, 2), (112, 3, 2), (7, 3, 1)])
def test_same_pooling_and_conv_padding_match_xla(size, window, stride):
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, window, window, 1),
        (1, stride, stride, 1), "SAME"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port_resnet.max_pool_same(t, (window, window), (stride, stride))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # the conv's SAME padding: a ConvBN with BatchNorm and ReLU taken out
    k = np.random.RandomState(1).randn(window, window, 3, 4) \
        .astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    cb = port_resnet.ConvBN(3, 4, (window, window), (stride, stride),
                            compute_dtype=torch.float32).eval()
    with torch.no_grad():
        cb.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
    cb.bn = torch.nn.Identity()
    cb.act = False
    with torch.no_grad():
        got = cb(t).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resnet50_geometry():
    """Full width, built without a forward pass."""
    m = port_resnet.resnet50()
    params = list(m.parameters())
    assert len(params) == 161
    assert sum(p.numel() for p in params) == 25_557_032
    # every flax variable of the JAX resnet50 has a home in the port
    shapes = jax.eval_shape(
        lambda: jax_resnet.resnet50().init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 32, 32, 3)),
                                           train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    port_resnet.load_flax_resnet(m, zeros["params"], zeros["batch_stats"])
    assert all(not p.detach().any() for p in m.parameters())
