"""The port's main path as a whole, and the rules of its package.

The main path: ``DistributedOptimizer`` -> engine -> onebit + error
feedback compressed push_pull.  Three SGD steps of one seeded torch
model through the port (``init(device="cpu")``, a world of one over gloo)
and through the JAX package's ``byteps_tpu.torch.DistributedOptimizer``
(its 8-device CPU mesh receives identical rows, so its average equals one
rank's up to rounding) end at the same parameters, rtol 1e-5.  Under
tests/conftest.py's BYTEPS_MIN_COMPRESS_BYTES=0 both compress every
tensor.
"""

import ast
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import byteps_tpu.torch as jax_torch
import byteps_tpu_torch as port
from byteps_tpu_torch.core import api as port_api
from byteps_tpu_torch.models.resnet import resnet_tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}


def _train(adapter, model, x, y, steps=3):
    opt = adapter.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(), compression=ONEBIT_EF)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def test_resnet_tiny_sgd_matches_jax_adapter():
    gen = torch.Generator().manual_seed(3)
    model = resnet_tiny(generator=gen)
    twin = copy.deepcopy(model)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, 16, 16, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, size=4))

    port.init(device="cpu")
    try:
        assert port.size() == 1 and port.rank() == 0
        port_losses = _train(port, model, x, y)
        n_compressed = sum(
            bool(port_api.engine().registry.get(f"torch.grad.{n}").compressor)
            for n, _ in model.named_parameters())
    finally:
        port.shutdown()
    jax_torch.init()
    try:
        jax_losses = _train(jax_torch, twin, x, y)
    finally:
        jax_torch.shutdown()

    assert n_compressed == len(list(model.parameters()))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for (name, b), c in zip(model.named_buffers(), twin.buffers()):
        np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def _port_modules():
    pkg = os.path.join(REPO, "byteps_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_imports_with_jax_blocked():
    names = []
    for path in _port_modules():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        names.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                     else rel)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['byteps_tpu'] = None\n"
        "sys.modules['tools'] = None\n"
        "sys.modules['example'] = None\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'byteps_tpu.',"
        " 'tools.', 'example.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_the_frontends_are_scanned_and_import_only_where_asked():
    """The scan below covers the frontends (TensorFlow, Keras, MXNet) and
    bench_smoke; ``import byteps_tpu_torch`` imports neither TensorFlow
    nor Keras; with jax blocked and no KERAS_BACKEND given, the port's
    Keras runs on TensorFlow."""
    rel = {os.path.relpath(p, REPO) for p in _port_modules()}
    for sub in ("mxnet/__init__.py", "mxnet/ops.py", "mxnet/compression.py",
                "tensorflow/__init__.py", "tensorflow/compression.py",
                "tensorflow/distribute/__init__.py", "keras/__init__.py",
                "keras/callbacks.py", "tools/bench_smoke.py"):
        assert os.path.join("byteps_tpu_torch", sub) in rel, sub
    code = (
        "import os, sys\n"
        "os.environ.pop('KERAS_BACKEND', None)\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['byteps_tpu'] = None\n"
        "import byteps_tpu_torch, byteps_tpu_torch.mxnet\n"
        "import byteps_tpu_torch.tools.bench_smoke\n"
        "assert 'tensorflow' not in sys.modules, 'tensorflow'\n"
        "assert 'keras' not in sys.modules, 'keras'\n"
        "import byteps_tpu_torch.keras, keras\n"
        "assert keras.backend.backend() == 'tensorflow'\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "KERAS_BACKEND"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", list(_port_modules()) + [
    os.path.join(REPO, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_jax_package_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            # nor the repository's root tools/ and example/, which drive
            # the JAX package
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "byteps_tpu", "tools", "example"), \
                f"{path}:{node.lineno} {m}"


def test_init_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        port.init()
    assert not port_api.initialized()
    assert not dist.is_initialized()
