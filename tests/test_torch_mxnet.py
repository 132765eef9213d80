"""The port's MXNet adapter (byteps_tpu_torch/mxnet) against the JAX
package's (byteps_tpu/mxnet), case by case as tests/test_mxnet_adapter.py
drives it: the same seeded numpy inputs through both, on duck-typed
NDArrays (there is no mxnet here).

Tolerances: at one process the port's push_pull is the identity, so its
results are held bit for bit to numpy's arithmetic (the SGD step, the
adapters' own numpy); the JAX adapter's reduction on the 8-device CPU
mesh sums eight replicas and divides them back out, so the two packages
are held to each other at the JAX tests' rtol of 1e-6.  The onebit case
runs the codec on both sides (an L1 scale summed in another order):
rtol 1e-5, atol 1e-6, as the JAX test holds it to its reference.

At two gloo ranks (tests/torch_frontend_worker.py) each rank's result
is the exact numpy mean of the ranks' rows (multiples of 1/64).
"""

import dataclasses

import numpy as np
import pytest

import byteps_tpu.mxnet as jax_mx
import byteps_tpu_torch.mxnet as port_mx
from byteps_tpu.mxnet.ops import compression_kwargs as jax_kwargs
from byteps_tpu_torch.mxnet.ops import compression_kwargs as port_kwargs

from . import torch_frontend_worker as FW
from .test_mxnet_adapter import FakeNDArray

PKGS = {"jax": jax_mx, "port": port_mx}


@pytest.fixture
def both():
    jax_mx.init()
    port_mx.init(device="cpu")
    yield
    port_mx.shutdown()
    jax_mx.shutdown()


def _each(fn):
    """``fn(mx)`` for each package: {"jax": ..., "port": ...}."""
    return {k: fn(m) for k, m in PKGS.items()}


@pytest.mark.parametrize("shape", [(17,), (5, 3), (2, 3, 4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_push_pull_inplace_sum(both, shape, dtype):
    x = np.random.RandomState(0).randn(*shape).astype(dtype)

    def run(mx):
        t = FakeNDArray(x.copy())
        mx.byteps_push_pull(t, name=f"mx/{shape}/{np.dtype(dtype)}",
                            is_average=False)
        return t.asnumpy()

    got = _each(run)
    assert got["port"].dtype == dtype and got["port"].shape == shape
    np.testing.assert_array_equal(got["port"], x)
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-6)


def test_push_pull_requires_name(both):
    for mx in PKGS.values():
        with pytest.raises(ValueError):
            mx.byteps_push_pull(FakeNDArray(np.ones(4, np.float32)))


def test_distributed_optimizer_runs_push_pull_then_update(both):
    g0 = np.random.RandomState(1).randn(4).astype(np.float32)

    def run(mx):
        calls = []

        class SGD:
            def update(self, index, weight, grad, state):
                calls.append(("update", list(index)))
                for w, g in zip(weight, grad):
                    w[:] = w.asnumpy() - 0.1 * g.asnumpy()

            def set_learning_rate(self, lr):
                calls.append(("lr", lr))

        opt = mx.DistributedOptimizer(SGD())
        w = [FakeNDArray(np.ones(4, np.float32))]
        g = [FakeNDArray(g0.copy())]
        opt.update([0], w, g, [None])
        opt.set_learning_rate(0.5)
        return calls, w[0].asnumpy()

    got = _each(run)
    assert got["port"][0] == got["jax"][0] == [("update", [0]),
                                               ("lr", 0.5)]
    np.testing.assert_array_equal(got["port"][1],
                                  np.ones(4, np.float32) - 0.1 * g0)
    np.testing.assert_allclose(got["port"][1], got["jax"][1], rtol=1e-6)


def test_broadcast_parameters_sorted_order(both):
    a0 = np.random.RandomState(2).randn(3).astype(np.float32)

    def run(mx):
        params = {"b": FakeNDArray(np.full(3, 2.0, np.float32)),
                  "a": FakeNDArray(a0.copy())}
        start = mx.parameter_index
        mx.broadcast_parameters(params)
        with pytest.raises(ValueError):
            mx.broadcast_parameters([FakeNDArray(np.ones(2))])
        return (mx.parameter_index - start, params["a"].asnumpy(),
                params["b"].asnumpy())

    got = _each(run)
    assert got["port"][0] == got["jax"][0] == 2
    np.testing.assert_array_equal(got["port"][1], a0)
    np.testing.assert_array_equal(got["port"][2], np.full(3, 2.0))
    for i in (1, 2):
        np.testing.assert_allclose(got["port"][i], got["jax"][i], rtol=1e-6)


def test_compression_params_attr_plumbing(both):
    def run(mx):
        class P:
            grad_req = "write"

        params = {"w0": P()}
        opt_params = {"momentum": 0.9, "wd": 1e-4}
        intra = mx._register_compression_attrs(
            params, opt_params,
            {"compressor": "onebit", "ef": "vanilla", "momentum": "nesterov",
             "scaling": True})
        attrs = {k: v for k, v in params["w0"].__dict__.items()
                 if k.startswith("byteps_")}
        mx.byteps_declare_tensor("gradient_attr",
                                 **{k: str(v) for k, v in attrs.items()})
        kwargs = (port_kwargs if mx is port_mx else jax_kwargs)(
            "gradient_attr")
        return (attrs, sorted(opt_params), type(intra).__name__,
                type(intra.compressor).__name__, kwargs)

    got = _each(run)
    assert got["port"] == got["jax"]
    attrs, left, outer, inner, kw = got["port"]
    assert attrs["byteps_compressor_type"] == "onebit"
    assert left == [] and (outer, inner) == ("NagAdapter",
                                             "WeightDecayMomentumAdapter")
    assert kw == {"compressor": "onebit", "ef": "vanilla",
                  "momentum": "nesterov", "mu": "0.9", "scaling": "True"}


def test_push_pull_with_onebit_kwargs_roundtrip(both):
    """Declared compressor kwargs engage the engine's compression: at one
    worker, onebit's bidirectional chain (pack, merge, re-pack, unpack)
    of the input."""
    x = np.random.RandomState(3).randn(512).astype(np.float32)

    def run(mx):
        t = FakeNDArray(x.copy())
        mx.byteps_declare_tensor("gradient_ob",
                                 byteps_compressor_type="onebit")
        mx.byteps_push_pull(t, name="gradient_ob", is_average=False)
        return t.asnumpy()

    got = _each(run)
    from tests import compression_refs as refs
    w, s = refs.onebit_compress(x)
    w2, s2 = refs.onebit_compress(refs.onebit_decompress(w, s, 512))
    want = refs.onebit_decompress(w2, s2, 512)
    for k in PKGS:
        np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-5,
                               atol=1e-6)


def test_async_mode_preserves_base_weights(both):
    """Async-PS: local update -> push delta -> pull merged; the pulled
    weight is base + sum(deltas), not the bare delta sum."""
    from byteps_tpu.common.config import get_config as jget
    from byteps_tpu.common.config import set_config as jset
    from byteps_tpu_torch.common.config import get_config as pget
    from byteps_tpu_torch.common.config import set_config as pset

    def run(mx):
        get, put = (pget, pset) if mx is port_mx else (jget, jset)
        old = get()
        put(dataclasses.replace(old, enable_async=True))
        try:
            class SGD:
                def update(self, index, weight, grad, state):
                    for w, g in zip(weight, grad):
                        w[:] = w.asnumpy() - 0.1 * g.asnumpy()

            opt = mx.DistributedOptimizer(SGD())
            w = [FakeNDArray(np.array([1.0, 2.0], np.float32))]
            g = [FakeNDArray(np.array([1.0, 1.0], np.float32))]
            out = []
            for _ in range(2):
                opt.update([0], w, g, [None])
                out.append(w[0].asnumpy().copy())
            return out
        finally:
            put(old)

    got = _each(run)
    for j, p, want in zip(got["jax"], got["port"], ([0.9, 1.9],
                                                     [0.8, 1.8])):
        np.testing.assert_allclose(p, want, rtol=1e-6)
        np.testing.assert_array_equal(p, j)


def test_wdmom_applies_wd_to_small_tensors():
    """Weight decay reaches every tensor; only the extra momentum is gated
    on the threshold: the two packages' numpy arithmetic, bit for bit."""
    x0 = np.random.RandomState(4).randn(4).astype(np.float32)

    def run(mx):
        wd, mu = 0.1, 0.9
        out = []
        for thr in (10**9, 0):
            comp = mx.Compression.wdmom(mx.Compression.none, mu, wd,
                                        threshold=thr)
            g = FakeNDArray(np.zeros(4, np.float32))
            out.append(comp.decompress(g, None, x=FakeNDArray(x0)).asnumpy())
        with pytest.raises(ValueError):
            comp.decompress(g, None)
        nag = mx.Compression.nag(mx.Compression.none, mu, 10**9)
        t = FakeNDArray(x0.copy())
        for _ in range(2):
            nag.compress(t)
        out.append(t.asnumpy())
        return out

    got = _each(run)
    np.testing.assert_allclose(got["port"][0], 0.1 * x0, rtol=1e-6)
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, b)


def test_fp16_intra_compressor():
    x = np.random.RandomState(5).randn(32).astype(np.float32)

    def run(mx):
        t = FakeNDArray(x.copy())
        out, ctx = mx.Compression.fp16.compress(t)
        assert mx.Compression.fp16.decompress(out, ctx) is out
        return out.asnumpy(), ctx

    got = _each(run)
    np.testing.assert_allclose(got["port"][0], x, rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1] == np.float32


def test_distributed_trainer_needs_mxnet():
    for mx in PKGS.values():
        with pytest.raises(ImportError, match="requires mxnet"):
            mx.DistributedTrainer([], "sgd")


def test_two_ranks_give_the_exact_mean(tmp_path):
    """byteps_push_pull (average and sum), DistributedOptimizer and
    broadcast_parameters at two gloo ranks."""
    ranks = FW.spawn("mxnet", 2, str(tmp_path))
    for r, res in enumerate(ranks):
        for k, want in FW.mxnet_want(2, r).items():
            np.testing.assert_array_equal(res[k], want, err_msg=k)
