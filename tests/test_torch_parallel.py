"""The port's DistributedDataParallel, CrossBarrier and
HalfPrecisionDistributedOptimizer against the JAX package's torch
adapter, on the CPU.

One seeded model and batch train a few steps through each wrapper of the
port (``init(device="cpu")``, a world of one over gloo) and through its
twin in ``byteps_tpu.torch`` on a mesh of one CPU device (a world of one
too: on the 8-device mesh an average of 8 equal rows rounds, since 3x is
not always exact).  Uncompressed, the parameters end equal bit for bit;
with onebit + error feedback to rtol 1e-5, the tolerance of
``tests/test_torch_slice.py`` (the onebit scale is an L1 sum taken in
another order).  The fp16 model of the half-precision optimizer with
onebit + error feedback: a scale one f32 step apart can round the fp16
gradient either way, and momentum carries that step on, so its fp16
parameters agree to one fp16 step (rtol 2**-10) above a floor of 2**-13
(seen: 4 of 1,252 elements, 2**-14 apart).  Under tests/conftest.py's BYTEPS_MIN_COMPRESS_BYTES=0
both compress every tensor.  A dropped wrapper frees its model.
"""

import copy
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

import byteps_tpu.torch as jax_torch
import byteps_tpu_torch as port
from byteps_tpu.torch import parallel as jax_parallel
from byteps_tpu_torch.core import api as port_api

ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
CODECS = {"none": None, "onebit_ef": ONEBIT_EF}
STEPS = 3


def _model(seed=5, half=False):
    torch.manual_seed(seed)
    m = torch.nn.Sequential(torch.nn.Linear(12, 32), torch.nn.ReLU(),
                            torch.nn.Linear(32, 32), torch.nn.ReLU(),
                            torch.nn.Linear(32, 4))
    return m.half() if half else m


def _batches(n, half=False):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        x = torch.from_numpy(rng.randn(8, 12).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 4, size=8))
        out.append((x.half() if half else x, y))
    return out


def _loss(model, x, y):
    return torch.nn.functional.cross_entropy(model(x).float(), y)


def _ddp_train(ddp_cls, model, compression):
    ddp = ddp_cls(model, compression=compression)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    batches = _batches(STEPS + 1)
    for i in range(STEPS):
        opt.zero_grad()
        if i == 1:      # an accumulation step without communication
            with ddp.no_sync():
                _loss(ddp, *batches[-1]).backward()
        _loss(ddp, *batches[i]).backward()
        opt.step()
    return ddp


def _xb_train(xb_cls, model, compression):
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    xb = xb_cls(model, opt, compression=compression)
    for x, y in _batches(STEPS):
        _loss(model, x, y).backward()
        xb.step()
    xb.synchronize()
    return xb


def _half_train(half_cls, model, compression):
    fp16 = [p for p in model.parameters() if p.requires_grad]
    fp32 = [p.detach().float().requires_grad_() for p in fp16]
    opt = half_cls(torch.optim.SGD(fp32, lr=0.1, momentum=0.9),
                   fp16_params=fp16, fp32_params=fp32, loss_scale=1024.0,
                   named_parameters=model.named_parameters(),
                   compression=compression)
    for x, y in _batches(STEPS, half=True):
        opt.zero_grad()
        opt.scale_loss(_loss(model, x, y)).backward()
        opt.step()
    return opt


WRAPPERS = {
    "ddp": (_ddp_train, lambda a: a.DistributedDataParallel, False),
    "cross_barrier": (_xb_train, lambda a: a.CrossBarrier, False),
    "half": (_half_train, lambda a: a.HalfPrecisionDistributedOptimizer,
             True),
}
JAX_ADAPTER = {"ddp": jax_parallel.DistributedDataParallel,
               "cross_barrier": jax_parallel.CrossBarrier,
               "half": jax_torch.HalfPrecisionDistributedOptimizer}


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_wrapper_matches_jax_adapter(wrapper, codec):
    train, cls_of, half = WRAPPERS[wrapper]
    model = _model(half=half)
    twin = copy.deepcopy(model)
    port.init(device="cpu")
    try:
        w = train(cls_of(port), model, CODECS[codec])
        keys = [n for n in port_api.engine().registry
                .names_in_declaration_order()]
        compressed = [n for n in keys if port_api.engine().registry.get(n)
                      .compressor]
        del w
    finally:
        port.shutdown()
    jax_torch.init(devices=jax.devices()[:1])
    try:
        assert jax_torch.size() == 1
        train(JAX_ADAPTER[wrapper], twin, CODECS[codec])
    finally:
        jax_torch.shutdown()
    n_params = len(list(model.parameters()))
    assert len(compressed) == (n_params if codec != "none" else 0)
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        if codec == "none":
            np.testing.assert_array_equal(p.detach().numpy(),
                                          q.detach().numpy(), err_msg=name)
        else:
            rtol, atol = (2**-10, 2**-13) if half else (1e-5, 1e-7)
            np.testing.assert_allclose(p.detach().float().numpy(),
                                       q.detach().float().numpy(),
                                       rtol=rtol, atol=atol, err_msg=name)


def test_ddp_no_sync_accumulates_then_averages():
    """Inside no_sync nothing is pushed; the next backward pushes the
    accumulated gradients and writes the average back before backward
    returns."""
    model = _model()
    port.init(device="cpu")
    try:
        ddp = port.DistributedDataParallel(model)
        (a, ya), (b, yb) = _batches(2)
        with ddp.no_sync():
            _loss(ddp, a, ya).backward()
        assert not ddp._handles
        acc = [p.grad.clone() for p in model.parameters()]
        _loss(ddp, b, yb).backward()
        assert not ddp._handles and not ddp._callback_queued
        ref = _model()
        _loss(ref, a, ya).backward()
        _loss(ref, b, yb).backward()
        for p, q, g in zip(model.parameters(), ref.parameters(), acc):
            assert torch.equal(p.grad, q.grad)
            assert not torch.equal(p.grad, g)
    finally:
        port.shutdown()


def test_cross_barrier_steps_each_module_at_its_forward():
    """step() returns at once; the next forward's pre-hook of each module
    applies only that module's update."""
    model = _model()
    port.init(device="cpu")
    try:
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        xb = port.CrossBarrier(model, opt)
        (x, y), = _batches(1)
        before = [p.detach().clone() for p in model.parameters()]
        _loss(model, x, y).backward()
        xb.step()
        assert len(xb._pending) == len(before)
        assert all(torch.equal(p, b) for p, b in zip(model.parameters(),
                                                      before))
        model[0](x)         # the first layer's gate only
        moved = [not torch.equal(p, b) for p, b in zip(model.parameters(),
                                                        before)]
        assert moved == [True, True, False, False, False, False]
        xb.synchronize()
        assert not xb._pending
        assert all(not torch.equal(p, b) for p, b in zip(model.parameters(),
                                                          before))
    finally:
        port.shutdown()


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_dropped_wrapper_frees_its_model(wrapper):
    """A wrapper that is dropped, with its model, frees them: its hooks
    (a parameter's live in C++, out of reach of the cycle collector) hold
    it weakly."""
    train, cls_of, half = WRAPPERS[wrapper]
    port.init(device="cpu")
    try:
        model = _model(half=half)
        w = train(cls_of(port), model, ONEBIT_EF)
        refs = [weakref.ref(model[0].weight), weakref.ref(w)]
        del model, w
        gc.collect()
        assert all(r() is None for r in refs)
    finally:
        port.shutdown()


@pytest.mark.parametrize("name", ["none", "fp16"])
def test_compression_shim_matches_jax(name):
    x = torch.randn(17, dtype=torch.float32)
    ours = getattr(port.Compression, name)
    theirs = getattr(jax_torch.Compression, name)
    (a, ca), (b, cb) = ours.compress(x), theirs.compress(x)
    assert a.dtype == b.dtype and torch.equal(a, b) and ca == cb
    back = ours.decompress(a, ca)
    assert back.dtype == torch.float32
    assert torch.equal(back, theirs.decompress(b, cb))
    i = torch.arange(5)
    assert ours.compress(i)[0] is i and ours.compress(i)[1] is None
