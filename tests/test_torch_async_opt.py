"""Parity of the port's ``AsyncDistributedOptimizer`` with the JAX
package's (``byteps_tpu/jax/async_opt.py``), on the CPU.

Two workers share one store and step in turn for 5 steps each; the same
seeded gradients go to both packages (SGD, SGD with momentum, Adam).
Parameters agree to ``JAX_ATOL`` = 4e-6: torch's ``add_(alpha=-lr)`` is
one fused multiply-add where optax rounds ``-lr*g`` and ``p + u``
separately, and Adam's division rounds alike only to an ulp or a few
(ROADMAP Queue C item 10); a control with the port's lr 1.01x must
break that bound.  The store's versions are equal.  With onebit + error
feedback the stores' ``wire_bytes`` are equal.  With ``drop`` armed at
``kv_push`` in both, every lost ack is retried with its token and each
delta lands exactly once: the store equals the clean run's bit for bit.
Within the port, sharded async (the slot's f32 master) equals unsharded
async bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.jax.async_opt import AsyncDistributedOptimizer as JAsync
from byteps_tpu.server.kv_store import KVStore as JStore
from byteps_tpu.common.telemetry import counters as jcounters
from byteps_tpu.fault import injector as jinj
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.common.telemetry import counters as pcounters
from byteps_tpu_torch.fault import injector as pinj
from byteps_tpu_torch.server.kv_store import KVStore as PStore
from byteps_tpu_torch.torch.async_opt import AsyncDistributedOptimizer

from .torch_ps_common import configure, counter_values
from .torch_ps_common import fresh_ps_state  # noqa: F401 — autouse

JAX_ATOL = 4e-6
STEPS = 5
SHAPES = {"a": (8, 6), "b": (6,), "c": (3, 4, 2)}
OPTS = {
    "sgd": (lambda lr: optax.sgd(lr),
            lambda ps, lr: torch.optim.SGD(ps, lr=lr)),
    "momentum": (lambda lr: optax.sgd(lr, momentum=0.9),
                 lambda ps, lr: torch.optim.SGD(ps, lr=lr, momentum=0.9)),
    "adam": (lambda lr: optax.adam(lr),
             lambda ps, lr: torch.optim.Adam(ps, lr=lr)),
}
LR = {"sgd": 0.1, "momentum": 0.1, "adam": 0.01}
ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}


def _init():
    rng = np.random.RandomState(0)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(worker, step):
    rng = np.random.RandomState(100 * worker + step + 1)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def run_jax(opt, lr, compression=None, chaos=None):
    store = JStore()
    init = _init()
    workers = []
    for w in range(2):
        o = JAsync(OPTS[opt][0](lr), store=store, name_prefix="async",
                   compression=compression, worker_id=w)
        params = {k: jnp.asarray(v) for k, v in init.items()}
        workers.append([o, o.init(params), params])
    if chaos:
        jinj.arm(chaos, seed=4)
    for step in range(STEPS):
        for w, (o, state, params) in enumerate(workers):
            g = {k: jnp.asarray(v) for k, v in _grads(w, step).items()}
            workers[w][2], workers[w][1] = o.update_and_sync(g, state,
                                                             params)
    jinj.disarm()
    names = workers[0][0]._names
    return {"store": {n: np.asarray(store.pull(n)) for n in names},
            "versions": [store.version(n) for n in names],
            "params": [{k: np.asarray(v) for k, v in wk[2].items()}
                       for wk in workers],
            "wire": (store.wire_bytes, store.wire_bytes_wasted),
            "counters": counter_values(jcounters)}


def run_port(opt, lr, compression=None, chaos=None, sharded=False,
             weight_decay=0.0):
    store = PStore(device="cpu")
    init = _init()
    workers = []
    for w in range(2):
        params = [torch.nn.Parameter(torch.from_numpy(init[k].copy()))
                  for k in SHAPES]
        inner = OPTS[opt][1](params, lr)
        for g in inner.param_groups:
            g["weight_decay"] = weight_decay
        o = AsyncDistributedOptimizer(
            inner, named_parameters=zip(SHAPES, params), store=store,
            name_prefix="async", compression=compression, worker_id=w,
            sharded_update=sharded)
        workers.append((o, params))
    if chaos:
        pinj.arm(chaos, seed=4)
    for step in range(STEPS):
        for w, (o, params) in enumerate(workers):
            for p, g in zip(params, _grads(w, step).values()):
                p.grad = torch.from_numpy(g)
            o.step()
    pinj.disarm()
    keys = [f"async.{k}" for k in SHAPES]
    return {"store": {k: store.pull(k).numpy() for k in keys},
            "versions": [store.version(k) for k in keys],
            "params": [{k: p.detach().numpy().copy()
                        for k, p in zip(SHAPES, params)}
                       for _, params in workers],
            "wire": (store.wire_bytes, store.wire_bytes_wasted),
            "counters": counter_values(pcounters),
            "stages": workers[0][0].stage_ms}


def _max_err(port, jax):
    errs = [np.abs(port["params"][w][k] - jax["params"][w][k]).max()
            for w in range(2) for k in SHAPES]
    return float(max(errs))


@pytest.mark.parametrize("opt", list(OPTS))
def test_two_workers_match_jax(opt):
    want = run_jax(opt, LR[opt])
    got = run_port(opt, LR[opt])
    assert got["versions"] == want["versions"] == [2 * STEPS] * 3
    assert _max_err(got, want) <= JAX_ATOL
    # each worker's parameters are the store's value at its last pull:
    # worker 1 stepped last, so it holds the store's final value
    for k, v in got["store"].items():
        assert v.tobytes() == got["params"][1][k.split(".")[1]].tobytes()
    assert set(got["stages"]) == {"d2h", "push", "pull", "h2d"}
    control = run_port(opt, LR[opt] * 1.01)
    assert _max_err(control, want) > JAX_ATOL


def test_onebit_ef_wire_bytes_match_jax():
    want = run_jax("momentum", 0.1, compression=ONEBIT_EF)
    got = run_port("momentum", 0.1, compression=ONEBIT_EF)
    assert got["wire"] == want["wire"] and got["wire"][0] > 0
    assert got["versions"] == want["versions"]
    # the same leaves in the same order (a, b, c)
    for g, w in zip(got["store"].values(), want["store"].values()):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_ack_loss_lands_exactly_once():
    chaos = "drop:site=kv_push:p=0.4"
    clean = run_port("momentum", 0.1)
    got = run_port("momentum", 0.1, chaos=chaos)
    want = run_jax("momentum", 0.1, chaos=chaos)
    assert got["versions"] == clean["versions"] == want["versions"]
    for k, v in clean["store"].items():
        assert got["store"][k].tobytes() == v.tobytes()
    assert got["counters"] == want["counters"]
    assert got["counters"]["fault.drop"] > 0
    assert got["counters"]["integrity.dup_dropped"] > 0


@pytest.mark.parametrize("opt,wd", [("sgd", 0.0), ("momentum", 0.01),
                                    ("adam", 0.01)])
def test_sharded_equals_unsharded_bit_for_bit(opt, wd):
    plain = run_port(opt, LR[opt], weight_decay=wd)
    sharded = run_port(opt, LR[opt], sharded=True, weight_decay=wd)
    assert sharded["versions"] == plain["versions"]
    for w in range(2):
        for k in SHAPES:
            assert (sharded["params"][w][k].tobytes()
                    == plain["params"][w][k].tobytes()), (w, k)


def test_refusals():
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(ValueError, match="compression"):
        AsyncDistributedOptimizer(torch.optim.SGD(p, lr=0.1),
                                  compression=ONEBIT_EF,
                                  sharded_update=True)
    configure(local_size=2)
    with pytest.raises(ValueError, match="local_size=2"):
        AsyncDistributedOptimizer(torch.optim.SGD(p, lr=0.1),
                                  sharded_update=True)
    configure()
    h = [torch.nn.Parameter(torch.zeros(3, dtype=torch.bfloat16))]
    opt = AsyncDistributedOptimizer(torch.optim.SGD(h, lr=0.1))
    h[0].grad = torch.ones(3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        opt.step()
    assert isinstance(opt.store, PStore) and opt.store.device.type == "cpu"


def test_default_sender_ids_are_distinct():
    p = [torch.nn.Parameter(torch.zeros(2))]
    store = PStore(device="cpu")
    ids = {AsyncDistributedOptimizer(torch.optim.SGD(p, lr=0.1),
                                     store=store).worker_id
           for _ in range(3)}
    assert len(ids) == 3
    assert Config().host_id == 0
