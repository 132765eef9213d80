"""The port's sharded weight update against its own replicated path and
the JAX package's ``push_pull_update``.

Multi-rank cases run the ranks of tests/torch_sharded_worker.py over
gloo, three layouts at once: one node of two ranks, two nodes of two,
one node of four (which ends with an elastic shrink to two ranks).
Rank r's gradients are row r of seeded arrays of multiples of 1/64, so
every sum is exact in any order and every average is rebuilt here.

Tolerances:
- within the port, sharded against replicated: bit for bit, in f32,
  for SGD, SGD with momentum, Adam and AdamW, on the scatter
  accumulator and on the parts fallback, at 2 and 4 ranks (the sums are
  exact, and ``torch.optim`` on a contiguous shard equals the optimizer
  on the whole vector element for element);
- against the JAX package: ``JAX_ATOL`` (4e-6) after 5 steps, for
  parameters of magnitude up to ~4.  ``param.add_(g, alpha=-lr)`` is one
  fused multiply-add in torch, where optax rounds ``-lr*g`` and ``p + u``
  apart, and torch's Adam divides by ``sqrt(v)/sqrt(bc2) + eps`` where
  optax divides ``m_hat`` by ``sqrt(v_hat) + eps``: an ulp or a few per
  step (measured on 100,000 elements, 5 steps: 2.4e-7 for SGD, 9.5e-7
  for Adam).  A learning rate 1 % off moves the parameters by ~5e-4 and
  must break it (the control);
- the fused mode against the exact one: 1e-6 (the reference's own bound
  for its fused Adam).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.comm.collectives import scatter_layout as jax_scatter_layout
from byteps_tpu.comm.mesh import CommContext as JaxComm
from byteps_tpu.comm.mesh import _build_mesh
from byteps_tpu.comm.shard_math import padded_size as jax_padded_size
from byteps_tpu.common.config import Config as JaxConfig
from byteps_tpu.common.partitioner import chunk_bounds
from byteps_tpu.core.engine import PushPullEngine as JaxEngine
from byteps_tpu.core.sharded_update import ShardedUpdateSlot as JaxSlot

import byteps_tpu_torch as bps
from byteps_tpu_torch.comm.collectives import scatter_layout
from byteps_tpu_torch.comm.mesh import CommContext
from byteps_tpu_torch.comm.shard_math import padded_size
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.core import api
from byteps_tpu_torch.core.sharded_update import ShardedUpdateSlot

from . import torch_sharded_worker as W

LAYOUTS = ("node_of_2", "2x2", "1x4")
JAX_ATOL = 4e-6
OPTAX = {
    "sgd": lambda lr: optax.sgd(lr),
    "momentum": lambda lr: optax.sgd(lr, momentum=0.9),
    "adam": lambda lr: optax.adam(lr),
    "adamw": lambda lr: optax.adamw(lr, weight_decay=0.1),
}


def _world(layout):
    hosts, local = W.LAYOUTS[layout]
    return hosts * local


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every layout's ranks, layouts run at once: {layout: [npz by rank]}."""
    tmp = str(tmp_path_factory.mktemp("torch_sharded"))
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        futures = {name: pool.submit(W.spawn, name, "cpu", tmp)
                   for name in LAYOUTS}
        outs = {name: f.result() for name, f in futures.items()}
    return {name: [dict(np.load(o)) for o in files]
            for name, files in outs.items()}


# ---------------------------------------------------------------- geometry

def _port_comm(L):
    return CommContext(rank=0, size=L, local_rank=0, local_size=L,
                       num_nodes=1, device=torch.device("cpu"),
                       backend="gloo")


@pytest.mark.parametrize("n,R", [(1, 1), (1, 2), (3, 4), (7, 8), (128, 1),
                                 (129, 2), (1000, 3), (3001, 4),
                                 (65536, 8), (1 << 20, 8)])
def test_padded_size_and_slot_geometry_match_reference(n, R):
    assert padded_size(n, R) == jax_padded_size(n, R)
    port = ShardedUpdateSlot(_port_comm(R), Config(sharded_update=True),
                             "g", (n,), torch.float32,
                             (torch.optim.SGD, {"lr": 0.1}))
    jcomm = JaxComm(mesh=_build_mesh(jax.devices()[:R], 1), n_dcn=1,
                    n_ici=R)
    ref = JaxSlot(jcomm, JaxConfig(sharded_update=True), "g", (n,),
                  np.float32, optax.sgd(0.1))
    assert (port.C, port.n_pad) == (ref.C, ref.n_pad)
    assert port.master.numel() == ref.C


@pytest.mark.parametrize("n,part,itemsize,L", [
    (3001, 4096, 4, 2), (3001, 4096, 4, 4), (3001, 4096, 4, 3),
    (100, 4096, 4, 8), (1 << 16, 4096, 2, 8), (5000, 4096, 8, 4),
    (10, 4096, 4, 1)])
def test_scatter_layout_matches_reference(n, part, itemsize, L):
    bounds = chunk_bounds(n, itemsize, part)
    assert scatter_layout(bounds, L) == jax_scatter_layout(bounds, L)


@pytest.mark.parametrize("bounds,L", [
    ([(0, 3), (3, 3), (6, 1)], 2),        # odd chunk offsets: refused
    ([(0, 4), (4, 4), (8, 2)], 2),
    ([(0, 5)], 4),                        # one chunk: always expressible
    ([(0, 6), (6, 5)], 3)])
def test_scatter_layout_table(bounds, L):
    assert scatter_layout(bounds, L) == jax_scatter_layout(bounds, L)


# ------------------------------------------------------- within the port

@pytest.mark.parametrize("tensor", list(W.TENSORS))
@pytest.mark.parametrize("opt", list(W.OPTIMIZERS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_equals_unsharded_bit_for_bit(results, layout, opt, tensor):
    """The multi-chunk tensor rides the scatter accumulator, the small one
    the parts fallback; both equal the replicated update (push_pull +
    the optimizer on the whole tensor) and the optimizer on the exact
    averages, on every rank."""
    R = _world(layout)
    n = W.TENSORS[tensor]
    want = W.replay(opt, W.init_param(7, n),
                         W.exact_averages(opt, tensor, R, n, W.STEPS))
    for res in results[layout]:
        key = f"slot/{opt}/{tensor}"
        assert bool(res[f"{key}/buffered"]) == (tensor == "w")
        np.testing.assert_array_equal(res[f"{key}/sharded"],
                                      res[f"{key}/unsharded"])
        np.testing.assert_array_equal(res[f"{key}/sharded"], want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_wire_bytes_per_leg(results, layout):
    """The reference's split: the scatter accumulator ships push N and
    pull N/R; the parts fallback all-reduces, pull N."""
    R = _world(layout)
    for res in results[layout]:
        for opt in W.OPTIMIZERS:
            push, pull = res[f"slot/{opt}/w/wire"]
            assert push == W.TENSORS["w"] * 4 and pull * R == push
            push, pull = res[f"slot/{opt}/b/wire"]
            assert push == W.TENSORS["b"] * 4 and pull == push


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ownership(results, layout):
    """Each rank's master and every moment hold exactly C = ceil(n/L)
    elements (L = local_size), and the sharded adapter's inner optimizer
    holds no state."""
    L = W.LAYOUTS[layout][1]
    moments = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}
    for res in results[layout]:
        for opt, k in moments.items():
            for t, n in W.TENSORS.items():
                C = -(-n // L)
                assert res[f"slot/{opt}/{t}/lengths"].tolist() == \
                    [C] * (1 + k)
        for tag in ("adamw", "momentum"):
            assert int(res[f"adapter/{tag}/inner_state/True"]) == 0
            assert int(res[f"adapter/{tag}/inner_state/False"]) == 4


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bf16_parameter_against_f32_master(results, layout):
    """A bf16 tensor: the slot's f32 master steps the exact f32 average of
    the bf16 gradients; every emitted parameter is that master rounded
    to bf16, bit for bit."""
    R = _world(layout)
    n = W.TENSORS["w"]
    cls, hyper = W.OPTIMIZERS["adamw"]
    master = torch.from_numpy(W.init_param(7, n)).bfloat16().float()
    o = cls([master], **hyper)
    for s in range(W.STEPS):
        g = torch.from_numpy(W.rows(W.grad_seed("adamw", "w", s), R, n))
        master.grad = g.bfloat16().float().sum(0) * np.float32(1 / R)
        o.step()
        want = master.bfloat16().view(torch.int16).numpy()
        for res in results[layout]:
            np.testing.assert_array_equal(res[f"bf16/w/{s}"], want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_adapter_sharded_equals_unsharded(results, layout):
    """DistributedOptimizer(sharded_update=True) against the unsharded
    adapter on the MLP, AdamW under a StepLR schedule, and SGD with
    momentum under backward_passes_per_step=2: bit for bit (gloo sums two
    ranks, and four within a node, in one order for the all-reduce and
    the reduce-scatter here; a division by 2 is exact)."""
    for res in results[layout]:
        for tag in ("adamw", "momentum"):
            for k in W.mlp_params():
                np.testing.assert_array_equal(
                    res[f"adapter/{tag}/{k}/sharded"],
                    res[f"adapter/{tag}/{k}/unsharded"], err_msg=(tag, k))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_steps_and_collectives_on_the_dispatcher(results, layout):
    """Every slot step ran on the dispatcher; no collective came from the
    syncer (the main thread's are the exports, ZeRO and the tests')."""
    for res in results[layout]:
        assert res["threads/slot_step"].tolist() == ["bps-dispatch"]
        assert set(res["threads/collectives"].tolist()) <= {
            "bps-dispatch", "MainThread"}


def test_elastic_reshard_4_to_2(results):
    """Adam at 4 ranks for 2 steps, suspend (the stash: each slot's export
    at logical length), resume at 2 ranks, declare_update with no
    init_value (the stash alone seeds the slot, re-padded to C =
    ceil(n/2)), 3 more steps: the trajectory of the replicated optimizer
    with the same transition, bit for bit."""
    opt, n, before, after = W.ELASTIC
    grads = (W.exact_averages(opt, "e", 4, n, before)
             + W.exact_averages(opt, "e", 2, n, after, first=before))
    want = W.replay(opt, W.init_param(7, n), grads)
    ranks = results["1x4"]
    for res in ranks:
        assert bool(res["elastic/stash"])
    for res in ranks[:2]:
        assert int(res["elastic/world_after"]) == 2
        assert bool(res["elastic/stash_consumed"])
        np.testing.assert_array_equal(res["elastic/params"], want)
    for res in ranks[2:]:
        assert "elastic/params" not in res


@pytest.mark.parametrize("layout", ["node_of_2", "2x2"])
def test_suspend_resume_round_trip(results, layout):
    opt, n, before, after = W.ROUNDTRIP
    R = _world(layout)
    grads = W.exact_averages(opt, "e", R, n, before + after)
    want = W.replay(opt, W.init_param(7, n), grads)
    for res in results[layout]:
        assert bool(res["elastic/stash_consumed"])
        np.testing.assert_array_equal(res["elastic/params"], want)


# ---------------------------------------------------- against the JAX package

_JAX_COMM = {}


def _jax_trajectory(opt, tensor, lr_scale=1.0):
    """JAX's push_pull_update at R = 2 (a mesh of two CPU devices) with
    the matching optax transform, on the worker's rows."""
    R, n = 2, W.TENSORS[tensor]
    if R not in _JAX_COMM:
        _JAX_COMM[R] = JaxComm(mesh=_build_mesh(jax.devices()[:R], 1),
                               n_dcn=1, n_ici=R)
    eng = JaxEngine(_JAX_COMM[R], JaxConfig(sharded_update=True,
                                            partition_bytes=W.PARTITION_BYTES))
    try:
        lr = W.OPTIMIZERS[opt][1]["lr"] * lr_scale
        p0 = W.init_param(7, n)
        eng.declare_update("w", (n,), np.float32, tx=OPTAX[opt](lr),
                           init_value=p0)
        params = jnp.asarray(p0)
        for s in range(W.STEPS):
            g = W.rows(W.grad_seed(opt, tensor, s), R, n)
            upd = eng.push_pull_update(g, "w", stacked=True)
            params = optax.apply_updates(params, jnp.asarray(upd))
        return np.asarray(params)
    finally:
        eng.shutdown(wait=True)


@pytest.mark.parametrize("tensor", list(W.TENSORS))
@pytest.mark.parametrize("opt", list(W.OPTIMIZERS))
def test_matches_jax_push_pull_update(results, opt, tensor):
    got = results["node_of_2"][0][f"slot/{opt}/{tensor}/sharded"]
    want = _jax_trajectory(opt, tensor)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)
    # control: a learning rate 1 % off must break the tolerance
    wrong = _jax_trajectory(opt, tensor, lr_scale=1.01)
    assert np.abs(got - wrong).max() > 10 * JAX_ATOL


# -------------------------------------------------------- one rank, in process

@pytest.fixture
def engine1():
    def start(**kw):
        api.init(Config(sharded_update=True, **kw), device="cpu")
        return api.engine()
    yield start
    api.shutdown()
    api._suspended_update_state.clear()


def test_planner_repartition_keeps_the_trajectory(engine1):
    """At one rank the planner re-carves the tensor between pushes; the
    slot's geometry (C = n at L = 1) does not move and the trajectory is
    the optimizer's on the whole tensor, bit for bit."""
    eng = engine1(partition_bytes=4096, partition_pinned=False)
    n = 40000
    rng = np.random.RandomState(3)
    p0 = rng.randn(n).astype(np.float32)
    cls, hyper = W.OPTIMIZERS["adam"]
    api.declare_update("w", (n,), torch.float32, optimizer=(cls, hyper),
                       init_value=torch.from_numpy(p0))
    ref = torch.from_numpy(p0.copy())
    ref_opt = cls([ref], **hyper)
    seen = set()
    for _ in range(16):
        g = torch.from_numpy(rng.randn(n).astype(np.float32))
        seen.add(tuple(eng.registry.get("w").chunk_bounds))
        out = api.push_pull_update(g, "w")
        ref.grad = g.clone()
        ref_opt.step()
        assert torch.equal(out, ref)
    assert len(seen) > 1, "the planner never re-carved the tensor"
    assert eng.update_slots["w"].C == n


def test_fused_mode_within_bound_of_exact(engine1):
    eng = engine1()
    n = 5000
    rng = np.random.RandomState(4)
    p0 = torch.from_numpy(rng.randn(n).astype(np.float32))
    grads = [torch.from_numpy(rng.randn(n).astype(np.float32))
             for _ in range(3)]
    cls, hyper = W.OPTIMIZERS["adam"]
    api.declare_update("exact", (n,), torch.float32, optimizer=(cls, hyper),
                       init_value=p0)
    eng.cfg.sharded_update_fused = True
    api.declare_update("fused", (n,), torch.float32, optimizer=(cls, hyper),
                       init_value=p0)
    assert eng.update_slots["fused"].optimizer.param_groups[0]["fused"]
    for g in grads:
        a = api.push_pull_update(g, "exact")
        b = api.push_pull_update(g, "fused")
    torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


def test_export_restore_round_trip_in_process(engine1):
    """export() at logical length, restore into a slot of another local
    size: the same master, and each moment re-padded to the new C."""
    eng = engine1()
    n = 1001
    cls, hyper = W.OPTIMIZERS["adamw"]
    api.declare_update("w", (n,), torch.float32, optimizer=(cls, hyper),
                       init_value=torch.arange(n, dtype=torch.float32))
    out = api.push_pull_update(torch.ones(n), "w")
    assert torch.equal(eng.update_slots["w"].params(), out)
    snap = eng.export_update_slots()["w"]
    assert snap["master"].shape == (n,) and snap["applied"] == 1
    assert sorted(snap["sharded"]) == ["exp_avg", "exp_avg_sq"]
    slot = ShardedUpdateSlot(_port_comm(4), Config(sharded_update=True),
                             "w", (n,), torch.float32, (cls, hyper),
                             restore=snap)
    assert slot.C == 251 and slot.applied == 1
    st = slot.optimizer.state[slot.master]
    assert torch.equal(slot.master, snap["master"][:251])
    assert torch.equal(st["exp_avg"], snap["state"]["exp_avg"][:251])
    assert float(st["step"]) == 1.0


# ---------------------------------------------------------------- validation

def test_config_validation():
    with pytest.raises(ValueError, match="requires sharded_update"):
        Config(sharded_update_fused=True)
    Config(sharded_update=True, sharded_update_fused=True)


def test_config_from_env(monkeypatch):
    monkeypatch.setenv("BYTEPS_SHARDED_UPDATE", "1")
    monkeypatch.setenv("BYTEPS_SHARDED_UPDATE_FUSED", "1")
    cfg = Config.from_env()
    assert cfg.sharded_update and cfg.sharded_update_fused
    monkeypatch.setenv("BYTEPS_SHARDED_UPDATE", "0")
    with pytest.raises(ValueError, match="requires sharded_update"):
        Config.from_env()


def test_declare_update_validation():
    api.init(Config(), device="cpu")
    try:
        with pytest.raises(ValueError, match="sharded-update mode"):
            api.declare_update("w", (8,), torch.float32,
                               optimizer=(torch.optim.SGD, {"lr": 1}))
    finally:
        api.shutdown()
    api.init(Config(sharded_update=True), device="cpu")
    try:
        with pytest.raises(ValueError, match="float tensor"):
            api.declare_update("i", (8,), torch.int32,
                               optimizer=(torch.optim.SGD, {"lr": 1}))
        with pytest.raises(ValueError, match="no sharded-update slot"):
            api.push_pull_update(torch.zeros(8), "nope")
        api.declare_update("w", (8,), torch.float32,
                           optimizer=(torch.optim.SGD, {"lr": 1}))
        eng = api.engine()
        with pytest.raises(ValueError, match="compression"):
            eng.push_pull_update_async(torch.zeros(8), "w",
                                       compression={"compressor": "onebit"})
        with pytest.raises(ValueError, match="op='average'"):
            eng.push_pull_update_async(torch.zeros(8), "w", op="sum")
        eng.cfg.sharded_update_fused = True
        with pytest.raises(ValueError, match="fused kernels"):
            api.declare_update("r", (8,), torch.float32,
                               optimizer=(torch.optim.RMSprop, {}))
    finally:
        api.shutdown()


def test_adapter_validation():
    model = torch.nn.Linear(4, 2)
    with pytest.raises(RuntimeError, match="init"):
        bps.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=1),
                                 sharded_update=True)
    api.init(Config(sharded_update=True), device="cpu")
    try:
        with pytest.raises(ValueError, match="compression"):
            bps.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=1),
                compression={"compressor": "onebit"}, sharded_update=True)
        # None follows the running engine's Config.sharded_update
        opt = bps.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=1))
        assert opt._sharded and len(api.engine().update_slots) == 2
    finally:
        api.shutdown()


def test_pad_region_stays_zero():
    """The pad of the last block carries zero gradients: SGD (momentum,
    weight decay), Adam and AdamW keep its master and state at +0.0
    (element 1 below)."""
    for opt, (cls, hyper) in W.OPTIMIZERS.items():
        m = torch.tensor([1.0, 0.0])
        o = cls([m], **dict(hyper, weight_decay=0.1))
        for _ in range(3):
            m.grad = torch.tensor([0.5, 0.0])
            o.step()
        assert m[1].item() == 0.0 and not torch.signbit(m[1]), opt
        for v in o.state[m].values():
            if torch.is_tensor(v) and v.dim() == 1:
                assert v[1].item() == 0.0, opt


def test_adapter_redeclares_after_suspend_resume():
    """DistributedOptimizer(sharded_update=True) across suspend/resume at
    one rank: the next push declares the slots on the new engine from the
    stash (master and moments, not the parameter's value), so the
    trajectory is the unsharded adapter's, bit for bit."""
    def run(sharded):
        api.init(Config(sharded_update=True), device="cpu")
        model = W.TinyMLP(W.mlp_params())
        inner = torch.optim.AdamW(model.parameters(), **W.ZERO_ADAMW)
        opt = bps.DistributedOptimizer(
            inner, named_parameters=model.named_parameters(),
            sharded_update=sharded)
        try:
            for s in range(4):
                if s == 2:
                    api.suspend()
                    if sharded:
                        assert len(api._suspended_update_state) == 4
                    api.resume()
                x, y = W.mlp_batch(s, 1)
                opt.zero_grad()
                W.mse(model, (torch.from_numpy(x),
                              torch.from_numpy(y))).backward()
                opt.step()
            assert not api._suspended_update_state
        finally:
            api.shutdown()
        return {k: p.detach().clone() for k, p in model.named_parameters()}

    got, want = run(True), run(False)
    for k in want:
        assert torch.equal(got[k], want[k]), k
