"""The port's host-side core against the JAX package, and its engine and
torch adapter at a world of one on the CPU (gloo).

Config parsing, chunk bounds, registry keys (``declared << 16 | part``)
and the priority/credit scheduler's pop order must equal the JAX
package's for the same inputs.  A world of one reduces to the identity,
so the engine's outputs are checked exactly against its inputs (and, for
compressed tensors, against the codec chain run directly).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import byteps_tpu_torch as port
from byteps_tpu.common import config as jax_config
from byteps_tpu.common import partitioner as jax_partitioner
from byteps_tpu.common import registry as jax_registry
from byteps_tpu.common import scheduler as jax_scheduler
from byteps_tpu.common import types as jax_types
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import partitioner as port_partitioner
from byteps_tpu_torch.common import registry as port_registry
from byteps_tpu_torch.common import scheduler as port_scheduler
from byteps_tpu_torch.common import types as port_types
from byteps_tpu_torch.common.handles import Handle
from byteps_tpu_torch.compression import registry as codecs
from byteps_tpu_torch.core import api

ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
CONFIG_FIELDS = ("num_hosts", "host_id", "local_rank", "local_size",
                 "coordinator_address", "partition_bytes",
                 "scheduling_credit", "enable_priority", "group_size",
                 "min_compress_bytes")


@pytest.mark.parametrize("env", [
    {},
    {"BYTEPS_PARTITION_BYTES": "5000", "BYTEPS_SCHEDULING_CREDIT": "9000",
     "BYTEPS_MIN_COMPRESS_BYTES": "17", "BYTEPS_NCCL_GROUP_SIZE": "2",
     "BYTEPS_ENABLE_PRIORITY": "0"},
    {"DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": "1",
     "BYTEPS_LOCAL_SIZE": "4", "BYTEPS_LOCAL_RANK": "3",
     "DMLC_PS_ROOT_URI": "10.0.0.1", "DMLC_PS_ROOT_PORT": "1234",
     "BYTEPS_GROUP_SIZE": "8", "BYTEPS_PARTITION_BYTES": "4096"},
], ids=["defaults", "knobs", "topology"])
def test_config_from_env_matches_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "BYTEPS_MIN_COMPRESS_BYTES" not in env:
        monkeypatch.delenv("BYTEPS_MIN_COMPRESS_BYTES", raising=False)
    j, p = jax_config.Config.from_env(), port_config.Config.from_env()
    for f in CONFIG_FIELDS:
        assert getattr(p, f) == getattr(j, f), f
    assert p.world_size == p.num_hosts * p.local_size
    assert p.rank == p.host_id * p.local_size + p.local_rank


@pytest.mark.parametrize("numel,itemsize,pb", [
    (0, 4, 4096), (1, 4, 4096), (1024, 4, 4096), (1025, 4, 4096),
    (25_000, 2, 4096), (2_048_000, 4, 4_096_000), (3_000_001, 4, 4_096_000),
    (1000, 4, 100), (7, 8, 8)])
def test_chunk_bounds_match_jax(numel, itemsize, pb):
    assert (port_partitioner.chunk_bounds(numel, itemsize, pb)
            == jax_partitioner.chunk_bounds(numel, itemsize, pb))


def test_registry_keys_match_jax():
    shapes = [("w0", (300, 20)), ("b0", (20,)), ("w1", (5000, 3)),
              ("s", ())]
    jreg, preg = jax_registry.TensorRegistry(), port_registry.TensorRegistry()
    for name, shape in shapes:
        j = jreg.init_tensor(name, shape, np.float32, partition_bytes=4096)
        p = preg.init_tensor(name, shape, torch.float32, partition_bytes=4096)
        assert (p.declared_key, p.key_list, p.chunk_bounds, p.nbytes) == \
            (j.declared_key, j.key_list, j.chunk_bounds, j.nbytes)
        assert all(port_types.split_key(k) == (p.declared_key, i)
                   for i, k in enumerate(p.key_list))
    assert preg.names_in_declaration_order() == jreg.names_in_declaration_order()
    with pytest.raises(ValueError, match="re-initialized"):
        preg.init_tensor("w0", (300, 21), torch.float32, partition_bytes=4096)


def _task(mod, name, key, prio, nbytes):
    extra = ({"version": 0, "total_parts": 1} if mod is jax_types else {})
    return mod.ChunkTask(name=name, key=key, priority=prio, offset_elems=0,
                         num_elems=nbytes // 4, nbytes=nbytes, **extra)


@pytest.mark.parametrize("credit", [0, 1000, 2500])
def test_scheduler_pop_order_matches_jax(credit):
    """A scripted add / pop / finish trace pops the same tasks in the same
    order on both schedulers, under the same credit window."""
    rng = np.random.RandomState(credit)
    specs = [(f"t{i}", int(rng.randint(0, 1 << 20)), int(rng.randint(-3, 3)),
              int(rng.choice([400, 1000, 3000]))) for i in range(40)]
    scheds = [(jax_types, jax_scheduler.ChunkScheduler(credit)),
              (port_types, port_scheduler.ChunkScheduler(credit))]
    trace = []
    for mod, s in scheds:
        popped, it = [], iter(specs)
        for step in range(120):
            if step % 3 != 2:
                spec = next(it, None)
                if spec is not None:
                    s.add_task(_task(mod, *spec))
            t = s.get_task()
            if t is not None:
                popped.append(t.name)
            if step % 4 == 3 and s.bytes_in_flight:
                s.report_finish(1000)
        popped += [t.name for t in s.drain()]
        trace.append(popped)
    assert trace[0] == trace[1]
    assert sorted(trace[1]) == sorted(n for n, *_ in specs)


def test_handle_wait_errors_and_callbacks():
    h = Handle(0, "x")
    with pytest.raises(TimeoutError):
        h.wait(timeout=0.01)
    seen = []
    h.add_done_callback(lambda hh: seen.append(hh.id))
    h.set_result(None, port_types.Status.error("boom"))
    assert seen == [0] and h.poll()
    with pytest.raises(RuntimeError, match="boom"):
        h.wait()
    h.add_done_callback(lambda hh: seen.append("late"))
    assert seen == [0, "late"]


@pytest.fixture
def engine1():
    port.init(port_config.Config(partition_bytes=4096, min_compress_bytes=0),
              device="cpu")
    yield api.engine()
    port.shutdown()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int32])
@pytest.mark.parametrize("shape", [(7,), (40, 90)], ids=["1chunk", "chunks"])
@pytest.mark.parametrize("op", ["average", "sum"])
def test_engine_world_of_one_is_identity(engine1, dtype, shape, op):
    x = (torch.arange(int(np.prod(shape))) % 97 - 40).reshape(shape).to(dtype)
    out = api.push_pull(x, f"t/{dtype}/{shape}", op=op)
    assert out.dtype == dtype and out.shape == x.shape
    assert torch.equal(out, x)
    assert engine1.registry.get(f"t/{dtype}/{shape}").chunk_bounds == \
        port_partitioner.chunk_bounds(x.numel(), x.element_size(), 4096)


def test_engine_compressed_chunks_run_the_codec_chain(engine1):
    x = torch.from_numpy(np.random.RandomState(0).randn(5000)
                         .astype(np.float32))
    for step in range(2):
        out = api.push_pull(x, "g", compression=ONEBIT_EF)
    ctx = engine1.registry.get("g")
    assert len(ctx.compressor) == len(ctx.chunk_bounds) == 5
    ref = []
    for off, ln in ctx.chunk_bounds:
        wc, sc = codecs.create(ONEBIT_EF, ln), codecs.create(
            ONEBIT_EF, ln, for_server=True)
        ws, ss = wc.init_state("cpu"), sc.init_state("cpu")
        for _ in range(2):
            p, _ = wc.compress(x[off:off + ln], ws)
            y = wc.decompress_sum({k: v[None] for k, v in p.items()})
            p2, _ = sc.compress(y, ss)
            last = sc.decompress(p2)
        ref.append(last)
    assert torch.equal(out, torch.cat(ref))


def test_engine_min_compress_bytes_cutoff():
    port.init(port_config.Config(min_compress_bytes=65536), device="cpu")
    try:
        small = torch.randn(1000)
        out = api.push_pull(small, "small", compression=ONEBIT_EF)
        ctx = api.engine().registry.get("small")
        assert ctx.compressor is None and not ctx.compression_kwargs
        assert torch.equal(out, small)
        big = torch.randn(20000)
        api.push_pull(big, "big", compression=ONEBIT_EF)
        assert api.engine().registry.get("big").compressor
    finally:
        port.shutdown()


def test_engine_rejects_bad_calls(engine1):
    with pytest.raises(ValueError, match="op must be"):
        api.push_pull(torch.ones(3), "a", op="max")
    with pytest.raises(ValueError, match="unknown compressor"):
        api.push_pull(torch.ones(3), "b", compression={"compressor": "x"})
    api.push_pull(torch.ones(3), "c")
    with pytest.raises(ValueError, match="re-initialized"):
        api.push_pull(torch.ones(4), "c")


def test_async_handles_and_shutdown():
    api.declare("first")
    api.declare("second")
    port.init(device="cpu")
    eng = api.engine()
    assert eng.registry.get("first").declared_key == 0
    assert eng.registry.get("second").declared_key == 1
    xs = [torch.full((3000,), float(i)) for i in range(8)]
    hs = [port.push_pull_async(x, name=f"x{i}") for i, x in enumerate(xs)]
    outs = [port.synchronize(h) for h in hs]
    assert all(torch.equal(o, x) for o, x in zip(outs, xs))
    assert all(port.poll(h) for h in hs)
    threads = (eng._dispatcher, eng._syncer)
    port.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        api.push_pull(torch.ones(2), "late")


def test_push_pull_is_differentiable(engine1):
    x = torch.randn(6, 4, requires_grad=True)
    w = torch.randn(6, 4)
    y = port.push_pull(x, average=True, name="diff")
    (y * w).sum().backward()
    assert torch.equal(x.grad, w)


def test_broadcast_parameters_world_of_one(engine1):
    model = torch.nn.Linear(4, 3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    port.broadcast_parameters(model.state_dict(), root_rank=0)
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    opt = torch.optim.Adam(model.parameters())
    model(torch.randn(2, 4)).sum().backward()
    opt.step()
    state = opt.state_dict()["state"]
    snap = {pid: {k: v.clone() for k, v in s.items()}
            for pid, s in state.items()}
    port.broadcast_optimizer_state(opt, root_rank=0)
    for pid, s in opt.state_dict()["state"].items():
        assert all(torch.equal(v, snap[pid][k]) for k, v in s.items())


@pytest.mark.parametrize("bpps", [1, 2])
def test_distributed_optimizer_matches_plain_sgd(engine1, bpps):
    torch.manual_seed(bpps)
    m, ref = torch.nn.Linear(5, 3), torch.nn.Linear(5, 3)
    ref.load_state_dict(m.state_dict())
    opt = port.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.05, momentum=0.9),
        named_parameters=m.named_parameters(),
        backward_passes_per_step=bpps)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.05, momentum=0.9)
    x, y = torch.randn(8 * bpps, 5), torch.randn(8 * bpps, 3)
    for _ in range(3):
        opt.zero_grad()
        for b in range(bpps):
            sl = slice(8 * b, 8 * (b + 1))
            torch.nn.functional.mse_loss(m(x[sl]), y[sl]).backward()
        opt.step()
        ref_opt.zero_grad()
        torch.nn.functional.mse_loss(ref(x), y).backward()
        ref_opt.step()
    for p, q in zip(m.parameters(), ref.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)


def test_hooks_enqueue_while_backward_runs(engine1):
    """Every parameter's gradient is enqueued by its hook during backward,
    before step() is called."""
    m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                            torch.nn.Linear(8, 2))
    opt = port.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                    named_parameters=m.named_parameters())
    m(torch.randn(3, 4)).sum().backward()
    assert len(opt._handles) == 4
    opt.step()
    assert not opt._handles


def test_concurrent_pushers_stress(engine1):
    """More pushing threads than cores, with a short switch interval: every
    handle resolves to its own tensor (a lost or crossed chunk, or a
    miscounted credit, would break it)."""
    import sys
    import threading

    errors, n_threads, n_pushes = [], 16, 12
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def pusher(t):
        try:
            for i in range(n_pushes):
                x = torch.full((1500 + 7 * t,), float(t * 100 + i))
                kw = ONEBIT_EF if i % 3 == 0 else None
                out = api.push_pull(x, f"s{t}.{i % 4}", compression=kw)
                if not torch.equal(out, x):
                    errors.append((t, i))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((t, repr(e)))

    try:
        threads = [threading.Thread(target=pusher, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:5]
    assert engine1.scheduler.bytes_in_flight == 0
    assert not engine1.handles.outstanding()
