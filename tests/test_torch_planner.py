"""The port's chunk/credit planner, throughput monitor and schedulers
against the JAX package's, on the same inputs.

``ChunkPlanner`` must make the same ``plan_partition``, ``locked`` and
``credit_bytes`` decisions as ``byteps_tpu.common.scheduler.ChunkPlanner``
over the same ``observe`` sequences (the cases of
``tests/test_aot_planner.py``, and seeded random ones); ``SpeedMonitor``
must give the same readings under one injected clock; the native and the
Python scheduler must pop in the JAX ``ChunkScheduler``'s order, and both
must honour interrupt, set-credit and wake as the JAX tests pin them.
A native scheduler that cannot be built raises.
"""

import threading
import time

import numpy as np
import pytest
import torch

from byteps_tpu.common import config as jax_config
from byteps_tpu.common import scheduler as jax_scheduler
from byteps_tpu.common import telemetry as jax_telemetry
from byteps_tpu.common import types as jax_types
from byteps_tpu_torch import native
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import scheduler as port_scheduler
from byteps_tpu_torch.common import telemetry as port_telemetry
from byteps_tpu_torch.common import types as port_types
from byteps_tpu_torch.core import api
from byteps_tpu_torch.core.engine import PushPullEngine

SCHEDULERS = {
    "python": port_scheduler.ChunkScheduler,
    "native": native.NativeChunkScheduler,
}


def _planners(num_procs=1, **kw):
    return (jax_scheduler.ChunkPlanner(jax_config.Config(**kw),
                                       num_procs=num_procs),
            port_scheduler.ChunkPlanner(port_config.Config(**kw),
                                        num_procs=num_procs))


def _decisions(p, sizes):
    return ([p.plan_partition(n) for n in sizes],
            [p.locked(n) for n in sizes], p.credit_bytes())


def _same_decisions(j, p, sizes):
    assert _decisions(p, sizes) == _decisions(j, sizes)
    js, ps = j.snapshot(), p.snapshot()
    for k in ("tuning_partition", "tuning_credit", "base_partition_bytes",
              "credit_bytes", "buckets"):
        assert ps[k] == js[k], k


@pytest.mark.parametrize("fast", [16384, 163840, 81920, 40960])
def test_planner_explores_then_locks_like_jax(fast):
    """tests/test_aot_planner.py::test_planner_explores_then_locks, with
    each candidate of the ladder as the fast one."""
    j, p = _planners(partition_bytes=16384, partition_pinned=False,
                     credit_pinned=False)
    nbytes = 160_000
    seen = []
    for _ in range(64):
        cand = p.plan_partition(nbytes)
        assert cand == j.plan_partition(nbytes)
        seen.append(cand)
        for pl in (j, p):
            pl.observe(nbytes, cand, 0.001 if cand == fast else 0.01)
        _same_decisions(j, p, [nbytes])
        if p.locked(nbytes):
            break
    assert p.locked(nbytes) and p.plan_partition(nbytes) == fast
    assert len(set(seen)) == 4
    assert p.credit_bytes() == 4 * fast


@pytest.mark.parametrize("case", ["small", "pinned", "multiprocess",
                                  "stale", "autotune_off"])
def test_planner_inert_cases_match_jax(case):
    """The small-tensor, pinned, multi-process and stale-sample cases of
    tests/test_aot_planner.py, and autotune off."""
    kw = {"partition_bytes": 16384, "partition_pinned": False,
          "credit_pinned": False}
    procs, sizes = 1, [1000, 160_000, 1_000_000]
    if case == "small":
        sizes = [1000, 16384]           # at or under the configured bound
    elif case == "pinned":
        kw.update(partition_bytes=8192, partition_pinned=True)
    elif case == "autotune_off":
        kw.update(autotune=False)
    elif case == "multiprocess":
        procs = 2
    j, p = _planners(procs, **kw)
    for step in range(12):
        for n in sizes:
            cand = p.plan_partition(n)
            if case == "stale":
                cand += 4096            # not a candidate of the ladder
            for pl in (j, p):
                pl.observe(n, cand, 0.001 * (1 + step % 3))
        _same_decisions(j, p, sizes)
    if case == "stale":
        assert not p.locked(160_000)
    else:           # nothing to explore: every size reads as locked
        assert all(p.locked(n) for n in sizes)
        assert p.snapshot()["buckets"] == {}
    assert p.active == (case not in ("pinned", "multiprocess",
                                     "autotune_off"))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("credit_pinned", [False, True])
def test_planner_random_sequences_match_jax(seed, credit_pinned):
    """Seeded pushes over several size buckets, completing out of order,
    some carved under a candidate the bucket no longer offers."""
    rng = np.random.RandomState(seed)
    j, p = _planners(partition_bytes=65536, partition_pinned=False,
                     credit_pinned=credit_pinned)
    sizes = [50_000, 70_000, 300_000, 1 << 20, 5_000_000, 33_554_432]
    inflight = []
    for _ in range(300):
        n = int(rng.choice(sizes))
        cand = p.plan_partition(n)
        assert cand == j.plan_partition(n)
        inflight.append((n, cand, float(rng.uniform(1e-4, 1e-2))))
        while inflight and rng.rand() < 0.6:
            done = inflight.pop(int(rng.randint(len(inflight))))
            for pl in (j, p):
                pl.observe(*done)
        _same_decisions(j, p, sizes)
    assert any(p.locked(n) for n in sizes[2:])


def test_speed_monitor_matches_jax_under_one_clock():
    now = [100.0]
    clock = lambda: now[0]  # noqa: E731
    mons = [jax_telemetry.SpeedMonitor(window_sec=2.0, clock=clock),
            port_telemetry.SpeedMonitor(window_sec=2.0, clock=clock)]
    rng = np.random.RandomState(3)
    readings = [[], []]
    for _ in range(200):
        now[0] += float(rng.choice([0.01, 0.05, 0.3, 1.5]))
        nbytes = int(rng.randint(0, 5 << 20))
        for m, r in zip(mons, readings):
            m.record(nbytes)
            r.append(m.speed()[1])
    assert readings[0] == readings[1]
    assert max(readings[1]) > 0


def _task(mod, name, key, prio, nbytes):
    extra = ({"version": 0, "total_parts": 1} if mod is jax_types else {})
    return mod.ChunkTask(name=name, key=key, priority=prio, offset_elems=0,
                         num_elems=nbytes // 4, nbytes=nbytes, **extra)


@pytest.mark.parametrize("credit", [0, 1 << 20])
@pytest.mark.parametrize("backend", list(SCHEDULERS))
def test_scheduler_pop_order_matches_jax(backend, credit):
    """A scripted add / pop / finish trace pops the same tasks in the
    same order as JAX's ChunkScheduler, under the same credit window."""
    rng = np.random.RandomState(credit % 97)
    specs = [(f"t{i}", int(rng.randint(0, 1 << 20)), int(rng.randint(-3, 3)),
              int(rng.choice([200_000, 450_000, 900_000])))
             for i in range(60)]
    scheds = [(jax_types, jax_scheduler.ChunkScheduler(credit)),
              (port_types, SCHEDULERS[backend](credit))]
    trace = []
    for mod, s in scheds:
        popped, it = [], iter(specs)
        for step in range(180):
            if step % 3 != 2:
                spec = next(it, None)
                if spec is not None:
                    s.add_task(_task(mod, *spec))
            t = s.get_task()
            if t is not None:
                popped.append(t.name)
            if step % 4 == 3 and s.bytes_in_flight:
                s.report_finish(500_000)
        popped.append(s.pending)
        popped += [t.name for t in s.drain()]
        trace.append(popped)
    assert trace[0] == trace[1]


def _ptask(key, nbytes=64):
    return _task(port_types, f"t{key}", key, 0, nbytes)


@pytest.mark.parametrize("backend", list(SCHEDULERS))
def test_scheduler_interrupt_wakes_blocked_get(backend):
    s = SCHEDULERS[backend](0)
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "task", s.get_task(block=True)))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()                         # parked, not polling
    s.interrupt()
    t.join(timeout=5)
    assert not t.is_alive() and got["task"] is None


@pytest.mark.parametrize("backend", list(SCHEDULERS))
def test_scheduler_interrupt_is_one_shot(backend):
    s = SCHEDULERS[backend](0)
    s.interrupt()                               # latched for the next get
    assert s.get_task(block=True) is None
    s.add_task(_ptask(1))
    assert s.get_task(block=True) is not None


@pytest.mark.parametrize("backend", list(SCHEDULERS))
def test_scheduler_set_credit_unblocks_waiter(backend):
    s = SCHEDULERS[backend](0)
    s.set_credit_bytes(64)
    assert s.credit_bytes == 64
    s.add_task(_ptask(1))
    s.add_task(_ptask(2))
    assert s.get_task() is not None
    assert s.get_task() is None                 # window exhausted
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "task", s.get_task(block=True)))
    t.start()
    time.sleep(0.05)
    s.set_credit_bytes(256)                     # widening notifies
    t.join(timeout=5)
    assert not t.is_alive() and got["task"] is not None


@pytest.mark.parametrize("backend", list(SCHEDULERS))
def test_scheduler_wake_is_latched(backend):
    s = SCHEDULERS[backend](0)
    s.add_task(_ptask(1, nbytes=128))
    s.set_credit_bytes(64)
    assert s.get_task() is not None            # one always fits
    s.add_task(_ptask(2, nbytes=128))
    s.wake()
    assert s.get_task(block=True) is None       # returns without waiting
    assert s.get_task(block=True) is None       # and keeps returning
    assert [t.key for t in s.drain()] == [2]    # the queue survives


@pytest.fixture
def broken_native(monkeypatch, tmp_path):
    """native/ pointed at a source that does not compile."""
    src = tmp_path / "core.cc"
    src.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)


def test_native_build_failure_raises(broken_native):
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        PushPullEngine._make_scheduler(port_config.Config(use_native=True))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        api.init(port_config.Config(use_native=True), device="cpu")
    assert not api.initialized()
    assert not torch.distributed.is_initialized()
    # selecting the Python heap is explicit, and builds nothing
    s = PushPullEngine._make_scheduler(port_config.Config(use_native=False))
    assert type(s) is port_scheduler.ChunkScheduler


def test_native_library_is_keyed_by_source(tmp_path, monkeypatch):
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR and lib.name.endswith(".so")
    src = tmp_path / "core.cc"
    src.write_text(native.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() != lib
