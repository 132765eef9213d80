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


def test_elias_coder_build_failure_raises(broken_native):
    """The Elias-delta coder of dithering's wire frame has no quiet
    fallback to the numpy twin either."""
    from byteps_tpu_torch.compression import elias
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        elias.encode_wire(np.ones(8, np.int8), 1.0)


# ------------------------------------------------------ compressor ladder

LADDER_KW = {"partition_bytes": 16384, "partition_pinned": False,
             "credit_pinned": False, "compress_autotune": True,
             "min_compress_bytes": 4096}
ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}


def _lock_partition(planners, nbytes):
    for _ in range(64):
        if all(pl.locked(nbytes) for pl in planners):
            return
        cand = planners[0].plan_partition(nbytes)
        for pl in planners:
            assert pl.plan_partition(nbytes) == cand
            pl.observe(nbytes, cand, 0.001)
    raise AssertionError("partition bucket never locked")


def _codec_key(kw):
    return (kw or {}).get("compressor", "none")


def _same_ladder(j, p, sizes):
    assert [p.plan_compression(n) for n in sizes] == \
        [j.plan_compression(n) for n in sizes]
    assert [p.compress_locked(n) for n in sizes] == \
        [j.compress_locked(n) for n in sizes]
    assert p.compress_active == j.compress_active
    assert p.snapshot()["compression"] == j.snapshot()["compression"]


@pytest.mark.parametrize("case", ["slow_wire", "ceiling", "below_cutoff",
                                  "straddle", "multiprocess", "off",
                                  "random"])
def test_compress_ladder_matches_jax(case):
    """The compressor ladder's plan, observe and lock against the JAX
    ChunkPlanner fed the same samples: the cases of
    tests/test_compressed_aot.py, and a seeded random sequence."""
    kw, procs = dict(LADDER_KW), 1
    sizes = [40_000, 4_000_000]
    if case == "ceiling":
        kw["compress_error_ceiling"] = 0.2      # onebit and randomk out
    elif case == "below_cutoff":
        kw["min_compress_bytes"] = 10**9
    elif case == "straddle":
        kw["min_compress_bytes"] = 100_000
        sizes = [120_000, 80_000]               # one size bucket
    elif case == "multiprocess":
        procs = 2
    elif case == "off":
        kw["compress_autotune"] = False
    j, p = _planners(procs, **kw)
    _same_ladder(j, p, sizes)                   # before the chunk locks
    for n in sizes:
        _lock_partition((j, p), n)
    rng = np.random.RandomState(7)
    for step in range(24):
        for n in sizes:
            key = _codec_key(p.plan_compression(n))
            assert key == _codec_key(j.plan_compression(n))
            if case == "random":
                secs = float(rng.uniform(1e-4, 1e-2))
                if rng.rand() < 0.1:
                    key = "nope"                # an earlier ladder's codec
            elif n >= 1_000_000:
                secs = 0.002 if key == "onebit" else 0.020
            else:
                secs = 0.001 if key == "none" else 0.010
            for pl in (j, p):
                pl.observe_compression(n, key, secs)
        _same_ladder(j, p, sizes)
    snap = p.snapshot()["compression"]["buckets"]
    if case == "slow_wire":
        assert p.plan_compression(40_000) is None
        assert _codec_key(p.plan_compression(4_000_000)) == "onebit"
    elif case == "ceiling":
        assert all(set(b["golden_error"]) == {"none", "topk"}
                   for b in snap.values())
    elif case in ("below_cutoff", "multiprocess", "off"):
        assert snap == {} and all(p.compress_locked(n) for n in sizes)
    elif case == "straddle":
        assert p.plan_compression(80_000) is None
    assert all(p.compress_locked(n) for n in sizes)


def test_compress_autotune_config_matches_jax(monkeypatch):
    monkeypatch.setenv("BYTEPS_COMPRESS_AUTOTUNE", "1")
    monkeypatch.setenv("BYTEPS_COMPRESS_ERROR_CEILING", "0.3")
    for cfg in (jax_config.Config.from_env(), port_config.Config.from_env()):
        assert cfg.compress_autotune is True
        assert cfg.compress_error_ceiling == 0.3
    assert port_config.Config().compress_autotune is False
    assert port_config.Config().compress_error_ceiling == 0.55
    for bad in (0.0, 1.5):
        for cls in (jax_config.Config, port_config.Config):
            with pytest.raises(ValueError, match="compress_error_ceiling"):
                cls(compress_error_ceiling=bad)
    monkeypatch.setenv("BYTEPS_COMPRESS_ERROR_CEILING", "high")
    with pytest.raises(ValueError, match="must be a number"):
        port_config.Config.from_env()


@pytest.fixture
def jax_ladder():
    import byteps_tpu as jax_bps
    from byteps_tpu.common.config import set_config
    set_config(jax_config.Config(**LADDER_KW))
    jax_bps.init()
    from byteps_tpu.core import api as jax_api
    yield jax_api._engine
    jax_bps.shutdown()


@pytest.fixture
def port_ladder():
    api.init(port_config.Config(**LADDER_KW), device="cpu")
    yield api.engine()
    api.shutdown()


def _owner(ctx):
    return (ctx.compression_tuned, ctx.compression_pin,
            _codec_key(ctx.compression_kwargs))


def _pin_sequence(push, ctx_of):
    """Pin, re-pin and a re-pin deferred behind an in-flight push: the
    codec owner of each tensor after every push."""
    trace = []
    push("pin", ONEBIT_EF)
    trace.append(_owner(ctx_of("pin")))
    push("pin", None)
    trace.append(_owner(ctx_of("pin")))
    push("repin", None)
    trace.append(_owner(ctx_of("repin")))
    push("repin", ONEBIT_EF)
    trace.append(_owner(ctx_of("repin")))
    push("repin", None)
    trace.append(_owner(ctx_of("repin")))
    push("defer", None)
    ctx = ctx_of("defer")
    with ctx.lock:
        ctx.inflight += 1           # another push holds a claim
    try:
        push("defer", ONEBIT_EF)
        trace.append(_owner(ctx))
    finally:
        with ctx.lock:
            ctx.inflight -= 1
    push("defer", None)
    trace.append(_owner(ctx))
    return trace


def test_engine_pin_and_repin_match_jax(jax_ladder):
    """Codec ownership in the engine: decided at the first push, explicit
    kwargs re-pin a ladder-owned tensor, and a re-pin behind an in-flight
    push is applied at the next idle push, as in the JAX engine."""
    n = 40_000
    x = np.random.RandomState(1).randn(n).astype(np.float32)
    stacked = np.ascontiguousarray(
        np.broadcast_to(x[None], (jax_ladder.comm.num_ranks, n)))

    def jax_push(name, kw):
        jax_ladder.push_pull_async(stacked, name, op="sum", out_shape=(n,),
                                   compression=kw).wait()

    want = _pin_sequence(jax_push, jax_ladder.registry.get)
    import byteps_tpu as jax_bps
    jax_bps.shutdown()
    api.init(port_config.Config(**LADDER_KW), device="cpu")
    try:
        eng = api.engine()
        got = _pin_sequence(
            lambda name, kw: api.push_pull(torch.from_numpy(x), name,
                                           op="sum", compression=kw),
            eng.registry.get)
    finally:
        api.shutdown()
    assert got == want
    assert want[3] == (False, None, "onebit")
    assert want[5] == (False, ONEBIT_EF, "none")    # deferred, not lost


def test_engine_ladder_explores_retunes_and_charges_the_codec_run(
        port_ladder, monkeypatch):
    """A bare tensor under the ladder: every rung is explored, each retune
    happens between pushes with fresh compressor state, each sample is
    charged to the codec its push ran under, and once the bucket locks
    every push carries the locked codec."""
    eng = port_ladder
    n = 40_000
    nbytes = n * 4
    charged = []
    real = eng.planner.observe_compression
    monkeypatch.setattr(
        eng.planner, "observe_compression",
        lambda nb, codec, s: (charged.append(codec), real(nb, codec, s)))
    rng = np.random.RandomState(0)
    ran = []
    for _ in range(80):
        x = torch.from_numpy(rng.randn(n).astype(np.float32))
        before = len(charged)
        ctx0 = eng.registry.get("tune/w")
        slots0 = ctx0.compressor if ctx0 is not None else None
        api.push_pull(x, "tune/w")
        ctx = eng.registry.get("tune/w")
        codec = _codec_key(ctx.compression_kwargs)
        ran.append(codec)
        if len(charged) > before:
            assert charged[-1] == codec
        if ctx.compressor is not None and ctx.compressor is not slots0:
            # slots built for this push start from fresh state: the first
            # chunk's residual is this push's alone
            slot = ctx.compressor[0]
            x0 = x[:ctx.chunk_bounds[0][1]]
            p0, _ = slot.worker.compress(x0, slot.worker.init_state("cpu"))
            assert torch.equal(slot.wstate["error"],
                               x0 - slot.worker.decompress(p0))
        if eng.planner.locked(nbytes) and eng.planner.compress_locked(nbytes):
            break
    assert eng.planner.compress_locked(nbytes)
    snap = eng.planner.snapshot()["compression"]["buckets"][
        str(nbytes.bit_length())]
    assert set(snap["explored"]) == {k for k, _ in
                                     port_scheduler.COMPRESS_LADDER}
    assert set(ran) == set(snap["explored"])
    for _ in range(2):
        api.push_pull(torch.randn(n), "tune/w")
        ctx = eng.registry.get("tune/w")
        assert _codec_key(ctx.compression_kwargs) == snap["locked_codec"]


def test_failed_dispatch_restores_nested_decorator_state(port_ladder,
                                                         monkeypatch):
    """momentum(ef(topk)): a push whose all-gather fails leaves the whole
    nested state ({"momentum", "inner": {"error", "inner"}}) as it was,
    and the next push continues from it."""
    from byteps_tpu_torch.comm import compressed
    from byteps_tpu_torch.compression import registry as codecs
    kw = {"compressor": "randomk", "k": "0.1", "ef": "vanilla",
          "momentum": "nesterov"}
    rng = np.random.RandomState(2)
    xs = [torch.from_numpy(rng.randn(3000).astype(np.float32))
          for _ in range(3)]
    api.push_pull(xs[0], "nest", compression=kw)
    slot, = port_ladder.registry.get("nest").compressor
    before = {k: v.clone() for k, v in _leaves(slot.wstate).items()}
    assert set(before) == {"momentum", "inner/error", "inner/inner/counter"}

    def failing(comm, t):
        raise RuntimeError("injected all-gather fault")

    monkeypatch.setattr(compressed, "_all_gather", failing)
    with pytest.raises(RuntimeError, match="injected"):
        api.push_pull(xs[1], "nest", compression=kw)
    monkeypatch.undo()
    after = _leaves(slot.wstate)
    assert all(torch.equal(after[k], before[k]) for k in before)
    out = api.push_pull(xs[2], "nest", compression=kw)
    wc = codecs.create(kw, 3000)
    sc = codecs.create(kw, 3000, for_server=True)
    ws, ss = wc.init_state("cpu"), sc.init_state("cpu")
    for x in (xs[0], xs[2]):
        p, ws = wc.compress(x, ws)
        y = wc.decompress_sum({k: v[None] for k, v in p.items()})
        p2, ss = sc.compress(y, ss)
        want = sc.decompress(p2)
    assert torch.equal(out, want)
    assert all(torch.equal(_leaves(slot.wstate)[k], v)
               for k, v in _leaves(ws).items())


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
