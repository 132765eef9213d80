"""The port's grouped dispatch, per-unit retirement and planner hooks,
against the JAX engine and at a world of one on the CPU (gloo).

``_plan_batch`` must cut the task sequences of
``tests/test_engine_grouped.py`` (and seeded random ones) into the units
JAX's cuts them into, before JAX's power-of-two split.  A world of one
reduces to the identity, so the engine's outputs are held bit for bit
against its inputs for every group size, with the planner on and off,
for four dtypes, ragged last chunks and both ops; and 8 equal small
tensors drained at once take the one dispatch the JAX engine takes.
"""

import time

import numpy as np
import pytest
import torch

import byteps_tpu as jax_bps
import byteps_tpu_torch as port
from byteps_tpu.common.config import Config as JaxConfig
from byteps_tpu.common.config import set_config as jax_set_config
from byteps_tpu.common.types import ChunkTask as JaxTask
from byteps_tpu.core.engine import _plan_batch as jax_plan_batch
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.common.registry import TensorRegistry
from byteps_tpu_torch.common.types import ChunkTask
from byteps_tpu_torch.core import api
from byteps_tpu_torch.core.engine import _plan_batch

ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
INT_VIEW = {torch.float32: torch.int32, torch.float16: torch.int16,
            torch.bfloat16: torch.int16, torch.int32: torch.int32}


# ---------------------------------------------------------------- planning

class _JaxPending:
    use_buffer = True


class _PortPending:
    multi_chunk = True


class _Arr:
    def __init__(self, shape, dtype):
        self.shape, self.dtype, self.ndim = tuple(shape), np.dtype(dtype), 2


# a task: (name, key, kind, arg, n, dtype, scale); kind "buf" is a chunk of
# a multi-chunk tensor (arg: which tensor) of n elements at offset key*n,
# "parts" a whole single-chunk tensor of n elements, "comp" a compressed
# chunk
SEQUENCES = {
    "contiguous_run": [("w", k, "buf", 0, 64, "float32", None)
                       for k in range(8)],
    "noncontiguous_and_foreign": [
        ("a", 0, "buf", 1, 64, "float32", None),
        ("a", 1, "buf", 1, 64, "float32", None),
        ("b", 0, "buf", 2, 64, "float32", None),
        ("a", 3, "buf", 1, 64, "float32", None)],
    "equal_parts": [(f"g{i}", i, "parts", None, 64, "float32", 0.125)
                    for i in range(5)],
    "incompatible_neighbours": [
        ("a", 0, "parts", None, 64, "float32", 0.125),
        ("b", 1, "parts", None, 32, "float32", 0.125),
        ("c", 2, "parts", None, 32, "float32", None),
        ("d", 3, "parts", None, 32, "int32", None)],
    "order_preserved": [
        ("hi", 0, "parts", None, 16, "float32", None),
        ("bulk", 1, "buf", 3, 64, "float32", None),
        ("bulk", 2, "buf", 3, 64, "float32", None),
        ("lo", 3, "parts", None, 16, "float32", None)],
}


def _random_sequence(seed):
    rng = np.random.RandomState(seed)
    seq = []
    for i in range(40):
        kind = rng.choice(["buf", "parts", "comp"], p=[0.4, 0.45, 0.15])
        n = int(rng.choice([32, 64]))
        dt = str(rng.choice(["float32", "int32"]))
        scale = [None, 0.125][rng.randint(2)]
        if kind == "buf":
            which = int(rng.randint(3))
            seq.append((f"t{which}", i, kind, which, 64, "float32", None))
        else:
            seq.append((f"p{i}", i, kind, None, n, dt, scale))
    return seq


def _build(spec_seq):
    """The same batch as JAX ChunkTasks and as port ChunkTasks."""
    jp, pp, jt, pt = {}, {}, [], []
    for name, key, kind, arg, n, dt, scale in spec_seq:
        comp = object() if kind == "comp" else None
        if kind == "buf":
            off = key * n
            jpend = jp.setdefault(arg, _JaxPending())
            ppend = pp.setdefault(arg, _PortPending())
            jdata, pdata = None, torch.empty(0)
        else:
            off, jpend, ppend = 0, None, None
            jdata = _Arr((8, n), dt)
            pdata = torch.empty(0, dtype=getattr(torch, dt))
        jt.append(JaxTask(name=name, key=key, priority=0, version=0,
                          offset_elems=off, num_elems=n, nbytes=4 * n,
                          total_parts=1, data=jdata, scale=scale,
                          pending=jpend, compression=comp))
        pt.append(ChunkTask(name=name, key=key, priority=0,
                            offset_elems=off, num_elems=n, nbytes=4 * n,
                            data=pdata, scale=scale, pending=ppend,
                            compression=comp))
    return jt, pt


@pytest.mark.parametrize("seq", list(SEQUENCES) + ["random0", "random1",
                                                    "random2"])
def test_plan_batch_matches_jax(seq):
    specs = (SEQUENCES[seq] if seq in SEQUENCES
             else _random_sequence(int(seq[-1])))
    jt, pt = _build(specs)
    want = [(k, [(t.name, t.key) for t in u]) for k, u in jax_plan_batch(jt)]
    got = [(k, [(t.name, t.key) for t in u]) for k, u in _plan_batch(pt)]
    assert got == want
    if seq == "equal_parts":
        assert [(k, len(u)) for k, u in got] == [("group", 5)]


# ----------------------------------------------------------- world of one

def _inputs(seed):
    """(name, tensor, op): four dtypes, one-chunk and ragged multi-chunk
    shapes at 4096-byte partitions, both ops; -0.0 and inf included."""
    rng = np.random.RandomState(seed)
    out = []
    for dt in INT_VIEW:
        for shape in ((7,), (40, 90)):
            for op in ("average", "sum"):
                x = rng.randn(*shape).astype(np.float32) * 50
                if dt == torch.int32:
                    t = torch.from_numpy(x.astype(np.int32))
                else:
                    x.reshape(-1)[::11] = -0.0
                    x.reshape(-1)[5] = np.inf
                    t = torch.from_numpy(x).to(dt)
                out.append((f"{dt}/{shape}/{op}", t, op))
    return out


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(INT_VIEW[a.dtype]),
                            b.view(INT_VIEW[b.dtype])))


@pytest.mark.parametrize("autotune", [True, False])
@pytest.mark.parametrize("group_size", [1, 4, -1])
def test_outputs_bit_identical_across_grouping_and_planner(group_size,
                                                           autotune):
    """Rounds of every input pushed at once behind pause_dispatch (so that
    groups and runs form), while the planner explores, locks and re-carves
    the multi-chunk tensors: each output keeps its input's bits, as with
    group_size=1 and the planner off."""
    port.init(Config(partition_bytes=4096, partition_pinned=False,
                     group_size=group_size, autotune=autotune),
              device="cpu")
    try:
        eng = api.engine()
        for rnd in range(8):
            xs = _inputs(rnd)
            eng.pause_dispatch()
            hs = [api.push_pull_async(x, name, op=op) for name, x, op in xs]
            eng.resume_dispatch()
            for (name, x, _), h in zip(xs, hs):
                assert _same_bits(h.wait(timeout=30), x), (rnd, name)
        stats, snap = dict(eng.stats), eng.planner.snapshot()
        bounds = {n: eng.registry.get(n).chunk_bounds
                  for n, _, _ in _inputs(0)}
    finally:
        port.shutdown()
    assert stats["chunks"] > len(_inputs(0)) * 8
    if group_size == 1:
        assert stats["dispatches"] == stats["chunks"]
    else:
        assert stats["dispatches"] < stats["chunks"]
    if autotune:
        assert snap["buckets"] and all(
            b["locked_partition_bytes"] for b in snap["buckets"].values())
        assert snap["credit_bytes"] == 4 * max(
            b["locked_partition_bytes"] for b in snap["buckets"].values())
    else:
        assert snap["buckets"] == {} and snap["credit_bytes"] == 0
        assert len(bounds["torch.float32/(40, 90)/sum"]) == 4


def test_drained_equal_tensors_take_one_dispatch_like_jax():
    """tests/test_engine_grouped.py's 8 equal small tensors: drained at
    once they are one dispatch of 8 chunks in both engines."""
    rng = np.random.RandomState(8)
    xs = [rng.randn(8, 300).astype(np.float32) for _ in range(8)]
    jax_set_config(JaxConfig(group_size=-1, telemetry_on=False))
    jax_bps.init()
    try:
        from byteps_tpu.core import api as jax_api
        jeng = jax_api._engine
        jeng.pause_dispatch()
        hs = [jeng.push_pull_async(x, f"g{i}", op="average")
              for i, x in enumerate(xs)]
        jeng.resume_dispatch()
        for h in hs:
            h.wait()
        jax_stats = dict(jeng.stats)
    finally:
        jax_bps.shutdown()

    port.init(Config(group_size=-1), device="cpu")
    try:
        eng = api.engine()
        units = []
        real = eng._dispatch_unit

        def recording(kind, unit):
            units.append((kind, list(unit)))
            real(kind, unit)

        eng._dispatch_unit = recording
        eng.pause_dispatch()
        ts = [torch.from_numpy(x[0].copy()) for x in xs]
        hs = [port.push_pull_async(t, name=f"g{i}")
              for i, t in enumerate(ts)]
        eng.resume_dispatch()
        outs = [h.wait(timeout=30) for h in hs]
        # the collective counts (the port's stats also count wire bytes)
        stats = {k: eng.stats[k] for k in jax_stats}
    finally:
        port.shutdown()
    assert all(_same_bits(o, t) for o, t in zip(outs, ts))
    assert stats == jax_stats == {"dispatches": 1, "chunks": 8}
    (kind, unit), = units
    assert kind == "group" and len(unit) == 8
    assert all(0 < t.t_enqueue <= t.t_dispatch for t in unit)


@pytest.fixture
def engine1():
    port.init(Config(partition_bytes=4096, partition_pinned=False),
              device="cpu")
    yield api.engine()
    port.shutdown()


def test_repartition_only_between_pushes(engine1, monkeypatch):
    """A push that finds another of the same tensor in flight keeps its
    bounds; the next push with none in flight takes the new plan; the
    result is right under both."""
    x = torch.arange(40_000, dtype=torch.float32)
    api.push_pull(x, "rp/w")
    ctx = engine1.registry.get("rp/w")
    engine1.pause_dispatch()
    try:
        h1 = api.push_pull_async(x, "rp/w")      # carved at the plan now
        first = list(ctx.chunk_bounds)
        other = 65536 if ctx.partition_bytes != 65536 else 16384
        monkeypatch.setattr(engine1.planner, "plan_partition",
                            lambda nbytes: other)
        h2 = api.push_pull_async(2 * x, "rp/w")  # h1 holds a claim
        assert ctx.inflight == 2 and ctx.chunk_bounds == first
    finally:
        engine1.resume_dispatch()
    assert torch.equal(h1.wait(timeout=30), x)
    assert torch.equal(h2.wait(timeout=30), 2 * x)
    assert ctx.inflight == 0
    assert torch.equal(api.push_pull(3 * x, "rp/w"), 3 * x)
    assert ctx.partition_bytes == other and ctx.chunk_bounds != first
    assert len(ctx.key_list) == len(ctx.chunk_bounds)


def test_compressed_tensor_is_never_recarved(engine1):
    x = torch.from_numpy(np.random.RandomState(1).randn(40_000)
                         .astype(np.float32))
    api.push_pull(x, "rp/c", compression=ONEBIT_EF)
    ctx = engine1.registry.get("rp/c")
    bounds, slots = list(ctx.chunk_bounds), list(ctx.compressor)
    with ctx.lock:
        assert not TensorRegistry.repartition_locked(ctx, 1 << 20)
    for _ in range(3):                           # no plan reaches it
        api.push_pull(x, "rp/c", compression=ONEBIT_EF)
    assert ctx.chunk_bounds == bounds and ctx.compressor == slots
    assert ctx.partition_bytes == 4096


def test_suspend_resume_keeps_keys_and_config():
    cfg = Config(partition_bytes=8192, group_size=-1)
    port.init(cfg, device="cpu")
    try:
        x = torch.ones(4, 3)
        port.push_pull(x, name="el/a", average=False)
        port.push_pull(x, name="el/b", average=False)
        key_a = api.engine().registry.get("el/a").declared_key
        key_b = api.engine().registry.get("el/b").declared_key
        port.suspend()
        assert not api.initialized()
        port.resume()
        eng = api.engine()
        assert eng.cfg is cfg and eng.device.type == "cpu"
        assert eng.registry.get("el/a").declared_key == key_a
        assert eng.registry.get("el/b").declared_key == key_b
        assert torch.equal(port.push_pull(x, name="el/a", average=False), x)
        with pytest.raises(RuntimeError, match="suspend"):
            port.resume()
        port.shutdown()
        with pytest.raises(RuntimeError, match="without a suspend"):
            port.resume()
        # the suspended order belonged to that engine alone
        port.init(cfg, device="cpu")
        assert api.engine().registry.get("el/a") is None
    finally:
        port.shutdown()


def test_pushpull_speed_moves(engine1):
    assert port.get_pushpull_speed()[1] == 0.0
    x = torch.ones(1024)
    for _ in range(5):
        api.push_pull(x, "spd", op="sum")
    ts, mbps = port.get_pushpull_speed()
    assert mbps > 0 and ts > 0


def _cpu_ticks(thread):
    """The thread's user + system CPU time so far, in clock ticks."""
    with open(f"/proc/self/task/{thread.native_id}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[11]) + int(fields[12])


def test_pause_dispatch_parks_without_polling(engine1):
    """pause_dispatch returns once the dispatcher has parked; tasks
    enqueued while paused stay queued; resume drains them."""
    engine1.pause_dispatch()
    try:
        assert engine1._parked.is_set()
        h = api.push_pull_async(torch.ones(256), "pause/t")
        ticks0 = _cpu_ticks(engine1._dispatcher)
        time.sleep(0.3)
        assert not h.poll() and engine1.scheduler.pending == 1
        # parked on an event: the dispatcher used no CPU meanwhile (a
        # polling loop would take tens of 10 ms ticks in 0.3 s)
        assert _cpu_ticks(engine1._dispatcher) - ticks0 <= 2
    finally:
        engine1.resume_dispatch()
    assert torch.equal(h.wait(timeout=30), torch.ones(256))
    assert not engine1._parked.is_set()


def test_retired_units_are_released(engine1, monkeypatch):
    """Once every handle has resolved and the caller has dropped them,
    nothing of the engine holds the pushes: the dispatcher and the syncer
    keep no retired unit (whose tasks hold the gradients, and whose
    results are the outputs) while they block for the next one, or a
    step's gradients and results would outlive it on the card."""
    import gc
    import weakref

    from byteps_tpu_torch.core import engine as engine_mod

    alive = []

    class Tracked(engine_mod._PendingTensor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            alive.append(weakref.ref(self))

    monkeypatch.setattr(engine_mod, "_PendingTensor", Tracked)
    engine1.pause_dispatch()
    hs = [api.push_pull_async(torch.full((5000,), float(i)), f"rel/{i}")
          for i in range(6)]
    engine1.resume_dispatch()
    assert all(torch.equal(h.wait(timeout=30), torch.full((5000,), float(i)))
               for i, h in enumerate(hs))
    del hs
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        gc.collect()
        if not any(r() is not None for r in alive):
            break
        time.sleep(0.05)
    assert len(alive) == 6 and not any(r() is not None for r in alive)
