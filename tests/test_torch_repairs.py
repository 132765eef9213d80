"""The port emits the reference's four planner and engine metrics and
fires its ``dcn`` chaos site, each held against the JAX package on the
same inputs.

- ``compression.planner_locked`` / ``compression.codec_locked`` (gauge and
  flight event) when a ladder bucket locks (JAX ``scheduler.py:451-462``);
- ``engine.credit_bytes`` when the tuned credit window is installed (JAX
  ``engine.py:758``);
- ``engine.sharded_updates`` once per slot step (JAX
  ``sharded_update.py:511``);
- ``dcn`` at each collective entry (JAX ``collectives.py:372``, ``:395``,
  ``:698``, ``:777``; ``compressed.py:130``).

Each metric has a control that must not emit it, and the ``dcn`` site a
control spec naming another site."""

import time

import jax
import numpy as np
import optax
import pytest
import torch

from byteps_tpu.comm.mesh import CommContext as JaxComm
from byteps_tpu.comm.mesh import _build_mesh
from byteps_tpu.common import config as jcfg
from byteps_tpu.common import flight_recorder as jflight
from byteps_tpu.common import scheduler as jsched
from byteps_tpu.common.telemetry import gauges as jgauges
from byteps_tpu.core.engine import PushPullEngine as JaxEngine
from byteps_tpu.fault import injector as jinj
from byteps_tpu_torch.comm import collectives as pcoll
from byteps_tpu_torch.comm import compressed as pcomp
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.common import flight_recorder as pflight
from byteps_tpu_torch.common import scheduler as psched
from byteps_tpu_torch.common.telemetry import counters as pcounters
from byteps_tpu_torch.common.telemetry import gauges as pgauges
from byteps_tpu_torch.compression import registry as codecs
from byteps_tpu_torch.core import api
from byteps_tpu_torch.fault import injector as pinj

from byteps_tpu.common.telemetry import counters as jcounters

from .torch_ps_common import fresh_ps_state  # noqa: F401 — autouse

LADDER_KW = {"partition_bytes": 16384, "partition_pinned": False,
             "credit_pinned": False, "compress_autotune": True,
             "min_compress_bytes": 4096}
CREDIT_KW = {"partition_bytes": 16384, "partition_pinned": False,
             "credit_pinned": False}


@pytest.fixture(autouse=True)
def fresh_planes():
    """Both packages' gauges and flight rings start empty (the shared
    fixture resets the counters, config and injector)."""
    for g, f in ((jgauges, jflight), (pgauges, pflight)):
        g.reset()
        f._reset_for_tests()
    yield
    for g, f in ((jgauges, jflight), (pgauges, pflight)):
        g.reset()
        f._reset_for_tests()


def _jax_comm():
    return JaxComm(mesh=_build_mesh(jax.devices()[:1], 1), n_dcn=1, n_ici=1)


def _lock_events(flight):
    return [(e["bucket"], e["codec"]) for e in flight.recorder.snapshot()
            if e.get("kind", e.get("event")) == "compression.codec_locked"]


def _lock_gauges(gauges):
    return {k: v for k, v in gauges.snapshot().items()
            if k.startswith("compression.codec_locked")}


def _drive_ladder(planners, sizes, steps=24):
    """The ladder's explore-and-lock sequence of
    ``test_torch_planner.py::test_compress_ladder_matches_jax``
    (slow_wire): each planner gets the same samples."""
    for n in sizes:
        for _ in range(64):
            if all(pl.locked(n) for pl in planners):
                break
            cands = {pl.plan_partition(n) for pl in planners}
            assert len(cands) == 1
            for pl in planners:
                pl.observe(n, *cands, 0.001)
    for _ in range(steps):
        for n in sizes:
            keys = {(pl.plan_compression(n) or {}).get("compressor", "none")
                    for pl in planners}
            assert len(keys) == 1
            key, = keys
            secs = ((0.002 if key == "onebit" else 0.020) if n >= 1_000_000
                    else (0.001 if key == "none" else 0.010))
            for pl in planners:
                pl.observe_compression(n, key, secs)


@pytest.mark.parametrize("autotune", [True, False], ids=["lock", "control"])
def test_codec_lock_metrics_match_jax(autotune):
    kw = dict(LADDER_KW, compress_autotune=autotune)
    j = jsched.ChunkPlanner(jcfg.Config(**kw), num_procs=1)
    p = psched.ChunkPlanner(pcfg.Config(**kw), num_procs=1)
    sizes = [40_000, 4_000_000]
    _drive_ladder((j, p), sizes)
    got = (pcounters.get("compression.planner_locked"),
           _lock_gauges(pgauges), _lock_events(pflight))
    want = (jcounters.get("compression.planner_locked"),
            _lock_gauges(jgauges), _lock_events(jflight))
    assert got == want
    if autotune:
        # one lock a size bucket, each with its gauge at 1.0 and an event
        assert got[0] == len(sizes) == len(got[1]) == len(got[2])
        assert set(got[1].values()) == {1.0}
        assert sorted(b for b, _ in got[2]) == sorted(
            n.bit_length() for n in sizes)
        assert dict(got[2])[(4_000_000).bit_length()] == "onebit"
    else:
        assert got == (0, {}, [])


def _feed_credit(planner, nbytes=160_000, fast=40960):
    """Samples that lock the partition bucket (and so tune the credit
    window) with ``fast`` the quickest candidate."""
    for _ in range(64):
        if planner.locked(nbytes):
            return
        cand = planner.plan_partition(nbytes)
        planner.observe(nbytes, cand, 0.001 if cand == fast else 0.01)
    raise AssertionError("partition bucket never locked")


@pytest.mark.parametrize("pinned", [False, True], ids=["tuned", "control"])
def test_credit_window_gauge_matches_jax(pinned):
    kw = dict(CREDIT_KW, credit_pinned=pinned)
    jeng = JaxEngine(_jax_comm(), jcfg.Config(**kw))
    try:
        _feed_credit(jeng.planner)
        jeng._apply_planned_credit()
        want = (jgauges.get("engine.credit_bytes"),
                jeng.scheduler.credit_bytes)
    finally:
        jeng.shutdown(wait=True)
    api.init(pcfg.Config(**kw), device="cpu")
    try:
        eng = api.engine()
        _feed_credit(eng.planner)
        eng._apply_planned_credit()
        got = (pgauges.get("engine.credit_bytes"), eng.scheduler.credit_bytes)
    finally:
        api.shutdown()
    assert got == want
    if pinned:
        assert got[0] == 0.0
        assert "engine.credit_bytes" not in pgauges.snapshot()
    else:
        assert got[0] == got[1] == 4 * 40960


def test_credit_window_gauge_follows_a_tuned_engine():
    """Real pushes, the planner timing them: once the bucket locks, the
    gauge holds the window the scheduler runs under."""
    api.init(pcfg.Config(**CREDIT_KW), device="cpu")
    try:
        eng = api.engine()
        x = torch.from_numpy(np.random.RandomState(0).randn(40_000)
                             .astype(np.float32))
        for _ in range(200):
            api.push_pull(x, "credit")
            if eng.planner.locked(x.numel() * 4):
                break
        api.push_pull(x, "credit")
        assert eng.planner.locked(x.numel() * 4)
        assert pgauges.get("engine.credit_bytes") == \
            eng.scheduler.credit_bytes == eng.planner.credit_bytes() > 0
    finally:
        api.shutdown()


@pytest.mark.parametrize("sharded", [True, False], ids=["slot", "control"])
def test_sharded_updates_count_matches_jax(sharded):
    n, steps = 3000, 5
    rng = np.random.RandomState(3)
    p0 = rng.randn(n).astype(np.float32)
    grads = [rng.randn(n).astype(np.float32) for _ in range(steps)]
    jeng = JaxEngine(_jax_comm(), jcfg.Config(sharded_update=sharded))
    try:
        if sharded:
            jeng.declare_update("w", (n,), np.float32, tx=optax.sgd(0.1),
                                init_value=p0)
        for g in grads:
            if sharded:
                jeng.push_pull_update(g[None], "w", stacked=True)
            else:
                jeng.push_pull_async(g[None], "w", op="sum",
                                     out_shape=(n,)).wait()
    finally:
        jeng.shutdown(wait=True)
    api.init(pcfg.Config(sharded_update=sharded), device="cpu")
    try:
        if sharded:
            api.declare_update("w", (n,), torch.float32,
                               optimizer=(torch.optim.SGD, {"lr": 0.1}),
                               init_value=torch.from_numpy(p0))
        for g in grads:
            if sharded:
                api.push_pull_update(torch.from_numpy(g), "w")
            else:
                api.push_pull(torch.from_numpy(g), "w", op="sum")
    finally:
        api.shutdown()
    got = pcounters.get("engine.sharded_updates")
    assert got == jcounters.get("engine.sharded_updates")
    assert got == (steps if sharded else 0)


# ----------------------------------------------------------------- dcn

N = 4096
DELAY_MS = 60


def _entries(comm):
    """Each collective entry of the port once, on small inputs."""
    x = torch.from_numpy(np.random.RandomState(5).randn(N)
                         .astype(np.float32))
    onebit = {"compressor": "onebit"}
    wc, sc = codecs.create(onebit, N), codecs.create(onebit, N,
                                                     for_server=True)
    return {
        "push_pull_array": lambda: pcoll.push_pull_array(comm, x, op="sum"),
        "push_pull_scaled": lambda: pcoll.push_pull_array(
            comm, x, op="sum", scale=0.5),
        "push_pull_arrays_batched": lambda: pcoll.push_pull_arrays_batched(
            comm, [x[:N // 2], x[N // 2:]]),
        "push_pull_chunk_scatter": lambda: pcoll.push_pull_chunk_scatter(
            comm, x, None, 0, N, 1, N),
        "fused_compressed_push_pull": lambda: pcomp.fused_compressed_push_pull(
            comm, x, wc, sc, wc.init_state("cpu"), sc.init_state("cpu")),
    }


ENTRIES = ["push_pull_array", "push_pull_scaled", "push_pull_arrays_batched",
           "push_pull_chunk_scatter", "fused_compressed_push_pull"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_dcn_delay_reaches_each_collective_entry(entry):
    api.init(pcfg.Config(), device="cpu")
    try:
        call = _entries(api.engine().comm)[entry]
        call()                                   # warm, disarmed
        plain = call()
        walls = {}
        for spec in (f"delay:site=dcn:p=1:ms={DELAY_MS}",
                     f"delay:site=sync:p=1:ms={DELAY_MS}"):
            pinj.arm(spec, seed=0)
            before = pcounters.get("fault.delay")
            t0 = time.perf_counter()
            out = call()
            walls[spec.split(":")[1]] = (time.perf_counter() - t0,
                                         pcounters.get("fault.delay")
                                         - before)
            pinj.disarm()
            # a delay changes no bit of the result
            for a, b in zip(_flat(out), _flat(plain)):
                assert torch.equal(a, b)
    finally:
        api.shutdown()
    wall, fires = walls["site=dcn"]
    assert fires == 1 and wall >= DELAY_MS / 1000.0
    assert walls["site=sync"][1] == 0            # control: another site


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


def test_kill_is_refused_at_dcn_alike():
    """``dcn`` is a woven fire() site: both injectors refuse a kill there
    with the same message (kill takes only its predicate sites), so there
    is no kill to run in a subprocess."""
    spec = "kill:site=dcn:step=1"
    with pytest.raises(ValueError) as pe:
        pinj.parse_spec(spec)
    with pytest.raises(ValueError) as je:
        jinj.parse_spec(spec)
    assert str(pe.value) == str(je.value)
    assert "kill supports only site=coordinator" in str(pe.value)


PUSHES = 40
SPEC = "delay:site=dcn:p=0.3:ms=1"


def _jax_schedule(seed):
    import byteps_tpu as jax_bps
    from byteps_tpu.core import api as jax_api
    jcfg.set_config(jcfg.Config(fault_spec=SPEC, fault_seed=seed))
    jax_bps.init()
    try:
        eng = jax_api._engine
        R = eng.comm.num_ranks
        x = np.random.RandomState(9).randn(N).astype(np.float32)
        stacked = np.ascontiguousarray(np.broadcast_to(x[None], (R, N)))
        out = []
        for i in range(PUSHES):
            before = jcounters.get("fault.delay")
            eng.push_pull_async(stacked, "g", op="sum",
                                out_shape=(N,)).wait()
            out.append(jcounters.get("fault.delay") - before)
        return out
    finally:
        jax_bps.shutdown()


def _port_schedule(seed):
    api.init(pcfg.Config(fault_spec=SPEC, fault_seed=seed), device="cpu")
    try:
        x = torch.from_numpy(np.random.RandomState(9).randn(N)
                             .astype(np.float32))
        out = []
        for i in range(PUSHES):
            before = pcounters.get("fault.delay")
            api.push_pull(x, "g", op="sum")
            out.append(pcounters.get("fault.delay") - before)
        return out
    finally:
        api.shutdown()


@pytest.mark.parametrize("seed", [0, 17])
def test_dcn_schedule_over_pushes_matches_jax(seed):
    got, want = _port_schedule(seed), _jax_schedule(seed)
    assert got == want
    assert set(got) <= {0, 1} and 0 < sum(got) < PUSHES
