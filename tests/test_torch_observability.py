"""The port's observability plane against the JAX package's on the same
inputs: step statistics and attribution, the health engine's hysteresis,
the time-series ring, the lock-order witness, the flight recorder, the
obs server's ``/metrics`` names, and the seams in the parameter server
and the envelope.

Each scenario runs once with one package's modules and returns what an
observer sees; both packages must give the same result.  The step
tracker reads a fake clock (both modules' ``time`` is replaced), so the
attribution, wall times and the ``other`` residual are exact; no test
reads a wall-clock threshold.  Then the port's own runs: an engine with
the lock witness armed, the endpoint's four routes over HTTP, and
``metrics_snapshot``.
"""

import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import byteps_tpu.common.config as jcfg
import byteps_tpu.common.flight_recorder as jflight
import byteps_tpu.common.health as jhealth
import byteps_tpu.common.lock_witness as jlw
import byteps_tpu.common.metrics as jmetrics
import byteps_tpu.common.telemetry as jtel
import byteps_tpu.common.timeseries as jts
import byteps_tpu.common.tracing as jtracing
import byteps_tpu.fault.injector as jinj
import byteps_tpu.common.obs_server as jobs
import byteps_tpu.server.engine as jse
import byteps_tpu.server.kv_store as jkv

import byteps_tpu_torch.common.config as pcfg
import byteps_tpu_torch.common.flight_recorder as pflight
import byteps_tpu_torch.common.health as phealth
import byteps_tpu_torch.common.lock_witness as plw
import byteps_tpu_torch.common.metrics as pmetrics
import byteps_tpu_torch.common.obs_server as pobs
import byteps_tpu_torch.common.telemetry as ptel
import byteps_tpu_torch.common.timeseries as pts
import byteps_tpu_torch.common.tracing as ptracing
import byteps_tpu_torch.fault.injector as pinj
import byteps_tpu_torch.server as pserver
from byteps_tpu_torch.core import api
from byteps_tpu_torch.utils import timing as ptiming

from .torch_obs_common import fresh_port_plane  # noqa: F401 (autouse)

PKGS = {
    "jax": types.SimpleNamespace(
        cfg=jcfg, flight=jflight, health=jhealth, lw=jlw, metrics=jmetrics,
        tel=jtel, ts=jts, tracing=jtracing, inj=jinj,
        server=types.SimpleNamespace(ServerEngine=jse.ServerEngine,
                                     KVStore=jkv.KVStore),
        array=np.asarray),
    "port": types.SimpleNamespace(
        cfg=pcfg, flight=pflight, health=phealth, lw=plw, metrics=pmetrics,
        tel=ptel, ts=pts, tracing=ptracing, inj=pinj, server=pserver,
        array=lambda a: torch.from_numpy(np.asarray(a))),
}


def both(scenario, *args):
    """The scenario's JSON-normalized result under each package."""
    out = {}
    for name, ns in PKGS.items():
        out[name] = json.loads(json.dumps(scenario(ns, *args), default=repr,
                                          sort_keys=True))
    return out


class _Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


class _Recorder:
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append({"kind": kind, **fields})


# ----------------------------------------------------- step attribution

def sc_step_stats(ns, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(ns.tel, "time", clock)
    rec = _Recorder()
    tr = ns.tel.StepStatsTracker(recorder=rec)
    for step in range(1, 5):
        for name, nbytes in (("a", 100), ("b", 40)):
            tr.on_push(name, nbytes)
            clock.t += 0.001
        ns.tel.attribution.add("wire", 2.5 * step)
        ns.tel.attribution.add("merge", 1.0)
        if step == 2:
            ns.tel.attribution.add("credit", 4.0)
        tr.add_component("queue", 0.5)
        tr.add_component("enqueue", 0.25)
        tr.add_component("assemble", 0.125)
        tr.add_stall(3.0 * step)
        tr.add_wire(280)
        tr.note_retire("b")
        ns.tel.counters.inc("integrity.retransmit", step)
        clock.t += 0.02 * step
    tail = tr.flush()
    gauges = {k: v for k, v in ns.metrics.registry.snapshot()["gauges"]
              .items() if k.startswith("step.")}
    return ([s.as_dict() for s in tr.history()], tail.as_dict(),
            rec.events, gauges, tr.summary(), tr.current_step,
            ns.tracing.last_stamp()[0],
            ns.tel.counters.get("step.completed"))


def test_step_stats_and_attribution_match_reference(monkeypatch):
    got = both(sc_step_stats, monkeypatch)
    assert got["port"] == got["jax"]
    for s in got["port"][0]:
        # the components and "other" add up to the step's wall time
        assert abs(sum(s["attrib"].values()) - s["wall_ms"]) < 0.01
        assert s["attrib"]["other"] >= 0
    assert set(got["port"][0][1]["attrib"]) == {
        "wire", "merge", "credit", "queue", "enqueue", "assemble", "sync",
        "other"}


def test_attribution_names_match_reference():
    # the JAX package's less ``compile``: eager PyTorch has nothing to
    # compile per shape, so the port has no such component
    assert ptel.ATTRIB_GAUGE_NAMES == {
        k: v for k, v in jtel.ATTRIB_GAUGE_NAMES.items() if k != "compile"}
    assert [f.name for f in
            ptel.dataclasses.fields(ptel.StepStats)] == [
        f.name for f in jtel.dataclasses.fields(jtel.StepStats)]


# ---------------------------------------------------------------- health

class _FakeStore:
    def __init__(self, interval_s=1.0):
        self.interval_s = interval_s
        self._pts = []

    def push(self, **kw):
        kw.setdefault("t", float(len(self._pts)))
        self._pts.append(kw)

    def points(self):
        return list(self._pts)

    def values(self, key):
        return [(p["t"], p[key]) for p in self._pts if key in p]


HEALTH_FEED = (
    [dict(steps=1, overlap=0.1, retransmit=5)] * 3
    + [dict(steps=1, overlap=0.5, retransmit=0)] * 3
    + [dict(steps=1, overlap=0.9, ef_norm=1.0 + i) for i in range(6)]
    + [dict(steps=0, overlap=0.0, slow_score=9.0)] * 4
    + [dict(steps=1, overlap=0.9)] * 4)


def sc_health(ns):
    cfg = ns.cfg.Config(health_windows=3, health_overlap_floor=0.2,
                        health_burn_rate=1.0, health_skew_ratio=4.0)
    ns.health.configure(cfg)
    history = {0: {"series": {"attrib_wire": {"mean": 10.0}}},
               1: {"series": {"attrib_wire": {"mean": 80.0}}},
               2: {"series": {"attrib_wire": {"mean": 12.0}}}}
    ns.health.set_cluster_history_provider(lambda: history)
    ns.health.set_quorum_provider(lambda: {"reachable": 1, "world": 3})
    store = _FakeStore()
    trail = []
    for p in HEALTH_FEED:
        store.push(**p)
        ns.health.evaluate(store)
        trail.append(sorted(ns.health.active_alerts()))
    alerts = [{k: v for k, v in e.items() if k not in ("t", "mono")}
              for e in ns.flight.recorder.snapshot() if e["kind"] == "alert"]
    gauges = {k: v for k, v in ns.metrics.registry.snapshot()["gauges"]
              .items() if k.startswith("health.")}
    return (trail, alerts, gauges, ns.tel.counters.get("health.evals"),
            ns.tel.counters.get("health.alerts_fired"),
            ns.health.attrib_skew_findings(history, 4.0))


def test_health_engine_matches_reference():
    got = both(sc_health)
    assert got["port"] == got["jax"]
    assert phealth.RULE_IDS == jhealth.RULE_IDS
    trail = got["port"][0]
    assert "overlap_floor" not in trail[1] and "overlap_floor" in trail[2]
    assert got["port"][5][0]["rank"] == 1       # the skewed rank


# ------------------------------------------------------------ time series

def sc_timeseries(ns):
    store = ns.ts.TimeSeriesStore(interval_s=0.5, window=8)
    c, g, h = ns.tel.counters, ns.tel.gauges, ns.tel.histograms
    pts = []
    for i in range(12):
        c.inc("integrity.retransmit", i % 3)
        c.inc("step.completed")
        g.set("step.overlap_fraction", i / 11.0)
        g.set("step.attrib_wire_ms", 2.0 * i)
        g.set("compression.ef_norm", 1.0 + i, tensor="w")
        g.set("compression.ef_norm", 0.5, tensor="b")
        for _ in range(20):
            h.observe("transport.rtt_ms", 1.0 + i)
        if i == 6:
            ns.metrics.registry.reset("counters")
        pts.append(store.sample_once(now=float(i)))
    return pts, store.dump(), store.summary(), ns.ts.series_keys()


def _less_compile(obj):
    """``obj`` without the JAX package's ``attrib_compile`` series (the
    port has no ``compile`` attribution component)."""
    if isinstance(obj, dict):
        return {k: _less_compile(v) for k, v in obj.items()
                if k != "attrib_compile"}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_less_compile(v) for v in obj
                         if v != "attrib_compile")
    return obj


def test_timeseries_store_matches_reference():
    got = both(sc_timeseries)
    # both samplers refresh their slowness tracker's gauge before each
    # sample, so every point carries slow_score (0.0: no peers)
    assert got["port"] == _less_compile(got["jax"])
    assert "attrib_compile" in got["jax"][3]
    assert len(got["port"][1]["points"]) == 8


def test_sampler_thread_feeds_health(monkeypatch):
    cfg = pcfg.Config(ts_interval_s=0.01, ts_window=8, health_windows=1)
    phealth.configure(cfg)
    store = pts.ensure_started(cfg)
    assert pts.ensure_started(cfg) is store        # idempotent
    seen = []
    monkeypatch.setattr(phealth, "evaluate", lambda s: seen.append(s))
    for _ in range(500):
        if len(store.points()) >= 2 and seen:
            break
        torch.ones(1).add_(1)
        time.sleep(0.01)
    assert len(store.points()) >= 2 and seen[0] is store


# ----------------------------------------------------------- lock witness

def sc_lock_witness(ns):
    lw = ns.lw
    lw._force_for_tests(True)
    lw.reset_witness_for_tests()
    a, b = lw.named_lock("pa"), lw.named_lock("pb")
    r = lw.named_lock("pr", reentrant=True)
    with a:
        with b:
            pass
    with r:
        with a:
            with r:
                pass
    with b:
        assert a.acquire(blocking=False)     # try-acquire: no check
        a.release()
    err = None
    try:
        with b:
            with a:
                pass
    except lw.LockOrderError as e:
        err = str(e).replace(ns.lw.__file__, "<lw>")
    edges = sorted(lw.witness_edges())
    lw._force_for_tests(False)
    plain = type(lw.named_lock("x")).__name__
    return err, edges, repr(a), plain


def test_lock_witness_matches_reference():
    got = both(sc_lock_witness)
    assert got["port"] == got["jax"]
    assert got["port"][0].startswith("lock-order cycle: acquiring 'pa'")


@pytest.mark.parametrize("name,reentrant", [
    ("metrics.registry", False), ("scheduler.cv", True), ("planner", False),
    ("kvstore", False), ("flight_recorder", True)])
def test_witnessed_sites_carry_the_reference_names(name, reentrant):
    """The port builds each of these locks with ``named_lock`` under the
    JAX name: armed, a construction records the name."""
    import byteps_tpu_torch.common.scheduler as sched
    import byteps_tpu_torch.server.kv_store as kv
    plw._force_for_tests(True)
    built = []
    real = plw.named_lock

    def spy(n, reentrant=False):
        built.append((n, reentrant))
        return real(n, reentrant)

    for mod in (sched, kv, pmetrics, pflight):
        mod.named_lock = spy
    try:
        sched.ChunkScheduler()
        sched.ChunkPlanner(pcfg.Config())
        kv.KVStore(device="cpu")
        pmetrics.MetricsRegistry()
        pflight.FlightRecorder()
    finally:
        for mod in (sched, kv, pmetrics, pflight):
            mod.named_lock = real
    assert (name, reentrant) in built


def test_engine_runs_clean_under_the_witness():
    """An engine with ``lock_witness=True`` (its scheduler, planner and
    flight recorder locks witnessed) through grouped pushes, a sharded
    update with a codec, a store and a server engine: no
    LockOrderError."""
    api.init(pcfg.Config(lock_witness=True, sharded_update=True,
                         sharded_param_codec="onebit", min_compress_bytes=0,
                         use_native=False), device="cpu")
    try:
        eng = api.engine()
        assert isinstance(eng.planner._lock, plw._WitnessLock)
        assert isinstance(eng.scheduler._cv._lock, plw._WitnessLock)
        api.declare_update("u", (4000,), torch.float32,
                           optimizer=(torch.optim.SGD, {"lr": 0.1}))
        store = pserver.KVStore(device="cpu")
        se = pserver.ServerEngine(2, device="cpu")
        try:
            for s in range(3):
                hs = [api.push_pull_async(torch.ones(64) * s, f"t{i}")
                      for i in range(6)]
                api.push_pull_update(torch.ones(4000), "u")
                for h in hs:
                    h.wait()
                store.init_key("k", torch.zeros(8)) if s == 0 else None
                store.push_delta("k", torch.ones(8), worker_id=0, seq=s)
                se.push("m", torch.ones(8), 0, 1)
                se.pull("m", timeout=10)
        finally:
            se.shutdown()
    finally:
        api.shutdown()


# ---------------------------------------------------------- flight recorder

def sc_flight(ns, tmp_path):
    rec = ns.flight.FlightRecorder(capacity=16)
    ns.tracing.note_step(7)
    for i in range(20):
        rec.record("engine.dispatch_failed", tensor=f"t{i}", error="x")
    rec.record("step_stats", step=3, wall_ms=1.5)
    path = rec.dump("quarantine", path=str(tmp_path / f"{id(ns)}.json"))
    with open(path) as f:
        doc = json.load(f)
    drop = ("t", "mono")
    events = [{k: v for k, v in e.items() if k not in drop}
              for e in doc["events"]]
    ns.cfg.set_config(ns.cfg.Config(flight_dump_on_exit=True,
                                     flight_dir=str(tmp_path / "exit")))
    rec.configure(out_dir=str(tmp_path / "exit"))
    first = rec.maybe_exit_dump() is not None
    second = rec.maybe_exit_dump()
    rec.configure(enabled=False)
    return (doc["reason"], doc["capacity"], events, len(rec), first,
            second, rec.dump("x"))


def test_flight_recorder_matches_reference(tmp_path):
    got = both(sc_flight, tmp_path)
    assert got["port"] == got["jax"]
    assert len(got["port"][2]) == 16


def test_injector_flight_events_match_reference():
    """A seeded bitflip at ``kv_push`` records ``fault.bitflip`` with the
    same byte in both packages."""
    out = {}
    for name, ns in PKGS.items():
        ns.inj.arm("bitflip:site=kv_push:p=1.0", seed=7)
        try:
            for _ in range(3):
                ns.inj.corrupt("kv_push", np.arange(64, dtype=np.float32))
        finally:
            ns.inj.disarm()
        out[name] = [(e["kind"], e.get("site"), e.get("byte"))
                     for e in ns.flight.recorder.snapshot()
                     if e["kind"].startswith("fault.")]
    assert out["port"] == out["jax"] and len(out["port"]) == 3


# --------------------------------------------------------------- the seams

def sc_server_trace(ns, tmp_path, chaos):
    """A ServerEngine round under 1/1 sampling (and a bitflip at
    ``server_push`` that forces the sealed hop): the trace's event
    names, phases and tracks."""
    d = tmp_path / f"{chaos}_{id(ns)}"
    ns.tracing.set_tracer(ns.tracing.Tracer(enabled=False, sample_n=1,
                                            out_dir=str(d)))
    if chaos:
        ns.inj.arm("bitflip:site=server_push:p=0.5", seed=3)
    kw = {} if ns is PKGS["jax"] else {"device": "cpu"}
    se = ns.server.ServerEngine(1, **kw)
    try:
        for w in range(2):
            se.push("k", ns.array(np.full(8, w + 1.0, np.float32)), w, 2)
        merged = np.asarray(se.pull("k", timeout=10))
    finally:
        se.shutdown()
        ns.inj.disarm()
    store = ns.server.KVStore(**kw)
    store.init_key("kv", ns.array(np.zeros(4, np.float32)))
    store.push_delta("kv", ns.array(np.ones(4, np.float32)), worker_id=1,
                     seq=0)
    with open(ns.tracing.tracer().flush()) as f:
        doc = json.load(f)
    names = {m["tid"]: m["args"]["name"] for m in doc["traceEvents"]
             if m["ph"] == "M"}
    evs = sorted((e["name"], e["ph"], names[e["tid"]])
                 for e in doc["traceEvents"] if e["ph"] != "M")
    wire = ns.tel.attribution.totals().get("wire", 0.0) > 0
    merge = ns.tel.attribution.totals().get("merge", 0.0) > 0
    return merged.tolist(), evs, wire, merge


@pytest.mark.parametrize("chaos", [False, True])
def test_server_and_store_trace_match_reference(tmp_path, chaos):
    got = both(sc_server_trace, tmp_path, chaos)
    assert got["port"] == got["jax"]
    evs = got["port"][1]
    assert ["server.merge", "X", "server/k"] in evs
    assert ["bps_flow", "f", "server/k"] in evs
    assert ["kv.push", "X", "kv/kv"] in evs
    if chaos:
        assert ["wire:server_push", "X", "wire/server_push"] in evs


def test_quarantine_dumps_the_flight_recorder(tmp_path):
    out = {}
    for name, ns in PKGS.items():
        d = tmp_path / name
        ns.cfg.set_config(ns.cfg.Config(nonfinite_policy="skip",
                                         flight_dir=str(d)))
        ns.flight.recorder.configure(out_dir=str(d))
        kw = {} if name == "jax" else {"device": "cpu"}
        se = ns.server.ServerEngine(1, **kw)
        try:
            se.push("q", ns.array(np.ones(4, np.float32)), 0, 2)
            se.push("q", ns.array(np.full(4, np.nan, np.float32)), 1, 2)
        finally:
            se.shutdown()
        files = sorted(p.name for p in d.iterdir())
        with open(d / files[0]) as f:
            doc = json.load(f)
        out[name] = (len(files), doc["reason"],
                     [e["kind"] for e in doc["events"]])
    assert out["port"] == out["jax"]
    assert "quarantine" in out["port"][2]


# ------------------------------------------------------------- obs server

def _get(port, route):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{route}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _families(text):
    return sorted(line.split()[2] for line in text.splitlines()
                  if line.startswith("# TYPE"))


def _feed(ns):
    ns.tel.counters.inc("compression.param_wire_bytes", 516)
    ns.tel.counters.inc("wire_bytes", 100, leg="push")
    ns.tel.counters.inc("integrity.retransmit", 2)
    ns.tel.gauges.set("step.attrib_wire_ms", 1.5)
    ns.tel.gauges.set("step.attrib_other_ms", 0.5)
    ns.tel.histograms.observe("engine.unit_sync_ms", 3.0)


def test_metrics_endpoint_names_match_reference():
    """The same feed through both registries: the port's ``/metrics``
    (served on port 0) names the JAX exposition's families."""
    for ns in PKGS.values():
        _feed(ns)
    srv = pobs.ensure_started(pcfg.Config(obs_port=0))
    status, text = _get(srv.port, "/metrics")
    assert status == 200
    fams = _families(text)
    jobs._refresh_live_gauges()       # the JAX scrape's live gauges
    assert fams == _families(jmetrics.registry.render_prometheus())
    assert "byteps_compression_param_wire_bytes_total" in fams
    assert "byteps_step_attrib_wire_ms" in fams


def test_endpoint_routes_over_http(tmp_path):
    """An engine with telemetry, sampling and the endpoint on port 0:
    ``/metrics`` carries the attribution gauges, ``/healthz`` answers 200
    and then 503 while a rule fires, ``/debug/state`` has its ``trace``
    section, the serving, tier, reconciler and journal sections, and an
    empty omitted list (every plane is ported), ``/timeseries`` has
    points."""
    cfg = pcfg.Config(obs_port=0, ts_interval_s=0.01, health_windows=1,
                      trace_sample="1/1", trace_dir=str(tmp_path))
    api.init(cfg, device="cpu")
    try:
        port = pobs.get_server().port
        for s in range(4):
            api.push_pull(torch.ones(256) * s, "g")
        status, text = _get(port, "/metrics")
        assert status == 200 and "byteps_step_attrib_other_ms" in text
        status, body = _get(port, "/healthz")
        assert status == 200 and json.loads(body)["engine_running"]
        dbg = json.loads(_get(port, "/debug/state")[1])
        assert dbg["trace"]["sample_n"] == 1
        assert "membership" not in dbg["omitted"]
        assert dbg["omitted"] == []
        # every registered component of each plane (none is built here;
        # an earlier test's may still be alive in this process)
        for section in ("serving_planes", "serving_tier", "reconciler",
                        "wal"):
            assert isinstance(dbg[section], list), section
        assert dbg["engine"]["step"]["step"] >= 1
        for _ in range(500):
            doc = json.loads(_get(port, "/timeseries")[1])
            if doc["len"] >= 2:
                break
            time.sleep(0.01)
        assert doc["len"] >= 2
        # a breaching series fires its rule at the sampler's next tick
        # (health_windows=1) and degrades /healthz: the sampler refreshes
        # slow_score from the slowness tracker, where peer 2 is a
        # straggler beside two healthy peers
        from byteps_tpu_torch.utils import slowness as pslowness
        for _ in range(20):
            for peer, lat in ((0, 0.010), (1, 0.011), (2, 0.350)):
                pslowness.tracker().observe(peer, lat, site="probe")
        for _ in range(1000):
            status, body = _get(port, "/healthz")
            if status == 503:
                break
            time.sleep(0.01)
        assert status == 503 and json.loads(body)["alerts"] == ["slow_peer"]
    finally:
        api.shutdown()


def test_metrics_snapshot_keys_match_reference():
    api.init(pcfg.Config(), device="cpu")
    try:
        api.push_pull(torch.ones(16), "g")
        api.push_pull(torch.ones(16), "g")
        snap = api.metrics_snapshot()
        light = api.metrics_snapshot(light=True)
    finally:
        api.shutdown()
    # the JAX snapshot's keys
    assert set(snap) == {"ts", "pid", "rank", "epoch", "counters", "gauges",
                         "histograms", "slowness", "speed_mbps",
                         "sched_pending", "bytes_in_flight", "step",
                         "planner"}
    assert set(snap) - set(light) == {"histograms", "slowness", "planner"}
    # the engine's sync loop fed this process's own rank at "sync"
    assert snap["slowness"]["sync"][0]["n"] >= 2
    assert snap["step"]["step"] == 1 and snap["step"]["pushes"] == 1


def test_init_starts_and_shutdown_keeps_the_plane(tmp_path):
    cfg = pcfg.Config(flight_dir=str(tmp_path), flight_dump_on_exit=True,
                      ts_interval_s=5.0)
    api.init(cfg, device="cpu")
    assert pflight.recorder._out_dir == str(tmp_path)
    assert pts.get_store() is not None and phealth.get_engine() is not None
    assert pcfg.get_config() is cfg
    api.push_pull(torch.ones(4), "g")
    api.shutdown()
    kinds = [e["kind"] for e in pflight.recorder.snapshot()]
    assert kinds[0] == "engine.init" and kinds[-1] == "engine.shutdown"
    assert "step_stats" in kinds
    dumps = list(tmp_path.iterdir())
    assert len(dumps) == 1 and "_exit_" in dumps[0].name
    assert pts.get_store() is not None     # process-lifetime


def test_timer_and_throughput():
    t = ptiming.Timer()
    with t:
        x = torch.ones(8) * 2
    assert t.elapsed >= 0
    assert t.stop(block_on={"a": [x]}) >= 0
    calls = []
    rate = ptiming.throughput(lambda: calls.append(1) or torch.ones(2),
                              steps=3, items_per_step=10, warmup=2)
    assert len(calls) == 5 and rate > 0


def _gauge_lines(text, family):
    """``{labels: value}`` of a labelled gauge family in an exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{"):
            labels, value = line[len(family):].rsplit(" ", 1)
            out[labels] = float(value)
    return out


def test_live_engine_publishes_compression_gauges_at_scrape():
    """A CPU engine pushing with onebit + error feedback: a scrape of
    ``/metrics`` reads ``compression.active{tensor,codec}`` at 1 and a
    nonzero ``compression.ef_norm{tensor}``, refreshed from the engine's
    own compressor state (nothing here sets a gauge)."""
    cfg = pcfg.Config(obs_port=0, min_compress_bytes=0)
    api.init(cfg, device="cpu")
    try:
        port = pobs.get_server().port
        kw = {"compressor": "onebit", "ef": "vanilla"}
        g = torch.Generator().manual_seed(0)
        for _ in range(3):
            api.push_pull(torch.randn(4096, generator=g), "w",
                          compression=kw)
            api.push_pull(torch.randn(64, generator=g), "b")
        status, text = _get(port, "/metrics")
        assert status == 200
        active = _gauge_lines(text, "byteps_compression_active")
        assert active == {'{codec="onebit",tensor="w"}': 1.0}
        norms = _gauge_lines(text, "byteps_compression_ef_norm")
        assert list(norms) == ['{tensor="w"}'] and norms['{tensor="w"}'] > 0
        # the residual's own L2 norm, read from the engine's slots
        eng = api.engine()
        want = sum(float(e.square().sum())
                   for s in eng.registry.get("w").compressor
                   for e in eng._ef_error_leaves(s.wstate)) ** 0.5
        assert norms['{tensor="w"}'] == pytest.approx(want, rel=1e-6)
    finally:
        api.shutdown()


def test_retuned_codec_series_reads_zero():
    """After the tensor's codec is swapped (the compressor ladder's
    retune, between pushes), the retired codec's series reads 0 and the
    new one 1."""
    cfg = pcfg.Config(obs_port=0, min_compress_bytes=0)
    api.init(cfg, device="cpu")
    try:
        port = pobs.get_server().port
        x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
        api.push_pull(x, "w", compression={"compressor": "onebit",
                                            "ef": "vanilla"})
        assert _gauge_lines(_get(port, "/metrics")[1],
                            "byteps_compression_active") == {
            '{codec="onebit",tensor="w"}': 1.0}
        eng = api.engine()
        ctx = eng.registry.get("w")
        with ctx.lock:
            assert ctx.inflight == 0
            eng.registry.retune_compression_locked(
                ctx, {"compressor": "topk", "k": "0.01", "ef": "vanilla"},
                ctx.partition_bytes)
        api.push_pull(x, "w")
        assert _gauge_lines(_get(port, "/metrics")[1],
                            "byteps_compression_active") == {
            '{codec="onebit",tensor="w"}': 0.0,
            '{codec="topk",tensor="w"}': 1.0}
    finally:
        api.shutdown()
