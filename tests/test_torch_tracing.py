"""The port's tracer (``byteps_tpu_torch/common/tracing.py``) and its
``bps_trace`` copy against the JAX package's on the same inputs.

Each scenario drives one package's ``tracing`` module and returns what
an observer sees (the flushed trace document, the capture decisions,
the counters); both packages must give the same result.  Trace ids fold
a process counter into their low bits, so they are renamed by order of
first appearance before the comparison; the ``monoAnchor`` clock pair is
the only field left out (it is read from the clocks).  Then the port's
engine on the CPU: its trace of a traced run passes the ``--validate``
of both ``tools/bps_trace.py`` and the port's copy.  No test here reads
a wall-clock threshold.
"""

import importlib.util
import json
import os
import threading

import pytest
import torch

from byteps_tpu.common import config as jax_config
from byteps_tpu.common import telemetry as jax_telemetry
from byteps_tpu.common import tracing as jax_tracing

from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import telemetry as port_telemetry
from byteps_tpu_torch.common import tracing as port_tracing
from byteps_tpu_torch.core import api
from byteps_tpu_torch.tools import bps_trace as port_bps_trace

from .torch_obs_common import fresh_port_plane  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jax_tracing, jax_config, jax_telemetry),
        "port": (port_tracing, port_config, port_telemetry)}


def _jax_bps_trace():
    spec = importlib.util.spec_from_file_location(
        "jax_bps_trace", os.path.join(REPO, "tools", "bps_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path):
    with open(path) as f:
        return json.load(f)


def _normalize(obj, ids=None):
    """Rename trace/flow ids by first appearance; drop the clock anchor."""
    ids = {} if ids is None else ids
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "monoAnchor":
                continue
            if k in ("id", "trace_id") and isinstance(v, int) and v:
                v = ids.setdefault(v, f"T{len(ids)}")
            out[k] = _normalize(v, ids)
        return out
    if isinstance(obj, list):
        return [_normalize(v, ids) for v in obj]
    return obj


# ------------------------------------------------------------- scenarios

def sc_window_gating(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=True, start_step=2, end_step=3, out_dir=d)
    for step in (1, 2, 3, 4):
        tr.record("g", 7, "push_pull", 1.0, 2.0, step, nbytes=64)
    return _read(tr.flush(path=os.path.join(d, "win.json")))


def sc_on_push_and_window_flush(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=True, start_step=1, end_step=2, out_dir=d)
    steps = [tr.on_push("a"), tr.on_push("b"), tr.on_push("a")]
    tr.record("a", 0, "push_pull", 0.0, 1.0, 2)
    steps.append(tr.on_push("a"))         # past the window: flushes
    return steps, sorted(os.listdir(d))


def sc_disabled(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=False, out_dir=d)
    tr.record("g", 0, "push_pull", 0.0, 1.0, 15)
    tr.record_span("fault", 0.0, 1.0)
    return tr.active, tr.flush()


def sc_flush_idempotent(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=True, start_step=1, end_step=99, out_dir=d)
    tr.record("g", 0, "queued", 0.0, 1.0, 1)
    p1 = tr.flush()
    again = tr.flush()
    tr.record("g", 0, "queued", 1.0, 2.0, 2)
    p2 = tr.flush()
    return os.path.basename(p1), again, p1 == p2, _read(p2)


def sc_record_span_and_tids(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=True, start_step=10, end_step=20, out_dir=d)
    tr.record_span("recovery", 5.0, 6.0, epoch=3)
    tr.record("tensor.a", 0, "queued", 0.0, 1.0, 12)
    tr.record("tensor.b", 1, "queued", 0.0, 1.0, 12)
    return _read(tr.flush())


def sc_merge_metadata(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=True, start_step=1, end_step=9, out_dir=d)
    mod.set_clock_offset(0.012, 0.001, source="bus test")
    tr.record("g", 0, "queued", 0.0, 1.0, 1)
    doc = _read(tr.flush())
    return doc, sorted(doc["monoAnchor"])


def sc_sampling(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=False, sample_n=3, out_dir=d)
    caught = [tr.start_push("g") for _ in range(9)]
    stamp = mod.last_stamp()
    tr.record("g", 0, "push_pull", 0.0, 1.0, 1)   # window-gated: nothing
    tr.record_traced(caught[2][1].trace_id, "push_pull", "g", 0.0, 1.0,
                     key=3)
    sites = [tr.maybe_sample(s) is not None
             for s in ("serve", "kv", "serve", "kv", "serve", "serve")]
    return ([(s, c is not None and c.sampled) for s, c in caught],
            stamp[0], sites, _read(tr.flush()))


def sc_window_maybe_sample(mod, cfg, tel, d):
    tw = mod.Tracer(enabled=True, start_step=2, end_step=3, sample_n=0,
                    out_dir=d)
    seen = [tw.maybe_sample("serve") is not None]
    for _ in range(4):
        step, ctx = tw.start_push("g")
        seen.append((step, ctx is not None,
                     tw.maybe_sample("serve") is not None))
    return seen


def sc_flows(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=False, sample_n=1, out_dir=d)
    _, ctx = tr.start_push("g")
    tr.record_traced(ctx.trace_id, "queued", "g", 1.0, 2.0, key=1)
    tr.flow(ctx.trace_id, "s", "g", 1.0)
    tr.flow(ctx.trace_id, "t", "wire/server_push", 2.5)
    tr.flow(ctx.trace_id, "f", "g", 3.0)
    return _read(tr.flush()), mod.FLOW_NAME, mod.FLOW_CAT


def sc_spill(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=True, start_step=1, end_step=10 ** 9,
                    out_dir=d, capacity=256)
    for i in range(1000):
        tr.record("g", 0, "queued", float(i), float(i) + 0.5, 1)
    mem, spilled, dropped = len(tr._events), tr._spill_count, tr.dropped
    files = sorted(os.listdir(d))
    return mem, spilled, dropped, files, _read(tr.flush())


def sc_step_map_bound(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=False, sample_n=1, out_dir=d)
    tr._MAX_TENSORS = 4
    for i in range(8):
        tr.start_push(f"t{i}")
    before = tel.counters.get("trace.events_dropped")
    step, ctx = tr.start_push("t7")
    return (len(tr._step), step, ctx, tr.dropped,
            tel.counters.get("trace.events_dropped") - before)


def sc_debug_state(mod, cfg, tel, d):
    tr = mod.Tracer(enabled=False, sample_n=4, out_dir=d, capacity=300)
    tr.start_push("g")
    return tr.debug_state()


def sc_context(mod, cfg, tel, d):
    mod.set_tracer(mod.Tracer(enabled=False, sample_n=1, out_dir=d))
    outer = mod.TraceContext(trace_id=7)
    seen = []
    with mod.use(outer):
        inner, _ = mod.begin_sample("kv.push")
        t = threading.Thread(target=lambda: seen.append(mod.current()))
        t.start()
        t.join()
    fresh, _ = mod.begin_sample("kv.push")
    return inner is outer, seen, mod.current(), fresh.trace_id != 7


def sc_config(mod, cfg, tel, d):
    out = [cfg.Config(trace_sample=s).trace_sample_n
           for s in ("1/8", "8", "0", "")]
    with pytest.raises(ValueError) as e:
        cfg.Config(trace_sample="every-other")
    out.append(str(e.value))
    for bad in (dict(trace_capacity=10), dict(obs_port=70000),
                dict(ts_window=4), dict(health_skew_ratio=1.0),
                dict(flight_capacity=0), dict(health_overlap_floor=2.0)):
        with pytest.raises(ValueError) as e:
            cfg.Config(**bad)
        out.append(str(e.value))
    c = cfg.Config()
    out.append({k: getattr(c, k) for k in (
        "trace_on", "trace_start_step", "trace_end_step", "trace_jax",
        "trace_sample_n", "trace_capacity", "telemetry_on", "obs_port",
        "obs_host", "flight_recorder_on", "flight_capacity",
        "flight_dump_on_exit", "ts_on", "ts_interval_s", "ts_window",
        "health_on", "health_windows", "health_overlap_floor",
        "health_burn_rate", "health_skew_ratio", "lock_witness")})
    return out


SCENARIOS = [sc_window_gating, sc_on_push_and_window_flush, sc_disabled,
             sc_flush_idempotent, sc_record_span_and_tids,
             sc_merge_metadata, sc_sampling, sc_window_maybe_sample,
             sc_flows, sc_spill, sc_step_map_bound, sc_debug_state,
             sc_context, sc_config]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_tracer_matches_reference(tmp_path, scenario):
    got = {}
    for name, (mod, cfg, tel) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        mod._reset_for_tests()
        got[name] = _normalize(json.loads(json.dumps(
            scenario(mod, cfg, tel, str(d)), default=repr)))
        mod._reset_for_tests()
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("var,field,value,want", [
    ("BYTEPS_TRACE_ON", "trace_on", "1", True),
    ("BYTEPS_TRACE_SAMPLE", "trace_sample_n", "1/4", 4),
    ("BYTEPS_TRACE_CAPACITY", "trace_capacity", "1024", 1024),
    ("BYTEPS_TRACE_JAX", "trace_jax", "1", True),
    ("BYTEPS_OBS_PORT", "obs_port", "0", 0),
    ("BYTEPS_TS_INTERVAL_S", "ts_interval_s", "0.25", 0.25),
    ("BYTEPS_HEALTH_WINDOWS", "health_windows", "5", 5),
    ("BYTEPS_FLIGHT_DUMP_ON_EXIT", "flight_dump_on_exit", "1", True),
    ("BYTEPS_LOCK_WITNESS", "lock_witness", "1", True),
])
def test_env_vars_match_reference(monkeypatch, var, field, value, want):
    monkeypatch.setenv(var, value)
    assert getattr(port_config.Config.from_env(), field) == want
    assert getattr(jax_config.Config.from_env(), field) == want


def test_trace_and_flight_dirs_default_outside_the_working_tree(
        monkeypatch):
    for var in ("BYTEPS_TRACE_DIR", "BYTEPS_FLIGHT_DIR"):
        monkeypatch.setenv(var, "")
    assert (port_config.trace_dir_from_env()
            == jax_config.trace_dir_from_env())
    assert (port_config.flight_dir_from_env()
            == jax_config.flight_dir_from_env())
    assert not port_config.trace_dir_from_env().startswith(os.getcwd())


def test_device_profiler_window(tmp_path):
    """``trace_jax``: torch.profiler opens at the window's first step and
    closes past its end (start and stop on the profiler's own thread),
    writing a Chrome trace under ``<trace_dir>/torch_profile``; a later
    start is a no-op, as the JAX state machine's ``done``."""
    port_config.set_config(port_config.Config(
        trace_on=True, trace_jax=True, trace_start_step=2, trace_end_step=3,
        trace_dir=str(tmp_path)))
    tr = port_tracing.Tracer()
    states = []
    for _ in range(4):
        tr.on_push("g")
        torch.ones(64).add_(1.0)
        states.append(tr._jax_state)
    assert states == ["idle", "running", "running", "done"]
    doc = _read(tr.profile_path)
    assert os.path.dirname(tr.profile_path) == str(tmp_path / "torch_profile")
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])
    tr._jax_start()
    assert tr._jax_state == "done"


def test_device_profiler_is_inert_without_the_window(tmp_path):
    port_config.set_config(port_config.Config(
        trace_on=False, trace_jax=True, trace_dir=str(tmp_path)))
    tr = port_tracing.Tracer()
    for _ in range(3):
        tr.on_push("g")
    assert tr._jax_state == "idle" and tr.profile_path is None


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("mode", ["window", "sampled"])
def test_engine_trace_validates_under_both_tools(tmp_path, mode):
    """A traced port engine run on the CPU (3 tensors, one multi-chunk, 4
    steps): every captured chunk has its ``queued`` and ``push_pull``
    spans, every push one ``s``/``f`` flow pair, and both ``bps_trace``
    tools validate the flushed file with 0 errors and the same
    summary."""
    d = tmp_path / "trace"
    kw = (dict(trace_on=True, trace_start_step=2, trace_end_step=3)
          if mode == "window" else dict(trace_sample="1/1"))
    api.init(port_config.Config(partition_bytes=4096, trace_dir=str(d),
                                **kw), device="cpu")
    try:
        shapes = {"w": (3000,), "b": (37,), "e": (64, 8)}
        for s in range(4):
            hs = [api.push_pull_async(torch.full(shp, float(s)), name)
                  for name, shp in shapes.items()]
            for h in hs:
                h.wait()
    finally:
        api.shutdown()
    files = [f for f in os.listdir(d) if f.startswith("bps_trace_rank")]
    assert len(files) == 1
    doc = _read(d / files[0])
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    names = {m["tid"]: m["args"]["name"] for m in doc["traceEvents"]
             if m.get("ph") == "M"}
    steps = (2, 3) if mode == "window" else (1, 2, 3, 4)
    chunks = {"w": 3, "b": 1, "e": 1}
    for step in steps:
        for t, n in chunks.items():
            for kind in ("queued", "push_pull"):
                got = [e for e in spans if e["name"] == kind
                       and names[e["tid"]] == t
                       and e["args"]["step"] == step]
                assert len(got) == n, (step, t, kind)
    flows = [e for e in doc["traceEvents"] if e.get("ph") in ("s", "f")]
    by_id = {}
    for e in flows:
        by_id.setdefault(e["id"], []).append(e["ph"])
    assert len(by_id) == len(steps) * len(chunks)
    assert all(sorted(v) == ["f", "s"] for v in by_id.values())
    out = {}
    for tag, tool in (("jax", _jax_bps_trace()), ("port", port_bps_trace)):
        merged = tool.merge(tool.load_trace_files(str(d)))
        assert tool.validate(merged) == []
        out[tag] = tool.summarize(merged)
    assert out["jax"] == out["port"]
    assert port_bps_trace.main(["--dir", str(d), "--validate"]) == 0


def test_tracing_off_takes_no_tracer_lock(monkeypatch):
    """With tracing off, enqueue never calls into the tracer (the JAX
    engine's lock-free hot path)."""
    api.init(port_config.Config(), device="cpu")
    try:
        eng = api.engine()
        assert not eng.tracer.active
        monkeypatch.setattr(eng.tracer, "start_push", lambda *a: (
            _ for _ in ()).throw(AssertionError("tracer on the hot path")))
        api.push_pull(torch.ones(8), "x")
    finally:
        api.shutdown()
