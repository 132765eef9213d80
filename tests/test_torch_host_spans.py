"""The host path's counters and spans: ``engine.stats``' cumulative ms of
each step of a gradient's path (enqueue, queue, dispatch, the codecs'
dispatch, sync, assemble, and ``DistributedOptimizer``'s wait and
update), and the ``bps.*`` spans at the same sites, in
``torch.profiler`` and in the comm trace.  On the CPU, with no
wall-clock threshold."""

import importlib.util
import json
import os
import threading
import time

import pytest
import torch

from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.common import tracing as port_tracing
from byteps_tpu_torch.core import api
from byteps_tpu_torch.tools import bps_trace as port_bps_trace
import byteps_tpu_torch.torch as bps

from .torch_obs_common import fresh_port_plane  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("enqueue_ms", "queue_ms", "dispatch_ms", "codec_dispatch_ms",
        "sync_ms", "assemble_ms", "wait_ms", "update_ms")
ENGINE_SPANS = ("bps.dispatch", "bps.sync", "bps.assemble")


def _model():
    """Two layers: the first weight (32 KiB) is the one tensor at or
    over ``min_compress_bytes``, so onebit carries it alone."""
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.ReLU(),
                               torch.nn.Linear(128, 10))


def _config(**kw):
    return port_config.Config(partition_bytes=8192, min_compress_bytes=16384,
                              **kw)


def _optimizer(model):
    return bps.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        compression={"compressor": "onebit", "ef": "vanilla"})


def _train(model, opt, steps, label=None):
    """``steps`` closed-loop steps; the host seconds of the ``step()``
    calls.  ``label`` wraps each step in a ``record_function``."""
    from torch.profiler import record_function
    host = 0.0
    for i in range(steps):
        g = torch.Generator().manual_seed(i)
        x = torch.randn(8, 64, generator=g)
        ctx = record_function(label) if label else None
        if ctx is not None:
            ctx.__enter__()
        opt.zero_grad()
        model(x).square().mean().backward()
        t0 = time.monotonic()
        opt.step()
        host += time.monotonic() - t0
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return host


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_every_host_path_counter_grows_over_three_steps():
    api.init(_config(), device="cpu")
    try:
        eng = api.engine()
        model = _model()
        opt = _optimizer(model)
        before = dict(eng.stats)
        host_s = _train(model, opt, 3)
        d = {k: eng.stats[k] - before[k] for k in KEYS}
        codec_tensors = [n for n in eng.registry.names_in_declaration_order()
                         if eng.registry.get(n).compressor]
    finally:
        api.shutdown()
    assert codec_tensors == ["torch.grad.0.weight"]
    for k in KEYS:
        assert d[k] > 0, (k, d)
    assert d["codec_dispatch_ms"] <= d["dispatch_ms"]
    assert d["wait_ms"] + d["update_ms"] <= host_s * 1e3


class _RaisingLock:
    def __enter__(self):
        raise AssertionError("the tracer's lock on the host path")

    def __exit__(self, *exc):
        return False


def test_with_the_profiler_and_tracer_off_no_span_opens(monkeypatch):
    """No ``record_function`` is entered and no tracer lock is taken:
    either would raise inside a step."""
    def refuse(*a, **kw):
        raise AssertionError("record_function with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(port_tracing, "record_function", refuse)
    api.init(_config(), device="cpu")
    try:
        eng = api.engine()
        assert not eng.tracer.active
        model = _model()
        opt = _optimizer(model)
        lock, eng.tracer._lock = eng.tracer._lock, _RaisingLock()
        try:
            before = dict(eng.stats)
            _train(model, opt, 3)
        finally:
            eng.tracer._lock = lock
        assert eng.stats["wait_ms"] > before["wait_ms"]
    finally:
        api.shutdown()


def _nested(e, outer):
    return any(o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
               for o in outer)


def test_the_device_profiler_holds_every_threads_spans(tmp_path):
    """Under the program's device profiler the stepping thread's
    ``bps.wait`` and ``bps.update`` and the engine threads'
    ``bps.dispatch``, ``bps.sync`` and ``bps.assemble`` land in one
    trace, inside the step's outer range."""
    api.init(_config(trace_on=True, trace_jax=True, trace_start_step=2,
                     trace_end_step=3, trace_dir=str(tmp_path)),
             device="cpu")
    try:
        model = _model()
        opt = _optimizer(model)
        _train(model, opt, 5, label="test.step")
        path = api.engine().tracer.profile_path
    finally:
        api.shutdown()
    doc = _read(path)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    steps = [e for e in xs if e["name"] == "test.step"]
    assert steps
    me = steps[0]["tid"]
    for name in ("bps.wait", "bps.update"):
        got = [e for e in xs if e["name"] == name and e["tid"] == me]
        assert got and any(_nested(e, steps) for e in got), name
    for name in ENGINE_SPANS:
        got = [e for e in xs if e["name"] == name]
        assert got and all(e["tid"] != me for e in got), name
        assert any(_nested(e, steps) for e in got), name
    # the hooks' pushes run on the stepping thread on the CPU
    assert any(e["name"] == "bps.enqueue" and e["tid"] == me for e in xs)
    assert not port_tracing._all_threads


def test_a_captured_runs_comm_trace_holds_the_engine_threads_spans(tmp_path):
    d = tmp_path / "trace"
    api.init(_config(trace_on=True, trace_start_step=2, trace_end_step=3,
                     trace_dir=str(d)), device="cpu")
    try:
        model = _model()
        opt = _optimizer(model)
        _train(model, opt, 4)
    finally:
        api.shutdown()
    files = [f for f in os.listdir(d) if f.startswith("bps_trace_rank")]
    assert len(files) == 1
    doc = _read(d / files[0])
    names = {m["tid"]: m["args"]["name"] for m in doc["traceEvents"]
             if m.get("ph") == "M"}
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    tracks = {"bps.dispatch": "bps-dispatch", "bps.sync": "bps-sync",
              "bps.assemble": "bps-sync"}
    for name, track in tracks.items():
        got = [e for e in spans if e["name"] == name]
        assert got, name
        assert all(names[e["tid"]] == track and e["args"]["trace_id"]
                   for e in got), name
    codecs = {e["args"]["codec"] for e in spans
              if e["name"] == "bps.dispatch"}
    assert codecs == {"onebit", "none"}
    spec = importlib.util.spec_from_file_location(
        "jax_bps_trace", os.path.join(REPO, "tools", "bps_trace.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    for tool in (jax_tool, port_bps_trace):
        merged = tool.merge(tool.load_trace_files(str(d)))
        assert tool.validate(merged) == []
        assert tool.main(["--dir", str(d), "--validate"]) == 0


@pytest.mark.parametrize("engine", [False, True], ids=["caller", "engine"])
def test_a_thread_profiler_records_only_the_calling_threads_spans(engine):
    """Under a thread-local ``torch.profiler`` a caller's span opens and
    an engine thread's does not; with no profiler neither does."""
    from torch.profiler import ProfilerActivity, profile
    assert port_tracing.span_begin("bps.wait", engine=engine) is None
    got = []
    with profile(activities=[ProfilerActivity.CPU]):
        rf = port_tracing.span_begin("bps.wait", engine=engine)
        got.append(rf is not None)
        port_tracing.span_end(rf)
        t = threading.Thread(target=lambda: got.append(
            port_tracing.span_begin("bps.sync", engine=True)))
        t.start()
        t.join()
    assert got == [not engine, None]
