"""The port's ``bps_doctor`` (``byteps_tpu_torch/tools/bps_doctor.py``):
the JAX package's cases of ``tests/test_doctor_chaos.py`` (sparklines,
firing rules from the alert gauges, the dominant attribution, the live
verdict over a synthetic ``cluster_metrics`` reply, the postmortem over
synthetic dumps, windows and a merged trace, the CLI's exit codes, and
the 3-process straggler run on ``tests/torch_elastic_worker.py``: the
victim's ``/healthz`` goes 503 and back, ``cluster_metrics()`` carries
the history over the port's bus, and the postmortem names rank 1 at
site ``sync``).  Each diagnosis is also held equal to the JAX tool's on
the same reply or directory."""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request

import pytest

import byteps_tpu_torch.core.api as api
from byteps_tpu_torch.tools.bps_doctor import (diagnose_live,
                                               diagnose_postmortem,
                                               dominant_attrib,
                                               firing_rules)
from byteps_tpu_torch.tools.bps_doctor import main as doctor_main
from byteps_tpu_torch.tools.bps_doctor import render_markdown, sparkline
from tools import bps_doctor as jax_doctor
from tests.test_observability import _Reader

from .torch_member_common import free_port as _free_port
from .torch_member_common import fresh_member_state, spawn  # noqa: F401


# -- pure rendering / diagnosis ---------------------------------------------


def test_doctor_sparkline_shapes():
    assert sparkline([]) == "-"
    assert sparkline([1.0, 1.0, 1.0]) == "▁▁▁"      # flat: all-min
    s = sparkline([0, 2, 4, 6, 8])
    assert s[0] == "▁" and s[-1] == "█" and len(s) == 5


def test_doctor_firing_rules_reads_alert_gauges():
    cluster = {"ranks": {
        "1": {"metrics": {"gauges": {
            'health.alerts_active{rule="overlap_floor"}': 1.0,
            'health.alerts_active{rule="slow_peer"}': 0.0,
            "step.overlap_fraction": 0.1}}},
        "0": {"metrics": {"gauges": {
            'health.alerts_active{rule="overlap_floor"}': 0.0}}},
    }}
    assert firing_rules(cluster) == {1: ["overlap_floor"]}


def test_doctor_dominant_attrib_picks_largest_mean():
    summ = {"series": {"attrib_sync": {"mean": 40.0},
                       "attrib_compute": {"mean": 9.0},
                       "overlap": {"mean": 0.5}}}
    assert dominant_attrib(summ) == {"component": "sync", "mean_ms": 40.0}
    assert dominant_attrib({"series": {}}) is None


def _synthetic_cluster():
    hist_series = lambda mean, spark: {  # noqa: E731
        "series": {"attrib_sync": {"mean": mean},
                   "overlap": {"last": 0.2, "mean": 0.4, "min": 0.1,
                               "max": 0.9, "spark": spark}}}
    return {
        "epoch": 2, "world": [0, 1, 2], "coordinator": 0,
        "slow": {"1": 9.3, "0": 0.1},
        "probation": [1],
        "ranks": {"1": {"metrics": {"gauges": {
            'health.alerts_active{rule="overlap_floor"}': 1.0}}}},
        "history": {
            "0": {"summary": hist_series(4.0, [0.9, 0.9, 0.9])},
            "1": {"summary": hist_series(120.0, [0.9, 0.4, 0.1])},
            "2": {"summary": hist_series(5.0, [0.9, 0.9, 0.9])},
        },
    }


def test_doctor_diagnose_live_names_the_culprit():
    report = diagnose_live(_synthetic_cluster(), skew_ratio=4.0)
    assert report["healthy"] is False
    assert report["alerts"] == {1: ["overlap_floor"]}
    c = report["culprit"]
    assert c["rank"] == 1 and len(c["evidence"]) >= 3
    assert any("alert overlap_floor" in e for e in c["evidence"])
    assert any("skew" in e for e in c["evidence"])
    # trends render from the piggybacked spark tails
    assert report["trends"][1]["overlap"]["spark"] != "-"
    assert report["dominant_attrib"][1]["component"] == "sync"
    md = render_markdown(report)
    assert "Culprit: rank 1" in md and "DEGRADED" in md
    json.dumps(report)  # the --json path must serialize
    # the JAX tool diagnoses the same reply to the same report and text
    jreport = jax_doctor.diagnose_live(_synthetic_cluster(), skew_ratio=4.0)
    assert jreport == report
    assert jax_doctor.render_markdown(jreport) == md


def _write_dump(dir_, rank, events, reason="exit"):
    path = os.path.join(str(dir_), "bps_flight_1_rank%d_%d_%s_%d.json"
                        % (rank, 1000 + rank, reason, len(events)))
    with open(path, "w") as f:
        json.dump({"reason": reason, "wall_time": 10.0, "pid": 1000 + rank,
                   "rank": rank, "capacity": 64, "events": events}, f)


def test_doctor_diagnose_postmortem_synthetic(tmp_path, capsys):
    _write_dump(tmp_path, 0, [
        {"t": 2.0, "mono": 2.0, "kind": "membership.world_change"}])
    _write_dump(tmp_path, 1, [
        {"t": 1.0, "mono": 1.0, "kind": "alert", "rule": "overlap_floor",
         "state": "firing", "overlap": 0.1, "floor": 0.5},
        {"t": 3.0, "mono": 3.0, "kind": "fault.slow_cleared",
         "site": "sync", "rank": 1, "n": 12},
        {"t": 5.0, "mono": 5.0, "kind": "alert", "rule": "overlap_floor",
         "state": "cleared"}])
    with open(tmp_path / "bps_timeseries_rank1.json", "w") as f:
        json.dump({"points": [{"t": 0.5, "overlap": 0.9},
                              {"t": 1.0, "overlap": 0.1},
                              {"t": 1.5, "overlap": 0.8}]}, f)
    with open(tmp_path / "bps_trace_merged.json", "w") as f:
        json.dump({"traceEvents": [
            {"ph": "M", "name": "process_name"},
            {"ph": "X", "ts": 1500.0, "name": "push"}],
            "mergedFrom": ["a.json", "b.json"]}, f)

    report = diagnose_postmortem(str(tmp_path))
    first = report["first_degradation"]
    assert first["rule"] == "overlap_floor" and first["rank"] == 1
    c = report["culprit"]
    assert c["rank"] == 1 and c["site"] == "sync"
    assert any("fault slow_cleared" in e for e in c["evidence"])
    ts = report["timeseries"]["bps_timeseries_rank1.json"]
    assert ts["len"] == 3 and ts["overlap_min"] == 0.1
    # the JAX tool reads the same directory to the same report
    assert jax_doctor.diagnose_postmortem(str(tmp_path)) == report
    assert report["trace"]["events"] == 1
    assert report["trace"]["files"] == 2
    md = render_markdown(report)
    assert "Culprit: rank 1, site sync" in md
    assert "Degraded first: rule `overlap_floor` on rank 1" in md

    # the CLI: --json emits the same document, exit 0 on a named culprit
    rc = doctor_main(["--postmortem", str(tmp_path), "--json"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["culprit"]["rank"] == 1


def test_doctor_postmortem_without_evidence_exits_nonzero(tmp_path,
                                                          capsys):
    rc = doctor_main(["--postmortem", str(tmp_path)])
    assert rc == 1
    assert "postmortem" in capsys.readouterr().out


# -- the 3-process acceptance run -------------------------------------------


def _healthz(port, timeout=5.0):
    """(status, doc) — unlike urlopen's default, a 503 is an answer
    here, not an exception."""
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_doctor_3proc_straggler_healthz_cycle_and_postmortem(tmp_path):
    """Acceptance: under ``slow:rank=1:site=sync`` (with a
    ``slow_socket`` rule armed alongside) the victim's health rules
    fire within a few sampling windows and its /healthz flips to 503
    while the survivors stay 200; cluster_metrics() carries the
    piggybacked history view; after the fault budget exhausts and K
    clean windows pass the victim recovers to 200; and the postmortem
    over the run's flight dumps + the saved /timeseries window names
    culprit rank 1 at site "sync"."""
    steps = 90
    bus_port, hb_port = _free_port(), _free_port()
    fast = {
        "BYTEPS_ELASTIC_STEP_SLEEP": "0.05",
        "BYTEPS_TS_INTERVAL_S": "1.0",       # window > one slow step
        "BYTEPS_TS_WINDOW": "64",
        "BYTEPS_HEALTH_WINDOWS": "2",
        "BYTEPS_HEALTH_OVERLAP_FLOOR": "0.5",
        "BYTEPS_FLIGHT_DUMP_ON_EXIT": "1",
    }
    spec = ("slow:rank=1:site=sync:ms=300:n=16,"
            "slow_socket:rank=1:site=transport:ms=40")
    obs = {"BYTEPS_ELASTIC_STEP_SLEEP": "0.2", "BYTEPS_OBS_PORT": "0",
           "BYTEPS_FLIGHT_DIR": str(tmp_path)}
    procs = {
        r: spawn(r, (0, 1, 2), bus_port, hb_port, steps, extra={
            **obs, **fast, **({"BYTEPS_FAULT_SPEC": spec} if r == 1
                              else {})})
        for r in (0, 1, 2)}
    readers = {r: _Reader(p) for r, p in procs.items()}
    try:
        ports = {}
        for r in (0, 1, 2):
            line = readers[r].wait_for("OBS ", timeout=120)
            ports[r] = int(line.split()[2])

        # clause 1: the victim degrades to 503 within a few windows of
        # the fault biting, and names the firing rule
        deadline = time.monotonic() + 60
        degraded = None
        while time.monotonic() < deadline and degraded is None:
            try:
                status, doc = _healthz(ports[1])
            except OSError:
                status, doc = 0, None
            if status == 503:
                degraded = doc
                break
            time.sleep(0.15)
        assert degraded is not None, \
            "rank 1 never answered 503 under the straggler fault"
        assert degraded["degraded"] is True
        assert "overlap_floor" in degraded["alerts"], degraded["alerts"]

        # rank 2 stays healthy through the victim's degradation; rank 0
        # hosts the bus, so the one rule it may legitimately fire is the
        # cluster-scoped attrib_skew — and it must name rank 1, not
        # accuse itself
        status2, doc2 = _healthz(ports[2])
        assert status2 == 200 and doc2["ok"] is True, doc2
        status0, doc0 = _healthz(ports[0])
        if status0 != 200:
            assert doc0["alerts"] == ["attrib_skew"], doc0["alerts"]
            worst = doc0["alert_details"]["attrib_skew"]["worst"]
            assert worst["rank"] == 1, worst

        # clause 2: cluster_metrics() grew the history view — windowed
        # summaries piggybacked over the bus, multiple ranks deep
        deadline = time.monotonic() + 45
        history = None
        while time.monotonic() < deadline:
            try:
                out = api.cluster_metrics(bus=f"127.0.0.1:{bus_port}",
                                          timeout=5)
            except (ConnectionError, TimeoutError, OSError):
                out = {}
            h = out.get("history") or {}
            with_overlap = {r for r, v in h.items()
                           if "overlap" in ((v.get("summary") or {})
                                            .get("series") or {})}
            if len(with_overlap) >= 2:
                history = h
                break
            time.sleep(0.3)
        assert history is not None, "history never showed 2 ranks' windows"
        summ = history[1]["summary"]
        assert summ["series"]["overlap"]["min"] < 0.5   # the collapse shows
        assert len(summ["series"]["overlap"]["spark"]) >= 1

        # save the victim's raw ring for the postmortem, while it lives
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ports[1]}/timeseries", timeout=5) as r:
            ring = json.loads(r.read().decode())
        assert ring["len"] >= 2
        (tmp_path / "bps_timeseries_rank1.json").write_text(
            json.dumps(ring))

        # clause 3: the fault budget exhausts -> K clean windows -> the
        # victim un-pages all the way back to 200
        deadline = time.monotonic() + 90
        recovered = None
        while time.monotonic() < deadline:
            try:
                status, doc = _healthz(ports[1])
            except OSError:
                break                       # the worker may have finished
            if status == 200 and doc["ok"]:
                recovered = doc
                break
            time.sleep(0.2)
        assert recovered is not None, \
            "rank 1 never recovered to 200 after the fault budget cleared"
        assert recovered["alerts"] == []

        outs = {}
        for r, p in procs.items():
            p.communicate(timeout=180)
            outs[r] = "\n".join(readers[r].lines)
        for r in (0, 1, 2):
            assert procs[r].returncode == 0, outs[r][-2000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()

    # clause 4: the postmortem correlates the exit dumps + the saved
    # window into a verdict naming the culprit rank and injection site
    dumps = list(tmp_path.glob("bps_flight_*_exit_*.json"))
    assert len(dumps) == 3, list(tmp_path.iterdir())
    report = diagnose_postmortem(str(tmp_path))
    assert jax_doctor.diagnose_postmortem(str(tmp_path)) == report
    first = report["first_degradation"]
    assert first is not None
    # whichever rule paged first, it points at the victim: either it
    # fired ON rank 1, or it is the bus host's cluster-scoped skew rule
    # whose worst-offender detail names rank 1
    assert (first["rank"] == 1
            or first["detail"].get("worst", {}).get("rank") == 1), first
    c = report["culprit"]
    assert c["rank"] == 1 and c["site"] == "sync", c
    assert any("fault slow_cleared" in e for e in c["evidence"]), c
    ts = report["timeseries"]["bps_timeseries_rank1.json"]
    assert ts["overlap_min"] is not None and ts["overlap_min"] < 0.5
    # both transitions made it into the black box
    states = {(a["rank"], a["rule"], a["state"]) for a in report["alerts"]}
    assert (1, "overlap_floor", "firing") in states
    assert (1, "overlap_floor", "cleared") in states


_TOP_DOCS = {
    "live": {"epoch": 1, "world": [1, 2], "coordinator": 1, "standby": 2,
             "ranks": {1: {"age_s": 0.2, "metrics": {
                 "epoch": 1, "speed_mbps": 12.5, "sched_pending": 3,
                 "bytes_in_flight": 4096,
                 "step": {"step": 7, "wall_ms": 100.0, "sync_stall_ms": 30.0,
                          "attrib": {"sync": 60.0, "queue": 20.0,
                                     "other": 20.0}},
                 "counters": {"integrity.retransmit": 2},
                 "gauges": {'health.alerts_active{rule="overlap_floor"}': 1,
                            'compression.active{tensor="g",codec="onebit"}':
                            1}}}},
             "history": {1: {"summary": {"series": {
                 "mbps": {"spark": [1.0, 3.0, 2.0]}}}}}},
    "gossip": {"epoch": 2, "world": [0, 1, 2], "gossip": True,
               "states": {0: {"inc": 0, "state": "alive", "hb": 9},
                          1: {"inc": 1, "state": "suspect", "hb": 4},
                          2: {"inc": 2, "state": "dead", "hb": 0}},
               "ranks": {}, "history": {}},
    "probation": {"epoch": 3, "world": [0, 2], "coordinator": 0,
                  "standby": 2, "slow": {1: 12.4, 0: 0.1},
                  "probation": [1],
                  "ranks": {0: {"age_s": 0.5, "metrics": {"epoch": 3}}}},
    "failover": {"epoch": 1, "world": [1, 2], "coordinator": 1,
                 "standby": 2, "local_only": True,
                 "failover_in_progress": True, "ranks": {}},
}


@pytest.mark.parametrize("doc", sorted(_TOP_DOCS))
def test_bps_top_frames_equal_the_jax_tool(doc):
    """The port's ``bps_top`` renders the same frame as the JAX tool
    from the same ``cluster_metrics`` reply."""
    from byteps_tpu_torch.tools import bps_top
    from tools import bps_top as jax_top
    frame = bps_top.render(_TOP_DOCS[doc])
    assert frame == jax_top.render(_TOP_DOCS[doc])
    assert frame.splitlines()[0].startswith("byteps_tpu cluster")
