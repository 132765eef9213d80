"""The port's bench-smoke gate (byteps_tpu_torch/tools/bench_smoke.py)
against the JAX tool (tools/bench_smoke.py).

The gate arithmetic is pinned with EVERY lane stubbed (nothing is
measured, so nothing here depends on the host's speed): each lane's gate
function gives the JAX tool's verdict on the same inputs across its
boundary, :func:`evaluate` fails exactly the lane pushed past its gate,
and ``main`` exits 0 or 1 by it and writes a floor with the JAX floor's
keys.  The port's committed floor file has the JAX floor's keys.  Two
lanes also run for real on the CPU at a small size: the engine's result
is the bare collective's, bit for bit, and the compressed lanes' wire
ratios and golden errors are the JAX tool's contracts.
"""

import copy
import json
import os

import numpy as np
import pytest

from byteps_tpu_torch.tools import bench_smoke as pbs
from tools import bench_smoke as jbs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FLOOR = os.path.join(REPO, "tools", "bench_smoke_floor.json")

# one result of every lane, each comfortably inside FLOOR
RESULT = {
    "fused_8MB_gbps": 10.0, "engine_8MB_gbps": 4.0,
    "engine_vs_fused_ratio": 0.5, "ratio_per_rep": [0.5],
    "engine_equals_fused": True, "autotune": {}, "metrics": {},
    "serve": {"pulls_per_s": 1000.0, "p50_ms": 0.1, "p99_ms": 1.0,
              "pushes_per_s": 10.0, "failed_reads": 0,
              "delta": {"ok": True}},
    "straggler": {"p99_nofault_ms": 2.0, "p99_unhedged_ms": 31.0,
                  "p99_hedged_ms": 3.0, "slow_endpoint_ms": 30.0,
                  "hedged_pulls": 10, "hedge_wins": 10},
    "compressed": {
        "onebit": {"wire_ratio": 0.0313, "gbps": 1.0,
                   "uncompressed_gbps": 2.0, "throughput_ratio": 0.5,
                   "golden_error": 0.27, "zero_compile": True},
        "randomk": {"wire_ratio": 0.5, "gbps": 1.0,
                    "uncompressed_gbps": 2.0, "throughput_ratio": 0.5,
                    "golden_error": 0.47, "zero_compile": True}},
    "sharded_update": {"wire_bytes_per_step_unsharded": 100,
                       "wire_bytes_per_step_sharded": 100,
                       "wire_ratio": 1.0, "step_ms_unsharded": 5.0,
                       "step_ms_sharded": 5.0, "step_time_ratio": 1.0,
                       "ratio_per_rep": [1.0], "exact": True, "ranks": 1},
    "trace": {"sample_n": 4, "overhead_ratio": 0.9, "ratio_per_rep": [0.9],
              "events_buffered": 8, "events_dropped": 0},
    "ts_sampler": {"samples": 10, "overhead_ratio": 1.0,
                   "ratio_per_rep": [1.0]},
    "transport": {"nbytes": 262144, "loopback_gbps": 1.0, "tcp_gbps": 0.5,
                  "tcp_vs_loopback_ratio": 0.5,
                  "partitioned_peer_p99_ms": 5.0, "deadline_trips": 1,
                  "reconnect_attempts": 2},
    "serve_dist": {"hosts": 3, "pulls_per_s": 5000.0, "p50_ms": 0.1,
                   "p99_ms": 1.0, "pushes_per_s": 10.0, "failed_reads": 0,
                   "per_host": {"0": {"pulls": 4}, "1": {"pulls": 4},
                                "2": {"pulls": 4}},
                   "ships": 4, "ship_failures": 0, "failovers": 0,
                   "shed": 0},
    "fleet": {"base_hosts": 2, "peak_hosts": 4, "pulls_per_s": 5000.0,
              "p50_ms": 0.1, "p99_ms": 1.0, "pushes_per_s": 10.0,
              "failed_reads": 0, "spawned": 4, "drain_started": 2,
              "drained": 2, "drain_escalated": 0, "banned": 0,
              "final_hosts": 2, "still_draining": []},
    "durability": {"push_ratio": 0.6, "ratio_per_rep": [0.6],
                   "replay_records": 401, "replay_mb": 25.0,
                   "replay_mbps": 200.0, "truncated_tails": 0,
                   "corrupt_records": 0},
}
TOL = 0.30
FLOOR = pbs.new_floor(RESULT, note="test floor")

MEASURES = {"_measure": None, "_measure_serve": "serve",
            "_measure_straggler": "straggler",
            "_measure_compressed": "compressed",
            "_measure_sharded_update": "sharded_update",
            "_measure_trace": "trace", "_measure_ts_sampler": "ts_sampler",
            "_measure_transport": "transport",
            "_measure_serve_dist": "serve_dist", "_measure_fleet": "fleet",
            "_measure_durability": "durability"}


class _Comm:
    device = "cpu"

    def close(self):
        pass


@pytest.fixture
def stubbed(monkeypatch, tmp_path):
    """Every lane stubbed to RESULT (a copy a call), no process group,
    the floor file in tmp_path; returns the floor path."""
    top = {k: v for k, v in RESULT.items() if k not in MEASURES.values()}
    for fn, lane in MEASURES.items():
        val = top if lane is None else RESULT[lane]
        monkeypatch.setattr(pbs, fn,
                            lambda *a, _v=val, **k: copy.deepcopy(_v))
    monkeypatch.setattr(pbs, "_comm", lambda device: _Comm())
    monkeypatch.setattr(pbs, "card_line", lambda device: None)
    path = tmp_path / "floor.json"
    path.write_text(json.dumps(FLOOR))
    monkeypatch.setattr(pbs, "FLOOR_PATH", str(path))
    return path


def test_every_lane_is_stubbed_and_measured_in_the_jax_order(stubbed):
    out = pbs.measure_all("cpu")
    assert out == RESULT
    assert list(out)[-10:] == [v for v in MEASURES.values() if v]


def test_the_floor_has_the_jax_floor_keys():
    with open(JAX_FLOOR) as f:
        jax_keys = set(json.load(f))
    with open(pbs.FLOOR_PATH) as f:
        port = json.load(f)
    assert set(port) == jax_keys == set(FLOOR)
    assert set(pbs.new_floor(RESULT, "n")) == jax_keys
    # written by a run on the card's machine: the note names the card
    assert "H100" in port["note"] and " W" in port["note"], port["note"]


def test_the_floor_rules_are_the_jax_tools():
    """Half, a tenth, or the measured value, lane by lane, as the JAX
    tool's --update-floor writes them; the sharded wire ceiling is the
    JAX constant at R = 8 and grows where the pull leg saves less."""
    f = pbs.new_floor(RESULT, "n")
    assert f["engine_vs_fused_ratio"] == 0.5 and f["engine_8MB_gbps"] == 4.0
    assert f["compressed_throughput_floor"] == 0.25
    assert f["sharded_step_ratio_floor"] == 0.5
    assert f["transport_tcp_ratio_floor"] == 0.25
    assert f["serve_dist_pulls_per_s_floor"] == 500.0
    assert f["fleet_pulls_per_s_floor"] == 500.0
    assert f["durability_push_ratio_floor"] == 0.3
    assert f["durability_replay_mbps_floor"] == 20.0
    with open(JAX_FLOOR) as fh:
        jax_floor = json.load(fh)
    for k in ("straggler_hedge_p99_factor", "straggler_hedge_p99_abs_ms",
              "compressed_wire_ratio_max", "compressed_quality_ceiling",
              "trace_sample_overhead_floor", "ts_sampler_overhead_floor",
              "transport_partitioned_p99_ms"):
        assert f[k] == jax_floor[k], k
    assert pbs.sharded_wire_contract(8) == jax_floor["sharded_wire_ratio_max"]
    assert pbs.sharded_wire_contract(1) == 1.0575


# (lane, gate function name, key, values across the gate)
SWEEPS = [
    ("sharded_update", "_sharded_update_ok", "wire_ratio",
     (0.5, 1.0575, 1.06, 2.0)),
    ("sharded_update", "_sharded_update_ok", "step_time_ratio",
     (0.2, 0.349, 0.35, 0.36, 1.0)),
    ("sharded_update", "_sharded_update_ok", "exact", (True, False)),
    ("trace", "_trace_ok", "overhead_ratio", (0.48, 0.49, 0.5, 1.0)),
    ("trace", "_trace_ok", "events_buffered", (0, 1)),
    ("ts_sampler", "_ts_ok", "overhead_ratio", (0.66, 0.665, 0.7)),
    ("ts_sampler", "_ts_ok", "samples", (0, 1)),
    ("transport", "_transport_ok", "tcp_vs_loopback_ratio",
     (0.17, 0.175, 0.2)),
    ("transport", "_transport_ok", "partitioned_peer_p99_ms",
     (49.9, 50.0, 50.1)),
    ("serve_dist", "_serve_dist_ok", "pulls_per_s", (349.0, 350.0, 351.0)),
    ("serve_dist", "_serve_dist_ok", "failed_reads", (0, 1)),
    ("fleet", "_fleet_ok", "pulls_per_s", (349.0, 350.0, 351.0)),
    ("fleet", "_fleet_ok", "drained", (0, 1)),
    ("fleet", "_fleet_ok", "drain_escalated", (0, 1)),
    ("durability", "_durability_ok", "push_ratio", (0.2, 0.21, 0.22)),
    ("durability", "_durability_ok", "replay_mbps", (13.9, 14.0, 14.1)),
    ("durability", "_durability_ok", "corrupt_records", (0, 1)),
]


@pytest.mark.parametrize("lane,gate,key,values", SWEEPS,
                         ids=[f"{s[0]}-{s[2]}" for s in SWEEPS])
def test_each_gate_gives_the_jax_verdict(lane, gate, key, values):
    seen = set()
    for v in values:
        args = []
        for mod in (pbs, jbs):
            res = copy.deepcopy(RESULT[lane])
            res[key] = v
            args.append(getattr(mod, gate)(res, FLOOR, TOL))
        assert args[0] == args[1], (key, v)
        seen.add(args[0])
    assert seen == {True, False}, f"{key}: the sweep never crossed"


@pytest.mark.parametrize("hedged", [3.0, 5.0, 5.001, 40.0])
def test_straggler_gate_gives_the_jax_verdict(hedged):
    got = []
    for mod in (pbs, jbs):
        st = dict(RESULT["straggler"], p99_hedged_ms=hedged)
        got.append((mod._straggler_ok(st, FLOOR), st["gate_ms"]))
    assert got[0] == got[1] == (hedged <= 5.0, 5.0)


@pytest.mark.parametrize("codec,key,value,ok", [
    ("onebit", "wire_ratio", 0.35, True), ("onebit", "wire_ratio", 0.36,
                                           False),
    ("randomk", "wire_ratio", 0.9, True),
    ("randomk", "golden_error", 0.55, True),
    ("randomk", "golden_error", 0.551, False),
    ("onebit", "throughput_ratio", 0.175, True),
    ("onebit", "throughput_ratio", 0.17, False)])
def test_compressed_gate_gives_the_jax_verdict(codec, key, value, ok):
    got = []
    for mod in (pbs, jbs):
        lanes = copy.deepcopy(RESULT["compressed"])
        lanes[codec][key] = value
        got.append((mod._compressed_ok(lanes, FLOOR, TOL),
                    {k: v["ok"] for k, v in lanes.items()}))
    assert got[0] == got[1]
    assert got[0][0] is ok and got[0][1][codec] is ok


def test_evaluate_passes_inside_every_gate():
    out = copy.deepcopy(RESULT)
    ok, bad = pbs.evaluate(out, FLOOR, TOL)
    assert ok and bad == [] and out["ok"] is True
    assert out["gate_ratio"] == 0.35 and out["gate_gbps"] == 2.8
    for lane in ("straggler", "sharded_update", "trace", "ts_sampler",
                 "transport", "serve_dist", "fleet", "durability"):
        assert out[lane]["ok"] is True, lane


# one push past each lane's gate -> the lane that must fail
BREAKS = [
    ({"engine_vs_fused_ratio": 0.3, "engine_8MB_gbps": 2.7}, "engine"),
    ({"straggler": {"p99_hedged_ms": 6.0}}, "straggler"),
    ({"compressed": {"onebit": {"wire_ratio": 0.4}}}, "compressed"),
    ({"sharded_update": {"exact": False}}, "sharded_update"),
    ({"trace": {"events_buffered": 0}}, "trace"),
    ({"ts_sampler": {"overhead_ratio": 0.5}}, "ts_sampler"),
    ({"transport": {"partitioned_peer_p99_ms": 60.0}}, "transport"),
    ({"serve_dist": {"failed_reads": 1}}, "serve_dist"),
    ({"fleet": {"still_draining": [3]}}, "fleet"),
    ({"durability": {"truncated_tails": 1}}, "durability"),
]


def _patch(out, change):
    for k, v in change.items():
        if isinstance(v, dict):
            _patch(out[k], v)
        else:
            out[k] = v


@pytest.mark.parametrize("change,lane", BREAKS, ids=[b[1] for b in BREAKS])
def test_evaluate_fails_exactly_the_broken_lane(change, lane):
    out = copy.deepcopy(RESULT)
    _patch(out, change)
    ok, bad = pbs.evaluate(out, FLOOR, TOL)
    assert not ok and out["ok"] is False
    assert [b.split(":")[0] for b in bad] == [lane]


def test_engine_gate_passes_on_either_figure():
    for ratio, gbps, ok in ((0.35, 0.1, True), (0.1, 2.8, True),
                            (0.349, 2.79, False)):
        out = dict(copy.deepcopy(RESULT), engine_vs_fused_ratio=ratio,
                   engine_8MB_gbps=gbps)
        assert pbs.evaluate(out, FLOOR, TOL)[0] is ok


def test_main_exits_by_the_gate(stubbed, monkeypatch, capsys):
    assert pbs.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] is True
    broken = dict(FLOOR, engine_vs_fused_ratio=10.0, engine_8MB_gbps=100.0)
    stubbed.write_text(json.dumps(broken))
    assert pbs.main(["--device", "cpu"]) == 1
    assert "bench-smoke FAIL: engine" in capsys.readouterr().err


def test_update_floor_writes_the_rules(stubbed, capsys):
    assert pbs.main(["--device", "cpu", "--update-floor"]) == 0
    written = json.loads(stubbed.read_text())
    assert written == pbs.new_floor(RESULT, written["note"])
    assert "measured floor on cpu" in written["note"]


def test_main_refuses_the_card_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pbs.main([]) == 1


# ------------------------------------------------- two lanes, for real

@pytest.fixture(scope="module")
def comm():
    from byteps_tpu_torch.comm.mesh import bootstrap, resolve_device
    from byteps_tpu_torch.common.config import Config
    c = bootstrap(Config(), resolve_device("cpu"))
    yield c
    c.close()


def test_engine_lane_equals_the_bare_collective(comm):
    out = pbs._measure(comm, nbytes=1 << 18, reps=2)
    assert out["engine_equals_fused"] is True
    assert out["engine_8MB_gbps"] > 0 and out["fused_8MB_gbps"] > 0
    assert len(out["ratio_per_rep"]) == 2


def test_compressed_lanes_keep_the_jax_contracts(comm):
    """The wire ratios are the payload formats' (both packages' frames
    are byte-equal) and the golden errors the JAX registry's, to 1e-4
    (the port's codecs on torch, the JAX ones on XLA)."""
    from byteps_tpu.compression import registry as jreg
    lanes = pbs._measure_compressed(comm, nbytes=1 << 17, reps=1)
    assert set(lanes) == {"onebit", "randomk"}
    assert lanes["onebit"]["wire_ratio"] <= 0.35
    for codec, kwargs in pbs.COMPRESSED_CODECS:
        np.testing.assert_allclose(lanes[codec]["golden_error"],
                                   jreg.golden_error(kwargs), atol=1e-4)
        assert lanes[codec]["golden_error"] <= 0.55
        assert lanes[codec]["zero_compile"] is True
    np.testing.assert_allclose(lanes["randomk"]["wire_ratio"], 0.5,
                               atol=1e-3)
