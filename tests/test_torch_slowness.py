"""The port's slowness scoring (``byteps_tpu_torch/utils/slowness.py``):
the JAX package's cases (``tests/test_slowness.py``) on the port, the
same scores and snapshots as the JAX tracker after the same seeded
observation sequences, and the feeds and views wired into the port
(the engine's sync loop, the envelope's wire hop, ``metrics_snapshot``,
``/debug/state`` and the time-series sampler)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from byteps_tpu.utils import slowness as jslow
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.common import integrity as pinteg
from byteps_tpu_torch.common import obs_server as pobs
from byteps_tpu_torch.common import timeseries as pts
from byteps_tpu_torch.common.telemetry import gauges
from byteps_tpu_torch.core import api
from byteps_tpu_torch.utils import slowness as slowness_mod
from byteps_tpu_torch.utils.slowness import (PHI_MAX, LatencyQuantile,
                                             SlownessTracker,
                                             wait_recovered)

from .torch_fault_common import fresh_fault_state  # noqa: F401


# -- SlownessTracker (the JAX package's cases) --------------------------------


def test_uniform_peers_score_low():
    tr = SlownessTracker(window=32)
    for _ in range(20):
        for r in (0, 1, 2):
            tr.observe(r, 0.010, site="sync")
    for r in (0, 1, 2):
        assert tr.score(r, site="sync") < 2.0, tr.scores(site="sync")


def test_one_slow_peer_scores_high_others_stay_low():
    tr = SlownessTracker(window=32)
    for _ in range(20):
        tr.observe(0, 0.010, site="sync")
        tr.observe(1, 0.011, site="sync")
        tr.observe(2, 0.350, site="sync")   # the straggler
    scores = tr.scores(site="sync")
    assert scores[2] >= 8.0, scores
    assert scores[0] < 2.0 and scores[1] < 2.0, scores
    assert tr.latency(2, site="sync") == pytest.approx(0.35, rel=0.01)


def test_identical_baseline_clamps_at_phi_max():
    tr = SlownessTracker(window=32)
    for _ in range(16):
        tr.observe(0, 0.010, site="s")
        tr.observe(1, 0.010, site="s")
        tr.observe(2, 10.0, site="s")
    assert tr.score(2, site="s") == PHI_MAX


def test_single_peer_scores_against_own_history():
    tr = SlownessTracker(window=32)
    for _ in range(12):
        tr.observe(0, 0.010, site="solo")
    for _ in range(12):
        tr.observe(0, 0.400, site="solo")
    assert tr.score(0, site="solo") >= 8.0
    tr2 = SlownessTracker(window=32)
    for _ in range(24):
        tr2.observe(0, 0.010, site="solo")
    assert tr2.score(0, site="solo") < 2.0


def test_window_bound_and_recovery():
    tr = SlownessTracker(window=16)
    for _ in range(16):
        tr.observe(0, 0.010, site="s")
        tr.observe(1, 0.400, site="s")
    assert tr.score(1, site="s") >= 8.0
    for _ in range(16):
        tr.observe(0, 0.010, site="s")
        tr.observe(1, 0.010, site="s")   # recovered
    assert tr.score(1, site="s") < 2.0


def test_score_without_site_takes_worst_site():
    tr = SlownessTracker(window=32)
    for _ in range(16):
        tr.observe(1, 0.010, site="a")
        tr.observe(2, 0.010, site="a")
        tr.observe(1, 0.500, site="b")
        tr.observe(2, 0.010, site="b")
    assert tr.score(1) >= 8.0          # slow at site b only
    assert tr.score(1, site="a") < 2.0


def test_snapshot_shape_and_gauges():
    tr = SlownessTracker(window=16)
    for _ in range(10):
        tr.observe(0, 0.010, site="sync")
        tr.observe(1, 0.300, site="sync")
    snap = tr.snapshot()
    assert set(snap) == {"sync"}
    assert set(snap["sync"]) == {0, 1}
    row = snap["sync"][1]
    assert set(row) == {"n", "median_ms", "score"}
    assert row["median_ms"] == pytest.approx(300.0, rel=0.01)
    tr.publish_gauges()
    assert gauges.get("slowness.max_score") >= 8.0
    assert gauges.get("slowness.score", site="sync", rank=1) >= 8.0
    assert gauges.get("slowness.score", site="sync", rank=0) < 2.0


def test_window_validation_and_reset():
    with pytest.raises(ValueError, match="window"):
        SlownessTracker(window=4)
    tr = SlownessTracker()
    tr.observe(0, 1.0)
    tr.reset()
    assert tr.scores() == {} and tr.latency(0) == 0.0


def test_module_tracker_honors_config_window(monkeypatch):
    slowness_mod._reset_for_tests()
    monkeypatch.setenv("BYTEPS_SLOWNESS_WINDOW", "16")
    pcfg.reset_config()
    assert slowness_mod.tracker().window == 16
    assert slowness_mod.tracker() is slowness_mod.tracker()  # singleton
    monkeypatch.setenv("BYTEPS_SLOWNESS_WINDOW", "4")
    with pytest.raises(ValueError, match="slowness_window"):
        pcfg.Config.from_env()
    with pytest.raises(ValueError, match="slowness_phi"):
        pcfg.Config(slowness_phi=0.0)


def test_latency_quantile_none_until_min_samples():
    q = LatencyQuantile(window=32, min_samples=8)
    for i in range(7):
        q.observe(0.001 * (i + 1))
        assert q.quantile(0.99) is None
    q.observe(0.008)
    assert q.quantile(0.99) == pytest.approx(0.008)


def test_latency_quantile_values():
    q = LatencyQuantile(window=100, min_samples=8)
    for i in range(1, 101):
        q.observe(i / 1000.0)
    assert q.quantile(0.5) == pytest.approx(0.050)
    assert q.quantile(0.99) == pytest.approx(0.099)
    assert len(q) == 100


def test_wait_recovered_waits_out_the_fault():
    state = {"n": 0}

    def probe():
        state["n"] += 1
        if state["n"] <= 4:
            time.sleep(0.05)    # "slow" phase

    assert wait_recovered(probe, baseline_s=0.01, factor=2.0,
                          consecutive=3, interval_s=0.0, timeout_s=10.0)
    assert state["n"] == 7


def test_wait_recovered_times_out_on_a_sustained_fault():
    assert not wait_recovered(lambda: time.sleep(0.03), baseline_s=0.01,
                              factor=2.0, consecutive=2,
                              interval_s=0.0, timeout_s=0.3)


# -- the feeds and views ------------------------------------------------------


def test_engine_sync_loop_feeds_tracker():
    """Every retired unit lands one ``sync`` sample for this process's
    own rank; a healthy engine does not accuse itself, and the full
    metrics snapshot carries the same view."""
    api.init(pcfg.Config(telemetry_on=True), device="cpu")
    try:
        for _ in range(4):
            api.push_pull(torch.ones(8), "slowfeed", op="sum")
        snap = slowness_mod.tracker().snapshot()
        assert "sync" in snap, snap
        assert snap["sync"][0]["n"] >= 4
        assert snap["sync"][0]["score"] < 8.0
        assert api.metrics_snapshot()["slowness"]["sync"][0]["n"] >= 4
        assert "slowness" not in api.metrics_snapshot(light=True)
    finally:
        api.shutdown()


def test_wire_hop_debug_state_and_sampler_views():
    """The envelope's wire hop feeds its worker at its site; /debug/state
    serves the tracker's snapshot (stamping the gauges) and the sampler
    refreshes ``slow_score`` before each point."""
    for w in (0, 1, 2):
        for _ in range(10):
            frame = pinteg.seal_array(np.ones(4, np.float32), key="k",
                                      seq=1, worker=w)
            pinteg.wire_transmit(frame, key="k", worker=w, seq=1,
                                 site="kv_push",
                                 opener=pinteg.open_array, who="test")
    snap = slowness_mod.tracker().snapshot()
    assert {w: snap["kv_push"][w]["n"] for w in (0, 1, 2)} == {
        0: 10, 1: 10, 2: 10}
    tr = slowness_mod.tracker()
    for _ in range(20):
        tr.observe(0, 0.010, site="probe")
        tr.observe(1, 0.011, site="probe")
        tr.observe(2, 0.350, site="probe")
    doc = pobs.debug_state()
    assert doc["slowness"]["probe"][2]["score"] >= 8.0
    assert "slowness" not in doc["omitted"]
    assert gauges.get("slowness.score", site="probe", rank=2) >= 8.0
    gauges.set("slowness.max_score", 0.0)
    store = pts.TimeSeriesStore(interval_s=1.0, window=8)
    assert store.sample_once(now=0.0)["slow_score"] >= 8.0


# -- parity with the JAX tracker ------------------------------------------------


def _sequence(seed: int):
    """A seeded observation sequence: (peer, latency_s, site) triples over
    three sites, one straggling peer at one of them, and a solo site."""
    rng = np.random.RandomState(seed)
    obs = []
    for _ in range(120):
        site = ("sync", "transport", "kv_push", "solo")[rng.randint(4)]
        if site == "solo":
            peer, lat = 0, float(rng.lognormal(-4.0, 0.3))
        else:
            peer = int(rng.randint(4))
            lat = float(rng.lognormal(-4.5, 0.2))
            if site == "transport" and peer == 3:
                lat *= 30.0
        obs.append((peer, lat, site))
    return obs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("window", [8, 16, 64])
def test_scores_match_the_jax_tracker(seed, window):
    port, ref = SlownessTracker(window=window), jslow.SlownessTracker(
        window=window)
    for peer, lat, site in _sequence(seed):
        port.observe(peer, lat, site=site)
        ref.observe(peer, lat, site=site)
    # the same Python arithmetic in the same order: equal, not close
    assert port.snapshot() == ref.snapshot()
    assert port.scores() == ref.scores()
    for site in ("sync", "transport", "kv_push", "solo"):
        assert port.scores(site=site) == ref.scores(site=site)
        for peer in range(4):
            assert port.latency(peer, site=site) == ref.latency(peer,
                                                                site=site)
    q_port, q_ref = LatencyQuantile(window=32), jslow.LatencyQuantile(
        window=32)
    for _, lat, _ in _sequence(seed):
        q_port.observe(lat)
        q_ref.observe(lat)
    for q in (0.5, 0.9, 0.99):
        assert q_port.quantile(q) == q_ref.quantile(q)
