"""Gray-failure tolerance on the port (``byteps_tpu_torch/fault/
membership.py``): the JAX package's cases of ``tests/test_straggler.py``
(step-barrier lag scoring on the bus, the demote decision, the
coordinator's exemption, deadline trips riding the metrics piggyback,
readmission clearing probation, probation in the replica seed,
``Demoted`` rather than ``Evicted``, the in-process demote lifecycle,
``cluster_metrics`` and ``bps_top``'s SLOW/STATE columns, and the
3-process demote-and-readmit lane on ``tests/torch_straggler_worker.py``).
The serving plane's ``serve_hedge_ms`` knob is not ported, so the
validation case leaves it out."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import byteps_tpu_torch.core.api as api
from byteps_tpu_torch.common.config import (Config, get_config, reset_config,
                                            set_config)
from byteps_tpu_torch.common.telemetry import counters
from byteps_tpu_torch.fault.membership import (Demoted, ElasticMembership,
                                               MembershipView, WorldChanged,
                                               _BusServer, _recv_obj,
                                               _send_obj)

from .torch_member_common import REPO, fresh_member_state  # noqa: F401
from .torch_member_common import free_port as _free_port

WORKER = os.path.join(REPO, "tests", "torch_straggler_worker.py")


def _req(port, msg, timeout=20.0):
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.settimeout(timeout)
    _send_obj(s, msg)
    reply = _recv_obj(s)
    s.close()
    return reply


def _demote_config(**kw):
    """A config tuned for fast in-process demotion tests."""
    base = dict(straggler_policy="demote", straggler_demote_after=2,
                straggler_min_lag_s=0.1, slowness_phi=3.0,
                membership_rendezvous_timeout_s=3.0,
                membership_sync_timeout_s=10.0)
    base.update(kw)
    cfg = Config(**base)
    set_config(cfg)
    return cfg


# -- config ------------------------------------------------------------------


def test_straggler_policy_validation(monkeypatch):
    assert Config().straggler_policy == "wait"
    for ok in ("wait", "hedge", "demote"):
        assert Config(straggler_policy=ok).straggler_policy == ok
    with pytest.raises(ValueError, match="STRAGGLER_POLICY"):
        Config(straggler_policy="panic")
    with pytest.raises(ValueError, match="slowness_phi"):
        Config(slowness_phi=0)
    with pytest.raises(ValueError, match="slowness_window"):
        Config(slowness_window=2)
    with pytest.raises(ValueError, match="demote_after"):
        Config(straggler_demote_after=0)
    with pytest.raises(ValueError, match="min_lag"):
        Config(straggler_min_lag_s=-1)
    monkeypatch.setenv("BYTEPS_STRAGGLER_POLICY", "Demote")
    monkeypatch.setenv("BYTEPS_SLOWNESS_PHI", "5.5")
    monkeypatch.setenv("BYTEPS_STRAGGLER_DEMOTE_AFTER", "4")
    monkeypatch.setenv("BYTEPS_STRAGGLER_MIN_LAG", "0.5")
    reset_config()
    cfg = get_config()
    assert cfg.straggler_policy == "demote"          # case-normalized
    assert cfg.slowness_phi == 5.5
    assert cfg.straggler_demote_after == 4
    assert cfg.straggler_min_lag_s == 0.5


# -- the bus: arrival-lag scoring and the demote decision --------------------


def _run_rounds(port, epoch, steps, ranks, slow_rank=None, slow_s=0.25,
                metrics=None):
    """Drive sync rounds against a raw bus: one thread per rank per
    round, ``slow_rank`` arriving ``slow_s`` late.  Returns
    ``{step: {rank: reply}}``."""
    out = {}
    for step in steps:
        replies = {}
        lock = threading.Lock()

        def sync(rank, step=step):
            if rank == slow_rank:
                time.sleep(slow_s)
            msg = {"op": "sync", "rank": rank, "epoch": epoch,
                   "step": step, "payload": rank}
            if metrics is not None:
                msg["metrics"] = metrics(rank, step)
            r = _req(port, msg)
            with lock:
                replies[rank] = r

        ts = [threading.Thread(target=sync, args=(r,)) for r in ranks]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        out[step] = replies
    return out


def test_bus_scores_step_barrier_lags_and_demotes():
    """Three ranks, rank 1 consistently 0.25s late to every barrier:
    round 1 completes ok (hysteresis), the demote_after-th consecutive
    slow round answers EVERY member with the demote signal, and the bus
    parks rank 1 on the probation list."""
    _demote_config()
    port = _free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1, 2)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=10.0)
    try:
        rounds = _run_rounds(port, 0, (1, 2, 3), (0, 1, 2), slow_rank=1)
        # round 1: slow but not yet demote_after consecutive — round ok
        assert all(r["ok"] for r in rounds[1].values()), rounds[1]
        # by round 2 the decision lands; whichever round carries it,
        # every member of that round sees the same signal
        demote_round = next(s for s in (2, 3)
                            if not rounds[s][0].get("ok"))
        for rank in (0, 1, 2):
            r = rounds[demote_round][rank]
            assert r["ok"] is False and r["demote"] == 1, (demote_round, r)
            assert r["probation"] == [1]
        assert counters.get("membership.straggler_demote_decided") == 1
        # the observability verbs expose the accusation and the state
        ping = _req(port, {"op": "ping"})
        assert ping["probation"] == [1]
        met = _req(port, {"op": "metrics"})
        assert met["probation"] == [1]
        assert met["slow"][1] >= 3.0, met["slow"]
        assert met["slow"].get(0, 0.0) < 3.0
        # the replica snapshot carries probation (failover-safe)
        rep = _req(port, {"op": "replicate", "rank": 1})
        assert sorted(rep["replica"]["probation"]) == [1]
    finally:
        bus.close()


def test_bus_policy_wait_scores_but_never_demotes():
    """Default policy: the same sustained straggler is SCORED (the
    operator sees it) but nothing acts — every round completes."""
    _demote_config(straggler_policy="wait")
    port = _free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1, 2)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=10.0)
    try:
        rounds = _run_rounds(port, 0, (1, 2, 3, 4), (0, 1, 2),
                             slow_rank=1)
        for step, replies in rounds.items():
            assert all(r["ok"] for r in replies.values()), (step, replies)
        met = _req(port, {"op": "metrics"})
        assert met["slow"][1] >= 3.0
        assert met["probation"] == []
        assert counters.get("membership.straggler_demote_decided") == 0
    finally:
        bus.close()


def test_bus_coordinator_is_exempt_from_demotion():
    """The coordinator hosts the bus: demoting it would race its own
    failover.  A slow rank 0 is scored but never demoted — its
    slowness escalates through the crash-failover path instead."""
    _demote_config()
    port = _free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=10.0)
    try:
        rounds = _run_rounds(port, 0, (1, 2, 3, 4), (0, 1), slow_rank=0)
        for step, replies in rounds.items():
            assert all(r["ok"] for r in replies.values()), (step, replies)
        assert _req(port, {"op": "ping"})["probation"] == []
    finally:
        bus.close()


def test_bus_deadline_trips_piggyback_drives_demotion():
    """The self-reported trigger: a rank whose metrics piggyback shows
    fresh ``engine.sync_deadline_trips`` each round is slow even with
    zero arrival lag — demoted after demote_after consecutive rounds."""
    _demote_config()
    port = _free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=10.0)

    def metrics(rank, step):
        if rank != 1:
            return {"counters": {}}
        # trips grow every round; round 1 establishes the baseline
        return {"counters": {"engine.sync_deadline_trips": step}}

    try:
        rounds = _run_rounds(port, 0, (1, 2, 3, 4), (0, 1),
                             metrics=metrics)
        assert all(r["ok"] for r in rounds[1].values())   # baseline round
        demote_round = next(s for s in (2, 3, 4)
                            if not rounds[s][0].get("ok"))
        # rounds 2 and 3 carry fresh trips -> demote on the 2nd of them
        assert demote_round == 3, rounds
        for rank in (0, 1):
            assert rounds[demote_round][rank]["demote"] == 1
        assert _req(port, {"op": "ping"})["probation"] == [1]
    finally:
        bus.close()


def test_bus_readmission_clears_probation():
    """After a demotion, survivors agree the shrunk world (hello), the
    demoted rank parks a rejoin, and admission at a state-carrying
    quorum clears its probation entry — the full bus-side lifecycle."""
    _demote_config()
    port = _free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1, 2)),
                     rendezvous_timeout_s=3.0, sync_timeout_s=10.0)
    try:
        rounds = _run_rounds(port, 0, (1, 2, 3), (0, 1, 2), slow_rank=1)
        assert any(not rounds[s][0].get("ok") for s in (2, 3))
        assert _req(port, {"op": "ping"})["probation"] == [1]
        # survivors run the shrink rendezvous for epoch 1, world {0, 2}
        hellos = {}

        def hello(rank):
            hellos[rank] = _req(port, {"op": "hello", "rank": rank,
                                       "epoch": 1, "world": [0, 2]})

        ts = [threading.Thread(target=hello, args=(r,)) for r in (0, 2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert hellos[0]["ok"] and hellos[0]["epoch"] == 1
        assert hellos[0]["world"] == [0, 2]
        # probation SURVIVES the shrink — demoted, not forgotten
        assert _req(port, {"op": "ping"})["probation"] == [1]
        # the straggler recovered: it parks a rejoin; survivors sync
        # with state and the admission lands on the second quorum
        join_out = {}

        def rejoin():
            join_out["r"] = _req(port, {"op": "rejoin", "rank": 1},
                                 timeout=30.0)

        tj = threading.Thread(target=rejoin)
        tj.start()
        time.sleep(0.2)
        for step in (10, 11, 12):
            _run_rounds(port, 1, (step,), (0, 2),
                        metrics=None)
            # attach state explicitly on a quorum (raw protocol: the
            # state-carrying sync is what admission consumes)
            replies = {}
            lock = threading.Lock()

            def sync(rank, step=step):
                r = _req(port, {"op": "sync", "rank": rank, "epoch": 1,
                                "step": step + 100, "payload": rank,
                                "state": b"blob", "declared": ["g"]})
                with lock:
                    replies[rank] = r

            ts = [threading.Thread(target=sync, args=(r,))
                  for r in (0, 2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
            if "r" in join_out:
                break
        tj.join(timeout=30)
        r = join_out["r"]
        assert r["ok"] and r["world"] == [0, 1, 2], r
        assert r["state"] == b"blob" and r["declared"] == ["g"]
        assert _req(port, {"op": "ping"})["probation"] == []
        assert counters.get("membership.probation_readmitted") == 1
    finally:
        bus.close()


def test_bus_seed_restores_probation():
    """A coordinator failover must not forget who is demoted: the
    replica seed carries probation into the successor bus."""
    _demote_config()
    port = _free_port()
    seed = {"epoch": 2, "world": [0, 2],
            "probation": {1: {"since": 123.0, "score": 9.5}}}
    bus = _BusServer(("127.0.0.1", port), MembershipView(2, (0, 2)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=5.0,
                     seed=seed)
    try:
        assert _req(port, {"op": "ping"})["probation"] == [1]
    finally:
        bus.close()


# -- the client: Demoted vs Evicted, demote() --------------------------------


def test_stale_reply_with_probation_raises_demoted_not_evicted():
    """A demoted rank that syncs late (it raced the demote signal)
    learns its status from the stale reply: probation ⇒ Demoted (stay
    alive, recover, rejoin) — never Evicted (restartable exit)."""
    _demote_config()
    port = _free_port()
    seed = {"epoch": 3, "world": [0, 2],
            "probation": {1: {"since": 1.0, "score": 9.0}}}
    bus = _BusServer(("127.0.0.1", port), MembershipView(3, (0, 2)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=5.0,
                     seed=seed)
    try:
        m = ElasticMembership(1, [0, 1, 2], f"127.0.0.1:{port}")
        with pytest.raises(Demoted) as ei:
            m.step_sync(7, payload=0)
        assert ei.value.probation == [1]
    finally:
        bus.close()


def test_in_process_demote_lifecycle():
    """Two in-process members, rank 1 sleeping before every barrier:
    the bus demotes it — rank 1 raises Demoted (and does NOT exit),
    rank 0 applies the demotion through the ordinary shrink machinery
    and continues alone at epoch 1."""
    _demote_config()
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    # the applied demotion resumes an engine (as the JAX one does): on
    # the host here
    m0 = ElasticMembership(0, [0, 1], addr, device="cpu").start()
    m1 = ElasticMembership(1, [0, 1], addr, device="cpu").start()
    results = {}

    def run(m, rank):
        step = 1
        try:
            while step <= 8:
                if rank == 1:
                    time.sleep(0.25)
                try:
                    m.step_sync(step, payload=rank)
                except WorldChanged as e:
                    results[rank] = ("world", e.view)
                    return
                step += 1
            results[rank] = ("done", None)
        except Demoted as e:
            results[rank] = ("demoted", e.probation)
        except Exception as e:  # noqa: BLE001
            results[rank] = ("error", e)

    try:
        ts = [threading.Thread(target=run, args=(m, r))
              for r, m in ((0, m0), (1, m1))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert results[1][0] == "demoted", results
        assert results[1][1] == [1]
        assert results[0][0] == "world", results
        assert results[0][1] == MembershipView(1, (0,))
        assert m0.view() == MembershipView(1, (0,))
        assert counters.get("membership.straggler_demote") >= 1
        assert counters.get("membership.demoted") == 1
        assert _req(port, {"op": "ping"})["probation"] == [1]
    finally:
        m1.stop()
        m0.stop()


# -- surfaces ----------------------------------------------------------------


def test_cluster_metrics_carries_slow_and_probation():
    _demote_config()
    port = _free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1, 2)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=10.0)
    try:
        _run_rounds(port, 0, (1, 2, 3), (0, 1, 2), slow_rank=1)
        out = api.cluster_metrics(bus=f"127.0.0.1:{port}")
        assert out["probation"] == [1]
        assert out["slow"][1] >= 3.0
    finally:
        bus.close()


def test_bps_top_renders_slow_and_probation_columns():
    from byteps_tpu_torch.tools import bps_top
    cluster = {
        "epoch": 3, "world": [0, 2], "coordinator": 0, "standby": 2,
        "slow": {1: 12.4, 0: 0.1, 2: 0.3},
        "probation": [1],
        "ranks": {0: {"age_s": 0.5, "metrics": {"epoch": 3}},
                  2: {"age_s": 0.7, "metrics": {"epoch": 3}}},
    }
    txt = bps_top.render(cluster)
    assert "SLOW" in txt and "STATE" in txt
    assert "PROBATION" in txt          # rank 1's state
    assert "12.4" in txt               # rank 1's score, shown although
    #                                    it is outside the world
    assert "probation=[1]" in txt      # header flag
    lines = txt.splitlines()
    # one row per world member PLUS the probation rank
    assert sum(1 for l in lines if l.strip().startswith(("0 ", "1 ", "2 "))
               or l.strip().split()[:1] in (["0"], ["1"], ["2"])) >= 3


# -- the acceptance pin ------------------------------------------------------


def _spawn(rank, world, bus_port, steps, extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["DMLC_NUM_WORKER"] = "1"
    env["DMLC_WORKER_ID"] = str(rank)
    env["BYTEPS_ELASTIC_RANK"] = str(rank)
    env["BYTEPS_ELASTIC_WORLD"] = world
    env["BYTEPS_ELASTIC_BUS"] = f"127.0.0.1:{bus_port}"
    env["BYTEPS_ELASTIC_STEPS"] = str(steps)
    env["BYTEPS_ELASTIC_STEP_SLEEP"] = "0.1"
    env["BYTEPS_MEMBERSHIP_RENDEZVOUS_TIMEOUT"] = "3"
    env["BYTEPS_MEMBERSHIP_SYNC_TIMEOUT"] = "20"
    env["BYTEPS_STRAGGLER_POLICY"] = "demote"
    env["BYTEPS_STRAGGLER_DEMOTE_AFTER"] = "3"
    env["BYTEPS_STRAGGLER_MIN_LAG"] = "0.15"
    env["BYTEPS_LOG_LEVEL"] = "ERROR"
    env.pop("BYTEPS_FAULT_SPEC", None)
    env.update(extra or {})
    return subprocess.Popen([sys.executable, WORKER], env=env, cwd=REPO,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _final(out):
    for line in out.splitlines():
        if line.startswith("FINAL "):
            _, epoch, world, w0 = line.split()
            return int(epoch), world, float(w0)
    raise AssertionError("no FINAL line in:\n" + out[-3000:])


def _step_windows(out):
    """Parse one worker's output into ``[(step, world, dt), ...]`` by
    tracking the WORLD transitions around its STEP lines."""
    world = (0, 1, 2)
    rows = []
    for line in out.splitlines():
        if line.startswith("WORLD "):
            parts = line.split()
            world = tuple(int(r) for r in parts[2].split(","))
        elif line.startswith("STEP "):
            _, step, dt = line.split()
            rows.append((int(step), world, float(dt)))
    return rows


def test_straggler_demote_and_readmit_3proc():
    """THE acceptance pin: 3 real processes, rank 1 under a sustained
    ``slow`` fault (350ms per engine sync visit, 12-visit window).

    - the bus demotes rank 1 after 3 consecutive slow barriers
      (survivors print the shrink WORLD line; rank 1 prints DEMOTED);
    - survivor step throughput recovers: the demoted-window median step
      wall is a fraction of the faulted-window's, and within the 70%
      bound of the post-readmission fault-free window;
    - rank 1 probes its own data path, observes the fault clear
      (RECOVERED), rejoins at a step boundary (REJOINED), and the bus
      lifts probation — world (0,1,2) again at epoch 2;
    - zero lost / double-counted gradients: every member's FINAL state
      equals a float32 replay of the exact world sequence each step ran
      under.
    """
    n = 50
    bus = str(_free_port())
    procs = {
        r: _spawn(r, "0,1,2", bus, n, extra=(
            {"BYTEPS_FAULT_SPEC": "slow:rank=1:site=sync:ms=350:n=12",
             "BYTEPS_FAULT_SEED": "7"} if r == 1 else None))
        for r in (0, 1, 2)}
    outs = {}
    try:
        for r, p in procs.items():
            outs[r], _ = p.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        for p in procs.values():
            p.kill()
        pytest.fail("straggler workers hung; partial: "
                    + "".join(o[-2000:] for o in outs.values()))

    for r in (0, 1, 2):
        assert procs[r].returncode == 0, (r, outs[r][-4000:])

    # the straggler went through the full lifecycle
    assert "DEMOTED at" in outs[1], outs[1][-3000:]
    assert "RECOVERED after" in outs[1], outs[1][-3000:]
    assert "REJOINED 2 0,1,2" in outs[1], outs[1][-3000:]
    # the injected fault really fired AND really cleared
    slow_line = next(l for l in outs[1].splitlines()
                     if l.startswith("SLOW-FIRED"))
    assert int(slow_line.split()[1]) == 12 and slow_line.split()[3] == "1", \
        slow_line
    # survivors observed demote (shrink) then readmission (grow)
    for r in (0, 2):
        assert "WORLD 1 0,2" in outs[r], outs[r][-3000:]
        assert "WORLD 2 0,1,2" in outs[r], outs[r][-3000:]

    # throughput: faulted window vs demoted window vs readmitted window
    rows = _step_windows(outs[0])
    fault_w = [dt for s, w, dt in rows if w == (0, 1, 2) and s <= 5]
    demoted_w = [dt for s, w, dt in rows if w == (0, 2)]
    healthy_w = [dt for s, w, dt in rows if w == (0, 1, 2) and s > 5]
    assert fault_w and demoted_w and healthy_w, rows

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    assert med(fault_w) >= 0.25, (med(fault_w), fault_w)   # fault bit
    # demotion restored throughput: >= 70% of the fault-free rate
    # (post-readmission window IS fault-free operation of the full
    # world), with a small absolute allowance for host noise — and an
    # order of magnitude better than the faulted window either way
    assert med(demoted_w) <= max(med(healthy_w) / 0.7,
                                 med(healthy_w) + 0.05), (
        med(demoted_w), med(healthy_w))
    assert med(demoted_w) <= 0.4 * med(fault_w), (
        med(demoted_w), med(fault_w))

    # zero lost / double-counted gradients: FINALs agree and equal the
    # float32 replay of the observed world sequence (PR-3/PR-4 style
    # integrity equivalence)
    finals = {r: _final(outs[r]) for r in (0, 1, 2)}
    for r in (0, 1, 2):
        assert finals[r][0] == 2 and finals[r][1] == "0,1,2", finals
    assert finals[0][2] == pytest.approx(finals[2][2], abs=1e-6)
    assert finals[0][2] == pytest.approx(finals[1][2], abs=1e-6)
    w = np.float32(0.0)
    for _, world, _ in _step_windows(outs[0]):
        g = (np.sum([np.float32((r + 1) ** 2) for r in world],
                    dtype=np.float32) / np.float32(len(world)))
        w = np.float32(w - np.float32(0.1) * g)
    assert finals[0][2] == pytest.approx(float(w), abs=1e-5), (
        finals[0][2], float(w))
