"""Coordinator failover on the port (``byteps_tpu_torch/fault/
membership.py``): the JAX package's cases of
``tests/test_coordinator_failover.py`` (view-aware bus resolution,
standby replication and the seeded successor bus, the loud bind
failure, heartbeat re-hosting, the ``/healthz`` and ``/debug/state``
membership sections, ``bps_top``'s header, the ``kill:site=coordinator``
predicate, and the multi-process kill-the-coordinator, rejoin through
the successor bus and double failure mid-failover lanes on
``tests/torch_elastic_worker.py``; the wedge-reconcile lane is in
``tests/test_torch_failure_detector.py``).  Finals are held against
the JAX worker's arithmetic (``_simulate`` of ``tests/test_elastic.py``)
at its 1e-5.

One port difference is pinned here: the replica carries no sync round
(``test_replica_carries_no_sync_round``)."""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest

from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.common.telemetry import counters
from byteps_tpu_torch.fault import injector as fault_injector
from byteps_tpu_torch.fault.membership import (ElasticMembership,
                                               MembershipView, _BusServer,
                                               bus_request, resolve_bus_addr)
from byteps_tpu_torch.utils.failure_detector import HeartbeatMonitor
from tests.test_elastic import _simulate

from .torch_member_common import communicate, final  # noqa: F401
from .torch_member_common import free_port as _free_port
from .torch_member_common import fresh_member_state, spawn  # noqa: F401


def _req(port, msg, timeout=20.0):
    return bus_request(("127.0.0.1", port), msg, timeout=timeout)


# -- view-aware address resolution ------------------------------------------


def test_resolve_bus_addr_is_view_aware_after_coordinator_change(monkeypatch):
    monkeypatch.setenv("BYTEPS_MEMBERSHIP_HOSTS",
                       "10.0.0.5:7000, 10.0.0.6:7100, 10.0.0.7")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9000")
    monkeypatch.delenv("BYTEPS_MEMBERSHIP_PORT", raising=False)
    pcfg.reset_config()
    # explicit arg always wins
    assert resolve_bus_addr("1.2.3.4:5") == ("1.2.3.4", 5)
    # no view: static env resolution (DMLC root + port+2)
    assert resolve_bus_addr() == ("127.0.0.1", 9002)
    # the view's coordinator picks the host-map entry — a failover from
    # rank 0 to rank 1 MOVES the resolved address
    assert resolve_bus_addr(view=MembershipView(0, (0, 1, 2))) == \
        ("10.0.0.5", 7000)
    assert resolve_bus_addr(view=MembershipView(1, (1, 2))) == \
        ("10.0.0.6", 7100)
    # an entry without a port uses the default membership port
    assert resolve_bus_addr(view=MembershipView(2, (2,))) == \
        ("10.0.0.7", 9002)
    # coordinator outside the map: static fallback
    assert resolve_bus_addr(view=MembershipView(3, (7,))) == \
        ("127.0.0.1", 9002)


# -- bus replication ---------------------------------------------------------


def test_bus_ping_and_standby_replication():
    port = _free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1, 2)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=5.0,
                     host_rank=0)
    try:
        ping = _req(port, {"op": "ping"})
        assert ping["ok"] and ping["epoch"] == 0
        assert ping["coordinator"] == 0 and ping["standby"] == 1
        assert ping["bus_rank"] == 0
        # replies to the STANDBY piggyback the replica; other ranks'
        # replies do not
        r1 = _req(port, {"op": "metrics_put", "rank": 1, "metrics": {"x": 1}})
        r0 = _req(port, {"op": "metrics_put", "rank": 0, "metrics": {"x": 0}})
        assert "replica" in r1 and "replica" not in r0
        rep = r1["replica"]
        assert rep["epoch"] == 0 and rep["world"] == [0, 1, 2]
        # the explicit replicate verb answers anyone (a rank that just
        # BECAME standby bootstraps through it)
        rep2 = _req(port, {"op": "replicate", "rank": 2})["replica"]
        assert rep2["metrics"][1][1] == {"x": 1}
    finally:
        bus.close()


def test_bus_seeded_from_replica_resumes_parked_joiner():
    """The failover headline at bus granularity: a replica taken from a
    bus with a PARKED joiner seeds a successor that still advertises the
    admission — the joiner survives the coordinator's death parked, and
    the next state-carrying quorum admits it."""
    port_a = _free_port()
    bus_a = _BusServer(("127.0.0.1", port_a), MembershipView(1, (1, 2)),
                       rendezvous_timeout_s=2.0, sync_timeout_s=30.0,
                       host_rank=1)
    out = {}
    try:
        # a joiner parks on bus A...
        tj = threading.Thread(target=lambda: out.update(
            joinA=_req(port_a, {"op": "rejoin", "rank": 0}, timeout=5.0)))
        tj.start()
        time.sleep(0.3)   # until the rejoin op is registered
        rep = _req(port_a, {"op": "replicate", "rank": 2})["replica"]
        assert rep["join_wait"] == [0]
    finally:
        bus_a.close()     # ...and the coordinator dies
    tj.join(timeout=10)

    # the standby binds a successor seeded with the replica
    port_b = _free_port()
    bus_b = _BusServer(("127.0.0.1", port_b), MembershipView(1, (1, 2)),
                       rendezvous_timeout_s=2.0, sync_timeout_s=30.0,
                       seed=rep, host_rank=2)
    try:
        assert bus_b.view() == MembershipView(1, (1, 2))
        from byteps_tpu_torch.utils.checkpoint import pack_state
        state = pack_state({"w": np.ones(3, np.float32)})

        def member(r, step, with_state):
            msg = {"op": "sync", "rank": r, "epoch": 1, "step": step,
                   "payload": None}
            if with_state:
                msg["state"] = state
                msg["declared"] = ["g"]
            out[(r, step)] = _req(port_b, msg, timeout=40.0)

        # first quorum: no state attached, but the seeded park means the
        # reply already advertises join_waiting
        ts = [threading.Thread(target=member, args=(r, 7, False))
              for r in (1, 2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=20)
        assert out[(1, 7)]["ok"] and out[(1, 7)]["join_waiting"], out
        # the joiner re-parks on the successor (its old connection died
        # with bus A) and the next state-carrying quorum admits it
        tj2 = threading.Thread(target=lambda: out.update(
            joinB=_req(port_b, {"op": "rejoin", "rank": 0}, timeout=40.0)))
        tj2.start()
        time.sleep(0.2)
        ts = [threading.Thread(target=member, args=(r, 8, True))
              for r in (1, 2)]
        for t in ts:
            t.start()
        for t in ts + [tj2]:
            t.join(timeout=30)
        join = out["joinB"]
        assert join["ok"] and join["epoch"] == 2
        assert join["world"] == [0, 1, 2] and join["declared"] == ["g"]
    finally:
        bus_b.close()


def test_elastic_failover_seeds_bus_and_records_flight():
    """Two in-process members: the standby holds a replica, the
    coordinator's bus dies, and the standby's shrink re-binds the SAME
    address seeded with the replicated state — recorded as
    ``membership.coordinator_failover``."""
    from byteps_tpu_torch.common import flight_recorder as _flight
    port = _free_port()
    bus = f"127.0.0.1:{port}"
    # the applied shrink resumes an engine (as the JAX one does): on the
    # host here
    m0 = ElasticMembership(0, [0, 1], bus, rendezvous_timeout_s=2.0,
                           sync_timeout_s=5.0, device="cpu").start()
    m1 = ElasticMembership(1, [0, 1], bus, rendezvous_timeout_s=2.0,
                           sync_timeout_s=5.0, device="cpu").start()
    try:
        assert m0.hosting_bus and not m1.hosting_bus
        assert m1.standby_rank == 1 and m1._pull_replica()
        assert m1._replica["epoch"] == 0
        # the coordinator dies (its bus with it)
        m0._bus.close()
        m0._bus = None
        view = m1.shrink({0})
        assert view == MembershipView(1, (1,))
        assert m1.hosting_bus
        assert counters.get("membership.coordinator_failover") >= 1
        kinds = [e["kind"] for e in _flight.recorder.snapshot()]
        assert "membership.coordinator_failover" in kinds
        # the successor bus answers with the agreed view
        ping = _req(port, {"op": "ping"})
        assert ping["epoch"] == 1 and ping["world"] == [1]
        assert ping["bus_rank"] == 1
    finally:
        m1.stop()
        m0.stop()


def test_ensure_bus_bind_failure_is_loud_not_silent():
    """a bind that stays refused with NOTHING serving the
    address is a busless world — counter + flight event + raise, not a
    log-and-continue."""
    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)   # accepts nothing, speaks nothing
    port = blocker.getsockname()[1]
    try:
        m = ElasticMembership(0, [0], f"127.0.0.1:{port}",
                              rendezvous_timeout_s=1.0, sync_timeout_s=2.0)
        with pytest.raises(OSError):
            m.start()
        assert counters.get("membership.bus_bind_failed") >= 1
        from byteps_tpu_torch.common import flight_recorder as _flight
        kinds = [e["kind"] for e in _flight.recorder.snapshot()]
        assert "membership.bus_bind_failed" in kinds
    finally:
        blocker.close()


# -- heartbeat re-hosting ----------------------------------------------------


def test_heartbeat_server_follows_server_rank_and_detects_its_death():
    """A monitor hosted on an arbitrary server_rank (not rank 0), with
    explicit world-set ranks; a client that has HEARD the server once
    detects its death within `timeout` even though the startup grace is
    much larger."""
    port = _free_port()
    fired = []
    server = HeartbeatMonitor(2, coordinator=f"127.0.0.1:{port}",
                              interval=0.05, timeout=5.0, grace=30.0,
                              ranks={0, 2}, server_rank=2,
                              on_failure=lambda s: None).start()
    client = HeartbeatMonitor(0, coordinator=f"127.0.0.1:{port}",
                              interval=0.05, timeout=0.5, grace=30.0,
                              ranks={0, 2}, server_rank=2,
                              on_failure=lambda s: fired.append(set(s)))
    client.start()
    try:
        deadline = time.monotonic() + 5.0
        while not client._got_reply and time.monotonic() < deadline:
            time.sleep(0.02)
        assert client._got_reply, "client never heard the server"
        server.stop()   # the server dies mid-run
        deadline = time.monotonic() + 5.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        # detected in ~timeout seconds despite grace=30: the grace gate
        # opens permanently after the first reply
        assert fired and fired[0] == {2}, fired
    finally:
        client.stop()
        server.stop()


# -- observability surfaces --------------------------------------------------


def test_healthz_and_debug_state_name_the_control_plane():
    port = _free_port()
    m = ElasticMembership(0, [0, 1, 2], f"127.0.0.1:{port}",
                          rendezvous_timeout_s=1.0,
                          sync_timeout_s=2.0).start()
    try:
        from byteps_tpu_torch.common.obs_server import debug_state, healthz
        doc = healthz()["membership"]
        assert doc["coordinator"] == 0 and doc["standby"] == 1
        assert doc["is_coordinator"] and doc["hosting_bus"]
        assert doc["bus_addr"].endswith(f":{port}")
        dbg = debug_state()["membership"]
        assert dbg["coordinator"] == 0 and dbg["standby"] == 1
        assert dbg["replica"] == {"held": False, "epoch": None}
        assert m._pull_replica()
        assert debug_state()["membership"]["replica"]["held"]
    finally:
        m.stop()
    # with the membership stopped the sections disappear again
    from byteps_tpu_torch.common.obs_server import healthz
    assert "membership" not in healthz()


def test_bps_top_renders_coordinator_and_failover_header():
    from byteps_tpu_torch.tools import bps_top
    live = bps_top.render({"epoch": 1, "world": [1, 2],
                           "coordinator": 1, "standby": 2,
                           "ranks": {}})
    assert "coordinator=1 standby=2" in live.splitlines()[0]
    failover = bps_top.render({"epoch": 1, "world": [1, 2],
                               "coordinator": 1, "standby": 2,
                               "local_only": True,
                               "failover_in_progress": True,
                               "ranks": {}})
    assert "FAILOVER IN PROGRESS" in failover.splitlines()[0]
    plain = bps_top.render({"epoch": 0, "world": [0], "local_only": True,
                            "ranks": {}})
    assert "local-only view: no membership bus" in plain.splitlines()[0]


# -- kill:site=coordinator ---------------------------------------------------


def test_kill_site_coordinator_spec_validation():
    rules = fault_injector.parse_spec("kill:site=coordinator:step=3")
    assert rules[0].kind == "kill" and rules[0].site == "coordinator"
    with pytest.raises(ValueError, match="site=coordinator"):
        fault_injector.parse_spec("kill:site=dcn:step=3")
    with pytest.raises(ValueError, match="kill-only"):
        fault_injector.parse_spec("delay:site=coordinator:ms=5")


def test_kill_site_coordinator_fires_only_on_the_coordinator(monkeypatch):
    exits = []
    monkeypatch.setattr(fault_injector, "_exit",
                        lambda code: exits.append(code))
    port = _free_port()
    m = ElasticMembership(1, [1, 2], f"127.0.0.1:{port}",
                          rendezvous_timeout_s=1.0,
                          sync_timeout_s=2.0).start()
    try:
        # this process is rank 2 of the active membership: NOT the
        # coordinator, so the kill predicate must not fire...
        m.rank = 2
        fault_injector._reset_lifetime_for_tests()
        inj = fault_injector.arm("kill:site=coordinator:step=1", rank=2)
        inj.on_step()
        assert exits == []
        # ...while the coordinator at the same step dies
        m.rank = 1
        fault_injector._reset_lifetime_for_tests()
        inj2 = fault_injector.arm("kill:site=coordinator:step=1", rank=1)
        inj2.on_step()
        assert exits == [1]
        # and a re-armed schedule (elastic suspend/resume) never
        # cascade-kills: the lifetime counter is already past the step
        fault_injector.arm("kill:site=coordinator:step=1",
                           rank=1).on_step()
        assert exits == [1]
    finally:
        fault_injector.disarm()
        m.stop()


# -- multiprocess acceptance pins -------------------------------------------


def test_coordinator_kill_shrink_matches_clean_run():
    """THE headline: rank 0 — bus host AND heartbeat server — is
    chaos-killed mid-step.  The standby (rank 1) re-binds the bus seeded
    with its replica, survivors shrink to {1, 2} in place (no process
    exit), re-host the heartbeat, finish training, and their final state
    equals a fault-free 2-process {1, 2} run from the shrink-boundary
    state."""
    n, kill_at = 9, 4
    bus, hb = _free_port(), _free_port()
    procs = {
        r: spawn(r, (0, 1, 2), bus, hb, n, extra={
            "BYTEPS_FAULT_SPEC": f"kill:site=coordinator:step={kill_at}",
            "BYTEPS_FAULT_SEED": "7"})
        for r in (0, 1, 2)}
    outs = communicate(procs)

    # exactly the coordinator died (same spec armed on EVERY rank: the
    # site predicate selects the bus host, and the successor — whose
    # step counter is already past kill_at — is never cascade-killed)
    assert procs[0].returncode == 1, outs[0][-3000:]
    assert "FINAL" not in outs[0]
    finals = {}
    for r in (1, 2):
        assert procs[r].returncode == 0, outs[r][-3000:]
        assert "WORLD 1 1,2" in outs[r], outs[r][-3000:]
        finals[r] = final(outs[r])
        assert finals[r][0] == 1 and finals[r][1] == "1,2", finals[r]
    assert finals[1][2] == pytest.approx(finals[2][2], abs=1e-6)

    # fault-free 2-process run from the same state
    w_shrink = _simulate(0.0, (0, 1, 2), kill_at - 1)
    bus2 = _free_port()
    procs2 = {
        r: spawn(r, (1, 2), bus2, None, n, extra={
            "BYTEPS_ELASTIC_START_STEP": str(kill_at),
            "BYTEPS_ELASTIC_INIT_W": repr(w_shrink)})
        for r in (1, 2)}
    outs2 = communicate(procs2)
    for r in (1, 2):
        assert procs2[r].returncode == 0, outs2[r][-3000:]
    clean = final(outs2[1])
    assert clean[0] == 0 and clean[1] == "1,2"
    assert finals[1][2] == pytest.approx(clean[2], abs=1e-5), (
        finals, clean, w_shrink)


def test_coordinator_kill_rejoin_through_successor_bus():
    """After the coordinator kill, the dead rank restarts and rejoins
    through the SUCCESSOR bus (rank 1's, at the same address): admitted
    at a step boundary with epoch/keys/params, and every member finishes
    at the same state."""
    n, kill_at = 30, 4
    bus, hb = _free_port(), _free_port()
    procs = {
        r: spawn(r, (0, 1, 2), bus, hb, n, extra={
            "BYTEPS_ELASTIC_STEP_SLEEP": "0.3",
            "BYTEPS_FAULT_SPEC": f"kill:site=coordinator:step={kill_at}",
            "BYTEPS_FAULT_SEED": "7"})
        for r in (0, 1, 2)}
    out_victim, _ = procs[0].communicate(timeout=120)
    assert procs[0].returncode == 1, out_victim[-3000:]
    # the rejoiner gets the heartbeat port too: admitted as the new
    # coordinator it re-hosts the UDP server (taking the port over from
    # rank 1's interim server), so liveness detection stays armed after
    # the rejoin
    rejoiner = spawn(0, (0, 1, 2), bus, hb, n, extra={
        "BYTEPS_ELASTIC_REJOIN": "1",
        "BYTEPS_ELASTIC_STEP_SLEEP": "0.3"})
    outs = communicate({1: procs[1], 2: procs[2], "rj": rejoiner})

    assert rejoiner.returncode == 0, outs["rj"][-3000:]
    rejoin_line = next(line for line in outs["rj"].splitlines()
                       if line.startswith("REJOINED "))
    _, epoch, world, step0 = rejoin_line.split()
    assert int(epoch) == 2 and world == "0,1,2", rejoin_line
    assert kill_at - 1 <= int(step0) < n, rejoin_line
    finals = {}
    for r in (1, 2):
        assert procs[r].returncode == 0, outs[r][-3000:]
        assert "WORLD 1 1,2" in outs[r], outs[r][-3000:]
        assert "WORLD 2 0,1,2" in outs[r], outs[r][-3000:]
        finals[r] = final(outs[r])
        assert finals[r][0] == 2 and finals[r][1] == "0,1,2", finals[r]
    fin_rj = final(outs["rj"])
    assert fin_rj[0] == 2 and fin_rj[1] == "0,1,2", fin_rj
    assert finals[1][2] == pytest.approx(finals[2][2], abs=1e-6)
    assert finals[1][2] == pytest.approx(fin_rj[2], abs=1e-6)


def test_coordinator_double_failure_standby_dies_mid_failover():
    """Kill the coordinator, then lose the standby INSIDE the failover
    window (it exits the moment its detector fires, before binding the
    successor bus).  The last survivor must not wedge: its hello to the
    never-bound bus exhausts the rendezvous window, rank 1 is presumed
    dead too, and rank 2 hosts the bus itself and completes alone."""
    n, kill_at = 9, 4
    bus, hb = _free_port(), _free_port()
    procs = {
        r: spawn(r, (0, 1, 2), bus, hb, n, extra=(
            {"BYTEPS_FAULT_SPEC": f"kill:site=coordinator:step={kill_at}",
             "BYTEPS_FAULT_SEED": "7"} if r == 0 else
            {"BYTEPS_ELASTIC_DIE_ON_DETECT": "1"} if r == 1 else None))
        for r in (0, 1, 2)}
    outs = communicate(procs)

    assert procs[0].returncode == 1, outs[0][-3000:]
    assert procs[1].returncode == 1, outs[1][-3000:]
    assert "DIED-ON-DETECT" in outs[1], outs[1][-3000:]
    assert procs[0].returncode == 1
    # the survivor either finished alone (the escalation ladder bound
    # the bus on the third-lowest rank) or exited restartable — never a
    # wedge (the _communicate timeout would have tripped)
    if procs[2].returncode == 0:
        epoch, world, w0 = final(outs[2])
        assert world == "2" and epoch >= 1, (epoch, world)
        expected = _simulate(_simulate(0.0, (0, 1, 2), kill_at - 1),
                             (2,), n - kill_at + 1)
        assert w0 == pytest.approx(expected, abs=1e-5), (w0, expected)
    else:
        assert procs[2].returncode == 17, outs[2][-3000:]


def test_replica_carries_no_sync_round():
    """The port's replica leaves the sync rounds out (a successor always
    re-agrees the world, voiding them, and at a model's gradients they
    would be hundreds of MB on every standby reply); the rest of the
    snapshot is the JAX bus's."""
    from byteps_tpu.fault import membership as jmm
    port = _free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0, 1)),
                     rendezvous_timeout_s=2.0, sync_timeout_s=5.0,
                     host_rank=0)
    try:
        out = {}

        def member(r):
            out[r] = _req(port, {"op": "sync", "rank": r, "epoch": 0,
                                 "step": 1,
                                 "payload": np.ones(1 << 16, np.float32)})
        ts = [threading.Thread(target=member, args=(r,)) for r in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=20)
        rep = out[1]["replica"]
        assert out[0]["ok"] and rep["sync"] == {}
        with bus._cv:
            assert bus._sync      # the round is retained on the bus
        # a JAX successor seeded from it resumes the view
        succ = jmm._BusServer(("127.0.0.1", _free_port()),
                              jmm.MembershipView(0, (0, 1)), 2.0, 5.0,
                              seed=rep, host_rank=1)
        try:
            assert succ.view() == jmm.MembershipView(0, (0, 1))
        finally:
            succ.close()
    finally:
        bus.close()
