"""The port's failure detection (``byteps_tpu_torch/utils/
failure_detector.py``) and the engine's sync deadline: the JAX package's
cases (``tests/test_failure_detector.py``; ``tests/test_sync_deadline.py``,
its two ``ElasticMembership`` cases among them: a deadline trip becomes a
reconcile, and a stall during a shrink follows it; and the JAX package's
3-process wedge lane of ``tests/test_coordinator_failover.py``), the
heartbeat datagrams against the JAX monitor both ways (a port client
keeps a JAX server quiet, and the reverse), the heartbeat ``init()``
arms under the retry policy, and a real 2-process worker death."""

from __future__ import annotations

import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from byteps_tpu.utils import failure_detector as jfd
from byteps_tpu_torch.common import config as pcfg
from byteps_tpu_torch.common import obs_server as pobs
from byteps_tpu_torch.common.telemetry import counters
from byteps_tpu_torch.core import api
from byteps_tpu_torch.fault import injector as inj
from byteps_tpu_torch.utils import failure_detector as fd_mod
from byteps_tpu_torch.utils.failure_detector import (HeartbeatMonitor,
                                                     StepWatchdog,
                                                     install_failure_action)

from .torch_fault_common import (REPO, child_env, free_port,  # noqa: F401
                                 fresh_fault_state, thread_count, wait_for)
from .torch_member_common import communicate, final, spawn
from .test_elastic import _simulate


@pytest.fixture
def exits(monkeypatch):
    """The restartable exit trapped: a real os._exit would take pytest
    with it."""
    calls = []
    monkeypatch.setattr(fd_mod, "_exit", calls.append)
    return calls


# -- heartbeats ---------------------------------------------------------------


def test_healthy_cluster_no_fire(thread_count):
    port = free_port()
    fired = []
    mons = [HeartbeatMonitor(r, 2, f"127.0.0.1:{port}", interval=0.1,
                             timeout=1.0, on_failure=fired.append).start()
            for r in range(2)]
    assert all(m.wait_server(5.0) for m in mons)
    time.sleep(1.5)
    for m in mons:
        m.stop()
    assert not fired


def test_missing_rank_detected_after_grace(thread_count):
    port = free_port()
    fired = []
    done = threading.Event()

    def on_failure(stale):
        fired.append(stale)
        done.set()

    m = HeartbeatMonitor(0, 2, f"127.0.0.1:{port}", interval=0.1,
                         timeout=0.8, grace=0.8, on_failure=on_failure)
    m.start()
    assert done.wait(10.0), "detector did not fire"
    m.stop()
    assert fired == [{1}]


def test_dead_coordinator_detected(thread_count):
    port = free_port()  # nothing listens here
    fired = []
    done = threading.Event()

    def on_failure(stale):
        fired.append(stale)
        done.set()

    m = HeartbeatMonitor(1, 2, f"127.0.0.1:{port}", interval=0.1,
                         timeout=0.6, on_failure=on_failure)
    m.start()
    assert done.wait(10.0), "client did not detect silent coordinator"
    m.stop()
    assert fired == [{0}]


def test_on_failure_fires_once(thread_count):
    port = free_port()
    fired = []
    m = HeartbeatMonitor(0, 3, f"127.0.0.1:{port}", interval=0.05,
                         timeout=0.4, grace=0.4, on_failure=fired.append)
    m.start()
    wait_for(lambda: fired, timeout=10.0, what="detection")
    time.sleep(0.5)   # a second report would land here
    m.stop()
    assert len(fired) == 1  # both missing ranks reported in ONE call
    assert fired[0] == {1, 2}


def test_step_watchdog_stall_and_feed():
    stalls = []
    wd = StepWatchdog(timeout=0.5, on_stall=stalls.append)
    wd.start()
    for _ in range(4):  # regular feeding keeps it quiet
        time.sleep(0.2)
        wd.feed()
    assert not stalls
    wait_for(lambda: stalls, timeout=10.0, what="stall")
    wd.stop()
    assert len(stalls) == 1 and stalls[0] > 0.5


def test_custom_on_failure_suppresses_exit(exits, thread_count):
    port = free_port()
    fired = []
    done = threading.Event()

    def on_failure(stale):
        fired.append(stale)
        done.set()

    m = HeartbeatMonitor(0, 2, f"127.0.0.1:{port}", interval=0.1,
                         timeout=0.5, grace=0.5, on_failure=on_failure)
    m.start()
    assert done.wait(10.0)
    m.stop()
    assert fired == [{1}]
    assert exits == []


def test_custom_on_stall_suppresses_exit(exits):
    stalls = []
    wd = StepWatchdog(timeout=0.3, on_stall=stalls.append)
    wd.start()
    wait_for(lambda: stalls, timeout=10.0, what="stall")
    wd.stop()
    assert len(stalls) == 1
    assert exits == []


def test_default_on_failure_exits_restartable(monkeypatch, exits):
    monkeypatch.setenv("BYTEPS_FAILURE_EXIT_CODE", "23")
    pcfg.reset_config()
    fd_mod._default_on_failure({1})
    assert exits == [23]


def test_install_failure_action_rewires_the_default(exits):
    seen = []
    prev = install_failure_action(seen.append)
    try:
        fd_mod._default_on_failure({2, 3})
        assert seen == [{2, 3}]
        assert exits == []
    finally:
        install_failure_action(prev)
    fd_mod._default_on_failure({1})   # restored: the default exits again
    assert len(exits) == 1


def test_failure_exit_code_rejects_non_restartable_codes(monkeypatch):
    for bad in ("0", "1", "256", "-3"):
        monkeypatch.setenv("BYTEPS_FAILURE_EXIT_CODE", bad)
        with pytest.raises(ValueError, match="not restartable"):
            pcfg.Config.from_env()
    monkeypatch.setenv("BYTEPS_FAILURE_EXIT_CODE", "copper")
    with pytest.raises(ValueError, match="integer"):
        pcfg.Config.from_env()
    monkeypatch.setenv("BYTEPS_FAILURE_EXIT_CODE", "23")
    assert pcfg.Config.from_env().failure_exit_code == 23


_WORKER = r"""
import os, sys, time
from byteps_tpu_torch.utils.failure_detector import HeartbeatMonitor
rank = int(sys.argv[1]); port = sys.argv[2]; die_after = float(sys.argv[3])

def on_failure(stale):
    print("DETECTED", sorted(stale), flush=True)
    os._exit(0)   # the beat thread's report ends the survivor at once

m = HeartbeatMonitor(rank, 2, "127.0.0.1:" + port, interval=0.2,
                     timeout=2.0, on_failure=on_failure)
m.start()
m.wait_server(20.0)
print("BEATING", flush=True)
t0 = time.time()
while time.time() - t0 < 20:
    if die_after > 0 and time.time() - t0 > die_after:
        print("DYING", flush=True)
        os._exit(1)  # simulated crash, no cleanup
    time.sleep(0.1)
print("TIMEOUT-NO-DETECT", flush=True)
"""


def test_two_process_worker_death_detected():
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(rank), port, die],
        env=child_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for rank, die in ((0, "0"), (1, "1.5"))]
    try:
        out_v, _ = procs[1].communicate(timeout=60)
        out_s, _ = procs[0].communicate(timeout=60)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("heartbeat workers hung")
    assert "DYING" in out_v, out_v[-2000:]
    assert "DETECTED [1]" in out_s, out_s[-2000:]


# -- the wire against the JAX monitor -----------------------------------------


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_heartbeats_interoperate_with_the_jax_monitor(server_pkg,
                                                      thread_count):
    """A port client beating to a JAX server (and a JAX client to a port
    server) is heard: the server stays quiet, the client's grace is
    released by the server's reply; then the client dies and the other
    package's server reports it."""
    port = free_port()
    server_cls, client_cls = ((jfd.HeartbeatMonitor, HeartbeatMonitor)
                              if server_pkg == "jax" else
                              (HeartbeatMonitor, jfd.HeartbeatMonitor))
    fired_s, fired_c = [], []
    srv = server_cls(0, 2, f"127.0.0.1:{port}", interval=0.05,
                     timeout=1.0, grace=10.0, on_failure=fired_s.append)
    cli = client_cls(1, 2, f"127.0.0.1:{port}", interval=0.05,
                     timeout=1.0, grace=10.0, on_failure=fired_c.append)
    srv.start()
    cli.start()
    try:
        assert cli.wait_server(10.0) and srv.wait_server(10.0)
        time.sleep(1.5)     # longer than the timeout: both stay quiet
        assert fired_s == [] and fired_c == []
        assert cli.last_beat_age() < 1.0
        cli.stop()
        wait_for(lambda: fired_s, timeout=10.0, what="server detection")
        assert fired_s == [{1}]
    finally:
        cli.stop()
        srv.stop()


def test_datagrams_are_the_jax_bytes():
    """The beat and the reply, byte for byte: a raw socket sends the
    port's beat to a JAX server and the JAX beat to a port server, and
    both replies are the same datagram."""
    replies = []
    for server_cls in (jfd.HeartbeatMonitor, HeartbeatMonitor):
        port = free_port()
        srv = server_cls(0, 2, f"127.0.0.1:{port}", interval=10.0,
                         timeout=30.0, on_failure=lambda s: None).start()
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.settimeout(5.0)
                s.sendto(fd_mod._MAGIC + b"1", ("127.0.0.1", port))
                replies.append(s.recvfrom(512)[0])
        finally:
            srv.stop()
    assert fd_mod._MAGIC == jfd._MAGIC
    assert replies[0] == replies[1] == \
        b'bpshb1 {"server": 0, "stale": []}'


# -- the heartbeat init() arms ------------------------------------------------


def test_init_heartbeat_bind_retried_under_the_policy(monkeypatch,
                                                      thread_count):
    """``_arm_heartbeat`` (the part of ``init()`` that runs at a world
    above one) retries a UDP bind that races a previous socket's
    teardown, and /healthz reports the beat's age once armed."""
    port = free_port()
    monkeypatch.setenv("BYTEPS_HEARTBEAT_PORT", str(port))
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    blocker = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    blocker.bind(("127.0.0.1", port))
    threading.Timer(0.3, blocker.close).start()
    cfg = pcfg.Config(heartbeat_on=True, heartbeat_interval_s=0.05,
                      heartbeat_timeout_s=30.0, retry_max_attempts=20,
                      retry_base_delay_s=0.05, retry_max_delay_s=0.1)

    class Comm:
        rank, size = 0, 2

    hb = api._arm_heartbeat(cfg, Comm())
    try:
        assert counters.get("retry.attempt") >= 1
        assert hb.rank == 0 and hb.num_ranks == 2
        monkeypatch.setattr(api, "_heartbeat", hb)
        assert hb.wait_server(5.0)
        age = pobs.healthz()["last_heartbeat_age_s"]
        assert age is not None and age < 5.0
        assert "heartbeat" not in pobs.healthz().get("omitted", [])
    finally:
        hb.stop()
    assert pobs.healthz()["last_heartbeat_age_s"] is not None
    api._stop_heartbeat()
    assert api._heartbeat is None


def test_init_arms_no_heartbeat_at_a_world_of_one():
    api.init(pcfg.Config(heartbeat_on=True), device="cpu")
    try:
        assert api._heartbeat is None
        assert pobs.healthz()["last_heartbeat_age_s"] is None
    finally:
        api.shutdown()


# -- the engine's sync deadline -------------------------------------------------


def _wedge_next_unit(eng, seconds):
    """The NEXT unit the syncer retires blocks ``seconds`` (one shot)."""
    orig = eng._block

    def _wedge_once(done):
        eng._block = orig
        time.sleep(seconds)
        return orig(done)
    eng._block = _wedge_once


def test_sync_deadline_off_by_default():
    assert pcfg.Config().sync_deadline_s == 0.0
    api.init(pcfg.Config(), device="cpu")
    try:
        assert api.engine()._deadline_thread is None
    finally:
        api.shutdown()


def test_sync_deadline_config_validation(monkeypatch):
    with pytest.raises(ValueError, match="sync_deadline_s"):
        pcfg.Config(sync_deadline_s=-1.0)
    monkeypatch.setenv("BYTEPS_SYNC_DEADLINE_S", "2.5")
    pcfg.reset_config()
    assert pcfg.get_config().sync_deadline_s == 2.5


def test_sync_deadline_fires_installed_action_not_exit(exits):
    """A wedged unit trips the deadline: the installed action receives
    the empty-stale-set evidence once, the counter and the flight
    recorder record it, the process does not exit, and the unit still
    completes once the wedge resolves."""
    calls = []
    install_failure_action(lambda stale: calls.append(set(stale)))
    api.init(pcfg.Config(sync_deadline_s=0.3), device="cpu")
    try:
        eng = api.engine()
        assert eng._deadline_thread is not None
        _wedge_next_unit(eng, 1.2)
        h = api.push_pull_async(torch.ones(8), "g", op="sum")
        wait_for(lambda: calls, what="installed failure action call")
        assert calls[0] == set()
        out = h.wait(timeout=30)
        torch.testing.assert_close(out, torch.ones(8))
        assert calls == [set()]           # one report per wedged unit
        assert counters.get("engine.sync_deadline_trips") == 1
        assert exits == []
        # the next push completes with no second trip
        api.push_pull(torch.ones(8), "g2")
        assert counters.get("engine.sync_deadline_trips") == 1
    finally:
        api.shutdown()


def test_sync_deadline_trips_on_a_chaos_delay_at_sync(exits):
    """The chaos ``sync`` site sits inside the stamped wait: a delay
    there longer than the deadline is a wedged unit."""
    calls = []
    install_failure_action(lambda stale: calls.append(set(stale)))
    api.init(pcfg.Config(sync_deadline_s=0.3), device="cpu")
    try:
        inj.arm("delay:site=sync:p=1:ms=900", seed=1)
        h = api.push_pull_async(torch.ones(8), "g")
        wait_for(lambda: calls, what="installed failure action call")
        inj.disarm()
        h.wait(timeout=30)
        assert counters.get("engine.sync_deadline_trips") == 1
        assert counters.get("fault.delay") >= 1
        assert exits == []
    finally:
        inj.disarm()
        api.shutdown()


def test_concurrent_stall_reports_fire_the_action_once(exits):
    calls = []
    entered = threading.Event()

    def slow_action(stale):
        calls.append(set(stale))
        entered.set()
        time.sleep(0.5)         # the first report is still in flight...

    install_failure_action(slow_action)
    t = threading.Thread(target=fd_mod.data_path_stalled,
                         args=(1.0, "first"))
    t.start()
    assert entered.wait(5.0)
    fd_mod.data_path_stalled(1.0, "second")     # ...when the second lands
    t.join(timeout=5)
    assert calls == [set()]
    assert counters.get("failure_detector.stall_suppressed") == 1
    assert exits == []
    fd_mod.data_path_stalled(2.0, "third")      # a later stall escalates
    assert len(calls) == 2


def test_step_watchdog_default_prefers_installed_action(exits):
    calls = []
    install_failure_action(lambda stale: calls.append(set(stale)))
    wd = StepWatchdog(timeout=0.2).start()
    try:
        wait_for(lambda: calls, timeout=5.0, what="watchdog stall action")
        assert calls[0] == set()
        assert exits == []
    finally:
        wd.stop()
    install_failure_action(None)
    wd2 = StepWatchdog(timeout=0.2).start()
    try:
        wait_for(lambda: exits, timeout=5.0, what="last-resort exit")
        assert exits[0] == 17
    finally:
        wd2.stop()


def test_drain_budget_follows_the_deadline():
    api.init(pcfg.Config(sync_deadline_s=0.3), device="cpu")
    try:
        eng = api.engine()
        _wedge_next_unit(eng, 6.0)
        install_failure_action(lambda stale: None)
        api.push_pull_async(torch.ones(8), "g")
        t0 = time.monotonic()
        eng.drain()
        # max(5, deadline) = 5 s, not the 60 s default
        assert 4.5 < time.monotonic() - t0 < 50.0
    finally:
        api.shutdown(wait=False)
    assert not api.initialized()


# -- the reconcile route (the JAX package's two membership cases of
#    tests/test_sync_deadline.py) ---------------------------------------------


@pytest.fixture
def member_exits(monkeypatch, exits):
    """``exits`` plus the membership's own escalation alias, and no
    membership left active after the test."""
    from byteps_tpu_torch.fault import membership as mm
    monkeypatch.setattr(mm, "_exit", exits.append)
    yield exits
    m = mm.active_membership()
    if m is not None:
        m.stop()
    mm._active_ref = None


def test_sync_deadline_routes_through_reconcile_not_exit(member_exits):
    """Deadline trip -> the installed ``ElasticMembership.on_failure`` ->
    reconcile (epoch + 1, same world) -> the engine suspended and resumed;
    the wedged unit's late result is dropped as stale."""
    from byteps_tpu_torch.fault import membership as mm
    port = free_port()
    api.init(pcfg.Config(sync_deadline_s=0.3,
                         membership_rendezvous_timeout_s=3.0,
                         membership_sync_timeout_s=10.0), device="cpu")
    m = mm.ElasticMembership(0, [0], f"127.0.0.1:{port}").start()
    try:
        install_failure_action(m.on_failure)
        eng = api.engine()
        _wedge_next_unit(eng, 1.5)
        h = eng.push_pull_async(torch.ones(8), "g", op="sum")
        wait_for(lambda: mm.current_epoch() >= 1, what="reconcile epoch")
        assert counters.get("membership.reconcile_started") >= 1
        with pytest.raises(RuntimeError, match="stale membership epoch"):
            h.wait(timeout=30)
        wait_for(lambda: api.initialized() and api.engine()._running,
                 what="resumed engine")
        wait_for(lambda: m.view() == mm.MembershipView(1, (0,)),
                 what="reconciled view applied")
        assert api.engine() is not eng and api.device().type == "cpu"
        out = api.engine().push_pull(torch.ones(8), "g2", op="sum")
        torch.testing.assert_close(out, torch.ones(8))
        assert member_exits == []
    finally:
        install_failure_action(None)
        m.stop()


def test_stall_during_inflight_shrink_does_not_double_exit(member_exits,
                                                          monkeypatch):
    """A stall report landing while another thread applies a world
    change follows that change (``wait_ready``): no second transition,
    no exit.

    The two threads are ordered by hooks, not by timing: the applier
    marks that its transition has begun (inside ``_maybe_apply``, at the
    engine's resume) and holds there until the report is following it,
    so the report can land neither before the transition nor after it."""
    from byteps_tpu_torch.fault import membership as mm
    port = free_port()
    # the applied view resumes an engine (as the JAX one does): on the
    # host here
    m = mm.ElasticMembership(0, [0], f"127.0.0.1:{port}",
                             rendezvous_timeout_s=2.0, sync_timeout_s=5.0,
                             device="cpu").start()
    began, following = threading.Event(), threading.Event()
    resume = mm._resume_for_world
    wait_ready = m.wait_ready

    def resume_once_followed(view, device):
        began.set()
        following.wait(timeout=60)
        return resume(view, device)

    def wait_ready_marked(epoch, timeout=None):
        following.set()
        return wait_ready(epoch, timeout=timeout)

    monkeypatch.setattr(mm, "_resume_for_world", resume_once_followed)
    monkeypatch.setattr(m, "wait_ready", wait_ready_marked)
    try:
        install_failure_action(m.on_failure)
        applier = threading.Thread(
            target=lambda: m._maybe_apply(mm.MembershipView(1, (0,))))
        mm.set_epoch(1)          # the shrink's guard is already up
        applier.start()
        assert began.wait(timeout=60), "the transition never began"
        fd_mod.data_path_stalled(3.0, "watchdog during shrink")
        applier.join(timeout=30)
        assert following.is_set()
        assert m.view().epoch == 1
        assert counters.get("membership.reconcile_started") == 0
        assert member_exits == []
    finally:
        install_failure_action(None)
        m.stop()


def test_sync_deadline_wedge_reconciles_world_no_exit():
    """The second acceptance lane: rank 1's engine wedges for 4s at step
    5 with BYTEPS_SYNC_DEADLINE_S=1.  The deadline fires, the installed
    action runs a membership reconcile (epoch +1, world unchanged — the
    wedge resolves, nobody is actually dead), members parked in the step
    sync JOIN the rendezvous, and the run finishes on the FULL world
    with the exact fault-free result.  No process exits."""
    n, wedge_at = 9, 5
    bus = free_port()
    procs = {
        r: spawn(r, (0, 1, 2), bus, None, n, extra={
            "BYTEPS_SYNC_DEADLINE_S": "1.0",
            "BYTEPS_MEMBERSHIP_RENDEZVOUS_TIMEOUT": "8",
            **({"BYTEPS_ELASTIC_WEDGE_STEP": str(wedge_at),
                "BYTEPS_ELASTIC_WEDGE_S": "4"} if r == 1 else {})})
        for r in (0, 1, 2)}
    outs = communicate(procs)

    assert "WEDGING 1" in outs[1], outs[1][-3000:]
    trips = next(line for line in outs[1].splitlines()
                 if line.startswith("DEADLINE-TRIPS "))
    assert int(trips.split()[1]) >= 1, trips        # the deadline fired
    assert int(trips.split()[3]) >= 1, trips        # ...into a reconcile
    finals = {}
    for r in (0, 1, 2):
        # rc 0 everywhere IS the os._exit proof: the old escalation (17)
        # would show up as a nonzero exit
        assert procs[r].returncode == 0, outs[r][-3000:]
        finals[r] = final(outs[r])
        assert finals[r][0] >= 1 and finals[r][1] == "0,1,2", finals[r]
    expected = _simulate(0.0, (0, 1, 2), n)         # world never changed
    for r in (0, 1, 2):
        assert finals[r][2] == pytest.approx(expected, abs=1e-5), (
            finals, expected)
