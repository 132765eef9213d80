"""The port's fleet reconciler (``byteps_tpu_torch/launcher/
reconciler.py``) and the serving-host directory it reads, held against
the JAX package's (``tests/test_fleet.py``): the directory's drain and
victim semantics, locally and over the port's membership bus (a JAX
directory client reads the port bus), the host's drain latch, the
``serve_host_start`` crash-looper predicate, the reconciler's core on
fake processes and an injected clock (convergence without over-spawn,
crash-loop backoff as a not-before stamp, the flap ban, drains and
their escalation, proposed victims) step for step equal to the JAX
reconciler's, the autoscaler's ``dispose="drain"``, the ``/debug/state``
and ``/healthz`` sections, and a real fleet of the port's ``serve_host``
processes on the CPU: a SIGKILLed host restarted, a crash-looper
banned, a scale-down drained."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from byteps_tpu.launcher.reconciler import FleetReconciler as JReconciler
from byteps_tpu.server import serving_tier as jst
from byteps_tpu_torch.common.telemetry import counters
from byteps_tpu_torch.fault import injector as inj
from byteps_tpu_torch.fault.membership import MembershipView, _BusServer
from byteps_tpu_torch.launcher import reconciler as prec
from byteps_tpu_torch.launcher.reconciler import FleetReconciler
from byteps_tpu_torch.server.kv_store import KVStore
from byteps_tpu_torch.server.serve_autoscaler import TierAutoscaler
from byteps_tpu_torch.server.serving_tier import (ServingHostCore,
                                                  ServingTier,
                                                  TierDirectory, inproc_host)

from .torch_fault_common import (REPO, child_env,  # noqa: F401
                                 fresh_fault_state, free_port)


class _FakeProc:
    def __init__(self):
        self.rc = None
        self.terminated = False

    def poll(self):
        return self.rc

    def exit(self, code):
        self.rc = code

    def terminate(self):
        self.terminated = True
        self.rc = -15

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


class _FixedRetry:
    def backoff(self, attempt):
        return 0.5 * attempt


def _core(hid):
    return ServingHostCore(host_id=hid, device="cpu")


def _mk_rec(cls, directory, spawn_fn, clock, **kw):
    for k, v in (("flap_limit", 3), ("flap_window_s", 30.0),
                 ("drain_deadline_s", 5.0), ("ban_s", 30.0),
                 ("max_hosts", 8)):
        kw.setdefault(k, v)
    return cls(directory=directory, spawn_fn=spawn_fn, retry=_FixedRetry(),
               interval_s=0.05, now=lambda: clock[0], **kw)


def _await(pred, deadline_s, what):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if pred():
            return
        time.sleep(0.1)
    pytest.fail(f"timeout after {deadline_s}s waiting for {what}")


# -- the directory -------------------------------------------------------------


def test_directory_drain_mark_gen_and_victims_busless():
    d = TierDirectory(static_hosts={0: ("h", 1), 1: ("h", 2), 2: ("h", 3)})
    gen0, hosts = d.hosts()
    assert sorted(hosts) == [0, 1, 2]
    d.register(("h", 2), host_id=1, draining=True)
    gen1, hosts = d.hosts()
    assert gen1 > gen0 and sorted(hosts) == [0, 2]
    assert d.info()["draining"] == [1] and 1 in d.info()["hosts"]
    d.register(("h", 2), host_id=1, draining=True)
    assert d.hosts()[0] == gen1
    d.propose_victims([2, 9])
    assert d.info()["victims"] == [2] and d.hosts()[0] == gen1
    d.unregister(1)
    d.unregister(2)
    assert d.info()["draining"] == [] and d.info()["victims"] == []


def test_bus_directory_drain_victims_and_target_read_by_both_packages():
    """Over the port's bus: drain marks, victims and the target, read
    back by a second port client and by a JAX directory client."""
    port = free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0,)), 5.0, 5.0)
    try:
        addr = f"127.0.0.1:{port}"
        d = TierDirectory(bus=addr, ttl_s=5.0)
        d.register(("127.0.0.1", 7000), host_id=0)
        d.register(("127.0.0.1", 7001), host_id=1)
        gen0, hosts = d.hosts(force=True)
        assert sorted(hosts) == [0, 1]
        d.register(("127.0.0.1", 7001), host_id=1, draining=True)
        gen1, hosts = d.hosts(force=True)
        assert gen1 > gen0 and sorted(hosts) == [0]
        d.set_target(4)
        d.propose_victims([0])
        for other in (TierDirectory(bus=addr), jst.TierDirectory(bus=addr)):
            other.refresh(force=True)
            info = other.info()
            assert info["draining"] == [1] and 1 in info["hosts"]
            assert info["target"] == 4 and info["victims"] == [0]
            assert info["gen"] == gen1
        d.unregister(1)
        d.unregister(0)
        d2 = TierDirectory(bus=addr)
        d2.refresh(force=True)
        assert d2.info()["draining"] == [] and d2.info()["victims"] == []
    finally:
        bus.close()


def test_host_core_drain_latch_idempotent_and_counted():
    core = _core(5)
    r = core.control({"cmd": "drain"})
    assert r["draining"] is True and "inflight" in r
    assert core.control({"cmd": "drain"})["draining"] is True
    assert core.draining.is_set()
    assert counters.get("serve.drain_requested") == 2
    assert core.debug_state()["draining"] is True


@pytest.mark.chaos
def test_kill_site_serve_host_start_validation_and_counter():
    with pytest.raises(ValueError, match="kill-only"):
        inj.parse_spec("delay:site=serve_host_start:ms=5")
    with pytest.raises(ValueError, match="step"):
        inj.parse_spec("kill:site=serve_host_start")
    killed = []
    inj.arm("kill:step=2:site=serve_host_start", rank=0)
    orig = inj._exit
    inj._exit = lambda code: killed.append(code)
    try:
        inj.on_serve()
        inj.on_step()
        inj.on_serve_start()
        assert not killed
        inj.on_serve_start()
        assert killed
    finally:
        inj._exit = orig
        inj.disarm()


# -- the reconciler's core, step for step against the JAX one ------------------


class _World:
    """One package's reconciler over a local directory and fake
    processes; ``register`` makes a spawned host register at spawn (as
    a quick HOST-UP), ``cores`` puts a host core behind each id so the
    drain RPC lands on a real latch."""

    def __init__(self, pkg, register=True, cores=False, **kw):
        self.pkg = pkg
        mod = jst if pkg == "jax" else None
        self.d = (jst.TierDirectory() if pkg == "jax" else TierDirectory())
        self.procs, self.log, self.cores = {}, [], {}
        self.clock = [0.0]

        def spawn(hid, env):
            assert env["BYTEPS_SERVE_HOST_ID"] == str(hid)
            assert "BYTEPS_FAULT_SPEC" not in env
            p = _FakeProc()
            self.procs[hid] = p
            self.log.append(hid)
            if cores:
                self.cores[hid] = (jst.inproc_host(
                    jst.ServingHostCore(host_id=hid)) if mod else
                    inproc_host(_core(hid)))
            if register:
                self.d.register(("127.0.0.1", 1000 + hid), host_id=hid)
            return p

        cls = JReconciler if pkg == "jax" else FleetReconciler
        self.rec = _mk_rec(cls, self.d, spawn, self.clock, **kw)


def _script_crash_loop(w):
    views = []
    w.d.set_target(2)
    views.append(w.rec.step())
    for _ in range(3):
        w.procs[1].exit(1)
        views.append(w.rec.step())
        views.append(dict(w.rec.debug_state()["pending_restarts"]))
        w.clock[0] += 2.0
        views.append(w.rec.step())
    views.append(w.rec.step())
    return views, list(w.log), w.rec.debug_state()


def _script_scale_down(w):
    views = []
    w.d.set_target(3)
    views.append(w.rec.step())
    w.d.set_target(2)
    views.append(w.rec.step())
    w.procs[2].exit(0)
    w.d.unregister(2)
    views.append(w.rec.step())
    w.d.set_target(1)
    views.append(w.rec.step())
    w.clock[0] += 5.1
    views.append(w.rec.step())
    views.append(w.rec.step())
    views.append(sorted(h for h, c in w.cores.items()
                        if c.draining.is_set()))
    views.append(sorted(h for h, p in w.procs.items() if p.terminated))
    return views, list(w.log), w.rec.debug_state()


def _script_converge_and_victims(w):
    views = []
    w.d.set_target(3)
    views.append(w.rec.step())
    views.append(w.rec.step())
    for h in list(w.procs):
        w.d.register(("127.0.0.1", 1000 + h), host_id=h)
    views.append(w.rec.step())
    w.d.set_target(99)
    views.append(w.rec.step())
    w.d.propose_victims([0])
    views.append(w.rec.step())
    return views, list(w.log), w.rec.debug_state()


@pytest.mark.parametrize("script,kw", [
    (_script_crash_loop, {}),
    (_script_scale_down, {"cores": True}),
    (_script_converge_and_victims, {"register": False, "cores": True,
                                    "max_hosts": 4}),
], ids=["crash_backoff_ban", "drain_escalate", "converge_victims"])
def test_reconciler_steps_equal_the_jax_reconcilers(script, kw):
    """The same scripted fleet (fake processes, one clock, fixed
    backoff) through both reconcilers: every pass's view, the spawn log
    and the final debug state are equal; the counters agree with the
    JAX test's figures."""
    port = _World("port", **kw)
    jax = _World("jax", **kw)
    try:
        got, want = script(port), script(jax)
        assert got == want
    finally:
        port.rec.close()
        jax.rec.close()
    if script is _script_crash_loop:
        assert counters.get("reconcile.crashed") == 3
        assert counters.get("reconcile.restarted") == 2
        assert counters.get("reconcile.banned") == 1
        assert got[1] == [0, 1, 1, 1, 2]
    elif script is _script_scale_down:
        assert counters.get("reconcile.drained") == 1
        assert counters.get("reconcile.drain_escalated") == 1
        assert counters.get("reconcile.crashed") == 0
        assert got[0][-2] == [1, 2] and got[0][-1] == [1]
    else:
        assert got[1][:4] == [0, 1, 2, 3]


def test_autoscaler_dispose_drain_proposes_instead_of_retiring():
    with pytest.raises(ValueError, match="dispose"):
        TierAutoscaler(object(), dispose="nuke")
    keys = [f"a{i}" for i in range(6)]
    d = TierDirectory(static_hosts={i: ("127.0.0.1", i + 1)
                                    for i in range(3)})
    for i in range(3):
        inproc_host(_core(i))
    store = KVStore(device="cpu")
    for k in keys:
        store.init_key(k, np.zeros(8, np.float32))
    tier = ServingTier(store, directory=d, replicas=2, cut_interval_s=None)
    try:
        tier.cut()
        asc = TierAutoscaler(tier, min_hosts=1, max_hosts=4, cooldown_s=0.0,
                             low_pulls_per_s=50.0, dispose="drain")
        assert asc.step(force=True).action == "hold"
        decision = asc.step(force=True)
        assert decision.action == "down" and decision.victims
        assert len(tier.ring.hosts()) == 3
        assert tier.directory.info()["victims"] == decision.victims
        assert tier.directory.target() == decision.target
    finally:
        tier.close()


def test_debug_state_and_healthz_reconciler_sections():
    from byteps_tpu_torch.common import obs_server
    w = _World("port")
    try:
        w.d.set_target(1)
        w.rec.step()
        mine = w.rec.debug_state()
        doc = obs_server.debug_state()
        assert mine in doc["reconciler"] and mine["supervised"] == [0]
        line = {k: mine[k] for k in ("supervised", "draining", "banned")}
        assert line in obs_server.healthz()["reconciler"]
    finally:
        w.rec.close()


def test_default_spawn_runs_the_ports_serve_host(monkeypatch):
    """The reconciler's own factory spawns this package's host on the
    reconciler's device, never the JAX package's."""
    seen = []

    class _P:
        stdout = None

        def __init__(self, argv, **kw):
            seen.append((argv, kw["env"]))
            r, w = os.pipe()
            os.close(w)
            self.stdout = os.fdopen(r)

    monkeypatch.setattr(prec.subprocess, "Popen", _P)
    for dev in ("cuda", "cpu"):
        rec = FleetReconciler(directory=TierDirectory(), device=dev)
        rec._spawn(7)
        rec.close()
        argv, env = seen[-1]
        assert argv[1:] == ["-m", "byteps_tpu_torch.server.serve_host",
                            "--device", dev]
        assert env["BYTEPS_SERVE_HOST_ID"] == "7"


# -- a real fleet of the port's serving hosts --------------------------------


def test_real_fleet_restart_flap_ban_and_drain():
    """A reconciler at target 2 over the port's bus spawns two of the
    port's ``serve_host`` processes (CPU); a SIGKILLed host is restarted
    in place; a host that dies at every start
    (``kill:site=serve_host_start:step=1``) is banned and its arc
    re-homed under a fresh id; at target 1 the youngest host drains
    (``HOST-DRAINED``, exit 0) and the drain completes."""
    port = free_port()
    bus = _BusServer(("127.0.0.1", port), MembershipView(0, (0,)), 5.0, 5.0)
    procs, outs = {}, {}

    def spawn(hid, env):
        env = dict(env, **{k: v for k, v in child_env().items()
                           if k in ("PYTHONPATH", "BYTEPS_LOG_LEVEL")})
        if hid == 2:
            env["BYTEPS_FAULT_SPEC"] = "kill:site=serve_host_start:step=1"
        p = subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.server.serve_host",
             "--device", "cpu"], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        buf = outs.setdefault(hid, [])
        threading.Thread(target=lambda: buf.extend(p.stdout),
                         daemon=True).start()
        procs.setdefault(hid, []).append(p)
        return p

    from byteps_tpu_torch.common.retry import RetryPolicy
    rec = FleetReconciler(bus=f"127.0.0.1:{port}", spawn_fn=spawn,
                          interval_s=0.1, flap_limit=2, flap_window_s=60.0,
                          drain_deadline_s=20.0, ban_s=60.0,
                          retry=RetryPolicy(max_attempts=10,
                                            base_delay_s=0.05,
                                            max_delay_s=0.1,
                                            deadline_s=60.0))
    d = TierDirectory(bus=f"127.0.0.1:{port}")
    stop = threading.Event()
    loop = threading.Thread(target=rec.run, args=(stop,), daemon=True)
    loop.start()
    try:
        d.set_target(2)
        _await(lambda: sorted(d.hosts(force=True)[1]) == [0, 1], 60,
               "hosts 0 and 1 up")
        old_addr = d.hosts(force=True)[1][1]
        os.kill(procs[1][0].pid, signal.SIGKILL)
        _await(lambda: counters.get("reconcile.restarted") >= 1
               and 1 in d.hosts(force=True)[1]
               and d.hosts(force=True)[1][1] != old_addr, 60,
               "host 1 restarted at a new address")
        assert len(procs[1]) == 2
        # a third host that crash-loops at start: banned, re-homed
        d.set_target(3)
        _await(lambda: counters.get("reconcile.banned") >= 1, 60,
               "the crash-looper banned")
        assert 2 in rec.debug_state()["banned"]
        _await(lambda: 3 in d.hosts(force=True)[1], 60,
               "the replacement under id 3")
        # scale down: the youngest arc drains cleanly
        d.set_target(2)
        _await(lambda: counters.get("reconcile.drained") >= 1, 60,
               "the drain completes")
        assert procs[3][-1].wait(timeout=30) == 0
        _await(lambda: any("HOST-DRAINED 3" in ln for ln in outs[3]), 10,
               "HOST-DRAINED")
        assert sorted(d.hosts(force=True)[1]) == [0, 1]
        assert counters.get("reconcile.drain_escalated") == 0
    finally:
        stop.set()
        loop.join(timeout=10)
        rec.close(kill_hosts=True)
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bus.close()
