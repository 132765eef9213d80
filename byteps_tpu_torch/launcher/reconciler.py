"""Fleet reconciler: the autoscaler proposes, THIS loop disposes; port of
``byteps_tpu/launcher/reconciler.py``.

``python -m byteps_tpu_torch.launcher.reconciler --bus HOST:PORT
[--device cuda|cpu]`` runs the reconciliation loop that
turns the serving tier's control plane into an actual control LOOP: it
watches the membership bus — the ``serve_dir`` generation, TTL
expiries, the autoscaler's ``serve_scale`` target and victim proposals
— and converges the real fleet to the target:

- **scale-up** spawns real serving hosts of this package
  (``python -m byteps_tpu_torch.server.serve_host --device <device>``,
  one per missing host, bus-allocated addresses, deterministic next-free
  ids; ``device`` defaults to ``cuda``);
- **crashes** are restarted in place under a full-jitter crash-loop
  backoff (:class:`~byteps_tpu_torch.common.retry.RetryPolicy`); a host that
  flaps ``BYTEPS_RECONCILE_FLAP_LIMIT`` times inside
  ``BYTEPS_RECONCILE_FLAP_WINDOW`` is BANNED through the directory's
  ban machinery (``reconcile.banned``) and its arc re-homed
  under a fresh id by the next convergence pass;
- **scale-down** retires victims through the graceful drain protocol:
  a ``serve_ctl drain`` flips the host to DRAINING (the directory mark
  bumps the generation, routers stop sending new pulls at their next
  sync), in-flight pulls finish, the host's final unregister handshake
  lands, clean exit — bounded by ``BYTEPS_RECONCILE_DRAIN_DEADLINE``,
  past which the reconciler escalates to SIGTERM/kill and force-
  unregisters, so a wedged host cannot park a scale-down forever.

Everything observable: ``reconcile.*`` counters, target/actual gauges,
flight-recorder events, and a ``/debug/state`` component.

:meth:`FleetReconciler.step` is one non-blocking reconcile pass (the
unit-testable core — backoff is a not-before timestamp, never a sleep
in the loop); :meth:`run` is the standalone loop.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from ..common.logging import get_logger
from ..common.telemetry import counters, gauges

__all__ = ["FleetReconciler", "main"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_spawn(hid: int, env: dict, device: str = "cuda"):
    """Spawn one real serving-host process of this package on
    ``device``.  stdout is piped and drained on a daemon thread — a
    chaos-noisy host must not wedge on a full 64 KiB pipe."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "byteps_tpu_torch.server.serve_host",
         "--device", str(device)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    threading.Thread(target=lambda f=proc.stdout: f.read(),
                     daemon=True, name=f"bps-reconcile-drain-{hid}").start()
    return proc


class FleetReconciler:
    """Converges the actual serving fleet to the bus's target.

    ``spawn_env`` customizes the child environment: a dict of overrides,
    or a callable ``host_id -> dict`` (chaos tests arm a fault spec on
    ONE specific host this way).  ``spawn_fn(host_id, env) -> proc`` is
    the process factory (injectable: unit tests supervise fakes);
    ``retry`` the backoff policy (injectable rng, so the crash-loop
    schedule is pinned without wall-clock waits); ``now`` the clock;
    ``device`` where the default factory's hosts decode (default
    ``cuda``).
    """

    def __init__(self, bus=None, *, directory=None,
                 interval_s: Optional[float] = None,
                 flap_limit: Optional[int] = None,
                 flap_window_s: Optional[float] = None,
                 drain_deadline_s: Optional[float] = None,
                 ban_s: Optional[float] = None,
                 max_hosts: Optional[int] = None,
                 spawn_env=None,
                 spawn_fn: Optional[Callable] = None,
                 retry=None,
                 conn_kw: Optional[dict] = None,
                 now: Callable[[], float] = time.monotonic,
                 device: str = "cuda"):
        from ..common.config import get_config
        from ..common.retry import RetryPolicy
        from ..server.serving_tier import TierDirectory
        cfg = get_config()
        self.directory = directory if directory is not None else \
            TierDirectory(bus=bus)
        self.interval_s = (cfg.reconcile_interval_s if interval_s is None
                           else float(interval_s))
        self.flap_limit = (cfg.reconcile_flap_limit if flap_limit is None
                           else int(flap_limit))
        self.flap_window_s = (cfg.reconcile_flap_window_s
                              if flap_window_s is None
                              else float(flap_window_s))
        self.drain_deadline_s = (cfg.reconcile_drain_deadline_s
                                 if drain_deadline_s is None
                                 else float(drain_deadline_s))
        self.ban_s = cfg.reconcile_ban_s if ban_s is None else float(ban_s)
        self.max_hosts = (cfg.serve_tier_max_hosts if max_hosts is None
                          else int(max_hosts))
        self._spawn_env = spawn_env
        self.device = str(device)
        self._spawn_fn = (spawn_fn if spawn_fn is not None else
                          lambda hid, env: default_spawn(hid, env,
                                                         self.device))
        self._retry = retry if retry is not None else \
            RetryPolicy.from_config(cfg)
        self._conn_kw = dict(conn_kw or {})
        self._now = now
        self._lock = threading.Lock()
        self._procs: Dict[int, object] = {}      # supervised hosts
        self._flaps: Dict[int, List[float]] = {}  # crash times per host
        self._pending: Dict[int, float] = {}     # hid -> respawn not-before
        self._draining: Dict[int, float] = {}    # hid -> escalation deadline
        self._killing: set = set()               # escalated, awaiting reap
        self._banned: set = set()                # never reuse these ids
        self._stop = threading.Event()
        from ..common import metrics as _metrics
        _metrics.register_component("reconciler", self)

    # -- spawning ------------------------------------------------------------

    def _child_env(self, hid: int) -> dict:
        env = dict(os.environ)
        # the child must import byteps_tpu_torch even when the
        # reconciler was launched from a different cwd
        env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
        if self.directory.bus is not None:
            env["BYTEPS_SERVE_TIER_BUS"] = "%s:%d" % self.directory.bus
        env["BYTEPS_SERVE_HOST_ID"] = str(hid)
        env["BYTEPS_SERVE_TIER_TTL"] = str(self.directory.ttl_s)
        # durable restart-in-place (server/wal.py): a restarted host id
        # gets the SAME per-host durable dir its predecessor persisted
        # to, so it restores its arc from local disk instead of pulling
        # the full arc back over DCN (the reconciler's restart path
        # prefers local recovery over a full re-sync)
        from ..common.config import get_config
        cfg = get_config()
        if cfg.durable_dir:
            env["BYTEPS_DURABLE_DIR"] = os.path.join(
                cfg.durable_dir, f"host-{hid}")
        env.pop("BYTEPS_FAULT_SPEC", None)   # chaos is opt-IN per host
        over = self._spawn_env
        if callable(over):
            over = over(hid)
        env.update(over or {})
        return env

    def _spawn(self, hid: int, *, restart: bool = False) -> None:
        from ..common import flight_recorder as _flight
        proc = self._spawn_fn(hid, self._child_env(hid))
        with self._lock:
            self._procs[hid] = proc
        if restart:
            counters.inc("reconcile.restarted")
            _flight.record("reconcile.restart", host=hid,
                           flaps=len(self._flaps.get(hid, ())))
        else:
            counters.inc("reconcile.spawned")
            _flight.record("reconcile.spawn", host=hid)
        get_logger().warning("reconciler: %s serve host %d",
                             "restarted" if restart else "spawned", hid)

    def _next_id(self, taken) -> int:
        used = set(taken) | set(self._procs) | set(self._pending) \
            | self._banned
        hid = 0
        while hid in used:
            hid += 1
        return hid

    # -- crash / flap handling ----------------------------------------------

    def _ban(self, hid: int) -> None:
        from ..common import flight_recorder as _flight
        self._banned.add(hid)
        self._flaps.pop(hid, None)
        self._pending.pop(hid, None)
        try:
            # the existing directory ban: re-registration under this id
            # is refused for ban_s, so the crash-looper cannot rejoin
            # the ring; its arc re-homes to the replacement id the next
            # convergence pass spawns
            self.directory.unregister(hid, ban_s=self.ban_s)
        except (ConnectionError, TimeoutError):
            get_logger().warning("reconciler: ban of host %d could not "
                                 "reach the bus (TTL finishes the "
                                 "eviction)", hid)
        counters.inc("reconcile.banned")
        _flight.record("reconcile.banned", host=hid,
                       flap_limit=self.flap_limit, ban_s=self.ban_s)
        get_logger().error(
            "reconciler: serve host %d banned — %d crashes inside %.1fs "
            "(arc re-homes under a fresh id)", hid, self.flap_limit,
            self.flap_window_s)

    def _reap(self, now: float) -> None:
        """Collect exited supervised processes: clean drain exits
        complete the drain; crashes count toward the flap window and
        schedule a backed-off restart or the ban."""
        from ..common import flight_recorder as _flight
        with self._lock:
            dead = [(h, p) for h, p in self._procs.items()
                    if p.poll() is not None]
            for h, _ in dead:
                del self._procs[h]
        for hid, proc in dead:
            rc = proc.poll()
            if hid in self._killing:
                self._killing.discard(hid)
                self._draining.pop(hid, None)
                continue
            if hid in self._draining and rc == 0:
                self._draining.pop(hid, None)
                counters.inc("reconcile.drained")
                _flight.record("reconcile.drained", host=hid)
                get_logger().warning(
                    "reconciler: serve host %d drained clean", hid)
                continue
            self._draining.pop(hid, None)
            counters.inc("reconcile.crashed")
            _flight.record("reconcile.crash", host=hid, code=rc)
            flaps = [t for t in self._flaps.get(hid, [])
                     if now - t <= self.flap_window_s] + [now]
            self._flaps[hid] = flaps
            if len(flaps) >= self.flap_limit:
                self._ban(hid)
                continue
            # full-jitter crash-loop backoff, as a not-before stamp (the
            # loop never sleeps on one host's schedule)
            delay = self._retry.backoff(len(flaps))
            self._pending[hid] = now + delay
            get_logger().warning(
                "reconciler: serve host %d crashed (exit %s, flap "
                "%d/%d); restart in %.3fs", hid, rc, len(flaps),
                self.flap_limit, delay)

    # -- drain protocol (scale-down) -----------------------------------------

    def _start_drain(self, hid: int, addr, now: float) -> None:
        if hid in self._draining or hid in self._banned:
            return
        from ..common import flight_recorder as _flight
        from ..server.serving_tier import _close_endpoint, \
            _resolve_endpoint
        self._draining[hid] = now + self.drain_deadline_s
        counters.inc("reconcile.drain_started")
        _flight.record("reconcile.drain", host=hid,
                       deadline_s=self.drain_deadline_s)
        get_logger().warning("reconciler: draining serve host %d "
                             "(deadline %.1fs)", hid,
                             self.drain_deadline_s)
        try:
            ep = _resolve_endpoint(hid, addr, self._conn_kw)
            try:
                ep.serve_ctl(cmd="drain")
            finally:
                _close_endpoint(ep)
        except Exception as e:  # noqa: BLE001 — an unreachable host is
            # escalated by the deadline path, not crashed on here
            get_logger().warning("reconciler: drain ctl to host %d "
                                 "failed (%s); deadline will escalate",
                                 hid, e)

    def _check_drains(self, live: set, now: float) -> None:
        """Escalate drains past their deadline: kill the process (when
        supervised) and force the arc off the ring NOW."""
        from ..common import flight_recorder as _flight
        for hid, deadline in list(self._draining.items()):
            if hid not in live and hid not in self._procs:
                # unsupervised host finished its drain (left the
                # directory); the supervised path completes in _reap
                self._draining.pop(hid, None)
                counters.inc("reconcile.drained")
                _flight.record("reconcile.drained", host=hid)
                continue
            if now < deadline:
                continue
            counters.inc("reconcile.drain_escalated")
            _flight.record("reconcile.drain_escalated", host=hid)
            get_logger().error("reconciler: drain of serve host %d "
                               "missed its %.1fs deadline — killing",
                               hid, self.drain_deadline_s)
            proc = self._procs.get(hid)
            if proc is not None:
                self._killing.add(hid)
                try:
                    proc.terminate()
                except Exception:  # noqa: BLE001 — already gone
                    pass
            else:
                self._draining.pop(hid, None)
            try:
                self.directory.unregister(
                    hid, ban_s=max(10.0, 3 * self.directory.ttl_s))
            except (ConnectionError, TimeoutError):
                pass

    # -- the reconcile pass --------------------------------------------------

    def step(self) -> dict:
        """ONE non-blocking reconcile pass; returns the view it acted on
        (target, actual, spawned/draining ids) for tests and the debug
        endpoint."""
        now = self._now()
        self._reap(now)
        # backed-off restarts whose not-before expired
        for hid, t0 in sorted(self._pending.items()):
            if now >= t0 and hid not in self._procs:
                self._pending.pop(hid, None)
                self._spawn(hid, restart=True)
        try:
            info = self.directory.info()
        except (ConnectionError, TimeoutError):
            # a bus hiccup degrades to "no new decisions", never to a
            # crashed control loop
            return {"target": None, "actual": None, "bus": "unreachable"}
        hosts = {int(h) for h in info["hosts"]}
        draining = {int(h) for h in info.get("draining") or ()}
        for h in draining:
            # drains started elsewhere (or re-learned after a restart
            # of the reconciler itself) still get a deadline
            self._draining.setdefault(h, now + self.drain_deadline_s)
        target = info.get("target")
        actual = len(hosts - draining)
        # the autoscaler's explicit victims drain first
        for v in info.get("victims") or ():
            v = int(v)
            if v in hosts and v not in draining:
                self._start_drain(v, info["hosts"].get(v), now)
                draining.add(v)
                actual -= 1
        if target is not None:
            target = max(0, min(int(target), self.max_hosts))
            # spawns already in flight (no HOST-UP yet): count them or
            # every pass until registration would over-spawn
            starting = [h for h in self._procs
                        if h not in hosts
                        and self._procs[h].poll() is None]
            pending = [h for h in self._pending if h not in hosts]
            effective = actual + len(starting) + len(pending)
            if effective < target:
                for _ in range(target - effective):
                    self._spawn(self._next_id(hosts))
            elif actual > target:
                # victims beyond the autoscaler's proposals: probation
                # first (the gray host), else the highest id (youngest
                # arc — smallest remap)
                spare = actual - target
                order = ([h for h in sorted(info.get("probation") or ())
                          if h in hosts and h not in draining]
                         + [h for h in sorted(hosts, reverse=True)
                            if h not in draining])
                seen = set()
                for h in order:
                    if spare <= 0:
                        break
                    if h in seen:
                        continue
                    seen.add(h)
                    self._start_drain(h, info["hosts"].get(h), now)
                    draining.add(h)
                    spare -= 1
        self._check_drains(hosts, now)
        gauges.set("reconcile.target", -1 if target is None else target)
        gauges.set("reconcile.actual", actual)
        return {"target": target, "actual": actual,
                "hosts": sorted(hosts), "draining": sorted(draining),
                "supervised": sorted(self._procs),
                "pending": sorted(self._pending),
                "banned": sorted(self._banned)}

    # -- lifecycle -----------------------------------------------------------

    def run(self, stop: Optional[threading.Event] = None) -> None:
        """The standalone loop: reconcile every ``interval_s`` until
        ``stop`` (or :meth:`close`) is set."""
        stop = stop if stop is not None else self._stop
        while not stop.is_set() and not self._stop.is_set():
            try:
                self.step()
            except Exception:  # noqa: BLE001 — one bad pass must not
                # kill the control loop; the next interval retries
                get_logger().error("reconciler: reconcile pass failed",
                                   exc_info=True)
            stop.wait(self.interval_s)

    def close(self, kill_hosts: bool = False) -> None:
        """Stop the loop.  ``kill_hosts=True`` also terminates every
        supervised host (test teardown); the default leaves the fleet
        serving — the reconciler is a supervisor, not an owner."""
        self._stop.set()
        if not kill_hosts:
            return
        with self._lock:
            procs = list(self._procs.values())
            self._procs.clear()
        for p in procs:
            try:
                if p.poll() is None:
                    p.terminate()
            except Exception:  # noqa: BLE001 — already gone
                pass
        for p in procs:
            try:
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001 — escalate once, then move on
                try:
                    p.kill()
                except Exception:  # noqa: BLE001
                    pass

    def debug_state(self) -> dict:
        with self._lock:
            supervised = sorted(self._procs)
        return {"kind": "reconciler",
                "interval_s": self.interval_s,
                "flap_limit": self.flap_limit,
                "flap_window_s": self.flap_window_s,
                "drain_deadline_s": self.drain_deadline_s,
                "supervised": supervised,
                "pending_restarts": {h: round(t, 3)
                                     for h, t in self._pending.items()},
                "draining": sorted(self._draining),
                "banned": sorted(self._banned),
                "flaps": {h: len(v) for h, v in self._flaps.items()}}


def main(argv=None) -> int:
    import argparse
    import signal
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bus", default=None,
                    help="membership bus host:port (default: "
                         "BYTEPS_SERVE_TIER_BUS)")
    ap.add_argument("--interval", type=float, default=None,
                    help="seconds between reconcile passes")
    ap.add_argument("--max-hosts", type=int, default=None,
                    help="never grow the fleet beyond this")
    ap.add_argument("--device", default="cuda",
                    help="the spawned serving hosts' device (cuda or "
                         "cpu; default cuda)")
    args = ap.parse_args(argv)
    rec = FleetReconciler(bus=args.bus, interval_s=args.interval,
                          max_hosts=args.max_hosts, device=args.device)
    if rec.directory.bus is None:
        print("reconciler: no bus (--bus or BYTEPS_SERVE_TIER_BUS) — "
              "nothing to reconcile against", file=sys.stderr)
        return 2
    stop = threading.Event()

    def _sig(_s, _f):
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    print("RECONCILER-UP %s:%d" % rec.directory.bus, flush=True)
    rec.run(stop)
    rec.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
