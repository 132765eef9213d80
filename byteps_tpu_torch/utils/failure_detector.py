"""Failure detection: heartbeats, the step watchdog and the data-path
stall funnel; port of ``byteps_tpu/utils/failure_detector.py``, whole.

The reference delegates liveness to ps-lite's scheduler heartbeats and
has no in-tree detector; recovery is manual suspend/resume
(reference operations.cc:96-119).  On a card the need is the same as on
a TPU: a dead peer does not error the survivors, their next collective
(an NCCL all-reduce) blocks.  Detection is therefore out of band, and
the last-resort escape from a wedged collective is process exit (the
launcher restarts the job; resume re-declares tensors in order,
``core/api.py`` ``resume()``).

Two cooperating pieces:

- :class:`HeartbeatMonitor`: the ``server_rank`` member (default rank 0)
  runs a small UDP server; every member of ``ranks`` beats every
  ``interval``; the server's replies carry the set of currently stale
  ranks.  A rank that misses ``timeout`` seconds of beats is reported to
  every survivor's ``on_failure``; a server that stops replying is
  itself reported as ``{server_rank}`` down, and once a client has heard
  the server at least once that detection is no longer gated by the
  startup ``grace``.  The datagrams are byte for byte the JAX
  package's (``b"bpshb1 " + rank`` and ``b"bpshb1 " + JSON``), so a port
  process and a JAX process beat to each other's server;
- :class:`StepWatchdog`: in-process, ``feed()`` every training step; a
  step that exceeds ``timeout`` fires ``on_stall``.  Its default stall
  action is :func:`data_path_stalled`: the evidence goes to the
  *installed failure action* first, and ``os._exit`` with
  ``BYTEPS_FAILURE_EXIT_CODE`` (default 17) is the escalation of last
  resort.  The engine's per-unit sync deadline
  (``BYTEPS_SYNC_DEADLINE_S``, ``core/engine.py``) reports through the
  same funnel.

The default ``on_failure``/``on_stall`` exit code is restartable.  For
in-process recovery instead of exit, pass a
:class:`~byteps_tpu_torch.fault.recovery.RecoveryCoordinator`'s
``on_failure``, or :func:`install_failure_action` to rewire the default
itself (which covers the monitor ``init()`` arms under
``BYTEPS_HEARTBEAT_ON``).

Both are host-side Python (sockets and threads), independent of CUDA,
so they keep working when the device does not.  Under elastic
membership the installed action is ``ElasticMembership.on_failure``
(``fault/membership.py``): a named stale set shrinks the world, and the
empty set of a data-path stall becomes a *reconcile* rendezvous over the
current world, whose timeout names exactly who is gone.  Its monitors
are rebuilt at every world change with ``server_rank`` set to the new
coordinator (``ElasticMembership.host_heartbeat``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Callable, Optional, Set

from ..common.logging import get_logger
from ..fault import injector as _fault

_MAGIC = b"bpshb1 "

# monkeypatch point for tests (a real os._exit would take pytest with it)
_exit = os._exit

# Process-wide pluggable default action (install_failure_action below):
# lets elastic layers (fault.membership.ElasticMembership.on_failure,
# fault.recovery.RecoveryCoordinator.on_failure) take over the DEFAULT escalation
# path — including the auto-armed monitor bps.init() starts — without
# every construction site having to thread a callback through.
_installed_action: Optional[Callable[[Set[int]], None]] = None


def install_failure_action(
        action: Optional[Callable[[Set[int]], None]]
) -> Optional[Callable[[Set[int]], None]]:
    """Replace the default on_failure escalation (log + restartable
    exit) with ``action`` for every monitor that uses the default.
    Pass ``None`` to restore the exit behavior.  Returns the previously
    installed action so callers can chain or restore it."""
    global _installed_action
    prev = _installed_action
    _installed_action = action
    return prev


def _failure_exit_code() -> int:
    """BYTEPS_FAILURE_EXIT_CODE (default 17): the code the launchers'
    --restart supervision treats as restartable.  Read leniently — the
    escape hatch must never die on a config error."""
    try:
        from ..common.config import get_config
        return get_config().failure_exit_code
    except Exception:  # noqa: BLE001
        return int(os.environ.get("BYTEPS_FAILURE_EXIT_CODE", "17") or 17)


def _default_on_failure(stale: Set[int]) -> None:
    action = _installed_action
    if action is not None:
        # an elastic layer owns the failure path (in-place shrink
        # instead of exit); it escalates itself if that fails
        action(stale)
        return
    code = _failure_exit_code()
    get_logger().error(
        "failure detector: rank(s) %s missed heartbeats — exiting %d so "
        "the launcher can restart/resume (a wedged collective cannot be "
        "cancelled in-process)", sorted(stale), code)
    _exit(code)


# Single-flight latch for data-path stall evidence: the sync-deadline
# watchdog and the step watchdog are SEPARATE threads observing the same
# wedge, and during an in-flight elastic transition both can fire inside
# one detection window.  The second report while the first is still
# being acted on must be a no-op — two concurrent escalations would
# double-run the failure action (or, uninstalled, double-fire os._exit
# mid-shrink).  Released when the action returns, so a LATER, distinct
# stall still escalates.
_stall_inflight = threading.Lock()


def data_path_stalled(gap_s: float, detail: str = "") -> None:
    """Failure evidence from the DATA path: a sync unit
    (``BYTEPS_SYNC_DEADLINE_S``, core/engine.py) or a whole step
    (:class:`StepWatchdog`) made no progress inside its deadline — the
    failure mode where a dead peer wedges survivors inside a
    collective without erroring them.

    Routed to the installed failure action with an EMPTY stale set
    ("something is wedged; no named suspect") —
    ``ElasticMembership.on_failure`` turns that into a *reconcile*
    rendezvous whose timeout identifies exactly who is gone
    (fault/membership.py).  Without
    an installed action the restartable ``os._exit`` remains the
    escalation of last resort: a wedged collective cannot be cancelled
    in-process.

    Single-flight: a report arriving while another is still being acted
    on (a stall observed by two watchdog threads, or one landing during
    an in-flight elastic shrink the first report started) is logged and
    dropped — the in-flight handler owns the escalation."""
    from ..common import flight_recorder as _flight
    if not _stall_inflight.acquire(blocking=False):
        from ..common.telemetry import counters
        counters.inc("failure_detector.stall_suppressed")
        _flight.record("failure_detector.stall_suppressed",
                       gap_s=round(gap_s, 3), detail=detail)
        get_logger().warning(
            "data path stall report (%.1fs, %s) suppressed: another "
            "stall report is already being acted on", gap_s,
            detail or "no detail")
        return
    try:
        _flight.record("failure_detector.data_path_stall",
                       gap_s=round(gap_s, 3), detail=detail)
        _flight.dump("data_path_stall")
        action = _installed_action
        if action is not None:
            action(set())
            return
        code = _failure_exit_code()
        get_logger().error(
            "data path stalled for %.1fs (%s) and no in-process failure "
            "action is installed — exiting %d so the launcher can restart",
            gap_s, detail or "no detail", code)
        _exit(code)
    finally:
        _stall_inflight.release()


class HeartbeatMonitor:
    """Out-of-band liveness over UDP.

    Parameters
    ----------
    rank, num_ranks: PROCESS identity (one beating entity per process).
        In the port a process is a rank: ``bps.rank()``/``bps.size()``.
    coordinator: ``host:port`` for the heartbeat endpoint.  Defaults to
        ``DMLC_PS_ROOT_URI`` with ``BYTEPS_HEARTBEAT_PORT`` (or
        DMLC_PS_ROOT_PORT + 1) — the same rendezvous the DMLC bootstrap
        already shares (reference docs/env.md:7-45).
    interval / timeout: beat period and staleness threshold (seconds).
    on_failure: called ONCE with the set of stale ranks; defaults to
        log + os._exit(BYTEPS_FAILURE_EXIT_CODE) (default 17).
    ranks: explicit member-rank set (elastic worlds keep ORIGINAL rank
        numbers after a shrink, e.g. {1, 2}); default ``range(num_ranks)``.
    server_rank: the member hosting the UDP server (default 0 for the
        static-world behavior; the JAX membership plane re-hosts it on
        the coordinator after every world change).
    """

    def __init__(self, rank: int, num_ranks: Optional[int] = None,
                 coordinator: Optional[str] = None,
                 interval: float = 1.0, timeout: float = 10.0,
                 on_failure: Callable[[Set[int]], None] = _default_on_failure,
                 grace: Optional[float] = None,
                 ranks: Optional[Set[int]] = None,
                 server_rank: int = 0):
        if ranks is None:
            if num_ranks is None:
                raise ValueError(
                    "HeartbeatMonitor needs num_ranks or an explicit ranks set")
            ranks = range(num_ranks)
        if coordinator is None:
            host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
            port = int(os.environ.get(
                # bpslint: ignore[env-knob] reason=default is derived from DMLC_PS_ROOT_PORT+1 at bind time; documented in env.md and validated by the socket bind
                "BYTEPS_HEARTBEAT_PORT",
                str(int(os.environ.get("DMLC_PS_ROOT_PORT", "9000")) + 1)))
        else:
            host, port_s = coordinator.rsplit(":", 1)
            port = int(port_s)
        self.rank = rank
        self.ranks = frozenset(int(r) for r in ranks)
        self.num_ranks = len(self.ranks)
        self.server_rank = int(server_rank)
        self.addr = (host, port)
        self.interval = interval
        self.timeout = timeout
        # ranks get `grace` seconds to send their first beat (process
        # startup skew is not a failure)
        self.grace = timeout if grace is None else grace
        self.on_failure = on_failure
        self._stop = threading.Event()
        self._fired = False
        self._lock = threading.Lock()
        self._threads = []
        self._sock: Optional[socket.socket] = None
        # server state (server_rank only)
        self._last_seen = {}
        self._started = time.monotonic()
        # client state; _got_reply releases the grace gate on server-down
        # detection (a server we have HEARD once is dead, not late, when
        # it goes silent)
        self._last_reply = time.monotonic()
        self._got_reply = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "HeartbeatMonitor":
        if self.rank == self.server_rank:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.bind(self.addr)
            self._sock.settimeout(0.25)
            t = threading.Thread(target=self._serve, daemon=True,
                                 name="bps-heartbeat-server")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._beat, daemon=True,
                             name="bps-heartbeat-client")
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            # an on_failure action (RecoveryCoordinator) that suspends the
            # engine stops this monitor FROM the beat thread — joining
            # oneself would raise and abort the recovery mid-flight
            if t is not threading.current_thread():
                t.join(timeout=2)
        if self._sock is not None:
            self._sock.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- internals ---------------------------------------------------------

    def wait_server(self, timeout: float = 60.0) -> bool:
        """Liveness bootstrap barrier: block until this monitor has
        heard ITS server reply at least once (the server's own monitor
        hears itself).  Before that first reply, this rank is invisible
        to the server — a death in the window would hide behind the
        never-beat startup grace.  Chaos workers (and any run that wants
        detection armed before work starts) call this after
        ``start()``; returns False on timeout/stop instead of raising —
        liveness bootstrap is advisory, not load-bearing."""
        deadline = time.monotonic() + timeout
        while not self._got_reply and not self._stop.is_set():
            if time.monotonic() >= deadline:
                return False
            time.sleep(min(0.02, self.interval))
        return self._got_reply

    def last_beat_age(self) -> float:
        """Seconds since this rank last heard a healthy reply from the
        heartbeat endpoint — the ``/healthz`` liveness figure
        (``common/obs_server.py``)."""
        return time.monotonic() - self._last_reply

    def _fire(self, stale: Set[int]) -> None:
        with self._lock:
            if self._fired:
                return
            self._fired = True
        # the trip is postmortem material whatever on_failure does next
        # (shrink, recovery, or exit): dump the black box first
        from ..common import flight_recorder as _flight
        _flight.record("failure_detector.trip", stale=sorted(stale))
        _flight.dump("failure_detector")
        self.on_failure(stale)

    def _stale_ranks(self) -> Set[int]:
        now = time.monotonic()
        stale = set()
        for r in sorted(self.ranks):
            seen = self._last_seen.get(r)
            if seen is None:
                if now - self._started > self.grace:
                    stale.add(r)
            elif now - seen > self.timeout:
                stale.add(r)
        return stale

    def _serve(self) -> None:
        """Server rank: receive beats, answer with the stale set."""
        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(512)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data.startswith(_MAGIC):
                continue
            try:
                r = int(data[len(_MAGIC):])
            except ValueError:
                continue
            if _fault.ENABLED and _fault.edge_cut(r):
                continue  # ranks-partition: deaf to the other side
            if r in self.ranks:
                self._last_seen[r] = time.monotonic()
            try:
                # the reply names WHO is serving: during a heartbeat
                # re-hosting, a client pointed at the NEW server must not
                # credit a reply from the predecessor incarnation still
                # draining on the same port — hearing the old server once
                # would release the grace gate and turn the predecessor's
                # own shutdown into a phantom "new server dead" detection
                self._sock.sendto(
                    _MAGIC + json.dumps(
                        {"server": self.rank,
                         "stale": sorted(self._stale_ranks())}).encode(),
                    addr)
            except OSError:
                pass

    def _beat(self) -> None:
        """Every rank: send beats, read the stale set, escalate."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.settimeout(self.interval)
        # size the reply buffer for the worst case (every rank stale,
        # ~7 chars each, plus the server-identity envelope): a truncated
        # datagram would otherwise kill this thread at exactly the
        # moment it matters
        bufsize = max(512, len(_MAGIC) + 8 * self.num_ranks + 64)
        self._last_reply = time.monotonic()
        while not self._stop.is_set():
            try:
                # chaos site: drop:site=heartbeat:p=... suppresses the
                # send, simulating a lossy/partitioned control network —
                # the reply read then times out like a real loss would.
                # A ranks-partition cutting the edge to the heartbeat
                # server has the same shape: beats blackholed both ways.
                if _fault.ENABLED and (
                        _fault.should_drop("heartbeat")
                        or _fault.edge_cut(self.server_rank)):
                    raise socket.timeout()
                sock.sendto(_MAGIC + str(self.rank).encode(), self.addr)
                data, _ = sock.recvfrom(bufsize)
                if data.startswith(_MAGIC):
                    try:
                        reply = json.loads(data[len(_MAGIC):])
                    except ValueError:
                        reply = None  # corrupt/truncated reply: not fatal
                    if (isinstance(reply, dict)
                            and reply.get("server") == self.server_rank):
                        # a reply from any OTHER server identity (a
                        # predecessor incarnation draining on the same
                        # port during a re-hosting) is ignored: crediting
                        # it would arm the grace-release latch against
                        # the wrong server's lifetime
                        stale = set(reply.get("stale") or ())
                        self._last_reply = time.monotonic()
                        self._got_reply = True
                        stale.discard(self.rank)  # self = clock skew
                        if stale:
                            self._fire(stale)
                            return
            except (socket.timeout, OSError):
                pass
            # a silent server is itself a failure — gated by the grace
            # window only until the FIRST reply (a server that starts
            # later than this rank is not a false alarm; a server we
            # have heard once and that then goes silent is dead, and
            # must be detected in `timeout`, not `grace`, seconds)
            now = time.monotonic()
            if (self.rank != self.server_rank
                    and now - self._last_reply > self.timeout
                    and (self._got_reply
                         or now - self._started > self.grace)):
                self._fire({self.server_rank})
                return
            self._stop.wait(self.interval)
        sock.close()


class StepWatchdog:
    """In-process stall detector: ``feed()`` each step; a gap longer than
    ``timeout`` fires ``on_stall`` — the escape hatch for a collective
    wedged on a peer the heartbeat layer still sees as alive (process up,
    chip blocked).  The default action is :func:`data_path_stalled`: an
    installed elastic failure action gets the evidence (and shrinks or
    reconciles in place); ``os._exit`` only when nobody in-process can
    act on it."""

    def __init__(self, timeout: float = 600.0,
                 on_stall: Optional[Callable[[float], None]] = None):
        self.timeout = timeout
        self.on_stall = on_stall or self._default
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._armed = False
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="bps-step-watchdog")

    @staticmethod
    def _default(gap: float) -> None:
        get_logger().error("step watchdog: no progress for %.1fs", gap)
        data_path_stalled(gap, detail="step watchdog")

    def start(self) -> "StepWatchdog":
        self._last = time.monotonic()
        self._armed = True
        self._thread.start()
        return self

    def feed(self) -> None:
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        if (self._thread.is_alive()
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=2)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _watch(self) -> None:
        while not self._stop.wait(min(1.0, self.timeout / 4)):
            gap = time.monotonic() - self._last
            if self._armed and gap > self.timeout:
                self.on_stall(gap)
                return
