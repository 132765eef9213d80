"""Supervised recovery: detector -> drain -> suspend -> resume -> restore;
port of ``byteps_tpu/fault/recovery.py``.

:class:`RecoveryCoordinator` replaces the detector's bare restartable
exit as the ``HeartbeatMonitor.on_failure`` action (or the installed
failure action, ``failure_detector.install_failure_action``) with an
in-process recovery, the flow the reference only sketches as manual
suspend/resume (reference operations.cc:96-119):

1. drain and suspend: ``api.suspend()`` waits out outstanding handles,
   stops the engine and the heartbeat, leaves the process group and
   keeps the declared-tensor order (so the re-declaration reproduces the
   same keys);
2. resume on the survivors' topology: ``api.resume(num_workers=k)`` joins
   a fresh process group (a world of one takes a fresh free port) and
   starts a new engine;
3. restore: ``CheckpointManager.reload()`` then ``restore_latest``, onto
   the template's devices and broadcast from the root, so the survivors
   continue from the last durable step.

If any stage fails, the coordinator escalates to the restartable exit
(``BYTEPS_FAILURE_EXIT_CODE``): the launcher's ``--restart`` supervision
is the outer loop, in-process recovery the inner, cheaper one.  The
outcome lands in the ``recovery.attempt`` / ``recovery.completed`` /
``recovery.failed`` counters, a ``recovery`` flight-recorder event and a
``recovery`` span in the resumed engine's tracer.  Concurrent detections
run the recovery once: later callers get the first outcome.

This coordinator recovers ONE process against a checkpoint.  The
multi-survivor story (every survivor agreeing on the shrunk world and
continuing from *in-memory* state, plus in-place rejoin of a restarted
rank) is :mod:`byteps_tpu_torch.fault.membership`, which composes the
same drain/suspend/resume primitives under an epoch-tagged rendezvous.
A survivor stuck *inside* a
collective cannot run this path (its thread is captive in NCCL): that
case stays with the step watchdog's exit.

Not ported yet: the durable-store probe and restore of the JAX
coordinator (``byteps_tpu/fault/recovery.py:171-215``), which wait for
``server/wal.py`` (ROADMAP Queue A item 4): ``RecoveryResult.durable``
is always None here.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Optional, Set

from ..common import flight_recorder as _flight
from ..common.logging import get_logger
from ..common.telemetry import counters

# monkeypatch point for tests (escalation must not kill the test runner)
_exit = os._exit


@dataclasses.dataclass
class RecoveryResult:
    """What a completed recovery handed back to the training loop."""

    failed_ranks: Set[int]
    num_workers: int            # surviving topology
    step: Optional[int]         # restored checkpoint step (None: no ckpt)
    state: Any                  # restored pytree (template when no ckpt)
    elapsed_s: float
    durable: Optional[dict] = None  # the durable plane's stats: None
    #                                   until server/wal.py is ported


class RecoveryCoordinator:
    """Turns a detected failure into an automated elastic restart.

    Parameters
    ----------
    checkpoint_manager / template : optional
        ``utils.checkpoint.CheckpointManager`` and the pytree template to
        restore into.  Without them, recovery re-initializes the engine
        but restores nothing (``result.step`` is None).
    survivors : optional
        Override for the post-recovery worker count; default is the
        current ``DMLC_NUM_WORKER`` minus the stale set.
    on_recovered : optional
        Callback run with the :class:`RecoveryResult` after a successful
        recovery (detector-thread context — keep it short).
    rearm_heartbeat : bool
        Re-arm liveness after resume.  Default False: the monitor was
        sized for the old topology, and re-arming it against the
        pre-failure world would re-detect the dead rank and exit a
        healthy survivor.
    """

    def __init__(self, checkpoint_manager=None, template: Any = None,
                 survivors: Optional[int] = None,
                 on_recovered: Optional[Callable[[RecoveryResult],
                                                 None]] = None,
                 rearm_heartbeat: bool = False):
        self.checkpoint_manager = checkpoint_manager
        self.template = template
        self.survivors = survivors
        self.on_recovered = on_recovered
        self.rearm_heartbeat = rearm_heartbeat
        self.result: Optional[RecoveryResult] = None
        self._done = threading.Event()
        self._started = threading.Event()
        self._lock = threading.Lock()

    # -- the HeartbeatMonitor.on_failure action ----------------------------

    def on_failure(self, stale: Set[int]) -> None:
        """Detector action: recover in place; escalate to the restartable
        exit code when recovery itself fails (launcher takes over)."""
        try:
            self.recover(stale)
        except Exception:  # noqa: BLE001 — end of the in-process line
            counters.inc("recovery.failed")
            code = _failure_exit_code()
            get_logger().error(
                "in-process recovery failed — exiting %d so the launcher "
                "can restart", code, exc_info=True)
            _exit(code)

    # -- the recovery flow -------------------------------------------------

    def recover(self, stale: Set[int]) -> RecoveryResult:
        """Drain → suspend → resume(survivors) → restore.  Idempotent:
        concurrent detections run it once; later callers get the first
        outcome — including a failed one, re-raised so their escalation
        path (on_failure → restartable exit) still runs instead of
        parking forever on a recovery that already died."""
        with self._lock:
            first = not self._started.is_set()
            self._started.set()
        if not first:
            self._done.wait()
            if self.result is None:
                raise RuntimeError(
                    "recovery already ran on another thread and failed")
            return self.result
        try:
            return self._recover(stale)
        except BaseException:
            # release waiters with the failure outcome (result stays
            # None); their recover() re-raises and escalates
            self._done.set()
            raise

    def _recover(self, stale: Set[int]) -> RecoveryResult:
        counters.inc("recovery.attempt")
        t0 = time.monotonic()
        from ..core import api
        old_n = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        k = self.survivors if self.survivors is not None \
            else max(1, old_n - len(stale))
        get_logger().error(
            "recovery: rank(s) %s lost — drain/suspend, resume on %d "
            "worker(s), restore from checkpoint", sorted(stale), k)
        if api.initialized():
            api.suspend()          # drains handles, stops engine+heartbeat
        if not self.rearm_heartbeat:
            # the resumed init must not re-arm liveness sized for the dead
            # topology (see class docstring)
            os.environ["BYTEPS_HEARTBEAT_ON"] = "0"
        api.resume(num_workers=k)
        step, state = None, self.template
        if self.checkpoint_manager is not None:
            if hasattr(self.checkpoint_manager, "reload"):
                # the trainer wrote the steps; this manager must re-scan
                # or it restores from its stale (possibly empty) view
                self.checkpoint_manager.reload()
            step, state = self.checkpoint_manager.restore_latest(
                self.template)
        elapsed = time.monotonic() - t0
        result = RecoveryResult(failed_ranks=set(stale), num_workers=k,
                                step=step, state=state, elapsed_s=elapsed)
        self._record_span(result, t0)
        counters.inc("recovery.completed")
        _flight.record("recovery", failed_ranks=sorted(stale),
                       num_workers=k, restored_step=step,
                       elapsed_s=round(elapsed, 3))
        get_logger().warning(
            "recovery complete in %.2fs: %d worker(s), restored step %s",
            elapsed, k, step)
        self.result = result
        self._done.set()
        if self.on_recovered is not None:
            try:
                self.on_recovered(result)
            except Exception:  # noqa: BLE001 — the recovery itself
                # succeeded; a broken user callback must not convert a
                # healthy survivor into a restartable exit
                get_logger().error("on_recovered callback raised after a "
                                   "successful recovery", exc_info=True)
        return result

    def _record_span(self, result: RecoveryResult, t0: float) -> None:
        """Recovery span into the *resumed* engine's tracer (the old
        tracer flushed when suspend tore the engine down)."""
        try:
            from ..core import api
            eng = api._require()
        except Exception:  # noqa: BLE001 — tracing is best-effort
            return
        eng.tracer.record_span(
            "recovery", t0, time.monotonic(),
            failed_ranks=sorted(result.failed_ranks),
            num_workers=result.num_workers, restored_step=result.step)

    # -- training-loop side ------------------------------------------------

    @property
    def triggered(self) -> bool:
        """True once a detection started recovery (training loops poll
        this to stop pushing into an engine being torn down)."""
        return self._started.is_set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None
             ) -> Optional[RecoveryResult]:
        """Block until recovery completes; None on timeout."""
        if not self._done.wait(timeout):
            return None
        return self.result


def _failure_exit_code() -> int:
    """The restartable exit code — one implementation, shared with the
    detector's default actions (utils/failure_detector.py).  Imported
    lazily: failure_detector imports the fault package for its
    heartbeat-drop site, so a module-level import here would cycle."""
    from ..utils.failure_detector import _failure_exit_code as _impl
    return _impl()
