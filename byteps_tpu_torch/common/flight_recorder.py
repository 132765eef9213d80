"""Flight recorder: a bounded ring of recent events, dumped on death;
port of ``byteps_tpu/common/flight_recorder.py``, whole.

- :func:`record` appends one event (kind + small fields) to a
  process-wide ring (``BYTEPS_FLIGHT_CAPACITY`` entries, default 4096),
  stamped with the tracer's last (step, trace_id); on by default
  (``BYTEPS_FLIGHT_RECORDER=0`` disarms).
- :func:`dump` writes the ring to a timestamped JSON file in
  ``BYTEPS_FLIGHT_DIR`` (a per-user temporary directory by default).  It
  is called on an uncaught exception (``sys.excepthook``), SIGTERM, a
  non-finite quarantine (``server/engine.py``) and a chaos kill
  (``fault/injector.py``).
- Engine ``shutdown()`` and an ``atexit`` hook call
  :func:`maybe_exit_dump`, which dumps once when
  ``BYTEPS_FLIGHT_DUMP_ON_EXIT=1`` asks for it.

The event kinds are the JAX package's (``engine.init``,
``engine.shutdown``, ``dispatch_failed``, ``step_stats``, ``alert``,
``fault.*``, ``quarantine``, ...), so one postmortem reader serves both.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .lock_witness import named_lock

_DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """The bounded event ring + dump machinery (singleton below)."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 enabled: bool = True):
        # REENTRANT: the SIGTERM hook dumps from the main thread, and the
        # signal can land while that same thread is inside record()
        # holding this lock — a plain Lock would deadlock the handler
        # and leave the process neither dumped nor dead
        self._lock = named_lock("flight_recorder", reentrant=True)
        self._ring: "deque[dict]" = deque(maxlen=capacity)
        self.enabled = enabled
        self._out_dir: Optional[str] = None   # None = resolve from config
        self._dump_count = 0
        self._exit_dumped = False

    # -- configuration -----------------------------------------------------

    def configure(self, *, capacity: Optional[int] = None,
                  enabled: Optional[bool] = None,
                  out_dir: Optional[str] = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(16, capacity))
            if enabled is not None:
                self.enabled = enabled
            if out_dir is not None:
                self._out_dir = out_dir

    def _resolve_dir(self) -> str:
        if self._out_dir is not None:
            return self._out_dir
        try:
            from .config import get_config
            return get_config().flight_dir
        except Exception:  # noqa: BLE001 — dumping must never fail on config
            import tempfile
            return tempfile.gettempdir()

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> None:
        if not self.enabled:
            return
        ev = {"t": time.time(), "mono": time.monotonic(), "kind": kind}
        # stamp the active (step, trace_id) so a crash black box
        # cross-references the merged timeline;
        # explicit fields of the same name win below
        try:
            from . import tracing as _tracing
            step, trace_id = _tracing.last_stamp()
            if step:
                ev["step"] = step
            if trace_id:
                ev["trace_id"] = trace_id
        except Exception:  # noqa: BLE001 — recording must never raise
            pass
        if fields:
            ev.update(fields)
        with self._lock:
            self._ring.append(ev)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- dumping -----------------------------------------------------------

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the ring (oldest → newest) to a timestamped JSON file;
        returns the path, or None when the recorder is disabled or the
        write failed (a dying process must die of its own cause, not of
        its black box)."""
        if not self.enabled:
            return None
        events = self.snapshot()
        try:
            from .config import get_config
            rank = get_config().host_id
        except Exception:  # noqa: BLE001
            rank = 0
        if path is None:
            out_dir = self._resolve_dir()
            with self._lock:
                self._dump_count += 1
                n = self._dump_count
            stamp = time.strftime("%Y%m%d-%H%M%S")
            path = os.path.join(
                out_dir,
                f"bps_flight_{stamp}_rank{rank}_{os.getpid()}"
                f"_{reason}_{n}.json")
        doc = {
            "reason": reason,
            "wall_time": time.time(),
            "pid": os.getpid(),
            "rank": rank,
            "capacity": self._ring.maxlen,
            "events": events,
        }
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                # default=str: event fields may carry numpy scalars,
                # sets, exceptions — a dump must never raise on them
                json.dump(doc, f, default=str)
            from .logging import get_logger
            get_logger().warning(
                "flight recorder: dumped %d event(s) (%s) -> %s",
                len(events), reason, path)
            return path
        except Exception:  # noqa: BLE001
            try:
                from .logging import get_logger
                get_logger().error("flight recorder: dump to %s failed",
                                   path, exc_info=True)
            except Exception:  # noqa: BLE001
                pass
            return None

    def maybe_exit_dump(self) -> Optional[str]:
        """The normal-exit dump (engine shutdown / atexit): fires at
        most once per process, and only when
        ``BYTEPS_FLIGHT_DUMP_ON_EXIT`` asks for it."""
        try:
            from .config import get_config
            wanted = get_config().flight_dump_on_exit
        except Exception:  # noqa: BLE001
            wanted = False
        if not wanted:
            return None
        with self._lock:
            if self._exit_dumped:
                return None
            self._exit_dumped = True
        return self.dump("exit")


recorder = FlightRecorder()


def record(kind: str, **fields: Any) -> None:
    """Append one event to the process-wide recorder."""
    recorder.record(kind, **fields)


def dump(reason: str, path: Optional[str] = None) -> Optional[str]:
    return recorder.dump(reason, path)


def maybe_exit_dump() -> Optional[str]:
    return recorder.maybe_exit_dump()


def configure_from_config(cfg) -> None:
    """Adopt the typed config's knobs (called from ``bps.init()``).

    Also re-arms the exit-dump latch: an elastic suspend/resume cycle
    runs ``engine.shutdown()`` (which spends the once-only exit dump)
    mid-run, and without re-arming here the REAL process exit after the
    transition would leave no dump — exactly the tail
    ``BYTEPS_FLIGHT_DUMP_ON_EXIT`` exists to preserve.  Each transition
    gets its own numbered dump file."""
    recorder.configure(capacity=cfg.flight_capacity,
                       enabled=cfg.flight_recorder_on,
                       out_dir=cfg.flight_dir)
    with recorder._lock:
        recorder._exit_dumped = False


# -- crash / signal / exit hooks --------------------------------------------

_hooks_installed = False
_hooks_lock = threading.Lock()
_prev_excepthook = None


def _crash_hook(tp, val, tb):
    try:
        recorder.record("crash", error=f"{tp.__name__}: {val}")
        recorder.dump("crash")
    except Exception:  # noqa: BLE001 — never mask the real traceback
        pass
    (_prev_excepthook or sys.__excepthook__)(tp, val, tb)


def _sigterm_hook(signum, frame):
    try:
        recorder.record("signal", signal="SIGTERM")
        recorder.dump("sigterm")
    finally:
        # restore the default disposition and re-deliver so the exit
        # status still says "killed by SIGTERM"
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _atexit_hook():
    try:
        # a run that exits without calling bps.shutdown() still flushes
        # its comm trace tail (Tracer.flush is idempotent) — and events
        # recorded AFTER shutdown (late bus barrier closes, serving
        # spans) land too, because the process tracer outlives the
        # engine (common/tracing.py singleton)
        from . import tracing as _tracing
        if _tracing._tracer is not None:
            _tracing._tracer.flush()
    except Exception:  # noqa: BLE001
        pass
    recorder.maybe_exit_dump()


def install_hooks() -> None:
    """Arm the crash/SIGTERM/atexit dump hooks (idempotent; called from
    ``bps.init()``).  The SIGTERM hook is installed only when the
    process still has the default disposition — an application handler
    owns the signal otherwise — and only from the main thread (signal
    module restriction)."""
    global _hooks_installed, _prev_excepthook
    with _hooks_lock:
        if _hooks_installed:
            return
        _hooks_installed = True
    _prev_excepthook = sys.excepthook
    sys.excepthook = _crash_hook
    atexit.register(_atexit_hook)
    try:
        if signal.getsignal(signal.SIGTERM) == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, _sigterm_hook)
    except (ValueError, OSError):  # not the main thread / exotic platform
        pass


def _reset_for_tests() -> None:
    """Fresh ring + re-enabled recorder (the conftest autouse reset).
    Installed hooks stay — they are process-level and idempotent."""
    with recorder._lock:
        recorder._ring.clear()
        recorder._dump_count = 0
        recorder._exit_dumped = False
    recorder.enabled = True
    recorder._out_dir = None
