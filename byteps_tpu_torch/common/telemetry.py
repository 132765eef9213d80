"""Push_pull throughput; port of ``SpeedMonitor`` in
``byteps_tpu/common/telemetry.py``, behind ``get_pushpull_speed()``, and
the metrics views of ``common/metrics.py`` (``counters``, ``gauges``,
``histograms``), re-exported here as in the JAX package.

The engine's retirement records each task's wire bytes (the payload for
a compressed chunk, ``nbytes`` otherwise; pushed plus pulled), as the JAX
engine does with telemetry on.

Not ported: the step statistics and attribution of the JAX module; they
belong to the observability plane.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Tuple

from .metrics import counters, gauges, histograms  # noqa: F401


class SpeedMonitor:
    """Rolling-window byte-rate monitor (MB/s over ``window_sec``).

    ``clock`` is injectable for deterministic tests.  :meth:`speed`
    rolls a stale window on read (a paused ``record()`` stream cannot
    freeze the figure) and never answers with a near-zero partial rate
    from a just-rolled window: a partial younger than 10% of the period
    defers to the last closed window's figure."""

    # partial windows younger than this fraction of the period are too
    # noisy to report when a closed window exists
    _MIN_PARTIAL_FRACTION = 0.1

    def __init__(self, window_sec: float = 10.0, history: int = 60,
                 clock: Callable[[], float] = time.monotonic):
        self._window = window_sec
        self._clock = clock
        self._lock = threading.Lock()
        self._bytes = 0
        self._t0 = clock()
        self._records: Deque[Tuple[float, float]] = collections.deque(
            maxlen=history)

    def _roll_locked(self, now: float) -> None:
        dt = now - self._t0
        # wall-clock timestamp for cross-host correlation
        self._records.append((time.time(), self._bytes / dt / 2**20))
        self._bytes = 0
        self._t0 = now

    def record(self, nbytes: int) -> None:
        now = self._clock()
        with self._lock:
            self._bytes += nbytes
            if now - self._t0 >= self._window:
                self._roll_locked(now)

    def speed(self) -> Tuple[float, float]:
        """(wall-clock timestamp, MB/s) of the freshest meaningful
        window: the live partial once it has matured past 10% of the
        period, otherwise the latest closed window (rolled on read when
        the partial has outlived the period: an idle monitor reports 0,
        not its last busy figure)."""
        with self._lock:
            now = self._clock()
            dt = now - self._t0
            if dt >= self._window:
                self._roll_locked(now)
                return self._records[-1]
            if self._records and (
                    self._bytes == 0
                    or dt < self._window * self._MIN_PARTIAL_FRACTION):
                return self._records[-1]
            if self._bytes and dt > 0:
                return (time.time(), self._bytes / dt / 2**20)
            if self._records:
                return self._records[-1]
            return (time.time(), 0.0)
