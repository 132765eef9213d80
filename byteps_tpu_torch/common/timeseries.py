"""Time-series retention: a fixed-memory ring of sampled registry
series; port of ``byteps_tpu/common/timeseries.py``.

A :class:`TimeSeriesStore` keeps ``BYTEPS_TS_WINDOW`` sampled points of
the series that drift rather than fail at an instant (overlap fraction,
the attribution components, wire speed, the error-feedback norm, burn
counters): gauges as they stand, counters as per-window deltas (a
counter that moves backwards is a new baseline, not a burst), histograms
as per-window p99s.  The ring is served at the obs server's
``/timeseries``, and each sampling tick hands it to ``common/health.py``.

The sampler is process-lifetime: ``init()`` starts it
(:func:`ensure_started`) and ``suspend()``/``resume()`` leave it running.

Not ported: the slowness tracker's refresh before each sample
(``utils/slowness.py`` is not in the port; ``slow_score`` is sampled
whenever something sets its gauge) and the summary's ride on the
membership bus (the bus is not ported either).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .metrics import registry
from .telemetry import ATTRIB_GAUGE_NAMES, counters, gauges

# --- sampled series: literal name tables --------------------------------
# One literal per registry series, NOT built at the sample site, so the
# docs/observability.md established-names table stays machine-checkable
# (tools/bpslint metric-name rule direction 2) and every sampled name is
# greppable.  The short key is the spelling points/summaries carry.

# gauges: sampled as-is (last written value at the tick)
GAUGE_SERIES = {
    "overlap": "step.overlap_fraction",
    "mbps": "engine.pushpull_mbps",
    "slow_score": "slowness.max_score",
    "step_wall_ms": "step.wall_ms",
}

# counters: sampled as per-window deltas (clamped at a reset)
COUNTER_SERIES = {
    "retransmit": "integrity.retransmit",
    "shed": "serve.shed",
    "conn_resets": "transport.conn_resets",
    "steps": "step.completed",
}

# histograms: per-window p99 from pow2-bucket deltas
HIST_SERIES = {
    "rtt_p99_ms": "transport.rtt_ms",
    "pull_p99_ms": "serve.pull_ms",
}

# labeled gauge families: sampled as the max over the family's labeled
# series (the health engine's growth rule watches the worst tensor)
LABELED_MAX_SERIES = {
    "ef_norm": "compression.ef_norm",
}

# attribution components ride under "attrib_<component>" keys; the full
# gauge names come from the telemetry literal table (same bpslint story)
ATTRIB_KEYS = {f"attrib_{comp}": name
               for comp, name in ATTRIB_GAUGE_NAMES.items()}


def series_keys() -> List[str]:
    """Every short key a sampled point may carry (doctor/top render
    from this, not from guessing)."""
    return (list(GAUGE_SERIES) + list(COUNTER_SERIES) + list(HIST_SERIES)
            + list(LABELED_MAX_SERIES) + list(ATTRIB_KEYS))


def _strip_labels(series: str) -> str:
    i = series.find("{")
    return series if i < 0 else series[:i]


def _hist_p99(delta: Dict[int, int]) -> Optional[float]:
    total = sum(delta.values())
    if total <= 0:
        return None
    target = 0.99 * total
    cum = 0
    for bucket in sorted(delta):
        cum += delta[bucket]
        if cum >= target:
            return float(bucket)
    return float(max(delta))


class TimeSeriesStore:
    """The per-rank ring: bounded, delta-encoded, summarizable."""

    def __init__(self, interval_s: float, window: int):
        self.interval_s = float(interval_s)
        self.window = int(window)
        self._points: deque = deque(maxlen=self.window)
        self._lock = threading.Lock()
        self._last_counters: Dict[str, int] = {}
        self._last_hists: Dict[str, Dict[int, int]] = {}

    # -- sampling --------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> Dict[str, float]:
        """Take one sample from the registry and append it to the ring.
        Returns the point (tests drive this directly; the background
        sampler calls it on the cadence)."""
        snap = registry.snapshot()
        point: Dict[str, float] = {"t": now if now is not None
                                   else time.time()}
        gsnap = snap.get("gauges", {})
        for key, name in GAUGE_SERIES.items():
            if name in gsnap:
                point[key] = float(gsnap[name])
        for key, name in ATTRIB_KEYS.items():
            if name in gsnap:
                point[key] = float(gsnap[name])
        for key, family in LABELED_MAX_SERIES.items():
            worst = None
            for series, v in gsnap.items():
                if _strip_labels(series) == family:
                    worst = v if worst is None else max(worst, v)
            if worst is not None:
                point[key] = float(worst)
        csnap = snap.get("counters", {})
        for key, name in COUNTER_SERIES.items():
            cur = int(csnap.get(name, 0))
            last = self._last_counters.get(name)
            if last is None or cur < last:
                # first sample, or the counter moved backwards (a reset
                # under the ring): new baseline, not a phantom burst
                delta = 0
            else:
                delta = cur - last
            self._last_counters[name] = cur
            point[key] = float(delta)
        hsnap = snap.get("histograms", {})
        for key, family in HIST_SERIES.items():
            merged: Dict[int, int] = {}
            for series, buckets in hsnap.items():
                if _strip_labels(series) != family:
                    continue
                for b, c in buckets.items():
                    merged[b] = merged.get(b, 0) + c
            last = self._last_hists.get(family, {})
            delta = {b: c - last.get(b, 0) for b, c in merged.items()
                     if c - last.get(b, 0) > 0}
            self._last_hists[family] = merged
            p99 = _hist_p99(delta)
            if p99 is not None:
                point[key] = p99
        with self._lock:
            self._points.append(point)
            fill = len(self._points)
        counters.inc("ts.samples")
        gauges.set("ts.window_fill", fill)
        return point

    # -- views -----------------------------------------------------------

    def points(self) -> List[Dict[str, float]]:
        with self._lock:
            return list(self._points)

    def values(self, key: str) -> List[Tuple[float, float]]:
        """``(t, value)`` of every point carrying ``key``, oldest
        first."""
        return [(p["t"], p[key]) for p in self.points() if key in p]

    def dump(self) -> dict:
        """The raw ring, for ``/timeseries`` and postmortem capture."""
        pts = self.points()
        return {"interval_s": self.interval_s, "window": self.window,
                "len": len(pts), "keys": series_keys(), "points": pts}

    def summary(self) -> dict:
        """The compact windowed view that piggybacks on the membership
        bus: per series key — last / mean / min / max over the window.
        Small enough to ride every ``step_sync`` frame."""
        pts = self.points()
        series: Dict[str, List[float]] = {}
        for p in pts:
            for k, v in p.items():
                if k != "t":
                    series.setdefault(k, []).append(v)
        out = {}
        for k, vs in series.items():
            out[k] = {"last": round(vs[-1], 4),
                      "mean": round(sum(vs) / len(vs), 4),
                      "min": round(min(vs), 4),
                      "max": round(max(vs), 4),
                      # a short tail of raw values so bps_doctor / bps_top
                      # can draw an honest sparkline from the piggybacked
                      # summary without fetching the full ring
                      "spark": [round(v, 4) for v in vs[-8:]]}
        span = round(pts[-1]["t"] - pts[0]["t"], 3) if len(pts) > 1 else 0.0
        return {"n": len(pts), "span_s": span,
                "interval_s": self.interval_s, "series": out}


class _Sampler(threading.Thread):
    """Background cadence: sample, then hand the window to the health
    engine.  Daemon and process-lifetime — stopped only by tests."""

    def __init__(self, store: TimeSeriesStore, interval_s: float):
        super().__init__(name="bps-ts-sampler", daemon=True)
        self.store = store
        self.interval_s = interval_s
        self._stop = threading.Event()

    def run(self) -> None:
        from . import health
        while not self._stop.wait(self.interval_s):
            try:
                self.store.sample_once()
                health.evaluate(self.store)
            except Exception:  # noqa: BLE001 — a sampler tick must
                pass           # never kill telemetry for the process

    def stop(self) -> None:
        self._stop.set()


_lock = threading.Lock()
_store: Optional[TimeSeriesStore] = None
_sampler: Optional[_Sampler] = None


def ensure_started(cfg) -> Optional[TimeSeriesStore]:
    """Idempotently start the process-lifetime store + sampler
    (``bps.init()`` calls this; suspend/resume leave it running).
    Returns the store, or None when ``BYTEPS_TS_ON=0`` disarmed it."""
    global _store, _sampler
    if not getattr(cfg, "ts_on", True):
        return _store
    with _lock:
        if _store is None:
            _store = TimeSeriesStore(cfg.ts_interval_s, cfg.ts_window)
        if _sampler is None or not _sampler.is_alive():
            _sampler = _Sampler(_store, cfg.ts_interval_s)
            _sampler.start()
        return _store


def get_store() -> Optional[TimeSeriesStore]:
    return _store


def stop_for_tests() -> None:
    """Stop the sampler and drop the store (tests only — production
    keeps the window for the life of the process)."""
    global _store, _sampler
    with _lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None
        _store = None
