"""Per-peer slowness scoring: the gray-failure half of detection; port of
``byteps_tpu/utils/slowness.py``, whole.

The failure detectors (:mod:`~byteps_tpu_torch.utils.failure_detector`)
answer *dead or alive*: heartbeats catch a crashed process, the step
watchdog and the engine's sync deadline catch a wedged one.  A rank that
is slow but alive is invisible to all of them while dragging every
synchronous push_pull down to its speed.  This module makes *slow* a
measured condition, distinct from *dead*:

- :class:`SlownessTracker` keeps bounded per-``(site, peer)`` latency
  windows and scores each peer with a phi-accrual suspicion level
  (Hayashibara et al.): ``phi = -log10(P(latency >= observed))`` under a
  robust normal fit (median + MAD) of the peer's reference population
  (the OTHER peers at the same site, or the peer's own older window when
  it has no peers), clamped at :data:`PHI_MAX`;
- feeds: the engine's sync loop (per-unit blocked time, ``site="sync"``),
  the sealed-envelope wire hops (``common/integrity.py``
  ``wire_transmit``) and the TCP transport's round trips
  (``site="transport"``);
- consumers: ``slowness.*`` gauges in the metrics registry (``/metrics``,
  the ``slowness`` section of ``/debug/state``, the time-series
  sampler's ``slow_score``) and ``metrics_snapshot()["slowness"]``.

The same observation sequence gives the same scores as the JAX module:
the arithmetic is the same Python, in the same order.  The membership
bus feeds its step barriers' lags (``site="step_sync"``) and demotes on
them; :class:`LatencyQuantile` is the serving plane's adaptive hedge
delay (``server/serving.py``).
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..common.telemetry import gauges

__all__ = ["SlownessTracker", "LatencyQuantile", "wait_recovered",
           "tracker", "PHI_MAX"]

# Score ceiling: past this the normal-fit survival function underflows
# and every "astronomically slow" peer would render as inf — clamp to a
# finite, comparable value (phi 16 ≈ one in 10^16).
PHI_MAX = 16.0


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _phi(x: float, baseline) -> float:
    """Suspicion level of observation ``x`` against ``baseline`` samples:
    ``-log10(sf(x))`` under a normal fit.  The fit is ROBUST — median +
    MAD-derived sigma, not mean/std: one legitimate outlier in the
    healthy population (a startup compile stall, a GC pause) would
    inflate a std-based sigma enough to mask a real straggler for the
    whole window.  Sigma is floored so a near-constant baseline cannot
    turn microsecond jitter into an accusation."""
    n = len(baseline)
    if n < 2:
        return 0.0
    mu = _median(baseline)
    mad = _median([abs(b - mu) for b in baseline])
    sigma = max(1.4826 * mad, abs(mu) * 0.125, 1e-4)
    z = (x - mu) / sigma
    if z <= 0:
        return 0.0
    # sf of the standard normal; erfc underflows to 0.0 around z ~ 38,
    # which is exactly the "clamp to PHI_MAX" region
    sf = 0.5 * math.erfc(z / math.sqrt(2.0))
    if sf <= 0.0:
        return PHI_MAX
    return min(PHI_MAX, -math.log10(sf))


class SlownessTracker:
    """Bounded per-``(site, peer)`` latency windows + phi-accrual scores.

    ``observe`` is designed for hot paths: one lock acquisition and a
    deque append — scoring (the expensive part) happens lazily in
    :meth:`score` / :meth:`scores` / :meth:`snapshot`, which are called
    from observability and policy points, not per-sample.
    """

    def __init__(self, window: int = 64):
        if window < 8:
            raise ValueError("slowness window must be >= 8 samples")
        self.window = window
        self._lock = threading.Lock()
        self._samples: Dict[Tuple[str, int], collections.deque] = {}

    # -- feed --------------------------------------------------------------

    def observe(self, peer: int, latency_s: float,
                site: str = "default") -> None:
        """Record one latency sample for ``peer`` at ``site``."""
        key = (site, int(peer))
        with self._lock:
            dq = self._samples.get(key)
            if dq is None:
                dq = self._samples[key] = collections.deque(
                    maxlen=self.window)
            dq.append(float(latency_s))

    # -- scoring -----------------------------------------------------------

    def _score_locked(self, site: str, peer: int) -> float:
        dq = self._samples.get((site, peer))
        if not dq:
            return 0.0
        mine = list(dq)
        others = [b for (s, p), d in self._samples.items()
                  if s == site and p != peer for b in d]
        if len(others) >= 2:
            baseline = others
            # recent behavior vs the population: median of the newest
            # quarter (min 1) so one old fast sample can't mask a
            # sustained slowdown
            recent = mine[-max(1, len(mine) // 4):]
        else:
            # no peers at this site: compare the peer's recent window
            # against its own older history
            if len(mine) < 8:
                return 0.0
            half = len(mine) // 2
            baseline, recent = mine[:half], mine[half:]
        return _phi(_median(recent), baseline)

    def score(self, peer: int, site: Optional[str] = None) -> float:
        """Phi suspicion for ``peer`` — at ``site``, or the max across
        every site the peer has samples at."""
        with self._lock:
            if site is not None:
                return self._score_locked(site, int(peer))
            sites = {s for (s, p) in self._samples if p == int(peer)}
            return max((self._score_locked(s, int(peer)) for s in sites),
                       default=0.0)

    def scores(self, site: Optional[str] = None) -> Dict[int, float]:
        """``{peer: score}`` over every peer with samples (at ``site``,
        or max-across-sites)."""
        with self._lock:
            if site is not None:
                peers = {p for (s, p) in self._samples if s == site}
                return {p: self._score_locked(site, p) for p in peers}
            out: Dict[int, float] = {}
            for (s, p) in self._samples:
                out[p] = max(out.get(p, 0.0), self._score_locked(s, p))
            return out

    def latency(self, peer: int, site: str = "default") -> float:
        """Median recent latency of ``peer`` at ``site`` (0.0 when no
        samples)."""
        with self._lock:
            dq = self._samples.get((site, int(peer)))
            return _median(dq) if dq else 0.0

    # -- surfaces ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[int, dict]]:
        """``{site: {peer: {n, median_ms, score}}}`` — the
        ``/debug/state`` shape."""
        with self._lock:
            keys = list(self._samples)
            out: Dict[str, Dict[int, dict]] = {}
            for site, peer in keys:
                dq = self._samples[(site, peer)]
                out.setdefault(site, {})[peer] = {
                    "n": len(dq),
                    "median_ms": round(_median(dq) * 1e3, 3),
                    "score": round(self._score_locked(site, peer), 2),
                }
        return out

    def publish_gauges(self) -> Dict[str, Dict[int, dict]]:
        """Stamp ``slowness.score{site=,rank=}`` labeled gauges plus the
        unlabeled ``slowness.max_score`` into the shared registry —
        called from scrape/aggregation points, not per sample.  Returns
        the snapshot it scored from, so a scrape that also embeds the
        document pays for the scoring pass once."""
        snap = self.snapshot()
        worst = 0.0
        for site, peers in snap.items():
            for peer, row in peers.items():
                gauges.set("slowness.score", row["score"],
                           site=site, rank=peer)
                worst = max(worst, row["score"])
        gauges.set("slowness.max_score", worst)
        return snap

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()


class LatencyQuantile:
    """Tiny bounded latency-sample ring with exact quantiles — the
    adaptive hedge-delay source of ``server/serving.py``'s
    ``ServingPlane``: the p99 of recent
    *winning* pull latencies is what "this is taking too long, fire the
    backup" means.  ``quantile`` answers ``None`` until ``min_samples``
    have landed so early noise cannot set a garbage delay."""

    def __init__(self, window: int = 256, min_samples: int = 8):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=window)
        self.min_samples = min_samples

    def observe(self, latency_s: float) -> None:
        with self._lock:
            self._ring.append(float(latency_s))

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if len(self._ring) < self.min_samples:
                return None
            s = sorted(self._ring)
        idx = min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))
        return s[idx]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def wait_recovered(probe: Callable[[], object], *,
                   baseline_s: float, factor: float = 2.0,
                   consecutive: int = 3, interval_s: float = 0.1,
                   timeout_s: float = 60.0) -> bool:
    """Probation recovery loop: run ``probe`` repeatedly, timing each
    call; return True once ``consecutive`` successive probes complete
    within ``baseline_s * factor`` (the demoted rank's local data path
    is healthy again — time to rejoin), False on ``timeout_s``.

    ``probe`` should exercise the same path whose slowness got the rank
    demoted — e.g. a small local ``push_pull`` (it visits the chaos
    ``dispatch``/``sync`` sites, so an injected ``slow`` fault keeps the
    probe honest until its window really ends)."""
    deadline = time.monotonic() + timeout_s
    streak = 0
    while time.monotonic() < deadline:
        t0 = time.perf_counter()
        probe()
        dt = time.perf_counter() - t0
        if dt <= baseline_s * factor:
            streak += 1
            if streak >= consecutive:
                return True
        else:
            streak = 0
        time.sleep(interval_s)
    return False


# -- the process-wide tracker ------------------------------------------------
#
# One shared instance for the in-process feeds (engine sync units, wire
# hops, transport round trips), sized by ``slowness_window`` at first use.

_tracker: Optional[SlownessTracker] = None
_tracker_lock = threading.Lock()


def tracker() -> SlownessTracker:
    global _tracker
    if _tracker is None:
        with _tracker_lock:
            if _tracker is None:
                from ..common.config import get_config
                try:
                    window = get_config().slowness_window
                except Exception:  # noqa: BLE001 — observability must
                    window = 64    # never fail a data-path caller
                _tracker = SlownessTracker(window=window)
    return _tracker


def _reset_for_tests() -> None:
    global _tracker
    with _tracker_lock:
        _tracker = None
