"""Push_pull throughput, step statistics and step attribution; port of
``byteps_tpu/common/telemetry.py``, whole.

- :class:`SpeedMonitor`: the rolling MB/s behind ``get_pushpull_speed()``
  (the engine's retirement records each task's wire bytes, pushed plus
  pulled, the payload for a compressed chunk).
- :class:`StepStatsTracker`: a step is the tracer's (per-tensor push
  counts, the max is the global step).  The engine feeds pushes, the
  syncer's blocked time (``sync``), each retired unit's queue wait, the
  caller's enqueue, and its own dispatch and assembly time (the same
  readings it keeps, always, in ``engine.stats``); the process-wide
  :data:`attribution` sink takes the components that happen off the
  engine's threads (the envelope's ``wire`` hops, the server engine's
  ``merge``).  Each finished step is published as the ``step.*`` gauges
  (``step.attrib_<component>_ms``, :data:`ATTRIB_GAUGE_NAMES`), a
  ``step_stats`` flight event and a bounded history; ``other`` is the
  rest of the wall time, so the components and ``other`` add up to
  ``wall_ms`` whenever they do not overlap.
- The JAX package's ``compile`` component has no counterpart: eager
  PyTorch compiles no program per shape (the CUDA kernels are built
  once per process, before the first step is timed), so nothing would
  feed it.
- The metrics views of ``common/metrics.py`` (``counters``, ``gauges``,
  ``histograms``) are re-exported, as in the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from .metrics import (Counters, Gauges, Histograms,  # noqa: F401
                      counters, gauges, histograms, registry)
from . import tracing as _tracing


# The full gauge name of every attribution component — one literal per
# name, NOT an f-string at the emit site, so the docs/observability.md
# established-names table stays machine-checkable against the code
# (tools/bpslint metric-name rule) and every name is greppable.
ATTRIB_GAUGE_NAMES = {
    "enqueue": "step.attrib_enqueue_ms",
    "queue": "step.attrib_queue_ms",
    "credit": "step.attrib_credit_ms",
    "wire": "step.attrib_wire_ms",
    "merge": "step.attrib_merge_ms",
    "sync": "step.attrib_sync_ms",
    "dispatch": "step.attrib_dispatch_ms",
    "assemble": "step.attrib_assemble_ms",
    "other": "step.attrib_other_ms",
}


class AttributionSink:
    """Process-wide wall-time accumulators for step attribution
    (the components of ``StepStatsTracker``).

    Components that happen OFF the engine's own threads — the sealed
    envelope wire hops (``wire``, incl. retransmit rounds), the server
    engine's merge work (``merge``), scheduler credit-gated waits
    (``credit``) — and the dispatcher's ``dispatch`` land here as they
    occur; the active
    :class:`StepStatsTracker` snapshots the totals at each step boundary
    and publishes the per-step deltas as ``step.attrib_*`` gauges.  One
    lock + one dict add per event: cheap enough to stay unconditional
    (every feed site already does comparable work per call)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ms: Dict[str, float] = {}

    def add(self, component: str, ms: float) -> None:
        with self._lock:
            self._ms[component] = self._ms.get(component, 0.0) + ms

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._ms)

    def reset(self) -> None:
        with self._lock:
            self._ms.clear()


attribution = AttributionSink()


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

    def total_windows(self) -> int:
        with self._lock:
            return len(self._records)


# -- per-step stats ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepStats:
    """One completed training step as the engine saw it.

    ``overlap_fraction`` is the share of the step's wall time the
    syncer did NOT spend blocked on device completion — communication
    that finished under compute instead of stalling it (1.0 = fully
    hidden; the per-model bench figure in ``tools/overlap_bench.py`` is
    the end-to-end counterpart)."""

    step: int
    bytes_pushed: int
    pushes: int
    sync_stall_ms: float
    retransmits: int
    wall_ms: float
    overlap_fraction: float
    # per-step critical-path breakdown (ms) — enqueue, queue wait,
    # credit stall, wire (incl. retransmits), server merge, sync block,
    # dispatch, assembly, plus an "other" residual so the components
    # always account for the full wall time.  Empty dict on
    # pre-attribution records.
    attrib: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the tensor whose unit retired LAST in this step — the chain the
    # step's completion actually waited on
    lagging_tensor: Optional[str] = None
    # push+pull wire bytes this step actually shipped (per-leg
    # accounting from the syncer: compressed chunks at payload size,
    # sharded-update pulls at the owner-slice/codec-payload size) — the
    # figure the sharded-vs-unsharded bench ratio is computed from
    wire_bytes_per_step: int = 0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


class StepStatsTracker:
    """Accumulates per-step engine stats.

    A "step" is defined exactly as the tracer defines it: per-tensor
    push counts, the max of which is the global step — when any
    tensor's count advances past the current step, the previous step is
    finalized.  The dispatcher/enqueue side feeds :meth:`on_push`
    (bytes), the syncer feeds :meth:`add_stall` (ms spent blocked in
    ``block_until_ready``); retransmits are deltas of the established
    ``integrity.retransmit`` counter.  Finalized steps land in three
    places at once: the gauge set (``step.*`` — the ``/metrics``
    surface), the flight recorder (``step_stats`` events), and a
    bounded in-process history for bench summaries."""

    def __init__(self, history: int = 64, recorder=None):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._step = 0
        self._t0 = time.perf_counter()
        self._bytes = 0
        self._pushes = 0
        self._stall_ms = 0.0
        self._wire = 0
        self._retx0 = counters.get("integrity.retransmit")
        self._history: Deque[StepStats] = collections.deque(maxlen=history)
        # step-attribution state: baseline of the process-wide
        # sink at the step boundary, locally fed components (queue wait),
        # and the last-retired tensor (the lagging chain)
        self._attrib0: Dict[str, float] = attribution.totals()
        self._comp: Dict[str, float] = {}
        self._last_retired: Optional[str] = None
        self._pub_attrib: set = set()   # gauge keys published last step
        if recorder is None:
            from . import flight_recorder as _flight
            recorder = _flight.recorder
        self._recorder = recorder

    # -- feeding -----------------------------------------------------------

    def on_push(self, name: str, nbytes: int) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1
            step = self._counts[name]
            if step > self._step:
                if self._step > 0 and self._pushes:
                    # published under the lock: two concurrent pushers
                    # finalizing steps N and N+1 must land their gauge
                    # writes and flight events in step order (the gauge
                    # and recorder locks never take this one, so there
                    # is no ordering cycle to invert)
                    self._publish(self._finalize_locked())
                self._step = step
                self._t0 = time.perf_counter()
                # flight-recorder stamp: every recorded event from here
                # on carries this step even with tracing off
                _tracing.note_step(step)
            self._bytes += int(nbytes)
            self._pushes += 1

    def add_stall(self, ms: float) -> None:
        with self._lock:
            self._stall_ms += ms

    def add_wire(self, nbytes: int) -> None:
        """Syncer feed: wire bytes (push + pull legs) of each retired
        chunk, at what the legs actually shipped."""
        with self._lock:
            self._wire += int(nbytes)

    def add_component(self, component: str, ms: float) -> None:
        """Engine-local attribution feed (e.g. ``queue`` — scheduler
        wait of each retired unit's head chunk)."""
        with self._lock:
            self._comp[component] = self._comp.get(component, 0.0) + ms

    def note_retire(self, name: str) -> None:
        """The syncer names each retired unit's tensor; the last one
        standing when the step finalizes is the lagging tensor."""
        with self._lock:
            self._last_retired = name

    # -- finalization ------------------------------------------------------

    def _finalize_locked(self) -> StepStats:
        wall_ms = max((time.perf_counter() - self._t0) * 1e3, 1e-6)
        retx = counters.get("integrity.retransmit")
        # Per-step attribution: deltas of the process-wide
        # sink (wire / merge / credit / dispatch) + locally
        # fed components (enqueue / queue / assemble) + the syncer's
        # block time (sync).  "other" is max(0, wall - sum): components
        # are wall-time integrals of each activity, so on a serialized
        # profile they partition the step, while pipelined units or
        # parallel merge/wire threads can overlap and push the sum PAST
        # the wall (other clamps at 0) — documented in
        # docs/observability.md.
        now_tot = attribution.totals()
        attrib: Dict[str, float] = {}
        for k in set(now_tot) | set(self._attrib0):
            d = now_tot.get(k, 0.0) - self._attrib0.get(k, 0.0)
            if d > 0.0005:
                attrib[k] = d
        for k, v in self._comp.items():
            attrib[k] = attrib.get(k, 0.0) + v
        attrib["sync"] = attrib.get("sync", 0.0) + self._stall_ms
        known = sum(attrib.values())
        attrib["other"] = max(0.0, wall_ms - known)
        attrib = {k: round(v, 3) for k, v in attrib.items()}
        stats = StepStats(
            step=self._step,
            bytes_pushed=self._bytes,
            pushes=self._pushes,
            sync_stall_ms=round(self._stall_ms, 3),
            retransmits=retx - self._retx0,
            wall_ms=round(wall_ms, 3),
            overlap_fraction=round(
                1.0 - min(1.0, self._stall_ms / wall_ms), 4),
            attrib=attrib,
            lagging_tensor=self._last_retired,
            wire_bytes_per_step=self._wire,
        )
        self._bytes = 0
        self._pushes = 0
        self._stall_ms = 0.0
        self._wire = 0
        self._retx0 = retx
        self._attrib0 = now_tot
        self._comp = {}
        self._last_retired = None
        self._history.append(stats)
        return stats

    def _publish(self, stats: StepStats) -> None:
        gauges.set("step.bytes_pushed", stats.bytes_pushed)
        gauges.set("step.pushes", stats.pushes)
        gauges.set("step.sync_stall_ms", stats.sync_stall_ms)
        gauges.set("step.retransmits", stats.retransmits)
        gauges.set("step.wall_ms", stats.wall_ms)
        gauges.set("step.overlap_fraction", stats.overlap_fraction)
        gauges.set("step.wire_bytes_per_step", stats.wire_bytes_per_step)
        for comp, ms in stats.attrib.items():
            # KeyError here is deliberate: a new attribution component
            # must be added to ATTRIB_GAUGE_NAMES (and the doc table) —
            # an f-string fallback would silently bypass the bpslint
            # metric-name check the map exists for
            gauges.set(ATTRIB_GAUGE_NAMES[comp], ms)
        # zero components absent THIS step (a step-5 credit stall must
        # not haunt every later scrape — the gauge set always describes
        # ONE step, summing to its wall_ms)
        for comp in self._pub_attrib - set(stats.attrib):
            gauges.set(ATTRIB_GAUGE_NAMES[comp], 0.0)
        self._pub_attrib = set(stats.attrib)
        counters.inc("step.completed")
        # the flight event names the lagging tensor and this rank — a
        # crash black box says WHO the dying step was waiting on
        try:
            from .config import get_config
            rank = get_config().host_id
        except Exception:  # noqa: BLE001 — publishing must never raise
            rank = 0
        self._recorder.record("step_stats", rank=rank, **stats.as_dict())

    def flush(self) -> Optional[StepStats]:
        """Finalize the in-progress step (engine shutdown: the tail step
        must not be silently lost)."""
        with self._lock:
            if self._step > 0 and self._pushes:
                done = self._finalize_locked()
                self._publish(done)
                return done
        return None

    # -- reading -----------------------------------------------------------

    @property
    def current_step(self) -> int:
        with self._lock:
            return self._step

    def last(self) -> Optional[StepStats]:
        with self._lock:
            return self._history[-1] if self._history else None

    def history(self) -> List[StepStats]:
        with self._lock:
            return list(self._history)

    def summary(self) -> Dict[str, float]:
        """Median-of-history digest for bench artifacts."""
        hist = self.history()
        if not hist:
            return {"steps": 0}

        def med(xs):
            xs = sorted(xs)
            return xs[len(xs) // 2]

        return {
            "steps": hist[-1].step,
            "bytes_pushed_med": med([s.bytes_pushed for s in hist]),
            "sync_stall_ms_med": round(
                med([s.sync_stall_ms for s in hist]), 3),
            "wall_ms_med": round(med([s.wall_ms for s in hist]), 3),
            "overlap_fraction_med": round(
                med([s.overlap_fraction for s in hist]), 4),
            "retransmits_total": sum(s.retransmits for s in hist),
        }
