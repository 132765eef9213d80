"""Chrome/Perfetto timeline of communication and causal tracing; port
of ``byteps_tpu/common/tracing.py``.

``BYTEPS_TRACE_ON`` / ``_START_STEP`` / ``_END_STEP`` / ``_DIR`` select a
window of training steps (a step is a tensor's push count, the max over
tensors).  For each captured chunk the engine's syncer records two
spans on the tensor's track: ``queued`` (enqueue -> dispatch) and
``push_pull`` (dispatch -> retirement).  A unit whose head chunk is
captured also gets its engine threads' spans, on tracks named after the
threads: ``bps.dispatch`` on ``bps-dispatch``, ``bps.sync`` and
``bps.assemble`` on ``bps-sync``.  On top of that:

- **Trace contexts** (:class:`TraceContext`): a captured push carries a
  cluster-unique ``trace_id``; its spans carry the id in ``args`` and
  Perfetto flow events (``ph: s/t/f``, bound by ``id``) join the hops,
  so one gradient's enqueue -> dispatch -> retirement renders as one
  arc.  The wire hops of the integrity envelope and the server engine's
  merge join the arc of the operation they run under (:func:`use`,
  :func:`current`).
- **Sampling** (``BYTEPS_TRACE_SAMPLE=1/N``): every Nth push is captured
  with no step window armed.
- **Bounded memory** (``BYTEPS_TRACE_CAPACITY``): the buffer spills to an
  ``.ndjson`` side file, folded back in at :meth:`Tracer.flush`; events
  that cannot be spilled are counted in ``trace.events_dropped``.
- **Clock alignment**: each file carries a ``(wall, monotonic)`` anchor
  and this process's offset against the cluster's reference clock
  (:func:`set_clock_offset`), so ``tools/bps_trace.py`` can merge
  per-rank files onto one timeline.  The estimate that feeds it is
  ``fault/membership.py`` ``estimate_clock_offset``: NTP-style ``ping``
  round trips to the membership bus, run by a traced member at start,
  after a coordinator change and (at most three times) after a step
  barrier while the offset is still unset.

File names, event names, ``ph``/``tid``/``args`` keys and the metadata
layout are the JAX package's, so either package's ``bps_trace`` reads
the other's files.

The device profiler (``BYTEPS_TRACE_JAX``, ``Config.trace_jax``: the
knob keeps its name) is ``torch.profiler`` here, with CPU and, where
there is a card, CUDA activities, over the same step window; it writes a
Chrome trace ``device_rank{R}_{pid}.json`` under ``<trace_dir>/
torch_profile``.  The profiler must start and stop on one thread, and
the window opens and closes on whatever thread pushes, so it runs on a
thread of its own (:class:`_DeviceProfiler`), recording every thread
(``profile_all_threads``) where the torch build has that option.

**Host spans** (:func:`span_begin`, :func:`span_end`): the ``bps.*``
ranges of a gradient's host path, opened through ``torch.profiler`` so
they share the kernels' clock: ``bps.enqueue`` (the caller's push),
``bps.wait`` and ``bps.update`` (``DistributedOptimizer``) on the
calling thread when that thread is recorded (a thread-local
``torch.profiler`` or the device profiler); ``bps.dispatch``,
``bps.sync`` and ``bps.assemble`` on the engine's threads only while the
device profiler records every thread.  With neither on, a span costs
the gate's check and opens nothing.  The profiler's ranges carry only
their names (``record_function``'s argument string does not reach the
exported trace); the comm file's spans carry the arguments.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from .config import get_config
from .logging import get_logger

# One name/category for every flow event: legacy chrome binds flow arcs
# on (name, cat, id), so all three phases must spell them identically.
FLOW_NAME = "bps_flow"
FLOW_CAT = "bps_flow"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Identity of one captured operation (a push, a pull, a barrier).

    ``trace_id`` is cluster-unique — rank and pid are folded into the
    high bits — so flow events from different ranks' trace files bind
    correctly after ``tools/bps_trace.py`` merges them."""

    trace_id: int
    step: int = 0
    sampled: bool = False


# -- cross-component propagation --------------------------------------------

_current: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("bps_trace_ctx", default=None))


def current() -> Optional[TraceContext]:
    """The trace context of the operation this thread is inside, if any
    (set by :func:`use`; read by the wire hops so a sealed-envelope
    transmit lands its span on the operation's arc)."""
    return _current.get()


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the thread's current trace context for the
    block (no-op when ``ctx`` is None)."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def begin_sample(site: str) -> Tuple[Optional[TraceContext], float]:
    """Entry-point helper for receivers that cannot wrap their body in a
    context manager: joins the thread's current trace or makes a
    sampling decision at ``site``; returns ``(ctx-or-None, t0)`` — the
    caller records its span against the pair on exit."""
    ctx = current()
    if ctx is None:
        ctx = tracer().maybe_sample(site)
    return ctx, (time.monotonic() if ctx is not None else 0.0)


# -- host spans in torch.profiler -------------------------------------------

# True while the device profiler records every thread: the engine's
# threads open their spans only then (a thread-local profiler, such as a
# benchmark's, records none of theirs)
_all_threads = False
# whether torch.profiler records the calling thread (thread-local)
_thread_profiled = torch._C._autograd._profiler_enabled


def span_begin(name: str, engine: bool = False):
    """Open the range ``name`` in ``torch.profiler`` if this thread is
    being recorded, and return it for :func:`span_end`; else None.  A
    caller's thread (``engine=False``) is recorded under its own
    profiler or the device profiler; an engine thread only under the
    device profiler."""
    if not _all_threads and (engine or not _thread_profiled()):
        return None
    rf = record_function(name)
    rf.__enter__()
    return rf


def span_end(rf, trace_id: int = 0, name: str = "", track: str = "",
             t_begin: float = 0.0, t_end: float = 0.0,
             args: Optional[dict] = None) -> None:
    """Close what :func:`span_begin` opened; for a captured unit
    (``trace_id``) also record ``name`` from the caller's monotonic
    timestamps on ``track`` of the comm file, with ``args``."""
    if rf is not None:
        rf.__exit__(None, None, None)
    if trace_id:
        tracer().record_traced(trace_id, name, track, t_begin, t_end,
                               **(args or {}))


# -- flight-recorder stamp ---------------------------------------------------

# (step, trace_id) of the most recent captured push — the flight
# recorder stamps every event with it so a crash black box
# cross-references the merged timeline.  Plain tuple swap: readers and
# writers race benignly under the GIL.
_last_stamp: Tuple[int, int] = (0, 0)


def note_step(step: int) -> None:
    """Record the current engine step (StepStatsTracker feeds this even
    when tracing is off, so flight events carry the step regardless)."""
    global _last_stamp
    _last_stamp = (int(step), _last_stamp[1])


def last_stamp() -> Tuple[int, int]:
    """(step, trace_id) of the most recent captured push (0 = unknown)."""
    return _last_stamp


# -- clock alignment ---------------------------------------------------------

_clock_lock = threading.Lock()
_clock: Dict[str, object] = {"offset_s": None, "err_s": None, "source": None}


def set_clock_offset(offset_s: float, err_s: float, source: str) -> None:
    """Record this process's wall-clock offset against the cluster
    reference (the membership coordinator): ``offset_s`` = local wall
    minus coordinator wall, ``err_s`` the half-RTT uncertainty of the
    estimate.  Written into every trace file's metadata so the merge
    tool can align timelines."""
    with _clock_lock:
        _clock["offset_s"] = float(offset_s)
        _clock["err_s"] = float(err_s)
        _clock["source"] = source


def clock_offset() -> Dict[str, object]:
    with _clock_lock:
        return dict(_clock)


# -- flow ids ----------------------------------------------------------------

_flow_counter = itertools.count(1)


def _new_flow_id(rank: int) -> int:
    """Cluster-unique 64-bit flow/trace id: rank and pid in the high
    bits keep two ranks' (or two incarnations') counters from ever
    colliding in a merged trace."""
    return (((rank & 0xFFFF) << 48)
            | ((os.getpid() & 0xFFFF) << 32)
            | (next(_flow_counter) & 0xFFFFFFFF))


class Tracer:
    """Collects per-chunk phase events and writes chrome trace JSON."""

    # names beyond this stop being step-tracked (and counted dropped):
    # the per-tensor map must not grow without bound under generated
    # tensor names
    _MAX_TENSORS = 8192

    def __init__(self, enabled: Optional[bool] = None,
                 start_step: Optional[int] = None,
                 end_step: Optional[int] = None,
                 out_dir: Optional[str] = None,
                 sample_n: Optional[int] = None,
                 capacity: Optional[int] = None):
        cfg = get_config()
        self.enabled = cfg.trace_on if enabled is None else enabled
        self.start_step = (cfg.trace_start_step if start_step is None
                           else start_step)
        self.end_step = cfg.trace_end_step if end_step is None else end_step
        self.out_dir = cfg.trace_dir if out_dir is None else out_dir
        # 1-in-N sampled capture, live without a step window
        self.sample_n = (cfg.trace_sample_n if sample_n is None
                         else int(sample_n))
        self.capacity = max(256, cfg.trace_capacity if capacity is None
                            else int(capacity))
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._step: Dict[str, int] = {}   # tensor name -> seen pushes
        self._max_step = 0                # highest step seen (window gate)
        self._window_flush_done = False   # once-only window-close flush
        self._written_count = 0           # events already on disk
        self._push_seq = 0                # global push counter (sampling)
        self._site_seq: Dict[str, int] = {}  # per-site sampling counters
        self._rank = cfg.host_id
        # spill-to-disk bound: events past capacity
        # move to an ndjson side file; flush folds them back in
        self._spill_path: Optional[str] = None
        self._spill_count = 0
        self.dropped = 0
        # wall/monotonic anchor pair: every event's ts is monotonic (it
        # must survive wall-clock steps), the anchor maps it back to
        # wall time for cross-rank alignment in bps_trace.py
        self._anchor_wall = time.time()
        self._anchor_mono = time.monotonic()
        # BYTEPS_TRACE_JAX: the device profiler over the same step window,
        # so the card's kernels land next to the host-side comm trace
        self.jax_trace = cfg.trace_jax
        if self.jax_trace and not self.enabled:
            # the profiler window rides the comm-trace step counter, so
            # without BYTEPS_TRACE_ON it would never open — say so once
            # instead of silently producing nothing
            get_logger().warning(
                "BYTEPS_TRACE_JAX=1 has no effect without BYTEPS_TRACE_ON=1"
                " (the profiler window follows the trace step window)")
        self._jax_state = "idle"          # idle -> running -> done
        # profiler calls happen under their own lock WITH the state
        # transition: transitioning outside the call would let a stop on
        # the syncer thread interleave with a start on the user thread
        # and leave an un-stoppable trace
        self._jax_lock = threading.Lock()
        self._profiler: Optional[_DeviceProfiler] = None
        self.profile_path: Optional[str] = None   # the written profile

    @property
    def active(self) -> bool:
        """True when anything records: the step window is armed OR the
        sampled stream is on.  The engine's per-push gate."""
        return self.enabled or self.sample_n > 0

    # -- step bookkeeping ---------------------------------------------------
    def on_push(self, name: str) -> int:
        """Count per-tensor pushes; the max defines the global step
        (the reference keys its window on per-tensor step counts too)."""
        return self.start_push(name)[0]

    def start_push(self, name: str) -> Tuple[int, Optional[TraceContext]]:
        """Per-push entry point: advances the tensor's step count and
        decides whether THIS push is captured — windowed (inside
        [start_step, end_step]) or sampled (every ``sample_n``-th push).
        Returns ``(step, ctx-or-None)``; a None context means the push
        records nothing."""
        global _last_stamp
        with self._lock:
            step = self._step.get(name)
            if step is None and len(self._step) >= self._MAX_TENSORS:
                # unbounded generated names must not grow the map; the
                # push is uncounted and uncaptured, visibly
                self.dropped += 1
                self._count_dropped(1)
                return 0, None
            step = (step or 0) + 1
            self._step[name] = step
            self._max_step = max(self._max_step, step)
            self._push_seq += 1
            seq = self._push_seq
        if (self.enabled and self.jax_trace and step >= self.start_step):
            if step > self.end_step:
                self._jax_stop()
            else:
                self._jax_start()
        if (self.enabled and step == self.end_step + 1
                and not self._window_flush_done):
            # window just closed for the FIRST tensor: flush once (a
            # 1000-tensor model must not pay 1000 sequential full-file
            # rewrites on the enqueue path as each name crosses);
            # stragglers are covered by record()'s own past-window
            # flush, and best-effort — a full disk must not crash a
            # training step for a tracing feature
            self._window_flush_done = True
            self._flush_safe()
        ctx = None
        if self.enabled and self._in_window(step):
            ctx = TraceContext(_new_flow_id(self._rank), step, False)
        elif self.sample_n and seq % self.sample_n == 0:
            ctx = TraceContext(_new_flow_id(self._rank), step, True)
        _last_stamp = (step, ctx.trace_id if ctx is not None else 0)
        return step, ctx

    def maybe_sample(self, site: str) -> Optional[TraceContext]:
        """Sampling decision for non-push capture sites (server pushes,
        KV deltas, serving pulls, step barriers): every ``sample_n``-th
        call per site; with only the step window armed, every call WHILE
        the window is open (gated on the engine's current step — a
        100k-step run must not keep recording server/serve spans forever
        after the window closed at step 20)."""
        if not self.active:
            return None
        if self.sample_n:
            with self._lock:
                c = self._site_seq.get(site, 0) + 1
                self._site_seq[site] = c
            if c % self.sample_n:
                return None
        elif not self._in_window(self._max_step):
            return None
        return TraceContext(_new_flow_id(self._rank), 0, True)

    # -- device profiler window --------------------------------------------
    def _jax_start(self) -> None:
        with self._jax_lock:
            if self._jax_state != "idle":
                return
            try:
                path = os.path.join(
                    self.out_dir, "torch_profile",
                    f"device_rank{self._rank}_{os.getpid()}.json")
                self._profiler = _DeviceProfiler(path)
                self._profiler.start()
                self._jax_state = "running"
                get_logger().info("device profiler started -> %s", path)
            except Exception:  # noqa: BLE001 - must never kill a run
                get_logger().warning("device profiler failed to start",
                                     exc_info=True)
                self._jax_state = "done"

    def _jax_stop(self) -> None:
        with self._jax_lock:
            if self._jax_state != "running":
                return
            try:
                self.profile_path = self._profiler.stop()
                get_logger().info("device profiler stopped")
            except Exception:  # noqa: BLE001
                get_logger().warning("device profiler failed to stop",
                                     exc_info=True)
            self._profiler = None
            self._jax_state = "done"

    def _in_window(self, step: int) -> bool:
        return self.start_step <= step <= self.end_step

    # -- bounded event buffer ----------------------------------------------
    @staticmethod
    def _count_dropped(n: int) -> None:
        try:  # lazy: telemetry imports this module's stamp helpers
            from .telemetry import counters
            counters.inc("trace.events_dropped", n)
        except Exception:  # noqa: BLE001 — counting must never raise here
            pass

    def _append_locked(self, ev: dict) -> None:
        self._events.append(ev)
        if len(self._events) >= self.capacity:
            self._spill_locked()

    def _spill_locked(self) -> None:
        """Move the in-memory buffer to the ndjson side file (caller
        holds the lock).  On any write failure the batch is DROPPED and
        counted — a tracer must bound memory even on a full disk."""
        batch, self._events = self._events, []
        try:
            if self._spill_path is None:
                os.makedirs(self.out_dir, exist_ok=True)
                self._spill_path = os.path.join(
                    self.out_dir,
                    f"bps_trace_rank{self._rank}_{os.getpid()}"
                    ".spill.ndjson")
                # truncate residue of a previous incarnation's same pid
                open(self._spill_path, "w").close()
            with open(self._spill_path, "a") as f:
                for ev in batch:
                    f.write(json.dumps(ev) + "\n")
            self._spill_count += len(batch)
        except Exception:  # noqa: BLE001 — bound memory over keeping data
            self.dropped += len(batch)
            self._count_dropped(len(batch))
            get_logger().warning(
                "tracer: dropped %d event(s) (spill to %s failed)",
                len(batch), self._spill_path, exc_info=True)

    def _iter_spill(self, limit: int):
        """Yield the first ``limit`` spilled events, one at a time
        (flush must not fold a multi-day spill file back into the heap —
        the capacity bound holds at flush time too).  ``limit`` is the
        spill count snapshotted under the lock: lines past it belong to
        a spill racing this flush (their events are ALSO in the racing
        flush's accounting, never lost) and a torn in-progress last
        line can only be past it."""
        if self._spill_path is None or limit <= 0:
            return
        n = 0
        try:
            with open(self._spill_path) as f:
                for line in f:
                    if n >= limit:
                        return
                    line = line.strip()
                    if line:
                        n += 1
                        yield json.loads(line)
        except Exception:  # noqa: BLE001
            get_logger().warning("tracer: spill read failed",
                                 exc_info=True)

    # -- event recording ----------------------------------------------------
    def record(self, name: str, key: int, phase: str, t_begin: float,
               t_end: float, step: int, nbytes: int = 0) -> None:
        if not self.enabled:
            return
        if step > self.end_step:
            # flush as soon as any tensor steps past the window: flush is an
            # idempotent rewrite gated on unwritten events, so in-flight
            # stragglers from other tensors just trigger one more rewrite
            # later (waiting for ALL tensors would lose the trace when a
            # frozen/conditional tensor never advances and the job is killed)
            self._flush_safe()
            return
        if not self._in_window(step):
            return
        with self._lock:
            self._append_locked({
                "name": phase,
                "cat": "comm",
                "ph": "X",                      # complete event
                "ts": t_begin * 1e6,            # chrome wants microseconds
                "dur": max(0.0, (t_end - t_begin) * 1e6),
                "pid": os.getpid(),
                "tid": name,                    # one track per tensor
                "args": {"key": key, "step": step, "bytes": nbytes},
            })

    def record_traced(self, trace_id: int, name: str, tid: str,
                      t_begin: float, t_end: float, cat: str = "comm",
                      **args) -> None:
        """One span belonging to a captured trace: NOT window-gated (the
        capture decision was made at :meth:`start_push` /
        :meth:`maybe_sample` time); the trace id rides ``args`` so the
        merged timeline is searchable by it."""
        if not trace_id or not self.active:
            return
        with self._lock:
            self._append_locked({
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts": t_begin * 1e6,
                "dur": max(0.0, (t_end - t_begin) * 1e6),
                "pid": os.getpid(),
                "tid": tid,
                "args": {"trace_id": trace_id, **args},
            })

    def flow(self, trace_id: int, point: str, tid: str, ts: float) -> None:
        """One flow-event endpoint (``point`` in ``s``/``t``/``f``):
        anchors to the slice enclosing ``ts`` on ``tid`` and binds to
        every other flow event carrying the same id — including ones in
        ANOTHER rank's trace file once merged."""
        if not trace_id or not self.active:
            return
        ev = {"name": FLOW_NAME, "cat": FLOW_CAT, "ph": point,
              "id": trace_id, "ts": ts * 1e6, "pid": os.getpid(),
              "tid": tid}
        if point == "f":
            ev["bp"] = "e"   # bind to the enclosing slice, not the next
        with self._lock:
            self._append_locked(ev)

    def record_span(self, name: str, t_begin: float, t_end: float,
                    **args) -> None:
        """One lifecycle span outside the step window (fault/recovery
        events): unlike :meth:`record`, these are not gated on
        START/END_STEP — a recovery at step 300 must land in the timeline
        even when the comm window closed at step 20.  Sampled streams
        (``BYTEPS_TRACE_SAMPLE``) keep these too: a retransmit storm
        belongs in a production trace."""
        if not self.active:
            return
        with self._lock:
            self._append_locked({
                "name": name,
                "cat": "fault",
                "ph": "X",
                "ts": t_begin * 1e6,
                "dur": max(0.0, (t_end - t_begin) * 1e6),
                "pid": os.getpid(),
                "tid": name,
                "args": dict(args),
            })

    def debug_state(self) -> dict:
        """The /debug/state "trace" section."""
        with self._lock:
            buffered = len(self._events)
        return {"enabled": self.enabled, "sample_n": self.sample_n,
                "active": self.active, "capacity": self.capacity,
                "events_buffered": buffered,
                "events_spilled": self._spill_count,
                "events_dropped": self.dropped,
                "clock": clock_offset()}

    # -- emission -----------------------------------------------------------
    def _flush_safe(self) -> Optional[str]:
        """Best-effort flush for hot-path triggers (window close,
        past-window records): tracing must never crash a training step
        on a full disk."""
        try:
            return self.flush()
        except Exception:  # noqa: BLE001
            get_logger().warning("tracer: flush failed", exc_info=True)
            return None

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        if self.jax_trace:
            self._jax_stop()  # idempotent; engine shutdown ends the window
        with self._lock:
            if not self.active:
                return None
            # consistent snapshot: spill_n + mem covers exactly the
            # events recorded so far — a spill racing this flush moves
            # events from mem to lines PAST spill_n, which stay out of
            # this write and inside the next flush's accounting (no
            # duplicates, no loss)
            spill_n = self._spill_count
            mem = list(self._events)
            total = spill_n + len(mem)
            if path is None and total == self._written_count:
                return None          # nothing new since the last write
            written_prev = self._written_count
            self._written_count = total
        if total == 0:
            return None
        rank = self._rank
        if path is None:
            os.makedirs(self.out_dir, exist_ok=True)
            # one file per process rank, like the reference's per-local-rank
            # emitter (global.cc:469-564); pid keeps restarts distinct
            path = os.path.join(self.out_dir,
                                f"bps_trace_rank{rank}_{os.getpid()}.json")
        meta = {
            "displayTimeUnit": "ms",
            # merge metadata (tools/bps_trace.py): all event timestamps
            # are monotonic; the anchor maps them to this process's wall
            # clock, and clockSync maps that onto the coordinator's
            "rank": rank,
            "pid": os.getpid(),
            "monoAnchor": {"wall": self._anchor_wall,
                           "mono": self._anchor_mono},
            "clockSync": clock_offset(),
            "droppedEvents": self.dropped,
        }
        # Streaming write: spill events then the in-memory tail, one at
        # a time — a multi-day sampled run's spill must not materialize
        # in RAM just to be rewritten.  String tids map to ints on the
        # fly (chrome requires numeric tids); names ride thread_name
        # metadata events appended at the end, as the reference does.
        tids: Dict[str, int] = {}
        n_out = 0
        try:
            with open(path, "w") as f:
                f.write("{")
                for k, v in meta.items():
                    f.write(json.dumps(k) + ": " + json.dumps(v) + ", ")
                f.write('"traceEvents": [')
                for e in itertools.chain(self._iter_spill(spill_n), mem):
                    tid = tids.setdefault(e["tid"], len(tids))
                    if n_out:
                        f.write(", ")
                    f.write(json.dumps({**e, "tid": tid}))
                    n_out += 1
                for name, tid in tids.items():
                    if n_out:
                        f.write(", ")
                    f.write(json.dumps(
                        {"name": "thread_name", "ph": "M",
                         "pid": os.getpid(), "tid": tid,
                         "args": {"name": name}}))
                    n_out += 1
                f.write("]}")
        except Exception:
            # the write failed: un-mark the events so a later flush (the
            # atexit one, after the disk recovers) retries instead of
            # answering "nothing new" forever
            with self._lock:
                self._written_count = min(self._written_count,
                                          written_prev)
            raise
        get_logger().info("wrote comm trace: %s (%d events)", path, n_out)
        return path

    def now(self) -> float:
        return time.monotonic()


class _DeviceProfiler:
    """``torch.profiler`` started, stopped and exported on a thread of
    its own (the profiler refuses to stop on another thread than the
    one that started it).  CPU activity always, CUDA activity where a
    card is present; the card's kernels are recorded whatever thread
    launches them, and the host's operators and ``bps.*`` spans of every
    thread where the build offers ``profile_all_threads`` (else of the
    profiler's own thread alone: said once in the log)."""

    def __init__(self, path: str):
        self.path = path
        self._go = threading.Event()
        self._started = threading.Event()
        self._stopped = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bps-device-profiler")

    def _run(self) -> None:
        global _all_threads
        from torch.profiler import ProfilerActivity, profile
        try:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            every = _every_thread_config()
            prof = (profile(activities=acts, experimental_config=every)
                    if every is not None else profile(activities=acts))
            prof.start()
        except BaseException as e:  # noqa: BLE001 — reported by start()
            self._error = e
            self._started.set()
            return
        _all_threads = every is not None
        self._started.set()
        self._go.wait()
        _all_threads = False
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            prof.export_chrome_trace(self.path)
        except BaseException as e:  # noqa: BLE001 — reported by stop()
            self._error = e
        self._stopped.set()

    def start(self) -> None:
        self._thread.start()
        self._started.wait()
        if self._error is not None:
            raise self._error

    def stop(self, timeout: float = 300.0) -> str:
        self._go.set()
        self._thread.join(timeout)
        if self._error is not None:
            raise self._error
        if not self._stopped.is_set():
            raise TimeoutError("device profiler did not stop")
        return self.path


_every_thread_warned = False


def _every_thread_config():
    """``torch.profiler``'s config that records every thread, or None
    where this torch build lacks the option (logged once)."""
    global _every_thread_warned
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        if not _every_thread_warned:
            _every_thread_warned = True
            get_logger().warning(
                "this torch build cannot profile every thread: the device "
                "trace holds the engine threads' kernels, not their spans")
        return None


# -- the process-wide tracer -------------------------------------------------

# One tracer per process (the engine's, the membership bus's, the
# serving plane's spans all land in ONE per-rank file — a merged
# timeline needs one emitter per process, not one per component).
_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def tracer() -> Tracer:
    """The process-wide tracer (created lazily from the live config)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def set_tracer(t: Optional[Tracer]) -> Optional[Tracer]:
    """Install an explicit tracer (tests, benches); None re-arms lazy
    construction from config.  Returns the installed tracer."""
    global _tracer
    with _tracer_lock:
        _tracer = t
    return t


def _reset_for_tests() -> None:
    global _tracer, _last_stamp, _all_threads
    with _tracer_lock:
        _tracer = None
    _last_stamp = (0, 0)
    _all_threads = False
    with _clock_lock:
        _clock.update({"offset_s": None, "err_s": None, "source": None})
