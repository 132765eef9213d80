"""Priority + credit chunk scheduler and the auto-tuned chunk/credit
planner; port of ``ChunkScheduler`` and ``ChunkPlanner`` in
``byteps_tpu/common/scheduler.py``.

Tasks pop by priority descending, then key ascending, and a byte budget
of in-flight work (the credit window, BYTEPS_SCHEDULING_CREDIT) bounds how
far the dispatcher runs ahead of retirement.  ``native/`` holds the same
queue in C++ (the engine's default); this is the Python heap both are
held to.

The planner's compressor ladder (``COMPRESS_LADDER``) races codecs for
the gradient path, and :meth:`ChunkPlanner.plan_param_codec` picks the
sharded update's parameter-leg codec from the same ladder, as a pure
function of size.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import List, Optional

from .config import ALIGN_BYTES
from . import flight_recorder as _flight
from .lock_witness import named_lock
from .telemetry import attribution as _attribution
from .telemetry import counters, gauges
from .types import ChunkTask


class ChunkScheduler:
    """Thread-safe priority queue with a bytes-in-flight credit window."""

    def __init__(self, credit_bytes: int = 0):
        # 0 = unlimited window
        self._credit_limit = int(credit_bytes)
        self._in_flight = 0
        self._heap: List[tuple] = []
        self._seq = 0
        self._cv = threading.Condition(
            named_lock("scheduler.cv", reentrant=True))
        self._interrupts = 0    # one-shot wakeups (pause handshake)
        self._shutdown = False  # latched wake (engine teardown)

    def add_task(self, task: ChunkTask) -> None:
        with self._cv:
            heapq.heappush(self._heap, (task.sort_tuple(), self._seq, task))
            self._seq += 1
            self._cv.notify()

    def _eligible_locked(self) -> bool:
        if not self._heap:
            return False
        if self._credit_limit <= 0:
            return True
        task = self._heap[0][2]
        # at least one task may always be in flight, however large
        return (self._in_flight == 0
                or self._in_flight + task.nbytes <= self._credit_limit)

    def get_task(self, block: bool = False,
                 timeout: Optional[float] = None) -> Optional[ChunkTask]:
        """Pop the highest-priority task if the credit window allows it.
        A blocking call waits without polling, and returns None when woken
        by :meth:`interrupt` (once) or :meth:`wake` (for good)."""
        with self._cv:
            if block:
                # tasks queued but the byte window full: the wait about
                # to happen is a credit stall, the step's "credit"
                # attribution component, not idleness
                credit_gated = bool(self._heap) and not self._eligible_locked()
                t0 = time.monotonic() if credit_gated else 0.0
                self._cv.wait_for(
                    lambda: (self._eligible_locked() or self._shutdown
                             or self._interrupts > 0),
                    timeout=timeout)
                if credit_gated:
                    _attribution.add("credit",
                                     (time.monotonic() - t0) * 1e3)
                if self._interrupts > 0:
                    self._interrupts -= 1
            if not self._eligible_locked():
                return None
            _, _, task = heapq.heappop(self._heap)
            self._in_flight += task.nbytes
            return task

    def interrupt(self) -> None:
        """One-shot wakeup: the next (or currently blocked) blocking
        get_task returns promptly even with nothing eligible."""
        with self._cv:
            self._interrupts += 1
            self._cv.notify_all()

    def wake(self) -> None:
        """Latched wakeup: every blocked and future get_task returns."""
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def set_credit_bytes(self, credit_bytes: int) -> None:
        """Retarget the credit window (the planner's value); a wider
        window may make queued tasks eligible, so waiters are notified."""
        with self._cv:
            self._credit_limit = int(credit_bytes)
            self._cv.notify_all()

    @property
    def credit_bytes(self) -> int:
        with self._cv:
            return self._credit_limit

    def report_finish(self, nbytes: int) -> None:
        """Return credits of retired work (one call per dispatch unit)."""
        with self._cv:
            self._in_flight = max(0, self._in_flight - nbytes)
            self._cv.notify()

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._heap)

    @property
    def bytes_in_flight(self) -> int:
        with self._cv:
            return self._in_flight

    def drain(self) -> List[ChunkTask]:
        """Pop everything regardless of credit (shutdown path)."""
        with self._cv:
            tasks = [t for _, _, t in sorted(self._heap)]
            self._heap.clear()
            return tasks


# Samples per (size bucket, candidate) before the planner locks a bucket;
# scoring a candidate by the least of its samples rejects one-off
# outliers (a pause of the host, the first CUDA touch of a size growing
# the caching allocator) without a long exploration.
_PLAN_SAMPLES = 2
# candidate chunk sizes stay on the partitioner's alignment
_PLAN_ALIGN = ALIGN_BYTES

# The compressor ladder: per size bucket the planner races these codecs on
# the wall time of a push, among those whose codec-golden gradient error
# (compression.registry.golden_error) is at most the configured ceiling.
# Every lossy rung carries error feedback, which the golden error counts;
# the sparsifiers keep a quarter (JAX ``scheduler.py:168-182``).
COMPRESS_LADDER = (
    ("none", None),
    ("onebit", {"compressor": "onebit", "ef": "vanilla"}),
    ("randomk", {"compressor": "randomk", "k": "0.25", "ef": "vanilla"}),
    ("topk", {"compressor": "topk", "k": "0.25", "ef": "vanilla"}),
)


class ChunkPlanner:
    """Online (chunk size, credit window) tuner for the push_pull path.

    Per tensor-size bucket (``nbytes.bit_length()``) it races a candidate
    ladder -- the configured bound, the whole tensor, its half and its
    quarter -- scoring each by the least wall seconds of a completed
    push_pull, round-robin (fewest samples first, ladder order on ties),
    then locks the winner and sets the credit window to 4x the largest
    locked chunk.  Tensors at or under the configured bound are one chunk
    either way and never tuned.

    A pinned knob (``Config.partition_pinned`` / ``credit_pinned``) is
    never moved, and at more than one rank (``num_procs > 1``) the
    planner is inert: the ranks of a process group must issue the same
    collectives with the same sizes, and per-rank timings would carve
    different chunks.

    A sample charged to a candidate that is no longer on the ladder (a
    push carved under an earlier plan) is dropped.  The JAX planner also
    drops a sample during which a program compiled; eager PyTorch
    compiles nothing, and the nearest pollution here, the allocator's
    first growth to a size, is left to the min-of-samples scoring.

    With ``Config.compress_autotune`` a second dimension, the compressor
    ladder (:data:`COMPRESS_LADDER`), races codecs per size bucket for
    the tensors the engine gives it (those pushed without explicit
    kwargs), in the same round-robin, min-of-2 way, once the bucket's
    chunk size has locked; a rung whose golden error exceeds
    ``compress_error_ceiling`` is never tried.  Inert at more than one
    rank too: a per-rank codec choice would diverge the ranks.
    """

    def __init__(self, cfg, num_procs: int = 1):
        self._base = cfg.partition_bytes
        self._tune_partition = (cfg.autotune and not cfg.partition_pinned
                                and num_procs == 1)
        self._tune_credit = (cfg.autotune and not cfg.credit_pinned
                             and num_procs == 1)
        self._tune_compress = cfg.compress_autotune and num_procs == 1
        self._error_ceiling = cfg.compress_error_ceiling
        self._min_compress = cfg.min_compress_bytes
        self._cbuckets = {}         # bucket -> the compressor ladder's state
        self._buckets = {}          # bucket -> {"cands", "samples", "locked"}
        self._lock = named_lock("planner")
        self._credit = 0            # 0 = leave the scheduler's window

    @property
    def active(self) -> bool:
        return self._tune_partition

    def _candidates(self, nbytes: int) -> List[int]:
        def align(b):
            b = max(_PLAN_ALIGN, int(b))
            r = b % _PLAN_ALIGN
            return b + (_PLAN_ALIGN - r) if r else b

        out = []
        for c in (self._base, align(nbytes), align(nbytes // 2),
                  align(nbytes // 4)):
            if c >= _PLAN_ALIGN and c not in out:
                out.append(c)
        return out

    def plan_partition(self, nbytes: int) -> int:
        """The partition bound to carve a tensor of ``nbytes`` with now."""
        if not self._tune_partition or nbytes <= self._base:
            return self._base
        bucket = nbytes.bit_length()
        with self._lock:
            st = self._buckets.get(bucket)
            if st is None:
                st = {"cands": self._candidates(nbytes), "samples": {},
                      "locked": None}
                self._buckets[bucket] = st
            if st["locked"] is not None:
                return st["locked"]
            return min(st["cands"],
                       key=lambda c: len(st["samples"].get(c, ())))

    def observe(self, nbytes: int, partition_bytes: int,
                seconds: float) -> None:
        """Record one completed push_pull of a tensor of ``nbytes`` carved
        at ``partition_bytes``; locks the bucket once every candidate has
        its samples."""
        if not self._tune_partition or nbytes <= self._base or seconds <= 0:
            return
        with self._lock:
            st = self._buckets.get(nbytes.bit_length())
            if st is None or st["locked"] is not None:
                return
            if partition_bytes not in st["cands"]:
                return      # carved under an earlier plan
            st["samples"].setdefault(partition_bytes, []).append(seconds)
            if any(len(st["samples"].get(c, ())) < _PLAN_SAMPLES
                   for c in st["cands"]):
                return
            st["locked"] = min(st["cands"],
                               key=lambda c: min(st["samples"][c]))
            if self._tune_credit:
                self._credit = 4 * max(s["locked"]
                                       for s in self._buckets.values()
                                       if s["locked"] is not None)

    def credit_bytes(self) -> int:
        """The credit window to install (0 = leave the configured one)."""
        with self._lock:
            return self._credit

    def locked(self, nbytes: int) -> bool:
        """Whether a tensor of ``nbytes`` has nothing left to explore."""
        if not self._tune_partition or nbytes <= self._base:
            return True
        with self._lock:
            st = self._buckets.get(nbytes.bit_length())
            return st is not None and st["locked"] is not None

    # -- the compressor ladder ---------------------------------------------
    @property
    def compress_active(self) -> bool:
        return self._tune_compress

    def _compress_candidates(self) -> List[tuple]:
        """The ladder's ``(key, kwargs, golden error)`` for one bucket: a
        rung over the ceiling is left out before any push pays for it.
        The golden errors run the codecs on the CPU, so callers hold no
        lock."""
        from ..compression import registry as codecs
        out = [("none", None, 0.0)]
        for key, kw in COMPRESS_LADDER[1:]:
            try:
                err = codecs.golden_error(kw)
            except Exception:  # noqa: BLE001 — a codec whose golden
                continue       # cannot even run is never chosen
            if err <= self._error_ceiling:
                out.append((key, kw, err))
        return out

    def _compressible(self, nbytes: int) -> bool:
        return self._tune_compress and nbytes >= max(1, self._min_compress)

    def plan_compression(self, nbytes: int):
        """The compression kwargs for an unpinned tensor of ``nbytes`` now
        (None: uncompressed).  The chunk size locks first: racing both at
        once would charge a chunk candidate's time to a codec.  Fewest
        samples first, ladder order on ties.  The cutoff is the tensor's
        size, not its bucket's: a bucket can straddle
        ``min_compress_bytes``."""
        if not self._compressible(nbytes) or not self.locked(nbytes):
            return None
        bucket = nbytes.bit_length()
        with self._lock:
            st = self._cbuckets.get(bucket)
        if st is None:
            cands = self._compress_candidates()     # outside the lock
            with self._lock:
                st = self._cbuckets.setdefault(
                    bucket, {"cands": cands, "samples": {}, "locked": None})
        with self._lock:
            if st["locked"] is not None:
                key = st["locked"]
            else:
                key = min((k for k, _, _ in st["cands"]),
                          key=lambda k: len(st["samples"].get(k, ())))
            return next(kw for k, kw, _ in st["cands"] if k == key)

    def plan_param_codec(self, nbytes: int):
        """The parameter-leg codec kwargs of a sharded-update tensor of
        ``nbytes`` under ``sharded_param_codec="auto"``, or None for full
        precision (JAX ``scheduler.py:397-421``).  Deterministic, with no
        race: the codec changes the values every replica integrates, so
        the choice is a pure function of size and the quality gate.
        Under 4 MiB the lowest-golden-error rung of the ceiling-filtered
        ladder, from 4 MiB onebit when it clears the gate, else the
        lowest-error rung."""
        if nbytes < max(1, self._min_compress):
            return None
        cands = [(k, kw, err) for k, kw, err in self._compress_candidates()
                 if kw is not None]
        if not cands:
            return None
        if nbytes >= (4 << 20):
            for k, kw, _ in cands:
                if k == "onebit":
                    return kw
        return min(cands, key=lambda c: c[2])[1]

    def observe_compression(self, nbytes: int, codec: str,
                            seconds: float) -> None:
        """Record one completed push of a ladder-owned tensor that ran
        under ``codec`` (a ladder key); locks the bucket once every rung
        has its samples."""
        if not self._compressible(nbytes) or seconds <= 0:
            return
        bucket = nbytes.bit_length()
        with self._lock:
            st = self._cbuckets.get(bucket)
            if st is None or st["locked"] is not None:
                return
            if codec not in {k for k, _, _ in st["cands"]}:
                return      # pushed under an earlier ladder
            st["samples"].setdefault(codec, []).append(seconds)
            if any(len(st["samples"].get(k, ())) < _PLAN_SAMPLES
                   for k, _, _ in st["cands"]):
                return
            locked = min((k for k, _, _ in st["cands"]),
                         key=lambda k: min(st["samples"][k]))
            st["locked"] = locked
        # outside the planner lock, as the JAX planner records it
        # (``scheduler.py:451-462``): bps_top's CODEC column, /metrics,
        # the flight recorder
        counters.inc("compression.planner_locked")
        gauges.set("compression.codec_locked", 1.0,
                   bucket=bucket, codec=locked)
        _flight.record("compression.codec_locked", bucket=bucket,
                       codec=locked)

    def compress_locked(self, nbytes: int) -> bool:
        """Whether a tensor of ``nbytes`` has no codec left to explore."""
        if not self._compressible(nbytes):
            return True
        with self._lock:
            st = self._cbuckets.get(nbytes.bit_length())
            return st is not None and st["locked"] is not None

    def snapshot(self) -> dict:
        """Locked partition (or exploration so far) per bucket, the
        credit window, and the compressor ladder's state per bucket."""
        with self._lock:
            buckets = {
                str(b): {"locked_partition_bytes": st["locked"],
                         "explored": {str(k): round(min(v), 6)
                                      for k, v in st["samples"].items()
                                      if v}}
                for b, st in self._buckets.items()}
            cbuckets = {
                str(b): {"locked_codec": st["locked"],
                         "explored": {k: round(min(v), 6)
                                      for k, v in st["samples"].items()
                                      if v},
                         "golden_error": {k: round(e, 4)
                                          for k, _, e in st["cands"]}}
                for b, st in self._cbuckets.items()}
            return {"tuning_partition": self._tune_partition,
                    "tuning_credit": self._tune_credit,
                    "base_partition_bytes": self._base,
                    "credit_bytes": self._credit,
                    "buckets": buckets,
                    "compression": {"tuning": self._tune_compress,
                                    "error_ceiling": self._error_ceiling,
                                    "buckets": cbuckets}}
