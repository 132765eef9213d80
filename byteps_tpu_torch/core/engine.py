"""The push_pull engine: plan -> partition -> schedule -> dispatch units
-> retire -> assemble; port of ``PushPullEngine`` in
``byteps_tpu/core/engine.py``.

Two threads, as in the JAX package:

- the **dispatcher** pops chunk tasks from the priority scheduler (credit
  window permitting): one blocking pop, then up to ``group_size - 1``
  more that are already eligible (the whole eligible window when
  ``group_size < 0``, bounded by the queue depth at the start of the
  drain).  :func:`_plan_batch` merges neighbours into the fewest dispatch
  units, and each unit is one collective on the engine's own CUDA
  stream.  That stream first waits on the event each caller recorded at
  enqueue, so a gradient produced on autograd's stream (or any other) is
  complete before the engine reads it;
- the **syncer** drains what has been dispatched and retires each unit
  in dispatch order: one wait on the unit's CUDA event, one return of
  the unit's credits, then each task's callback with its own result.  A
  tensor's handle resolves when its last chunk lands; assembly divides
  by R (an average) before any downcast, then hands the result to the
  handle with an event the caller's stream waits on.

On the CPU (gloo) the collectives are synchronous and no events exist.

The auto-tuned :class:`~..common.scheduler.ChunkPlanner` picks each
uncompressed tensor's chunk size per size bucket; a tensor is re-carved
only between its pushes (``TensorContext.inflight == 0``), and each
completed push is a timing sample.  Under ``compress_autotune`` its
compressor ladder then picks the codec of every tensor pushed without
explicit kwargs: which codec owns a tensor is decided at its first push,
explicit kwargs re-pin it, a new codec applies between pushes with
fresh compressor state, and each push's sample is charged to the codec
it ran under.  The planner is inert at more than one rank.

Dispatch order is the priority mechanism on one rank.  The ranks of a
process group must issue the same collectives, of the same sizes, in the
same order, and the moment a task becomes eligible differs between
ranks, so with more than one rank the engine dispatches in enqueue order
(hook order, which is the same on every rank), one chunk per collective
(a width of 1, as the JAX engine has for more than one process,
``byteps_tpu/core/engine.py:298``), and the planner does not tune.

The sharded weight update (``Config.sharded_update``): a tensor declared
with :meth:`PushPullEngine.declare_update` owns a
:class:`~.sharded_update.ShardedUpdateSlot`, and its pushes
(:meth:`PushPullEngine.push_pull_update_async`) ride the scatter
accumulator: each chunk is a column slab of the ``[L, C]`` view of the
tensor, reduce-scattered into this rank's block (``comm/collectives.py``).
Right after the tensor's last reduce-scatter the dispatcher runs the
slot's optimizer step on that block and the all-gather of the updated
parameters, on the engine stream, so the collectives keep one order on
every rank and the syncer never issues one; the handle resolves to the
parameters.  Chunk bounds the column view cannot express, and small
single-chunk tensors, take the parts fallback: the chunks are
all-reduced as usual, the dispatcher merges them and the slot steps its
block of the merged gradient.  ``stats`` counts the wire bytes of each
leg (``wire_push``, ``wire_pull``): push N, and pull N/R on the buffer
path, N on the fallback and for every other tensor.

The quantized parameter leg (``Config.sharded_param_codec``) is the
slot's (``core/sharded_update.py``, ``core/param_codec.py``): its pull
leg is accounted at the codec's payload and counted again under
``compression.param_wire_bytes``.

Observability, at the JAX engine's sites: the process tracer decides at
enqueue whether a push is captured (the step window or 1-in-N sampling;
with tracing off the enqueue path takes no tracer lock), and the syncer
records each captured chunk's ``queued`` (enqueue -> dispatch) and
``push_pull`` (dispatch -> retirement) spans with the push's flow arc
(``s`` at its first chunk's enqueue, ``f`` at its last chunk's
retirement).  With ``telemetry_on`` the :class:`StepStatsTracker` takes
every push, the syncer's blocked time (``sync``), each unit's queue wait
(``queue``), the dispatch call (``dispatch``), the caller's staging
(``enqueue``) and the retirement callbacks (``assemble``); the wire
counters carry each leg (``wire_bytes{leg=}``).  The flight recorder
gets ``engine.init``, ``engine.dispatch_failed`` and
``engine.shutdown``, and shutdown flushes the last step, the trace and
the exit dump.

Not ported:
- AOT warming: eager PyTorch compiles no program per shape, and the
  CUDA kernels are built once per process at their first launch, so
  there is nothing to warm (the ``compile`` attribution reads 0);
- ``export_shards`` (serving cuts);
- membership epochs with the stale-epoch guard (and its
  ``engine.stale_chunk`` flight event), and the ``_deadline_loop``
  watchdog: they need ``fault/membership.py`` and
  ``utils/failure_detector.py``.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..comm.collectives import (push_pull_array, push_pull_arrays_batched,
                                push_pull_chunk_scatter, scatter_layout)
from ..comm.compressed import fused_compressed_push_pull
from ..comm.mesh import CommContext
from ..common import flight_recorder as _flight
from ..common import tracing as _tracing
from ..common.config import Config
from ..common.handles import Handle, HandleManager
from ..common.registry import TensorRegistry
from ..common.scheduler import ChunkPlanner, ChunkScheduler
from ..common.telemetry import (SpeedMonitor, StepStatsTracker, attribution,
                                counters, gauges, histograms)
from ..common.types import ChunkTask, Status, StatusCode, TensorContext
from ..compression import registry as compression_registry
from ..fault import membership as _membership
from .sharded_update import ShardedUpdateSlot
from ..common.logging import get_logger

_log = get_logger()

_SHUTDOWN = object()  # sync-queue sentinel
_DRAIN_BUDGET_S = 60.0  # shutdown waits this long, in all, for handles
# A single-chunk sharded-update tensor rides the scatter accumulator from
# this size up, and the parts fallback below it: the JAX engine's
# buffer-mode rule, at the default of its BYTEPS_BUFFER_MIN_BYTES (not a
# knob here).
BUFFER_MIN_BYTES = 1 << 20


def _plan_batch(batch: List[ChunkTask]):
    """Group a popped, priority-ordered task batch into dispatch units:

    - ``("run", tasks)``: contiguous equal-length chunks of ONE
      uncompressed multi-chunk tensor, or of one sharded-update tensor.
      For a tensor on the scatter accumulator (a sharded-update tensor's
      buffer mode) that is JAX's run: contiguous equal-width column slabs,
      one reduce-scatter.  Otherwise it is the slice of the caller's flat
      tensor that its chunks cover, reduced as one collective whose one
      cast-copy reads it (no per-chunk copy-in).  A sharded-update
      tensor's chunks never join a group with other tensors: its slot
      steps when its own last chunk is dispatched;
    - ``("group", tasks)``: consecutive uncompressed chunks of distinct
      single-chunk tensors with equal length, dtype and scale: one buffer,
      one collective (``push_pull_arrays_batched``).  JAX compares the
      chunks' stacked shapes; the port's chunks are flat, so it compares
      lengths;
    - ``("single", [task])``: everything else (compressed chunks, odd
      sizes).

    Only adjacent tasks merge, so dispatch order, the priority mechanism,
    is kept across units.  The JAX engine then splits drain-mode units
    into power-of-two widths (``_pow2_split``) to bound XLA's compile
    cache; eager PyTorch has no such cache, so the port keeps each unit
    whole: its units are JAX's before that split."""
    units = []
    i = 0
    while i < len(batch):
        t = batch[i]
        if t.pending is not None and t.pending.multi_chunk:
            run = [t]
            j = i + 1
            while (j < len(batch)
                   and batch[j].pending is t.pending
                   and batch[j].num_elems == t.num_elems
                   and batch[j].offset_elems
                   == run[-1].offset_elems + run[-1].num_elems):
                run.append(batch[j])
                j += 1
            units.append(("run", run))
            i = j
            continue
        if t.compression is None:
            group = [t]
            j = i + 1
            while (j < len(batch)
                   and batch[j].compression is None
                   and not (batch[j].pending is not None
                            and batch[j].pending.multi_chunk)
                   and batch[j].num_elems == t.num_elems
                   and batch[j].data.dtype == t.data.dtype
                   and batch[j].scale == t.scale):
                group.append(batch[j])
                j += 1
            units.append(("group" if len(group) > 1 else "single", group))
            i = j
            continue
        units.append(("single", [t]))
        i += 1
    return units


def _chunk(task: ChunkTask) -> torch.Tensor:
    return task.data[task.offset_elems:task.offset_elems + task.num_elems]


def _wire_nbytes(task: ChunkTask) -> int:
    """Bytes a chunk puts on the wire each way: its compressed payload,
    or the chunk itself."""
    if task.compression is not None:
        return task.compression.worker.payload_nbytes()
    return task.nbytes


def _joined(parts: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """One flat view of ``parts`` when they lie end to end in one buffer
    (the chunks of one run), else None.  Only a run's buffer holds chunks
    of one tensor alone, so the view overlaps no other handle's result."""
    p0 = parts[0]
    base, off = p0.untyped_storage().data_ptr(), p0.storage_offset()
    for p in parts:
        if (p.untyped_storage().data_ptr() != base
                or p.storage_offset() != off or p.stride() != (1,)):
            return None
        off += p.numel()
    return p0.as_strided((off - p0.storage_offset(),), (1,),
                         p0.storage_offset())


class _CompressionSlot:
    """Per-chunk compressor pair and its state.  The dispatcher commits
    each step's new state when it dispatches the chunk (so the next step
    of the chunk, which may be dispatched before this one syncs, starts
    from it); the syncer puts the previous state back if the step fails."""

    __slots__ = ("worker", "server", "wstate", "sstate")

    def __init__(self, worker, server, wstate, sstate):
        self.worker = worker
        self.server = server
        self.wstate = wstate
        self.sstate = sstate


class _PendingTensor:
    """Collects the finished chunks of one push_pull.

    A sharded-update push (``slot``) is finished on the dispatcher: it
    counts the chunks dispatched, keeps the accumulator (``scatter``:
    the ``(layout, C)`` of buffer mode) or the fallback's merged chunk
    results, and after the last chunk stores the slot's emitted
    parameters in ``result``, which assembly returns."""

    def __init__(self, handle: Handle, ctx: TensorContext, out_shape,
                 denom: int, total: int, compressed: bool, slot=None,
                 scatter=None, scale: Optional[float] = None,
                 hyperparameters=None):
        self.handle = handle
        self.ctx = ctx
        self.out_shape = out_shape
        self.denom = denom        # divisor applied at assembly (1 = none)
        self.total = total
        # chunks that form runs of their own, never groups: those of an
        # uncompressed tensor of several chunks, and any of a
        # sharded-update tensor (its slot steps after its own last chunk)
        self.multi_chunk = (total > 1 and not compressed) or slot is not None
        self.slot = slot
        self.scatter = scatter
        self.scale = scale        # buffer mode's 1/R, applied by the slot
        self.hyperparameters = hyperparameters
        self.parts: Dict[int, Any] = {}
        self.resolved = False     # the handle has been (or is being) set
        self.lock = threading.Lock()
        # dispatcher-owned (sharded update)
        self.dispatched = 0
        self.dispatch_failed = False
        self.buf = None           # the scatter accumulator block
        self.merged: Dict[int, torch.Tensor] = {}  # fallback, by offset
        self.result = None
        # the push's captured trace (syncer-owned): its flow arc opens at
        # the first retired chunk and closes at the last
        self.trace = None
        self.trace_started = False
        self.trace_left = total

    def complete_part(self, part_idx: int, data) -> bool:
        """Keep a chunk's result; True for the chunk that completes the
        tensor."""
        with self.lock:
            if self.resolved:
                return False
            self.parts[part_idx] = data
            self.resolved = len(self.parts) == self.total
            return self.resolved

    def fail(self) -> bool:
        """True for the first failed chunk: only it resolves the handle."""
        with self.lock:
            first, self.resolved = not self.resolved, True
            self.parts.clear()
            self.result = None
            return first

    def assemble(self) -> torch.Tensor:
        if self.slot is not None:
            self.parts.clear()
            out, self.result = self.result, None
            return out
        return self.merge([self.parts.pop(i) for i in range(self.total)])

    def merge(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The reduced tensor from its chunks' results, in order."""
        if len(parts) == 1:
            flat = parts[0]
        else:
            flat = _joined(parts)
            if flat is None:
                flat = torch.cat(parts)
        out = flat.reshape(self.out_shape)
        if self.denom != 1:
            # f16/bf16 sums arrive in f32: divide before the downcast
            if out.is_floating_point():
                out = out / self.denom
            else:
                out = torch.div(out, self.denom, rounding_mode="floor")
        if out.dtype != self.ctx.dtype:
            out = out.to(self.ctx.dtype)
        return out


class PushPullEngine:
    """Process-wide engine; one per ``init()``."""

    def __init__(self, comm: CommContext, cfg: Config):
        self.comm = comm
        self.cfg = cfg
        self.device = comm.device
        self.registry = TensorRegistry()
        self.handles = HandleManager()
        self.scheduler = self._make_scheduler(cfg)
        self.planner = ChunkPlanner(cfg, num_procs=comm.size)
        self.speed = SpeedMonitor()
        # one tracer per process (common/tracing.py): the engine, the
        # server engine, the store and the envelope's hops emit into one
        # per-rank file, so a push's flow arc can cross components
        self.tracer = _tracing.tracer()
        # per-step stats and attribution: the step.* gauges, the flight
        # recorder's step_stats events, a bounded history
        self.step_stats = StepStatsTracker()
        # chunks popped per dispatch iteration: -1 drains the eligible
        # window; 1 at more than one rank (see the module docstring)
        self._group_size = (1 if comm.size > 1
                            else -1 if cfg.group_size < 0
                            else max(1, cfg.group_size))
        # collectives issued vs chunk tasks consumed; bytes on the wire of
        # each leg of every retired chunk
        self.stats = {"dispatches": 0, "chunks": 0, "wire_push": 0,
                      "wire_pull": 0}
        # name -> ShardedUpdateSlot, one per declare_update
        self.update_slots: Dict[str, ShardedUpdateSlot] = {}
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)
        self._sync_q: "queue.Queue" = queue.Queue()
        self._enq_lock = threading.Lock()
        self._enq_seq = 0
        self._dispatch_enabled = threading.Event()
        self._dispatch_enabled.set()
        self._parked = threading.Event()  # dispatcher pause handshake
        self._running = True
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="bps-dispatch", daemon=True)
        self._syncer = threading.Thread(
            target=self._sync_loop, name="bps-sync", daemon=True)
        self._dispatcher.start()
        self._syncer.start()
        _flight.record("engine.init", ranks=comm.size,
                       epoch=_membership.current_epoch())

    @staticmethod
    def _make_scheduler(cfg: Config):
        """The native C++ queue, or with ``use_native=False`` the Python
        heap.  A native scheduler that cannot be built or loaded raises:
        no silent fallback (``native/__init__.py`` says why)."""
        if cfg.use_native:
            from ..native import NativeChunkScheduler
            return NativeChunkScheduler(credit_bytes=cfg.scheduling_credit)
        return ChunkScheduler(credit_bytes=cfg.scheduling_credit)

    # ----------------------------------------------------------- helpers
    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    @contextlib.contextmanager
    def _caller_to_engine_stream(self):
        """Run the body on the engine stream, ordered after the caller's
        stream, and order the caller's later work after it (state the
        dispatcher will use, built or read from the caller's thread)."""
        if self.stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield
        caller.wait_stream(self.stream)

    def _record(self) -> Optional[torch.cuda.Event]:
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def _bind_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _plan_bytes(self, nbytes: int, compression) -> int:
        """The partition bound to carve with: the planner's for an
        uncompressed tensor, the configured one for a compressed tensor."""
        if compression:
            return self.cfg.partition_bytes
        return self.planner.plan_partition(nbytes)

    def _apply_planned_credit(self) -> None:
        """Install the planner's credit window on the scheduler (nothing
        until a bucket locks, or when the window is pinned)."""
        credit = self.planner.credit_bytes()
        if credit and self.scheduler.credit_bytes != credit:
            self.scheduler.set_credit_bytes(credit)

    # --------------------------------------------------------------- API
    def declare_tensor(self, name: str, shape, dtype: torch.dtype, *,
                       compression: Optional[Dict[str, str]] = None,
                       partition_bytes: Optional[int] = None
                       ) -> TensorContext:
        """Declare a tensor with its geometry: carve its chunks (at the
        planner's size when not given) and build its per-chunk
        compressors and their state now, not at the first push."""
        if compression:
            compression_registry.validate_kwargs(compression)
        if partition_bytes is None:
            nbytes = torch.Size(shape).numel() * dtype.itemsize
            partition_bytes = self._plan_bytes(nbytes, compression)
        ctx = self.registry.init_tensor(name, shape, dtype, partition_bytes,
                                        compression_kwargs=compression)
        self._ensure_compression(ctx)
        return ctx

    def push_pull_async(self, tensor: torch.Tensor, name: str,
                        priority: Optional[int] = None,
                        op: str = "average",
                        compression: Optional[Dict[str, str]] = None
                        ) -> Handle:
        """Enqueue this rank's ``tensor`` for reduction over all ranks.

        The tensor is split into chunks, each an independently scheduled
        task; the handle resolves to the sum (``op="sum"``) or average
        once every chunk has been reduced and the result reassembled.
        The caller must not modify ``tensor`` until the handle resolves.
        """
        return self._push(tensor, name, priority, op, compression)

    def _push(self, tensor: torch.Tensor, name: str, priority, op: str,
              compression, slot: Optional[ShardedUpdateSlot] = None,
              hyperparameters=None) -> Handle:
        if not self._running:
            raise RuntimeError("engine is shut down")
        if tensor.device != self.device:
            raise ValueError(f"push_pull of a tensor on {tensor.device}; "
                             f"the engine runs on {self.device}")
        if op not in ("average", "sum"):
            raise ValueError(f"op must be 'average' or 'sum', got {op!r}")
        est_nbytes = tensor.numel() * tensor.element_size()
        plan_bytes = self._plan_bytes(est_nbytes, compression)
        ctx = self.declare_tensor(name, tensor.shape, tensor.dtype,
                                  compression=compression,
                                  partition_bytes=plan_bytes)
        # the compressor ladder's plan, taken before ctx.lock: a bucket's
        # first plan runs the codecs' golden errors
        want_tuned = None
        if (compression is None and self.planner.compress_active
                and ctx.compression_tuned is not False):
            want_tuned = self.planner.plan_compression(est_nbytes)
        # claim the push (inflight) atomically with the codec and
        # repartition decisions: the codec and the bounds move only while
        # no push holds a claim, and this push's geometry is read after
        # the claim
        with ctx.lock:
            if ctx.compression_tuned is None:
                # decided once: explicit kwargs (this push's or a
                # declare's) pin the tensor; a bare one belongs to the
                # ladder when it is on
                ctx.compression_tuned = (not compression
                                         and not ctx.compression_kwargs
                                         and self.planner.compress_active)
            elif compression and ctx.compression_tuned:
                # explicit kwargs re-pin a ladder-owned tensor: ownership
                # moves now, the codec at the next push with nothing in
                # flight
                ctx.compression_tuned = False
                ctx.compression_pin = dict(compression)
            if ctx.compression_pin is not None and ctx.inflight == 0:
                self.registry.retune_compression_locked(
                    ctx, ctx.compression_pin, self.cfg.partition_bytes)
                ctx.compression_pin = None
            if ctx.compression_tuned and ctx.inflight == 0:
                self.registry.retune_compression_locked(
                    ctx, want_tuned,
                    self.cfg.partition_bytes if want_tuned else plan_bytes)
            if (not ctx.compression_kwargs and ctx.inflight == 0
                    and ctx.partition_bytes != plan_bytes):
                self.registry.repartition_locked(ctx, plan_bytes)
            ctx.inflight += 1
        try:
            # a retune dropped the slots: build them for the new codec
            # (fresh state); this push's claim keeps them in place
            self._ensure_compression(ctx)
            with ctx.lock:
                bounds, keys = list(ctx.chunk_bounds), list(ctx.key_list)
                slots = ctx.compressor
                part_used = ctx.partition_bytes
                codec_used = (ctx.compression_kwargs.get("compressor")
                              or "none") if ctx.compression_kwargs else "none"
                tuned = bool(ctx.compression_tuned)
                scatter = (self._scatter_layout_locked(ctx)
                           if slot is not None else None)
            return self._enqueue(tensor, name, ctx, priority, op, bounds,
                                 keys, slots, est_nbytes, part_used,
                                 codec_used, tuned, slot, scatter,
                                 hyperparameters)
        except BaseException:
            # the done callback never got the claim: release it, or the
            # tensor could never be re-carved again
            with ctx.lock:
                ctx.inflight -= 1
            raise

    def _scatter_layout_locked(self, ctx: TensorContext):
        """A sharded-update tensor's column layout ``(layout, C)`` on the
        scatter accumulator, or None for the parts fallback: chunk bounds
        the ``[L, C]`` view cannot express, or a single chunk under
        BUFFER_MIN_BYTES (the JAX engine's buffer-mode rule).  Computed
        once per chunk geometry; the caller holds ``ctx.lock``."""
        if ctx.scatter_layout is None:
            layout = None
            if (len(ctx.chunk_bounds) > 1
                    or ctx.nbytes >= BUFFER_MIN_BYTES):
                layout = scatter_layout(ctx.chunk_bounds,
                                        self.comm.local_size)
            ctx.scatter_layout = layout or "ineligible"
        if ctx.scatter_layout == "ineligible":
            return None
        return ctx.scatter_layout

    def _enqueue(self, tensor, name, ctx, priority, op, bounds, keys, slots,
                 est_nbytes, part_used, codec_used, tuned, update_slot,
                 scatter, hyperparameters) -> Handle:
        if self.tracer.active:
            # windowed and/or sampled capture, decided here; None for a
            # push that records nothing
            step, tctx = self.tracer.start_push(name)
        else:   # the hot enqueue path stays lock-free with tracing off
            step, tctx = 0, None
        telemetry = self.cfg.telemetry_on
        # the caller's staging until the tasks enter the queue is the
        # step's "enqueue" component
        t_api0 = time.monotonic() if tctx is not None or telemetry else 0.0
        if telemetry:
            self.step_stats.on_push(name, est_nbytes)
        denom = self.comm.size if op == "average" else 1
        scale = None
        if denom != 1 and slots is None and tensor.is_floating_point():
            # fused scale: the collective multiplies by 1/R before the
            # downcast, and assembly is a reshape (on the scatter
            # accumulator the slot applies it to its block)
            scale, denom = 1.0 / denom, 1
        # the planner's samples: wall seconds from enqueue to resolution,
        # for the chunk size until the tensor's size bucket locks, then,
        # for a ladder-owned tensor, for the codec it ran under
        track_plan = slots is None and not self.planner.locked(est_nbytes)
        track_comp = (tuned and self.planner.locked(est_nbytes)
                      and not self.planner.compress_locked(est_nbytes))
        flat = tensor.detach().reshape(-1)
        task_bounds = bounds
        if scatter is not None:
            # chunks are column slabs of the [L, C] view of the padded
            # tensor; credits and wire still count each chunk's real bytes
            task_bounds, C = scatter
            pad = C * self.comm.local_size - flat.numel()
            if pad:
                flat = F.pad(flat, (0, pad))
        ready = None
        if flat.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(flat.device))
            # the engine stream reads it: keep the allocator from reusing
            # its memory before that work is done
            flat.record_stream(self.stream)
        handle = self.handles.allocate(name)
        pending = _PendingTensor(handle, ctx, tuple(tensor.shape), denom,
                                 len(bounds), compressed=slots is not None,
                                 slot=update_slot, scatter=scatter,
                                 scale=scale,
                                 hyperparameters=hyperparameters)
        pending.trace = tctx
        t_enq = time.perf_counter()
        t_queued = time.monotonic()
        if telemetry:
            self.step_stats.add_component("enqueue",
                                          (t_queued - t_api0) * 1e3)
        with self._enq_lock:
            self._enq_seq += 1
            if self.comm.size > 1:
                prio = -self._enq_seq       # enqueue order, see module doc
            elif priority is not None:
                prio = priority
            else:
                prio = -ctx.declared_key if self.cfg.enable_priority else 0
            for i, (off, ln) in enumerate(task_bounds):
                task = ChunkTask(
                    name=name, key=keys[i], priority=prio,
                    offset_elems=off, num_elems=ln,
                    nbytes=bounds[i][1] * tensor.element_size(), data=flat,
                    compression=slots[i] if slots else None,
                    scale=scale, pending=pending, ready=ready,
                    t_enqueue=t_queued, step=step,
                    trace_id=tctx.trace_id if tctx is not None else 0)
                task.callback = self._make_chunk_callback(pending, i)
                self.scheduler.add_task(task)

        def on_done(h: Handle) -> None:
            with ctx.lock:
                ctx.inflight -= 1
            if track_comp and h.status.code == StatusCode.OK:
                self.planner.observe_compression(
                    est_nbytes, codec_used, time.perf_counter() - t_enq)
            if track_plan and h.status.code == StatusCode.OK:
                self.planner.observe(est_nbytes, part_used,
                                     time.perf_counter() - t_enq)
                if self.planner.locked(est_nbytes) and self.tracer.active:
                    # the moment exploration ended, with the winning
                    # chunk size, in the timeline
                    t_now = time.monotonic()
                    self.tracer.record_span(
                        "engine.planner_locked", t_now, t_now, tensor=name,
                        partition_bytes=self.planner.plan_partition(
                            est_nbytes))
                self._apply_planned_credit()
            self.handles.release(h.id)

        handle.add_done_callback(on_done)
        return handle

    def push_pull(self, tensor: torch.Tensor, name: str, **kw):
        """Synchronous push_pull; returns the reduced tensor."""
        return self.push_pull_async(tensor, name, **kw).wait()

    # ---------------------------------------------------- sharded update
    def declare_update(self, name: str, shape, dtype: torch.dtype, *,
                       optimizer, init_value=None,
                       restore=None) -> TensorContext:
        """Declare a tensor whose pull leg is the sharded weight update:
        register its geometry as :meth:`declare_tensor` does, then build
        its owner-resident slot, an f32 master block (seeded from
        ``init_value``, the caller's initial parameters, which must be the
        same on every rank) and the optimizer over it.  ``optimizer`` is
        ``(cls, hyperparameters)``: a ``torch.optim`` class and a param
        group's hyperparameters.  ``restore``: a
        :meth:`ShardedUpdateSlot.export` snapshot, re-padded to this
        world's geometry (how an elastic resume re-shards the optimizer
        state).  Local: issues no collective."""
        if not self.cfg.sharded_update:
            raise ValueError(
                "declare_update requires sharded-update mode: set "
                "BYTEPS_SHARDED_UPDATE=1 or Config(sharded_update=True)")
        if not dtype.is_floating_point:
            raise ValueError(
                f"sharded update needs a float tensor (the optimizer "
                f"runs on the shard), got dtype {dtype}")
        ctx = self.declare_tensor(name, shape, dtype)
        with ctx.lock:
            # the compressor ladder never takes this tensor: its gradient
            # stays on its owner, so there is nothing to compress
            ctx.compression_tuned = False
        with self._caller_to_engine_stream():
            self.update_slots[name] = ShardedUpdateSlot(
                self.comm, self.cfg, name, shape, dtype, optimizer,
                planner=self.planner, init_value=init_value,
                restore=restore)
        return ctx

    def push_pull_update_async(self, tensor: torch.Tensor, name: str, *,
                               op: str = "average", compression=None,
                               hyperparameters=None) -> Handle:
        """Contribute this rank's gradient for ``name`` and receive the
        owner-updated parameters (the declared shape and dtype), which
        the caller ``copy_``s into its parameter.  ``hyperparameters``
        (a param group's lr, betas, ...) are set on the slot's optimizer
        just before its step, so a scheduler's change reaches the step of
        this push.  Requires a prior :meth:`declare_update`."""
        slot = self.update_slots.get(name)
        if slot is None:
            raise ValueError(
                f"{name!r} has no sharded-update slot: call "
                f"declare_update(name, shape, dtype, optimizer=...) first")
        if op != "average":
            raise ValueError(
                "sharded_update supports op='average' only (the 1/R scale "
                "is applied to the shard before the optimizer step)")
        if compression:
            raise ValueError(
                "sharded update does not take gradient compression "
                "kwargs: the gradient never leaves its owner; the pull "
                "leg's codec is a different knob, sharded_param_codec "
                "(BYTEPS_SHARDED_PARAM_CODEC)")
        return self._push(tensor, name, None, op, None, slot=slot,
                          hyperparameters=hyperparameters)

    def push_pull_update(self, tensor: torch.Tensor, name: str, **kw):
        """Synchronous :meth:`push_pull_update_async`."""
        return self.push_pull_update_async(tensor, name, **kw).wait()

    def export_update_slots(self) -> Dict[str, dict]:
        """Host snapshots of every sharded-update slot (suspend):
        logical-length state, which :meth:`declare_update` can restore on
        any world size.  A collective over the node, made with the
        dispatcher parked: every rank calls it, with nothing in flight."""
        if not self.update_slots:
            return {}
        if self.handles.outstanding():
            raise RuntimeError("export_update_slots with pushes in flight: "
                               "wait for them first")
        self.pause_dispatch()
        try:
            with self._caller_to_engine_stream():
                return {name: slot.export()
                        for name, slot in self.update_slots.items()}
        finally:
            self.resume_dispatch()

    def _ensure_compression(self, ctx: TensorContext) -> None:
        """One compressor pair per chunk, built on first use; tensors under
        BYTEPS_MIN_COMPRESS_BYTES drop their compression kwargs."""
        with ctx.lock:
            if ctx.compressor is not None or not ctx.compression_kwargs:
                return
            if ctx.nbytes < self.cfg.min_compress_bytes:
                ctx.compression_kwargs = {}
                return
            slots = []
            with self._on_stream():
                for _, ln in ctx.chunk_bounds:
                    wc = compression_registry.create(
                        ctx.compression_kwargs, ln, ctx.dtype)
                    sc = compression_registry.create(
                        ctx.compression_kwargs, ln, ctx.dtype,
                        for_server=True)
                    slots.append(_CompressionSlot(
                        wc, sc, wc.init_state(self.device),
                        sc.init_state(self.device)))
            ctx.compressor = slots

    def _make_chunk_callback(self, pending: _PendingTensor, part_idx: int):
        def cb(data, status: Status):
            if status.code != StatusCode.OK:
                if pending.fail():
                    pending.handle.set_result(None, status)
                return
            if pending.complete_part(part_idx, data):
                try:
                    with self._on_stream():
                        out = pending.assemble()
                        ready = self._record()
                    pending.handle.set_result(out, Status.ok(), ready)
                except Exception as e:  # noqa: BLE001 — report on the handle
                    _log.exception("assembly of %s failed", pending.ctx.name)
                    pending.handle.set_result(None, Status.error(str(e)))
        return cb

    # ------------------------------------------------------------- pause
    def pause_dispatch(self, timeout: float = 10.0) -> None:
        """Hold the dispatcher: tasks enqueue, but nothing pops until
        :meth:`resume_dispatch`.  For where the merge width must be known
        (tests, the smoke run), since it is otherwise a race between
        enqueue and dispatch.  The gate is cleared, a blocked pop is
        interrupted (the scheduler's one-shot wakeup), and this returns
        once the dispatcher has parked: a pop already under way finishes
        its dispatch first, so after the return nothing pops until
        resume.  No polling on either side."""
        self._dispatch_enabled.clear()
        self.scheduler.interrupt()
        if not self._parked.wait(timeout=timeout) and self._running:
            _log.warning("pause_dispatch: dispatcher did not park within "
                         "%.1fs", timeout)

    def resume_dispatch(self) -> None:
        self._dispatch_enabled.set()

    # ------------------------------------------------------------- loops
    def _dispatch_loop(self):
        self._bind_device()
        while self._running:
            if not self._dispatch_enabled.is_set():
                self._parked.set()
                self._dispatch_enabled.wait()
                self._parked.clear()
                continue
            task = self.scheduler.get_task(block=True)
            if task is None:    # interrupted (pause) or woken (shutdown)
                continue
            # drain bound: the queue depth at the start of the drain, so
            # tasks enqueued while popping wait for the next iteration
            limit = (self.scheduler.pending if self._group_size < 0
                     else self._group_size - 1)
            batch = [task]
            while len(batch) - 1 < limit:
                t2 = self.scheduler.get_task(block=False)
                if t2 is None:
                    break
                batch.append(t2)
            telemetry = self.cfg.telemetry_on
            if telemetry:
                gauges.set("engine.sched_pending", self.scheduler.pending)
                gauges.set("engine.bytes_in_flight",
                           self.scheduler.bytes_in_flight)
            for kind, unit in _plan_batch(batch):
                if telemetry:
                    histograms.observe("engine.dispatch_unit_width",
                                       len(unit))
                    t_d0 = time.perf_counter()
                self._dispatch_unit(kind, unit)
                if telemetry:
                    # the dispatch call's wall: issuing the collective
                    # (and a slot's step) is host work on the critical
                    # path; eager PyTorch has no compile to tell apart
                    attribution.add("dispatch",
                                    (time.perf_counter() - t_d0) * 1e3)
            # a task holds its tensor (a gradient the caller frees at the
            # next step): hold none while blocked in the next pop
            task = t2 = batch = unit = None

    def _dispatch_unit(self, kind: str, unit: List[ChunkTask]) -> None:
        """Issue one unit's collective on the engine stream and hand the
        unit to the syncer: a run is a slice of one tensor, a group one
        buffer of k chunks, a single one chunk (compressed or not)."""
        now = time.monotonic()
        for t in unit:
            t.t_dispatch = now
        self.stats["dispatches"] += 1
        self.stats["chunks"] += len(unit)
        t0 = unit[0]
        rollback = None
        try:
            with self._on_stream():
                # a group spans tensors whose producers recorded different
                # events: wait on each before the first copy-in
                for ev in {id(t.ready): t.ready for t in unit
                           if t.ready is not None}.values():
                    self.stream.wait_event(ev)
                pending = t0.pending
                if kind == "run" and pending.scatter is not None:
                    pending.buf = push_pull_chunk_scatter(
                        self.comm, t0.data, pending.buf, t0.offset_elems,
                        t0.num_elems, len(unit), pending.scatter[1])
                    outs = [None] * len(unit)
                elif kind == "run":
                    n = t0.num_elems
                    x = t0.data[t0.offset_elems:
                                t0.offset_elems + n * len(unit)]
                    outs = push_pull_array(self.comm, x, op="sum",
                                           keep_acc=True,
                                           scale=t0.scale).split(n)
                elif kind == "group":
                    outs = push_pull_arrays_batched(
                        self.comm, [_chunk(t) for t in unit], scale=t0.scale)
                elif t0.compression is not None:
                    slot = t0.compression
                    out, wstate, sstate = fused_compressed_push_pull(
                        self.comm, _chunk(t0), slot.worker, slot.server,
                        slot.wstate, slot.sstate)
                    rollback = (slot, slot.wstate, slot.sstate)
                    slot.wstate, slot.sstate = wstate, sstate
                    outs = [out]
                else:
                    outs = [push_pull_array(self.comm, _chunk(t0), op="sum",
                                            keep_acc=True, scale=t0.scale)]
                if pending is not None and pending.slot is not None:
                    outs = self._advance_slot(pending, unit, outs)
                done = self._record()
            self._sync_q.put((unit, outs, done, rollback, None))
        except Exception as e:  # noqa: BLE001 — report on the handles
            _log.exception("dispatch failed for %s", t0.name)
            _flight.record("engine.dispatch_failed", tensor=t0.name,
                           error=str(e))
            self._restore(rollback)
            if t0.pending is not None and t0.pending.slot is not None:
                t0.pending.dispatch_failed = True
                t0.pending.buf = None
                t0.pending.merged.clear()
            self._sync_q.put((unit, None, None, None, e))

    @staticmethod
    def _advance_slot(pending: _PendingTensor, unit: List[ChunkTask],
                      outs) -> list:
        """After a sharded-update tensor's unit: keep the fallback's
        merged chunks, and once its last chunk is dispatched run the
        slot's step and all-gather here, on the dispatcher and the
        engine stream, behind the tensor's last reduction.  The units
        carry no per-chunk result: assembly returns the slot's."""
        if pending.scatter is None:
            for t, o in zip(unit, outs):
                pending.merged[t.offset_elems] = o
        pending.dispatched += len(unit)
        if pending.dispatched == pending.total:
            if pending.dispatch_failed:
                raise RuntimeError(f"an earlier chunk of {unit[0].name} "
                                   f"failed: the slot does not step")
            slot, hyper = pending.slot, pending.hyperparameters
            if pending.scatter is not None:
                pending.result = slot.apply_buffer(pending.buf,
                                                   pending.scale, hyper)
                pending.buf = None
            else:
                merged = pending.merge([pending.merged[k]
                                        for k in sorted(pending.merged)])
                pending.merged.clear()
                pending.result = slot.apply_full(merged, hyper)
        return [None] * len(unit)

    @staticmethod
    def _restore(rollback) -> None:
        """Put back the compressor state a failed step replaced."""
        if rollback is not None:
            slot, wstate, sstate = rollback
            slot.wstate, slot.sstate = wstate, sstate

    def _sync_loop(self):
        # exits only on the sentinel, which shutdown enqueues after the
        # dispatcher has joined; each wakeup takes every unit already
        # queued and retires them one at a time in dispatch order, so a
        # unit is never held behind a slower one dispatched after it
        self._bind_device()
        shutdown = False
        while not shutdown:
            items = [self._sync_q.get()]
            while True:
                try:
                    items.append(self._sync_q.get_nowait())
                except queue.Empty:
                    break
            # a retired unit's item holds its tasks' tensors and its
            # results: let go of each once retired, and of all before
            # blocking again (a step's worth of gradients and partial
            # buffers would otherwise outlive it)
            items.reverse()
            while items:
                item = items.pop()
                if item is _SHUTDOWN:
                    shutdown = True
                else:
                    self._retire(*item)
                item = None

    def _retire(self, tasks: List[ChunkTask], outs, done, rollback,
                err) -> None:
        """Retire one dispatch unit: one wait, one return of credits, then
        every task's callback (a failed unit fails every task in it)."""
        telemetry = self.cfg.telemetry_on
        if err is None and done is not None:
            t_blk = time.perf_counter()
            try:
                done.synchronize()
            except Exception as e:  # noqa: BLE001 — device fault
                err = e
                self._restore(rollback)
            if telemetry:
                # this thread's time blocked on the card: the step's
                # sync stall (the communication left un-overlapped)
                self.step_stats.add_stall(
                    (time.perf_counter() - t_blk) * 1e3)
        # credits back before the callbacks: the dispatcher can issue the
        # next window while this thread assembles
        self.scheduler.report_finish(sum(t.nbytes for t in tasks))
        head = tasks[0]
        if telemetry:
            if head.t_dispatch:
                histograms.observe(
                    "engine.unit_sync_ms",
                    (time.monotonic() - head.t_dispatch) * 1e3)
                # queue attribution: how long the unit's head chunk sat
                # in the priority queue
                self.step_stats.add_component(
                    "queue", (head.t_dispatch - head.t_enqueue) * 1e3)
            # the last unit retired before a step finalizes names the
            # chain the step waited on
            self.step_stats.note_retire(tasks[-1].name)
        wire = 0
        for t in tasks:
            push = pull = _wire_nbytes(t)
            slot = t.pending.slot if t.pending is not None else None
            buffered = slot is not None and t.pending.scatter is not None
            if slot is not None:
                pull = slot.pull_share(t.nbytes, buffered)
            self.stats["wire_push"] += push
            self.stats["wire_pull"] += pull
            wire += push + pull
            if telemetry:
                counters.inc("wire_bytes", push, leg="push")
                counters.inc("wire_bytes", pull, leg="pull")
                self.step_stats.add_wire(push + pull)
                if err is None and buffered and slot.codec is not None:
                    # the quantized parameter leg, apart from the
                    # gradient codecs' compression.wire_bytes
                    counters.inc("compression.param_wire_bytes", pull)
                if err is None and t.compression is not None:
                    counters.inc("compression.wire_bytes", push)
                    counters.inc("compression.bytes_saved",
                                 max(0, t.nbytes - push))
                    counters.inc("compression.compressed_chunks")
            if t.trace_id and self.tracer.active:
                self._trace_chunk(t)
        self.speed.record(wire)
        t_cb0 = time.perf_counter()
        for i, task in enumerate(tasks):
            if err is not None:
                task.callback(None, Status.error(str(err)))
            else:
                task.callback(outs[i], Status.ok())
        if telemetry:
            # assembly and the callbacks: the tail of a push's path
            self.step_stats.add_component(
                "assemble", (time.perf_counter() - t_cb0) * 1e3)

    def _trace_chunk(self, task: ChunkTask) -> None:
        """A captured chunk's two spans, ``queued`` and ``push_pull``,
        against its trace id (not window-gated: the capture was decided
        at enqueue), and the push's flow arc: ``s`` in the first retired
        chunk's queued span, ``f`` at the last chunk's retirement.  Only
        the syncer runs this, so the pending's bookkeeping needs no
        lock."""
        t_done = time.monotonic()
        t_disp = task.t_dispatch or t_done
        self.tracer.record_traced(task.trace_id, "queued", task.name,
                                  task.t_enqueue, t_disp, key=task.key,
                                  step=task.step, bytes=task.nbytes)
        if task.t_dispatch:
            self.tracer.record_traced(task.trace_id, "push_pull", task.name,
                                      t_disp, t_done, key=task.key,
                                      step=task.step, bytes=task.nbytes)
        p = task.pending
        if p is not None and p.trace is not None:
            if not p.trace_started:
                self.tracer.flow(task.trace_id, "s", task.name,
                                 task.t_enqueue)
                p.trace_started = True
            p.trace_left -= 1
            if p.trace_left == 0:
                self.tracer.flow(task.trace_id, "f", task.name, t_done)

    # --------------------------------------------------------- lifecycle
    def drain(self) -> None:
        """Wait, within _DRAIN_BUDGET_S in all, for the outstanding
        handles (their errors are the callers' to read)."""
        deadline = time.monotonic() + _DRAIN_BUDGET_S
        for h in self.handles.outstanding():
            try:
                h.wait(timeout=max(0.1, deadline - time.monotonic()))
            except Exception:  # noqa: BLE001 — draining, not consuming
                pass

    def shutdown(self, wait: bool = True):
        """Drain outstanding handles (``wait``), stop both threads, and fail
        whatever never reached dispatch."""
        if wait:
            self.drain()
        self._running = False
        # wake a dispatcher blocked in the pop or parked on the pause gate
        self._dispatch_enabled.set()
        self.scheduler.wake()
        self._dispatcher.join(timeout=10)
        self._sync_q.put(_SHUTDOWN)
        self._syncer.join(timeout=10)
        for task in self.scheduler.drain():
            task.callback(None, Status(StatusCode.ABORTED,
                                       "engine shut down"))
        self.handles.clear()
        # the tail of a normal exit: the in-progress step's stats, the
        # trace, and the exit dump when BYTEPS_FLIGHT_DUMP_ON_EXIT asks
        self.step_stats.flush()
        self.tracer.flush()
        _flight.record("engine.shutdown",
                       dispatches=self.stats["dispatches"],
                       chunks=self.stats["chunks"])
        _flight.maybe_exit_dump()
