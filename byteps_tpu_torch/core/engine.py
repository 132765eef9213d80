"""The push_pull engine: partition -> schedule -> chunk collective ->
retire -> assemble; port of ``PushPullEngine`` in
``byteps_tpu/core/engine.py``.

Two threads, as in the JAX package:

- the **dispatcher** pops chunk tasks from the priority scheduler (credit
  window permitting) and issues each chunk's collective, compressed or
  not, on the engine's own CUDA stream.  That stream first waits on an
  event the caller recorded at enqueue, so a gradient produced on
  autograd's stream is complete before the engine reads it;
- the **syncer** waits on the CUDA event recorded after each chunk,
  returns the chunk's scheduling credits, and assembles the tensor when
  its last chunk lands.  Assembly divides by R (an average) before any
  downcast, then hands the result to the handle together with an event
  the caller's stream waits on.

On the CPU (gloo) the collectives are synchronous and no events exist.

Dispatch order is the priority mechanism on one rank.  Collectives of a
process group must be issued in the same order on every rank, and the
moment a task becomes eligible differs between ranks, so with more than
one rank the engine dispatches in enqueue order (hook order, which is
the same on every rank) instead of by priority.

Not ported: AOT program warming, chunk-group batching, the auto-tuned
planner and compressor ladder, sharded update, membership epochs,
tracing and telemetry.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from typing import Any, Dict, Optional

import torch

from ..comm.collectives import push_pull_array
from ..comm.compressed import fused_compressed_push_pull
from ..comm.mesh import CommContext
from ..common.config import Config
from ..common.handles import Handle, HandleManager
from ..common.registry import TensorRegistry
from ..common.scheduler import ChunkScheduler
from ..common.types import ChunkTask, Status, StatusCode, TensorContext
from ..compression import registry as compression_registry

_log = logging.getLogger("byteps_tpu_torch")

_SHUTDOWN = object()  # sync-queue sentinel
_DRAIN_BUDGET_S = 60.0  # shutdown waits this long, in all, for handles


class _CompressionSlot:
    """Per-chunk compressor pair and its state (updated in place by the
    dispatcher, in dispatch order, on the engine stream)."""

    __slots__ = ("worker", "server", "wstate", "sstate")

    def __init__(self, worker, server, wstate, sstate):
        self.worker = worker
        self.server = server
        self.wstate = wstate
        self.sstate = sstate


class _PendingTensor:
    """Collects the finished chunks of one push_pull."""

    def __init__(self, handle: Handle, ctx: TensorContext, out_shape,
                 denom: int):
        self.handle = handle
        self.ctx = ctx
        self.out_shape = out_shape
        self.denom = denom        # divisor applied at assembly (1 = none)
        self.parts: Dict[int, Any] = {}
        self.total = len(ctx.chunk_bounds)
        self.lock = threading.Lock()

    def complete_part(self, part_idx: int, data) -> bool:
        with self.lock:
            self.parts[part_idx] = data
            return len(self.parts) == self.total

    def assemble(self) -> torch.Tensor:
        if self.total == 1:
            flat = self.parts[0]
        else:
            flat = torch.cat([self.parts[i] for i in range(self.total)])
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
        self.scheduler = ChunkScheduler(credit_bytes=cfg.scheduling_credit)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)
        self._sync_q: "queue.Queue" = queue.Queue()
        self._enq_lock = threading.Lock()
        self._enq_seq = 0
        self._running = True
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="bps-dispatch", daemon=True)
        self._syncer = threading.Thread(
            target=self._sync_loop, name="bps-sync", daemon=True)
        self._dispatcher.start()
        self._syncer.start()

    # ----------------------------------------------------------- helpers
    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _record(self) -> Optional[torch.cuda.Event]:
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def _bind_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # --------------------------------------------------------------- API
    def declare_tensor(self, name: str, shape, dtype: torch.dtype, *,
                       compression: Optional[Dict[str, str]] = None
                       ) -> TensorContext:
        """Declare a tensor with its geometry: carve its chunks and build
        its per-chunk compressors and their state now, not at the first
        push."""
        if compression:
            compression_registry.validate_kwargs(compression)
        ctx = self.registry.init_tensor(name, shape, dtype,
                                        self.cfg.partition_bytes,
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
        if not self._running:
            raise RuntimeError("engine is shut down")
        if tensor.device != self.device:
            raise ValueError(f"push_pull of a tensor on {tensor.device}; "
                             f"the engine runs on {self.device}")
        if op not in ("average", "sum"):
            raise ValueError(f"op must be 'average' or 'sum', got {op!r}")
        ctx = self.declare_tensor(name, tensor.shape, tensor.dtype,
                                  compression=compression)
        denom = self.comm.size if op == "average" else 1
        scale = None
        if denom != 1 and ctx.compressor is None and tensor.is_floating_point():
            # fused scale: the collective multiplies by 1/R before the
            # downcast, and assembly is a reshape
            scale, denom = 1.0 / denom, 1
        flat = tensor.detach().reshape(-1)
        ready = None
        if flat.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(flat.device))
            # the engine stream reads it: keep the allocator from reusing
            # its memory before that work is done
            flat.record_stream(self.stream)
        handle = self.handles.allocate(name)
        pending = _PendingTensor(handle, ctx, tuple(tensor.shape), denom)
        with self._enq_lock:
            self._enq_seq += 1
            if self.comm.size > 1:
                prio = -self._enq_seq       # enqueue order, see module doc
            elif priority is not None:
                prio = priority
            else:
                prio = -ctx.declared_key if self.cfg.enable_priority else 0
            for i, (off, ln) in enumerate(ctx.chunk_bounds):
                task = ChunkTask(
                    name=name, key=ctx.key_list[i], priority=prio,
                    offset_elems=off, num_elems=ln,
                    nbytes=ln * tensor.element_size(), data=flat,
                    compression=ctx.compressor[i] if ctx.compressor else None,
                    scale=scale, pending=pending, ready=ready)
                task.callback = self._make_chunk_callback(pending, i)
                self.scheduler.add_task(task)
        handle.add_done_callback(lambda h: self.handles.release(h.id))
        return handle

    def push_pull(self, tensor: torch.Tensor, name: str, **kw):
        """Synchronous push_pull; returns the reduced tensor."""
        return self.push_pull_async(tensor, name, **kw).wait()

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

    # ------------------------------------------------------------- loops
    def _dispatch_loop(self):
        self._bind_device()
        while self._running:
            task = self.scheduler.get_task(block=True)
            if task is not None:
                self._dispatch(task)

    def _dispatch(self, task: ChunkTask):
        try:
            with self._on_stream():
                if task.ready is not None:
                    self.stream.wait_event(task.ready)
                x = task.data[task.offset_elems:
                              task.offset_elems + task.num_elems]
                slot = task.compression
                if slot is not None:
                    out = fused_compressed_push_pull(
                        self.comm, x, slot.worker, slot.server,
                        slot.wstate, slot.sstate)
                else:
                    out = push_pull_array(self.comm, x, op="sum",
                                          keep_acc=True, scale=task.scale)
                done = self._record()
            self._sync_q.put((task, out, done, None))
        except Exception as e:  # noqa: BLE001 — report on the handle
            _log.exception("dispatch failed for %s", task.name)
            self._sync_q.put((task, None, None, e))

    def _sync_loop(self):
        # exits only on the sentinel, which shutdown enqueues after the
        # dispatcher has joined
        self._bind_device()
        while True:
            item = self._sync_q.get()
            if item is _SHUTDOWN:
                return
            task, out, done, err = item
            if err is None and done is not None:
                try:
                    done.synchronize()
                except Exception as e:  # noqa: BLE001 — device fault
                    err = e
            self.scheduler.report_finish(task.nbytes)
            if err is not None:
                task.callback(None, Status.error(str(err)))
            else:
                task.callback(out, Status.ok())

    # --------------------------------------------------------- lifecycle
    def shutdown(self, wait: bool = True):
        """Drain outstanding handles (``wait``), stop both threads, and fail
        whatever never reached dispatch."""
        if wait:
            deadline = time.monotonic() + _DRAIN_BUDGET_S
            for h in self.handles.outstanding():
                try:
                    h.wait(timeout=max(0.1, deadline - time.monotonic()))
                except Exception:  # noqa: BLE001 — draining, not consuming
                    pass
        self._running = False
        self.scheduler.wake()
        self._dispatcher.join(timeout=10)
        self._sync_q.put(_SHUTDOWN)
        self._syncer.join(timeout=10)
        for task in self.scheduler.drain():
            task.callback(None, Status(StatusCode.ABORTED,
                                       "engine shut down"))
        self.handles.clear()
