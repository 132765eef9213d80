"""Host-to-device input pipeline: background prefetch, double buffered;
port of ``byteps_tpu/utils/prefetch.py``.

A training loop that copies each batch to the card inline serializes the
copy with the step it feeds.  This module overlaps them:

- :func:`prefetch_to_device` wraps any iterator of host batches (nested
  dicts, lists and tuples of tensors or numpy arrays): a background
  thread stages the next ``size`` batches on the device while the
  current step runs.  On the card each tensor is copied into pinned host
  memory and from there with ``non_blocking=True`` on a side CUDA
  stream; an event recorded after the copies is waited on by the
  consumer's stream when the batch is handed over, and every staged
  tensor is marked with ``record_stream`` for the consumer's stream, so
  the caching allocator does not reuse its memory while the step may
  still read it.  On the CPU the batch is converted to tensors.
- :class:`ShardedBatchLoader` yields this rank's rows of each global
  batch (``utils/tree.py`` ``local_rows``), prefetched onto
  ``comm.device``, ready for the fused step.

As in the JAX module: the producer's put is bounded and polls a stop
flag, so a consumer that leaves early releases it; an error of the
source is raised at the consumer; the loader checks up front that every
batch keeps the first one's shapes, and refuses a second pass over a
one-shot iterator that is already spent.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import torch

from .tree import local_rows, tree_leaves, tree_map

__all__ = ["prefetch_to_device", "ShardedBatchLoader"]

_END = object()


def _stage(batch, device: torch.device, stream):
    """``batch`` on ``device``: on the card through pinned host memory
    and non-blocking copies on ``stream``; returns (staged, event)."""
    if device.type != "cuda":
        return tree_map(lambda x: torch.as_tensor(x).to(device), batch), None
    with torch.cuda.stream(stream):
        staged = tree_map(
            lambda x: torch.as_tensor(x).pin_memory().to(
                device, non_blocking=True), batch)
        ev = torch.cuda.Event()
        ev.record(stream)
    return staged, ev


def _hand_over(staged, ev):
    """Order the consumer's stream after the copies and tie each staged
    tensor's memory to it."""
    if ev is None:
        return staged
    consumer = torch.cuda.current_stream(ev.device)
    consumer.wait_event(ev)
    for t in tree_leaves(staged):
        t.record_stream(consumer)
    return staged


def prefetch_to_device(iterator: Iterable, size: int = 2, device="cuda",
                       device_put: Optional[Callable] = None) -> Iterator:
    """Yield the batches of ``iterator`` staged on ``device`` ahead of
    use.

    ``size`` is the number of batches in flight (2: double buffering).
    ``device_put`` replaces the transfer entirely (the staged batch is
    then handed over as it is returned).  Errors of the source are raised
    at the consumer."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device_put is not None:
        def put(b):
            return device_put(b), None
    else:
        stream = (torch.cuda.Stream(device) if device.type == "cuda"
                  else None)

        def put(b):
            return _stage(b, device, stream)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def offer(item) -> bool:
        # bounded put + stop poll: a consumer that leaves its loop must
        # not leave this thread parked in q.put, pinning staged batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        try:
            for batch in iterator:
                if not offer(put(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 - raised at the consumer
            offer((_END, e))
            return
        offer((_END, None))

    t = threading.Thread(target=producer, name="bps-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item[0] is _END:
                if item[1] is not None:
                    raise item[1]
                return
            yield _hand_over(*item)
    finally:
        # an early exit (break, GeneratorExit): release the producer and
        # drop the staged batches so their memory frees
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


class ShardedBatchLoader:
    """Global host batches -> this rank's rows on ``comm.device``,
    prefetched.

    ``source`` yields batches (nested dicts, lists and tuples of tensors
    or numpy arrays) whose leading axis divides by the world size;
    iterating the loader yields this rank's rows of each, the layout
    ``make_dp_train_step`` consumes."""

    def __init__(self, comm, source: Iterable, prefetch: int = 2):
        self.comm = comm
        self.source = source
        self.prefetch = prefetch
        self._shapes = None
        self._consumed = False

    def _check(self, batch):
        shapes = tree_map(lambda x: tuple(getattr(x, "shape", ())), batch)
        if self._shapes is None:
            self._shapes = shapes
            ranks = self.comm.size
            for leaf in tree_leaves(batch):
                if leaf.shape[0] % ranks:
                    raise ValueError(
                        f"batch axis {leaf.shape[0]} not divisible by "
                        f"{ranks} ranks")
        elif shapes != self._shapes:
            raise ValueError(
                f"batch shapes changed mid-stream: first {self._shapes}, "
                f"now {shapes}")
        return batch

    def __iter__(self):
        it = iter(self.source)
        if it is self.source and self._consumed:
            # a generator or iterator source is one-shot: a second epoch
            # would yield nothing without a word
            raise ValueError(
                "ShardedBatchLoader source is a one-shot iterator that "
                "was already consumed; pass a re-iterable (e.g. a list "
                "or a Dataset object) for multi-epoch iteration")
        self._consumed = True
        rows = (local_rows(self.comm, self._check(b)) for b in it)
        return prefetch_to_device(rows, size=self.prefetch,
                                  device=self.comm.device)
