"""Handles: the async completion surface of push_pull; port of
``byteps_tpu/common/handles.py``.

A handle resolves when every chunk of its tensor has retired and the
result is assembled.  On the card the result was written on the engine's
stream: :meth:`Handle.wait` makes the caller's current stream wait on the
event recorded after assembly, and marks the result as used on that
stream so the caching allocator does not hand its memory to the engine
while the caller's kernels may still read it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import torch

from .host import tensor_to_host
from .types import Status


class Handle:
    """One outstanding push_pull: result future."""

    def __init__(self, handle_id: int, name: str):
        self.id = handle_id
        self.name = name
        self._done = threading.Event()
        self._status: Optional[Status] = None
        self._result: Any = None
        self._ready = None            # CUDA event after assembly, or None
        self._on_done: List[Callable[["Handle"], None]] = []
        self._lock = threading.Lock()

    # engine side ----------------------------------------------------------
    def set_result(self, result: Any, status: Status = None,
                   ready=None) -> None:
        """Resolve the handle.  The done callbacks run first, so a waiter
        wakes to the engine's bookkeeping (the planner's sample, the
        tensor's in-flight count) already done."""
        with self._lock:
            self._result = result
            self._ready = ready
            self._status = status or Status.ok()
            callbacks, self._on_done = self._on_done, []
        try:
            for cb in callbacks:
                cb(self)
        finally:
            self._done.set()

    def add_done_callback(self, cb: Callable[["Handle"], None]) -> None:
        with self._lock:
            if self._status is None:
                self._on_done.append(cb)
                return
        cb(self)

    # user side ------------------------------------------------------------
    @property
    def status(self) -> Optional[Status]:
        """The outcome once resolved, else None."""
        return self._status

    def poll(self) -> bool:
        """True once the result is assembled (its device work may still be
        queued; :meth:`wait` orders the caller's stream after it)."""
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Block until complete and return the reduced tensor."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(f"push_pull handle {self.id} ({self.name}) "
                               f"timed out")
        self._status.ok_or_raise()
        out = self._result
        if self._ready is not None and isinstance(out, torch.Tensor):
            stream = torch.cuda.current_stream(out.device)
            stream.wait_event(self._ready)
            out.record_stream(stream)
        return out


class HandleManager:
    """Allocates handles and tracks outstanding ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._live: Dict[int, Handle] = {}

    def allocate(self, name: str) -> Handle:
        with self._lock:
            h = Handle(self._next, name)
            self._next += 1
            self._live[h.id] = h
            return h

    def get(self, handle_id: int) -> Optional[Handle]:
        with self._lock:
            return self._live.get(handle_id)

    def release(self, handle_id: int) -> None:
        with self._lock:
            self._live.pop(handle_id, None)

    def outstanding(self) -> List[Handle]:
        with self._lock:
            return [h for h in self._live.values() if not h.poll()]

    def clear(self) -> None:
        with self._lock:
            self._live.clear()


class HostHandle:
    """The handle of a host-array push (``push_pull_local_async``): the
    engine's handle, whose :meth:`wait` returns a numpy array of the
    input's shape and dtype."""

    def __init__(self, inner: Handle, shape, dtype):
        self._inner = inner
        self._shape = tuple(shape)
        self._dtype = dtype

    @property
    def id(self) -> int:
        return self._inner.id

    @property
    def name(self) -> str:
        return self._inner.name

    @property
    def status(self) -> Optional[Status]:
        return self._inner.status

    def poll(self) -> bool:
        return self._inner.poll()

    def wait(self, timeout: Optional[float] = None):
        return tensor_to_host(self._inner.wait(timeout=timeout),
                              self._shape, self._dtype)
