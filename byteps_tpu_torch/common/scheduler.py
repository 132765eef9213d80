"""Priority + credit chunk scheduler; port of ``ChunkScheduler`` in
``byteps_tpu/common/scheduler.py``.

Tasks pop by priority descending, then key ascending, and a byte budget
of in-flight work (the credit window, BYTEPS_SCHEDULING_CREDIT) bounds how
far the dispatcher runs ahead of retirement.  The auto-tuning
``ChunkPlanner`` and the native C++ scheduler are not ported yet.
"""

from __future__ import annotations

import heapq
import threading
from typing import List, Optional

from .types import ChunkTask


class ChunkScheduler:
    """Thread-safe priority queue with a bytes-in-flight credit window."""

    def __init__(self, credit_bytes: int = 0):
        # 0 = unlimited window
        self._credit_limit = int(credit_bytes)
        self._in_flight = 0
        self._heap: List[tuple] = []
        self._seq = 0
        self._cv = threading.Condition(threading.RLock())
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
        A blocking call returns None when woken by :meth:`wake`."""
        with self._cv:
            if block:
                self._cv.wait_for(
                    lambda: self._eligible_locked() or self._shutdown,
                    timeout=timeout)
            if not self._eligible_locked():
                return None
            _, _, task = heapq.heappop(self._heap)
            self._in_flight += task.nbytes
            return task

    def wake(self) -> None:
        """Latched wakeup: every blocked and future get_task returns."""
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def report_finish(self, nbytes: int) -> None:
        """Return credits of retired work."""
        with self._cv:
            self._in_flight = max(0, self._in_flight - nbytes)
            self._cv.notify()

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
