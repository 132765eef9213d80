"""Root-ordered dispatch: the engine's issue order at more than one rank.

The ranks of a process group must issue the same collectives in the same
order, and the moment a chunk becomes eligible differs between ranks.
The original BytePS pins the followers to the root's order
(``communicator.h:43``, its ``DO_*`` signals); so does the port:

- **the root** (rank 0) pops by priority, under its own credit window,
  exactly as at one rank (:class:`LeaderOrder` around the Python or the
  native scheduler).  Each time it pops it takes every task that is
  eligible at that moment and sends their ``(name, part, stale)`` entries
  to the followers in ONE message, so a step costs a handful of messages,
  not one per chunk; ``stale`` is its membership-epoch verdict, which
  every rank then applies;
- **a follower** (:class:`FollowerOrder`, in place of the scheduler)
  keeps its enqueued tasks in a map by ``(name, part)`` and hands the
  dispatcher the announced tasks in the announced order and in no other.
  If it has not yet enqueued the head of the order, it waits for it (its
  own autograd thread keeps enqueueing meanwhile); the time is
  ``order_wait_ms`` in the engine's ``stats``, the messages
  ``order_msgs``.  Its own priorities and credit window are not read.

Two pushes of one name in flight at once are told apart by enqueue
order: the root pops equal ``(priority, key)`` tasks first-in first-out,
and a follower takes the earliest task of a name and part.

The control channel never touches the data group and opens no port:
each engine takes a client of its own to the process group's store (the
TCPStore of the ``tcp://`` rendezvous, on rank 0), under a prefix of its
own (every rank starts its engines in the same order).  The root writes
announcement ``n`` once, under ``n`` (a JSON list), whatever the number
of followers; each follower's receiver waits for it, reads it and adds
one to ``ack/n``, and the last of them deletes both keys.  ``end`` under
the next key ends every stream (the root's shutdown).  A follower that
shuts down first claims the next key itself with ``end:<rank>``, from a
second client, so neither side's shutdown waits on the other; the claim
is never deleted, the other followers pass over it and the root writes
its announcement under the key after.  Every write is a ``compare_set``
on an empty key, so a key holds one value only.

``stats`` counts, besides ``order_msgs``: ``order_send_ms``, the root's
time writing its announcements; ``order_wait_ms``, a follower's wait for
an announced chunk it has not enqueued yet; and ``order_lag_ms``, a
follower's wait for an announcement while it holds enqueued chunks (the
root's lateness and the channel's latency).  A follower's wait with
nothing enqueued and nothing announced is idle time and not counted.
"""

from __future__ import annotations

import collections
import datetime
import itertools
import json
import threading
import time
from typing import Callable, Dict, Optional

import torch.distributed as dist

from ..common.logging import get_logger

_log = get_logger()

_PREFIX = "bps_root_order"
# engines opened in this process: each engine's channel has a prefix of
# its own, and every rank opens its engines in the same order
_opened = itertools.count()
_END = b"end"
_STORE_TIMEOUT = datetime.timedelta(seconds=300)
# a receiver's wait for the next announcement, renewed while it lasts (a
# wait that times out logs a warning of the store's)
_WAIT = datetime.timedelta(seconds=600)


# the counters of an engine's ``stats`` that the root order keeps: the
# root's are the first two, a follower's the first and the last two
ORDER_STATS = ("order_msgs", "order_send_ms", "order_wait_ms",
               "order_lag_ms")


def order_stats(stats: dict) -> dict:
    """The root order's counters of an engine's ``stats``, rounded."""
    return {k: round(stats[k], 3) for k in ORDER_STATS}


def worst_of(rows) -> dict:
    """Each counter's largest value over the ranks' :func:`order_stats`:
    the root's messages and send time, the slowest follower's waits."""
    return {k: max(r[k] for r in rows) for k in ORDER_STATS}


def _end_of(rank: int) -> bytes:
    """The key a follower that shuts down first claims."""
    return b"end:%d" % rank


def _entry(task) -> tuple:
    """The name a task goes by on every rank: its tensor and part."""
    return task.name, task.key & 0xFFFF


def store_client(coordinator_address: str, prefix: str):
    """A client of its own to the store at ``host:port``, under
    ``prefix``."""
    host, port = coordinator_address.rsplit(":", 1)
    client = dist.TCPStore(host, int(port), is_master=False,
                           timeout=_STORE_TIMEOUT)
    return dist.PrefixStore(prefix, client)


class LeaderOrder:
    """The root's scheduler: the inner priority queue, plus the
    announcement of every batch it pops, written once to ``store`` for
    every follower.  ``verdict(task)`` is the root's membership-epoch verdict
    on a popped task (True: stale)."""

    def __init__(self, inner, store, stats: dict,
                 verdict: Callable[[object], bool]):
        self._inner = inner
        self._store = store
        self._stats = stats
        self._verdict = verdict
        self._ready: collections.deque = collections.deque()
        self._next = 0

    def add_task(self, task) -> None:
        self._inner.add_task(task)

    def get_task(self, block: bool = False,
                 timeout: Optional[float] = None):
        if self._ready:
            return self._ready.popleft()
        task = self._inner.get_task(block=block, timeout=timeout)
        if task is None:
            return None
        batch = [task]
        while True:
            t2 = self._inner.get_task(block=False)
            if t2 is None:
                break
            batch.append(t2)
        entries = []
        for t in batch:
            t.order_stale = bool(self._verdict(t))
            entries.append((*_entry(t), t.order_stale))
        self._send(json.dumps(entries, separators=(",", ":")).encode())
        self._stats["order_msgs"] += 1
        self._ready.extend(batch[1:])
        return task

    def _send(self, body: bytes) -> None:
        """Write ``body`` once under the next key no follower claimed."""
        t0 = time.perf_counter()
        while True:
            key = str(self._next)
            self._next += 1
            if self._store.compare_set(key, "", body) == body:
                break
        self._stats["order_send_ms"] += (time.perf_counter() - t0) * 1e3

    def interrupt(self) -> None:
        self._inner.interrupt()

    def wake(self) -> None:
        self._inner.wake()

    def set_credit_bytes(self, credit_bytes: int) -> None:
        self._inner.set_credit_bytes(credit_bytes)

    @property
    def credit_bytes(self) -> int:
        return self._inner.credit_bytes

    def report_finish(self, nbytes: int) -> None:
        self._inner.report_finish(nbytes)

    @property
    def pending(self) -> int:
        return self._inner.pending + len(self._ready)

    @property
    def bytes_in_flight(self) -> int:
        return self._inner.bytes_in_flight

    def drain(self) -> list:
        out = list(self._ready)
        self._ready.clear()
        return out + self._inner.drain()

    def close(self) -> None:
        """End every follower's stream."""
        try:
            self._send(_END)
        except dist.DistError as e:
            _log.warning("root order: could not end the followers' "
                         "streams (%s)", e)


class FollowerOrder:
    """A follower's scheduler: its enqueued tasks by ``(name, part)``,
    handed out in the order the root announces.  A receiver thread reads
    the announcements from ``store``, the last of ``followers`` readers
    of each deleting it; ``waker()`` makes the second client that ends
    the stream at shutdown."""

    def __init__(self, store, rank: int, followers: int, stats: dict,
                 waker: Callable[[], object]):
        self._store = store
        self._rank = rank
        self._followers = followers
        self._stats = stats
        self._waker = waker
        self._next = 0
        self._cv = threading.Condition()
        self._local: Dict[tuple, collections.deque] = {}
        self._n_local = 0
        self._announced: collections.deque = collections.deque()
        self._in_flight = 0
        self._credit = 0
        self._interrupts = 0
        self._shutdown = False
        self._closed = False
        self._rx = threading.Thread(target=self._recv_loop,
                                    name="bps-root-order", daemon=True)
        self._rx.start()

    def _recv_loop(self) -> None:
        mine = _end_of(self._rank)
        while True:
            key = str(self._next)
            try:
                self._store.wait([key], _WAIT)
                body = self._store.get(key)
                # a follower's end claim stays, so the root never writes
                # under its key; the last reader drops any other
                if not body.startswith(b"end:") and self._store.add(
                        f"ack/{key}", 1) == self._followers:
                    self._store.delete_key(key)
                    self._store.delete_key(f"ack/{key}")
            except dist.DistStoreError:
                continue            # the wait's renewal
            except dist.DistError as e:
                if not self._closed:
                    _log.error("root order: the store is gone (%s)", e)
                return
            if body in (_END, mine):
                return
            self._next += 1
            if body.startswith(b"end:"):
                continue            # another follower's shutdown
            self.announce(json.loads(body))
            self._stats["order_msgs"] += 1

    def announce(self, entries) -> None:
        """Queue the root's ``(name, part, stale)`` entries, in order."""
        with self._cv:
            self._announced.extend(((n, p), bool(s)) for n, p, s in entries)
            self._cv.notify_all()

    def add_task(self, task) -> None:
        with self._cv:
            self._local.setdefault(_entry(task),
                                   collections.deque()).append(task)
            self._n_local += 1
            self._cv.notify_all()

    def _ready_locked(self) -> bool:
        return bool(self._announced) and bool(
            self._local.get(self._announced[0][0]))

    def get_task(self, block: bool = False,
                 timeout: Optional[float] = None):
        """The next task of the root's order, once this rank has it.  A
        blocking call returns None when woken by :meth:`interrupt` (once)
        or :meth:`wake` (for good), as the scheduler's does."""
        with self._cv:
            if block:
                end = None if timeout is None else time.monotonic() + timeout
                while not (self._ready_locked() or self._shutdown
                           or self._interrupts > 0):
                    left = None if end is None else end - time.monotonic()
                    if left is not None and left <= 0:
                        break
                    # the head of the order was announced and this rank
                    # has not enqueued it (order_wait_ms), or this rank
                    # holds chunks the root has not announced yet
                    # (order_lag_ms); else it is idle
                    counter = ("order_wait_ms" if self._announced
                               else "order_lag_ms" if self._n_local
                               else None)
                    t0 = time.monotonic()
                    self._cv.wait(left)
                    if counter is not None:
                        self._stats[counter] += (
                            time.monotonic() - t0) * 1e3
                if self._interrupts > 0:
                    self._interrupts -= 1
            if not self._ready_locked():
                return None
            entry, stale = self._announced.popleft()
            q = self._local[entry]
            task = q.popleft()
            if not q:
                del self._local[entry]
            self._n_local -= 1
            task.order_stale = stale
            self._in_flight += task.nbytes
            return task

    def interrupt(self) -> None:
        with self._cv:
            self._interrupts += 1
            self._cv.notify_all()

    def wake(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def set_credit_bytes(self, credit_bytes: int) -> None:
        # only the root's window gates a decision
        self._credit = int(credit_bytes)

    @property
    def credit_bytes(self) -> int:
        return self._credit

    def report_finish(self, nbytes: int) -> None:
        with self._cv:
            self._in_flight = max(0, self._in_flight - nbytes)

    @property
    def pending(self) -> int:
        with self._cv:
            return self._n_local

    @property
    def bytes_in_flight(self) -> int:
        with self._cv:
            return self._in_flight

    def drain(self) -> list:
        """Every task not yet handed out, in enqueue order."""
        with self._cv:
            tasks = sorted((t for q in self._local.values() for t in q),
                           key=lambda t: t.t_enqueue)
            self._local.clear()
            self._n_local = 0
            self._announced.clear()
            return tasks

    def close(self) -> None:
        """Stop the receiver: claim the key it waits for with this
        rank's end, from a client of its own (the receiver's is held by
        its wait), until it has stopped."""
        self._closed = True
        if not self._rx.is_alive():
            return
        try:
            waker = self._waker()
            end = time.monotonic() + 10.0
            while self._rx.is_alive() and time.monotonic() < end:
                # only where the root has written nothing yet
                waker.compare_set(str(self._next), "", _end_of(self._rank))
                self._rx.join(0.05)
        except dist.DistError as e:
            # the store is gone: the receiver's wait fails by itself
            _log.debug("root order: no second client (%s)", e)


def open_order(comm, inner_factory, stats: dict,
               verdict: Callable[[object], bool]):
    """This rank's scheduler under the root's order: a
    :class:`LeaderOrder` around ``inner_factory()`` on rank 0, a
    :class:`FollowerOrder` elsewhere, each on a client of its own to the
    group's rendezvous store (``comm.rendezvous``).  Every rank of the
    group calls it once, when its engine starts."""
    if not comm.rendezvous:
        raise ValueError("root-ordered dispatch needs the group's "
                         "rendezvous address (CommContext.rendezvous)")
    coordinator_address = comm.rendezvous
    prefix = f"{_PREFIX}/{next(_opened)}/"
    store = store_client(coordinator_address, prefix)
    if comm.rank == 0:
        return LeaderOrder(inner_factory(), store, stats, verdict)
    return FollowerOrder(store, comm.rank, comm.size - 1, stats,
                         lambda: store_client(coordinator_address, prefix))
