"""Opt-in runtime lock-order witness (FreeBSD WITNESS style); port of
``byteps_tpu/common/lock_witness.py``, whole.

A **named-lock wrapper** records, per thread, the order in which lock
*classes* are acquired, folds every observed ordering into one
process-wide lock graph, and raises :class:`LockOrderError` the moment
an acquisition would close a cycle: the AB/BA deadlock is reported at
the second acquire, with both witnessed code sites named, instead of
wedging two threads forever.

Opt-in: ``BYTEPS_LOCK_WITNESS=1`` (``Config.lock_witness``).  When the
flag is off, :func:`named_lock` returns a plain ``threading.Lock`` /
``RLock``: no wrapper and no overhead.

Lock names are the JAX package's, one per lock *role* (``"kvstore"``,
``"scheduler.cv"``, ``"metrics.registry"``, ``"flight_recorder"``), not
per instance: two instances of one component share a witness class, and
acquiring two instances of the same class adds no edge.

Signal-safety: the flight recorder's lock is reentrant so that a
SIGTERM dump can interrupt ``record()`` on its own thread; a reentrant
re-acquire touches no global state, and the graph mutex is only ever
try-acquired (a busy mutex skips the edge): the witness never becomes a
new way to hang.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["LockOrderError", "named_lock", "witness_enabled",
           "witness_edges", "reset_witness_for_tests"]

_ENV_FLAG = "BYTEPS_LOCK_WITNESS"

# Test override: None = consult the environment, True/False = forced.
_force: Optional[bool] = None

# The process-wide lock graph: directed edge (held, acquired) -> the
# code site (file:line) where `acquired` was first taken while `held`
# was held.  Guarded by _graph_mu, which is only ever try-acquired.
_graph: Dict[Tuple[str, str], str] = {}
_graph_mu = threading.Lock()

_tls = threading.local()


class LockOrderError(RuntimeError):
    """An acquisition would close a cycle in the process lock graph."""


def witness_enabled() -> bool:
    """Is the witness armed?  The INSTALLED config wins when one exists
    (``set_config(Config(lock_witness=True))`` arms every lock built
    after it — and ``Config.lock_witness`` defaults from the env var, so
    an explicit Config under the chaos lanes stays armed); locks created
    before any config exists — import-time singletons like the metrics
    registry — fall back to ``BYTEPS_LOCK_WITNESS`` directly.  Tests
    force it via :func:`_force_for_tests`."""
    if _force is not None:
        return _force
    try:
        from . import config as _config_mod
        cfg = _config_mod._config   # installed only: never build from
        if cfg is not None:         # env here (no side effects at lock
            return bool(cfg.lock_witness)  # construction time)
    except Exception:  # noqa: BLE001 — the witness must never crash a lock
        pass
    v = os.environ.get(_ENV_FLAG, "")
    return v.strip().lower() not in ("", "0", "false", "no", "off")


def _force_for_tests(value: Optional[bool]) -> None:
    global _force
    _force = value


def reset_witness_for_tests() -> None:
    """Drop every recorded edge (the graph is process-global; tests that
    construct deliberate orderings must not poison each other)."""
    with _graph_mu:
        _graph.clear()


def witness_edges() -> Dict[Tuple[str, str], str]:
    """Snapshot of the recorded ordering edges (debug surface)."""
    with _graph_mu:
        return dict(_graph)


def _holds() -> List[list]:
    """This thread's acquisition stack: [lock_obj, name, site, depth]."""
    h = getattr(_tls, "holds", None)
    if h is None:
        h = _tls.holds = []
    return h


def _site(skip_frames: int = 2) -> str:
    """file:line of the acquiring caller — the first frame outside this
    module (and outside threading.py, so ``with lock:`` through a
    Condition still names user code)."""
    f = sys._getframe(skip_frames)
    here = __file__
    while f is not None:
        fn = f.f_code.co_filename
        if fn != here and not fn.endswith("threading.py"):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _path(src: str, dst: str) -> Optional[List[Tuple[str, str]]]:
    """Directed path src -> ... -> dst over the recorded edges, as the
    edge list, or None.  Caller holds _graph_mu."""
    adj: Dict[str, List[str]] = {}
    for (a, b) in _graph:
        adj.setdefault(a, []).append(b)
    # iterative DFS with parent tracking (the graph is tiny — one node
    # per lock ROLE, not per instance)
    stack = [src]
    parent: Dict[str, str] = {}
    seen = {src}
    while stack:
        node = stack.pop()
        if node == dst:
            edges: List[Tuple[str, str]] = []
            while node != src:
                edges.append((parent[node], node))
                node = parent[node]
            edges.reverse()
            return edges
        for nxt in adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                parent[nxt] = node
                stack.append(nxt)
    return None


def _check_and_record(name: str, site: str, holds: List[list]) -> None:
    """Cycle check + edge recording for a blocking acquire of ``name``
    while ``holds`` are held.  Raises :class:`LockOrderError` when the
    new edges would close a cycle.  Best-effort: if the graph mutex is
    busy (e.g. a signal handler interrupted bookkeeping), skip."""
    if not _graph_mu.acquire(blocking=False):
        return
    try:
        for held in holds:
            hname, hsite = held[1], held[2]
            if hname == name:
                continue  # same lock class: instance order unchecked
            cycle = _path(name, hname)
            if cycle is not None:
                recorded = "; ".join(
                    f"'{a}' -> '{b}' first witnessed at {_graph[(a, b)]}"
                    for a, b in cycle)
                raise LockOrderError(
                    f"lock-order cycle: acquiring '{name}' at {site} "
                    f"while holding '{hname}' (acquired at {hsite}), but "
                    f"the reverse order is already on record: {recorded}. "
                    f"One of these two acquisition sites must change "
                    f"order (or stop nesting) — this interleaving "
                    f"deadlocks two threads.")
            _graph.setdefault((hname, name), site)
    finally:
        _graph_mu.release()


class _WitnessLock:
    """The armed wrapper: a plain (or reentrant) lock plus witness
    bookkeeping.  Drop-in for ``threading.Lock`` including use as the
    lock of a ``threading.Condition`` (``_is_owned`` provided)."""

    __slots__ = ("name", "_lock", "_reentrant")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        holds = _holds()
        if self._reentrant:
            # re-acquire by the owning thread: bump the depth and touch
            # NOTHING global (signal-handler reentrancy — see module doc)
            for h in reversed(holds):
                if h[0] is self:
                    ok = self._lock.acquire(blocking, timeout)
                    if ok:
                        h[3] += 1
                    return ok
        site = _site()
        if blocking and holds:
            # try-acquires are deadlock-free by construction; only a
            # blocking acquire participates in order checking
            _check_and_record(self.name, site, holds)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            holds.append([self, self.name, site, 1])
        return ok

    def release(self) -> None:
        holds = _holds()
        for i in range(len(holds) - 1, -1, -1):
            if holds[i][0] is self:
                holds[i][3] -= 1
                if holds[i][3] == 0:
                    del holds[i]
                break
        self._lock.release()

    def __enter__(self) -> "_WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # threading.Condition compatibility -------------------------------
    def _is_owned(self) -> bool:
        return any(h[0] is self for h in _holds())

    def _release_save(self):
        """Condition.wait(): fully unwind this thread's hold (all
        reentrant levels) and drop the witness entry — the wake-side
        re-acquire is a scheduler artifact, not an ordering event."""
        holds = _holds()
        entry = None
        for i in range(len(holds) - 1, -1, -1):
            if holds[i][0] is self:
                entry = holds.pop(i)
                break
        inner = getattr(self._lock, "_release_save", None)
        state = inner() if inner is not None else self._lock.release()
        return (state, entry)

    def _acquire_restore(self, saved) -> None:
        state, entry = saved
        inner = getattr(self._lock, "_acquire_restore", None)
        if inner is not None:
            inner(state)
        else:
            self._lock.acquire()
        if entry is not None:
            _holds().append(entry)

    def locked(self) -> bool:
        inner = getattr(self._lock, "locked", None)
        if inner is not None:
            return inner()
        return self._lock._is_owned()  # RLock before 3.13

    def __repr__(self) -> str:
        kind = "RLock" if self._reentrant else "Lock"
        return f"<witnessed {kind} {self.name!r}>"


def named_lock(name: str, reentrant: bool = False):
    """A lock carrying a witness class name.

    Witness off (the default): returns a bare ``threading.Lock`` /
    ``RLock`` — the wrapper does not exist at all on the production hot
    path.  Witness on (``BYTEPS_LOCK_WITNESS=1``): returns a
    :class:`_WitnessLock` that records acquisition order into the
    process lock graph and raises :class:`LockOrderError` on a cycle.
    """
    if not witness_enabled():
        return threading.RLock() if reentrant else threading.Lock()
    return _WitnessLock(name, reentrant)
