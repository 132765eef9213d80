"""Server sum-engine semantics: multi-threaded, priority-scheduled merge;
port of ``byteps_tpu/server/engine.py``.

Reference behavior being re-created (server.cc / queue.h):

- N engine threads (``BYTEPS_SERVER_ENGINE_THREAD``, default 4), each
  draining its own queue; keys are sticky-assigned to the least-loaded
  thread by accumulated bytes (server.h:149-173 GetThreadID).
- Sync flow per key and round: the first worker's push is COPY_FIRST
  (replaces the store), later workers are SUM_RECV (in-place sum via the
  native reducer), and when all ``num_workers`` arrived (ALL_RECV) the
  merged version is published and parked pulls are answered
  (server.cc:290-404).
- Optional scheduling (``BYTEPS_SERVER_ENABLE_SCHEDULE``): queues pop the
  message whose key has the *fewest* outstanding pushes first — keys
  closest to completing a merge go first, unblocking pulls sooner
  (queue.h:31-104; counters cleared on ALL_RECV).
- Debug value printing for a key (``BYTEPS_SERVER_DEBUG[_KEY]``,
  server.cc:115-139).

Where the data lives: contributions and merges are contiguous CPU
tensors summed by the native reducer, as the reference's CPU server and
the JAX engine's numpy arrays are.  A compressed key's codec runs on the
engine's ``device`` (default ``"cuda"``, which raises without CUDA;
tests pass ``device="cpu"``): ``push_compressed`` decodes there and
``pull_compressed`` re-encodes the merge there — onebit's unpack and
pack are the CUDA kernels of ``csrc/onebit.cu`` on a card.

With integrity on and no chaos armed, an in-process ``push`` takes the
loopback fast path (``BYTEPS_INTEGRITY_LOOPBACK``): one snapshot copy
instead of seal -> CRC -> open; with chaos armed every push crosses the
sealed envelope at site ``server_push``.  Non-finite contributions and
merges go through ``BYTEPS_NONFINITE_POLICY``: ``skip`` quarantines the
blamed ROUND (its queued messages dropped, late same-round pushes
one-shot-dropped, the previous merge republished), ``raise`` poisons the
key until :meth:`ServerEngine.reset_key`.

Observability, as in the JAX engine: a push joins the caller's captured
trace or samples one at ``server_push``; it records a ``server.push``
span and opens a flow arc (``s``) that the merge thread closes (``f``)
with its ``server.merge`` span, the envelope hop between them adding its
own (``t``).  Every merge's wall time is the step's ``merge``
attribution component, and a quarantined round records a flight event
and dumps the flight recorder.  Not ported: the transport's entry points
``receive_push`` / ``receive_push_wire`` (ROADMAP Queue A item 3).
"""

from __future__ import annotations

from collections import deque
import dataclasses
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..comm.mesh import resolve_device
from ..common import integrity as _integrity
from ..common import metrics as _metrics
from ..common.retry import RetryPolicy
from ..common import tracing as _tracing
from ..common.telemetry import attribution as _attribution
from ..common.telemetry import counters
from ..fault import injector as _fault
from ..fault import membership as _membership
from ..native import inplace_add
from .kv_store import decode, host_copy
from ..common.logging import get_logger

_log = get_logger()


def _host_tensor(value) -> torch.Tensor:
    """A contribution as a CPU tensor the engine may keep: a CPU tensor
    as it is, a read-only array (an opened frame) copied."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return t if t.device.type == "cpu" else t.cpu()
    a = np.asarray(value)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")     # numpy's spelling


@dataclass
class _Msg:
    key: str
    value: Optional[torch.Tensor] = None
    worker_id: int = 0
    num_workers: int = 1
    kind: str = "push"  # push | stop
    seq: int = 0        # arrival order, stamped by PriorityQueue.push
    epoch: int = 0      # key epoch at push time; bumped by reset_key so
    #                     pre-reset residue in the queues is dropped
    round_no: int = 0   # push-side merge round this message belongs to —
    #                     lets a quarantine drop exactly the blamed
    #                     round's queued messages, not earlier complete
    #                     rounds still waiting in the queue
    trace_id: int = 0   # the push's captured trace (0 = not captured):
    #                     the merge closes its flow arc


class PriorityQueue:
    """queue.h parity: FIFO by default; with scheduling enabled, pops the
    entry whose key has the fewest outstanding pushes (ties by arrival).

    Priority is evaluated at *pop* time from the live per-key counter, as
    the reference does (queue.h ComparePriority reads push_cnt_[key] when
    ordering): all queued messages of a key share the key's current total
    count, and clear_counter re-prioritizes messages that are already
    queued.  The stop sentinel sorts after every data message so pending
    merges drain before an engine thread exits.
    """

    def __init__(self, enable_schedule: bool):
        self._sched = enable_schedule
        self._cv = threading.Condition()
        # scheduling mode: per-key FIFO lanes; pop picks the lane with the
        # smallest live (push_cnt, head-arrival) — O(queued keys) per pop,
        # matching the reference's O(n) heap re-sort per operation.
        # FIFO mode (default): one global O(1) deque.
        self._fifos: Dict[str, "deque[_Msg]"] = {}
        self._fifo: "deque[_Msg]" = deque()
        self._stops: "deque[_Msg]" = deque()
        self._push_cnt: Dict[str, int] = {}
        self._seq = itertools.count()
        self._size = 0

    def push(self, msg: _Msg) -> None:
        with self._cv:
            msg.seq = next(self._seq)
            if msg.kind == "stop":
                self._stops.append(msg)
            elif self._sched:
                self._push_cnt[msg.key] = self._push_cnt.get(msg.key, 0) + 1
                self._fifos.setdefault(msg.key, deque()).append(msg)
            else:
                self._fifo.append(msg)
            self._size += 1
            self._cv.notify()

    def wait_and_pop(self) -> _Msg:
        with self._cv:
            self._cv.wait_for(lambda: self._size > 0)
            self._size -= 1
            if not self._sched:
                if self._fifo:
                    return self._fifo.popleft()
                # only the lowest-priority sentinel remains
                return self._stops.popleft()
            if not self._fifos:
                return self._stops.popleft()
            key = min(self._fifos,
                      key=lambda k: (self._push_cnt.get(k, 0),
                                     self._fifos[k][0].seq))
            dq = self._fifos[key]
            msg = dq.popleft()
            if not dq:  # prune empty lanes: pop cost stays O(queued keys)
                del self._fifos[key]
            return msg

    def clear_counter(self, key: str) -> None:
        if not self._sched:
            return
        with self._cv:
            self._push_cnt[key] = 0


class _Codec:
    """Per-key compression codec: the server-side compressor chain with
    its state on the engine's device, plus a per-merge-version wire cache
    (the reference likewise caches compressed pull responses per key,
    server.cc:34-75)."""

    __slots__ = ("comp", "state", "lock", "cached_version", "cached_wire")

    def __init__(self, comp, device: torch.device):
        self.comp = comp
        self.state = comp.init_state(device)
        self.lock = threading.Lock()
        self.cached_version = -1
        self.cached_wire: Optional[bytes] = None


class _KeyState:
    __slots__ = ("merged", "count", "version", "parked", "lock",
                 "submitted", "shape", "dtype", "poisoned", "epoch",
                 "published", "round_pushed", "drop_once", "known_workers",
                 "round_no", "merge_round", "quarantined_rounds")

    def __init__(self):
        self.merged: Optional[torch.Tensor] = None
        self.count = 0          # pushes processed this round
        self.version = 0        # completed merge rounds
        self.submitted = 0      # pushes enqueued (caller side)
        self.shape = None       # established by the first push (caller side)
        self.dtype = None
        self.poisoned = False   # poisoned until reset_key(): merge failed
        self.epoch = 0          # bumped by reset_key()
        self.published: Optional[torch.Tensor] = None
        #                         last COMPLETED merge (aliases merged at
        #                         publish time; COPY_FIRST rebinds merged to
        #                         a fresh buffer, leaving this intact) — what
        #                         a non-finite quarantine republishes
        self.round_pushed: set = set()
        #                         worker ids that entered the current round
        #                         (push side; cleared when all num_workers
        #                         have) — lets a quarantine know which
        #                         workers' round-k pushes are still inbound
        self.drop_once: set = set()
        #                         workers whose NEXT push belongs to a
        #                         quarantined round and must be dropped,
        #                         not counted into the restarted round
        self.known_workers: set = set()
        #                         every worker id that has ever pushed this
        #                         key — after an elastic shrink the survivor
        #                         world keeps ORIGINAL ranks (e.g. {0, 2}
        #                         with num_workers=2), so a quarantine must
        #                         not derive the inbound-push set from
        #                         range(num_workers) alone
        self.round_no = 0       # push-side round id (incremented when a
        #                         round is fully entered); stamped onto
        #                         every queued message
        self.merge_round = -1   # round id currently being merged (set at
        #                         COPY_FIRST) — tells a quarantine whether
        #                         the partial sum in ``merged`` belongs to
        #                         the blamed round or an earlier one
        self.quarantined_rounds: set = set()
        #                         round ids whose queued messages must be
        #                         dropped at _process; pruned as later
        #                         rounds stream past (per-key FIFO)
        self.parked: List[Callable[..., None]] = []
        self.lock = threading.Lock()




class ServerEngine:
    """The merge engine: push/pull with the reference's barrier flow."""

    def __init__(self, num_threads: Optional[int] = None,
                 enable_schedule: Optional[bool] = None,
                 debug_key: Optional[str] = None, device="cuda"):
        from ..common.config import get_config
        cfg = get_config()
        self.device = resolve_device(device)
        self.num_threads = (num_threads if num_threads is not None
                            else cfg.server_engine_threads)
        if self.num_threads < 1:
            raise ValueError("need at least one engine thread")
        sched = (enable_schedule if enable_schedule is not None
                 else cfg.server_enable_schedule)
        self._debug_key = (debug_key if debug_key is not None
                           else cfg.server_debug_key)
        self.queues = [PriorityQueue(sched) for _ in range(self.num_threads)]
        # membership-epoch gate: pushes stamped with another epoch arrive
        # from a world that no longer exists and are dropped, not summed
        self._membership_epoch = _membership.current_epoch()
        # integrity envelope sequence numbers (one counter per engine; the
        # (key, worker) identity rides the frame header)
        self._wire_seq = itertools.count(1)
        self._states: Dict[str, _KeyState] = {}
        self._codecs: Dict[str, "_Codec"] = {}
        self._states_lock = threading.Lock()
        # sticky least-loaded-by-bytes assignment (server.h GetThreadID)
        self._tid_of: Dict[str, int] = {}
        self._acc_load = [0] * self.num_threads
        self._assign_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._run, args=(q,), daemon=True,
                             name=f"bps-server-engine-{i}")
            for i, q in enumerate(self.queues)]
        for t in self._threads:
            t.start()
        _metrics.register_component("server_engine", self)

    # -- assignment --------------------------------------------------------

    def thread_id(self, key: str, nbytes: int) -> int:
        with self._assign_lock:
            tid = self._tid_of.get(key)
            if tid is None:
                tid = min(range(self.num_threads),
                          key=lambda i: self._acc_load[i])
                self._tid_of[key] = tid
                self._acc_load[tid] += nbytes
            return tid

    def _state(self, key: str) -> _KeyState:
        with self._states_lock:
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = _KeyState()
            return st

    # -- public API --------------------------------------------------------

    def set_membership_epoch(self, epoch: int) -> None:
        """Adopt a new membership epoch (monotonic).  From now on any
        push stamped with a different epoch is dropped at the door
        instead of poisoning a merge round."""
        if epoch > self._membership_epoch:
            self._membership_epoch = epoch
            # a world change invalidates the quarantine bookkeeping: a
            # one-shot drop armed against a departed rank must not fire
            # on its REJOINED incarnation's first push
            with self._states_lock:
                states = list(self._states.values())
            for st in states:
                with st.lock:
                    st.drop_once.clear()
                    st.known_workers.clear()
            _log.warning(
                "server engine: membership epoch now %d; differently "
                "stamped pushes will be dropped", epoch)

    @property
    def membership_epoch(self) -> int:
        return self._membership_epoch

    def debug_state(self) -> dict:
        """Postmortem internals: per-key merge round, version, poison
        flag, and the quarantined-round set."""
        with self._states_lock:
            items = list(self._states.items())
        keys = {}
        for key, st in items:
            with st.lock:
                keys[key] = {
                    "version": st.version,
                    "round_no": st.round_no,
                    "count": st.count,
                    "poisoned": st.poisoned,
                    "quarantined_rounds": sorted(st.quarantined_rounds),
                    "drop_once": sorted(st.drop_once),
                }
        return {"kind": "server_engine",
                "membership_epoch": self._membership_epoch,
                "threads": self.num_threads,
                "keys": keys}

    def _stale(self, what: str, key: str, mepoch: Optional[int]) -> bool:
        if mepoch is None or mepoch == self._membership_epoch:
            return False
        counters.inc("membership.stale_pushes_dropped")
        _log.warning(
            "server engine: dropped %s(%r) from membership epoch %d "
            "(current %d)", what, key, mepoch, self._membership_epoch)
        return True

    def push(self, key: str, value, worker_id: int,
             num_workers: int, mepoch: Optional[int] = None) -> None:
        """One worker's contribution (a host tensor or array) for this
        round (non-blocking).  The key's shape/dtype are established by
        its first push and every later push is validated here, in the
        caller's thread — a mismatched push must never reach
        COPY_FIRST/SUM_RECV on the engine thread.

        ``mepoch``: the caller's membership epoch; a mismatch means the
        push crossed an elastic world change — it is dropped, not
        summed.  ``None`` skips the check."""
        if self._stale("push", key, mepoch):
            return
        arr = _host_tensor(value)
        # join the caller's captured trace or sample here: the wire hop
        # and the merge thread stamp their spans with the same id, one
        # flow arc push (s) -> wire (t) -> merge (f)
        tctx = _tracing.current()
        if tctx is None:
            tctx = _tracing.tracer().maybe_sample("server_push")
        t_push0 = time.monotonic() if tctx is not None else 0.0
        if _integrity.enabled():
            if _integrity.loopback_fast() and not _fault.ENABLED:
                # In-process hop with no chaos armed: seal -> CRC -> open
                # would verify bytes against themselves.  The receiver
                # still SNAPSHOTS the contribution (push() is async and
                # the caller may reuse its buffer before the merge);
                # every downstream semantic still runs.
                counters.inc("integrity.loopback_fast")
                arr = host_copy(arr)
            else:
                # the loopback wire: seal -> (chaos corrupts the frame)
                # -> verify-on-receive, with bounded NACK-driven
                # retransmit from the sealed source copy
                with _tracing.use(tctx):
                    arr = self._wire_recv_array(key, arr, worker_id)
        elif _fault.ENABLED:
            # integrity off: the bitflip lands silently in this worker's
            # contribution — the unprotected baseline the envelope fixes
            arr = _host_tensor(_fault.corrupt("server_push", arr.numpy()))
            _fault.fire("server_push")
        enqueued = self._push_checked(key, arr, worker_id, num_workers,
                                      trace_id=tctx.trace_id if tctx else 0)
        if tctx is not None:
            self._trace_push(tctx, key, t_push0, enqueued, worker=worker_id)

    @staticmethod
    def _trace_push(tctx, key: str, t0: float, enqueued: bool,
                    **args) -> None:
        tr = _tracing.tracer()
        tr.record_traced(tctx.trace_id, "server.push", f"server/{key}", t0,
                         time.monotonic(), **args)
        if enqueued:
            # only a push that reached a merge queue opens the arc: the
            # merge thread closes it, and a dropped push must not leave
            # an orphan "s"
            tr.flow(tctx.trace_id, "s", f"server/{key}", t0)

    def _push_checked(self, key: str, arr: torch.Tensor, worker_id: int,
                      num_workers: int, trace_id: int = 0) -> bool:
        """Post-wire half of push(): non-finite screen, shape/dtype
        validation, round accounting, enqueue.  Returns True when the
        message reached a merge queue (False = dropped/quarantined)."""
        st = self._state(key)
        if _integrity.enabled():
            with st.lock:
                st.known_workers.add(worker_id)
                if self._drop_if_quarantined(st, key, worker_id):
                    return False
            arr = _integrity.screen_nonfinite(arr, what="push", key=key,
                                              worker=worker_id)
            if arr is None:  # skip policy: quarantine the whole round
                # atomic with the drop_once re-check: a quarantine that
                # fired while this push was being screened already
                # dropped it
                with st.lock:
                    if self._drop_if_quarantined(st, key, worker_id):
                        return False
                    quarantined = self._quarantine_round_locked(
                        st, key, worker_id, num_workers)
                self._fulfill_quarantined(key, quarantined)
                return False
        with st.lock:
            # re-checked atomically with round entry: a quarantine firing
            # between the pre-screen check and here would otherwise count
            # this stale round-k push into the restarted round
            if _integrity.enabled() and self._drop_if_quarantined(
                    st, key, worker_id):
                return False
            if st.poisoned:
                raise RuntimeError(f"key {key!r} is poisoned by an "
                                   "earlier merge failure")
            if st.shape is None:
                st.shape, st.dtype = tuple(arr.shape), arr.dtype
            elif tuple(arr.shape) != st.shape or arr.dtype != st.dtype:
                raise ValueError(
                    f"push({key!r}): {tuple(arr.shape)}/"
                    f"{_dtype_name(arr.dtype)} != established "
                    f"{st.shape}/{_dtype_name(st.dtype)}")
            st.round_pushed.add(worker_id)
            round_no = st.round_no
            if len(st.round_pushed) >= num_workers:
                st.round_pushed.clear()  # the round is fully entered
                st.round_no += 1
            st.submitted += 1
            epoch = st.epoch
        q = self.queues[self.thread_id(key, arr.numel() * arr.element_size())]
        q.push(_Msg(key=key, value=arr, worker_id=worker_id,
                    num_workers=num_workers, epoch=epoch,
                    round_no=round_no, trace_id=trace_id))
        return True

    # -- the loopback wire (integrity envelopes) ---------------------------

    def _wire_recv_array(self, key: str, arr: torch.Tensor,
                         worker_id: int) -> torch.Tensor:
        seq = next(self._wire_seq)
        frame = _integrity.seal_array(arr, key=key, seq=seq,
                                      worker=worker_id)
        return _host_tensor(_integrity.wire_transmit(
            frame, key=key, worker=worker_id, seq=seq, site="server_push",
            opener=_integrity.open_array, who="server engine"))

    def _drop_if_quarantined(self, st: "_KeyState", key: str,
                             worker_id: int) -> bool:
        """Caller holds ``st.lock``.  True when this worker's in-flight
        push belongs to a round that was quarantined before it landed:
        counting it into the restarted round would phase-shift every
        later merge by one contribution."""
        if worker_id not in st.drop_once:
            return False
        st.drop_once.discard(worker_id)
        counters.inc("integrity.quarantine_dropped")
        _log.warning(
            "server engine: dropped push(%r) from worker %d — "
            "its round was quarantined", key, worker_id)
        return True

    def _quarantine_round_locked(self, st: "_KeyState", key: str,
                                 blamed: int, num_workers: int) -> tuple:
        """Abandon the round the blamed push was entering after a skipped
        non-finite contribution, *without* wedging it: that round's
        already-queued messages are marked droppable (``round_no``-scoped
        — earlier fully-entered rounds still waiting in the queue merge
        and publish normally), workers whose same-round push is still
        inbound are marked for a one-shot drop, the round accounting
        restarts, and parked pulls are answered with the previous
        completed merge — the round's result is REPUBLISHED rather than
        advanced.  A first-round quarantine has nothing to republish, so
        its parked pulls stay parked for the next round.

        Caller holds ``st.lock`` so the decision to quarantine and the
        round restart are one atomic step.  Returns ``(parked, out,
        version)`` for :meth:`_fulfill_quarantined` to answer outside
        the lock."""
        q_round = st.round_no   # the round the blamed push was entering
        st.quarantined_rounds.add(q_round)
        # round-q messages already queued: every worker in round_pushed
        # enqueued exactly one, minus any _process already merged
        inflight_q = len(st.round_pushed)
        if st.count and st.merge_round == q_round:
            # part of the quarantined round is already in the partial
            # sum — discard it; COPY_FIRST of the next surviving round
            # rebinds ``merged``
            inflight_q -= st.count
            st.count = 0
            st.merged = st.published
        # pre-deduct the to-be-dropped messages so pull's in-flight
        # check (submitted == 0) never waits on a round that will not
        # publish; _process skips the decrement for quarantined drops
        st.submitted -= inflight_q
        # workers that have neither entered this round nor are the blamed
        # one will still send their round-k contribution — drop exactly
        # one push each.  range(num_workers) covers the contiguous-rank
        # convention; known_workers covers post-shrink worlds that keep
        # ORIGINAL ranks (e.g. {0, 2} with num_workers=2)
        st.drop_once |= ((st.known_workers | set(range(num_workers)))
                         - st.round_pushed - {blamed})
        st.round_pushed.clear()
        st.round_no = q_round + 1
        version = st.version
        # flush parked pulls with the previous merge ONLY when no earlier
        # fully-entered round is still in flight — otherwise that round's
        # own publish answers them
        if st.published is not None and st.submitted <= 0:
            parked, st.parked = st.parked, []
            out = st.published
        else:
            parked, out = [], None
        return parked, out, version

    def _fulfill_quarantined(self, key: str, quarantined: tuple) -> None:
        parked, out, version = quarantined
        for fulfill in parked:
            fulfill(out.clone(), version)
        _log.error(
            "server engine: round for key %r quarantined — previous merge "
            "version %d republished", key, version)
        # the moment the flight recorder exists for: dump the black box
        from ..common import flight_recorder as _flight
        _flight.record("quarantine", key=key, republished_version=version)
        _flight.dump("quarantine")

    def pull_versioned(self, key: str,
                       timeout: Optional[float] = None) -> tuple:
        """``(merged tensor, merge version)`` read atomically."""
        return self._pull_versioned(key, timeout)

    def pull(self, key: str, timeout: Optional[float] = None,
             retry: Optional[RetryPolicy] = None) -> torch.Tensor:
        """Blocks until the current round's merge completes (parked-pull
        semantics, server.cc:371-404); returns the SUM of the round's
        contributions.  ``retry`` re-parks a timed-out pull with the
        policy's backoff/deadline."""
        if _fault.ENABLED:
            _fault.fire("server_pull")
        if retry is None:
            return self._pull_versioned(key, timeout)[0]
        # only the timeout is transient: a poisoned key raises
        # RuntimeError and re-parking it would just burn the backoff
        retry = dataclasses.replace(retry, retry_on=(TimeoutError,))
        return retry.call(
            lambda: self._pull_versioned(key, timeout)[0],
            describe=f"pull({key!r})")

    def _pull_versioned(self, key: str, timeout: Optional[float] = None
                        ) -> tuple:
        """(merged tensor, merge version) — read atomically under the key
        lock / at publish time, so a caller can key caches by the version
        that actually produced the tensor."""
        st = self._state(key)
        ev = threading.Event()
        box: Dict[str, Any] = {}

        def fulfill(arr: Optional[torch.Tensor], version: int = -1) -> None:
            box["v"] = arr
            box["ver"] = version
            ev.set()

        with st.lock:
            if st.poisoned:
                raise RuntimeError(f"key {key!r} is poisoned by an "
                                   "earlier merge failure")
            # answer immediately only when no round is in flight: nothing
            # queued (submitted == 0) AND nothing partially merged
            # (count == 0).  ``merged`` can be None with version > 0
            # after reset_key — park until the next round completes
            if (st.version > 0 and st.submitted == 0 and st.count == 0
                    and st.merged is not None):
                return st.merged.clone(), st.version
            st.parked.append(fulfill)
        if not ev.wait(timeout):
            raise TimeoutError(f"pull({key!r}) timed out")
        if box["v"] is None:
            raise RuntimeError(f"key {key!r} was poisoned while this "
                               "pull was parked")
        return box["v"], box["ver"]

    # -- compressed push/pull (reference server.cc:87-113) -----------------

    def register_compression(self, key: str, kwargs: Dict[str, str],
                             numel: int,
                             dtype: torch.dtype = torch.float32) -> None:
        """Declare a key as compressed: pushes arrive as wire bytes and
        are decompressed before merging; pulls return the merged result
        re-compressed (server.cc:87-113).  The codec is the server-side
        compressor chain (momentum skipped), its state on the engine's
        device."""
        from ..compression import registry as compression_registry
        comp = compression_registry.create(dict(kwargs), numel, dtype,
                                           for_server=True)
        with self._states_lock:
            self._codecs[key] = _Codec(comp, self.device)

    def _codec(self, key: str) -> "_Codec":
        with self._states_lock:
            codec = self._codecs.get(key)
        if codec is None:
            raise ValueError(
                f"key {key!r} has no registered compression codec: call "
                f"ServerEngine.register_compression(key, kwargs, numel) "
                f"before push_compressed/pull_compressed")
        return codec

    def push_compressed(self, key: str, data: bytes, worker_id: int,
                        num_workers: int,
                        mepoch: Optional[int] = None) -> None:
        """Push one worker's wire-encoded payload; decompressed here (the
        caller's thread, on the engine's device) and merged by the engine
        threads like any dense push.  A stale ``mepoch`` is dropped
        before the decode even runs.

        With integrity armed, the envelope wraps the *compressed wire
        bytes*; a corrupt frame is NACKed and retransmitted BEFORE
        ``wire_decode`` ever runs."""
        if self._stale("compressed push", key, mepoch):
            return
        comp = self._codec(key).comp
        if _integrity.enabled():
            tctx = _tracing.current()
            if tctx is None:
                tctx = _tracing.tracer().maybe_sample("server_push")
            t_c0 = time.monotonic() if tctx is not None else 0.0
            if _integrity.loopback_fast() and not _fault.ENABLED:
                # same in-process fast path as push(): the wire bytes are
                # already the caller's buffer, nothing to re-CRC
                counters.inc("integrity.loopback_fast")
            else:
                seq = next(self._wire_seq)
                frame = _integrity.seal_bytes(data, key=key, seq=seq,
                                              worker=worker_id)
                with _tracing.use(tctx):
                    data = _integrity.wire_transmit(
                        frame, key=key, worker=worker_id, seq=seq,
                        site="server_push", opener=_integrity.open_bytes,
                        who="server engine")
            value = decode(comp, bytes(data), self.device)
            enq = self._push_checked(key, value, worker_id, num_workers,
                                     trace_id=tctx.trace_id if tctx else 0)
            if tctx is not None:
                self._trace_push(tctx, key, t_c0, enq, worker=worker_id,
                                 compressed=True)
            return
        value = decode(comp, data, self.device)
        self.push(key, value, worker_id, num_workers)

    def pull_compressed(self, key: str,
                        timeout: Optional[float] = None) -> bytes:
        """Pull the merged result re-compressed to wire bytes (on the
        engine's device).  Stateful codecs (server-side error feedback)
        advance once per completed round: the compression is cached under
        the merge version, so concurrent pullers of one round share a
        single compression."""
        codec = self._codec(key)
        merged, version = self._pull_versioned(key, timeout=timeout)
        flat = merged.reshape(-1).to(self.device)
        with codec.lock:
            if codec.cached_version == version:
                return codec.cached_wire
            if version > codec.cached_version:
                # newest round: advance the codec state exactly once
                payload, codec.state = codec.comp.compress(flat,
                                                           codec.state)
                codec.cached_wire = codec.comp.wire_encode(payload)
                codec.cached_version = version
                return codec.cached_wire
            # A puller that slept through newer rounds: compress its
            # round's data WITHOUT touching state or cache
            payload, _ = codec.comp.compress(flat, codec.state)
            return codec.comp.wire_encode(payload)

    def version(self, key: str) -> int:
        return self._state(key).version

    def reset_key(self, key: str) -> None:
        """Clear a key poisoned by a merge failure so a recovery pass can
        reuse it.  Drops the merged buffer, the round counters, and the
        established shape/dtype; completed-round ``version`` survives so
        pull caches keyed on it never see a version regress.  Parked
        pulls from the poisoned era are flushed with the poison error."""
        st = self._state(key)
        with st.lock:
            st.poisoned = False
            st.merged = None
            st.published = None
            st.count = 0
            st.submitted = 0
            st.shape = None
            st.dtype = None
            st.round_pushed.clear()
            st.drop_once.clear()
            st.known_workers.clear()
            st.quarantined_rounds.clear()
            st.merge_round = -1
            st.epoch += 1   # queued pre-reset messages become droppable
            parked, st.parked = st.parked, []
        for fulfill in parked:
            fulfill(None)
        _log.warning("server engine: key %r reset for recovery", key)

    def shutdown(self) -> None:
        for q in self.queues:
            q.push(_Msg(key="", kind="stop"))
        for t in self._threads:
            t.join(timeout=5)

    # -- engine thread -----------------------------------------------------

    def _run(self, q: PriorityQueue) -> None:
        while True:
            msg = q.wait_and_pop()
            if msg.kind == "stop":
                return
            t_m0 = time.monotonic()
            try:
                self._process(msg, q)
            except Exception:  # noqa: BLE001 — push() pre-validates
                # shape/dtype, so this is exceptional (OOM etc.); the key
                # is poisoned terminally rather than half-reset, but the
                # engine thread (and every other key on it) must survive
                _log.error(
                    "server engine: merge failed for key=%r — key "
                    "poisoned; pending and future push/pull raise",
                    msg.key, exc_info=True)
                st = self._state(msg.key)
                with st.lock:
                    st.poisoned = True
                    st.count = 0
                    st.merged = None
                    st.published = None
                    parked, st.parked = st.parked, []
                q.clear_counter(msg.key)
                for fulfill in parked:
                    fulfill(None)
            # merge attribution and the arc's closing hop, on success and
            # on the poison path (the push's journey ended either way)
            _attribution.add("merge", (time.monotonic() - t_m0) * 1e3)
            if msg.trace_id:
                tr = _tracing.tracer()
                if tr.active:
                    now = time.monotonic()
                    tr.record_traced(msg.trace_id, "server.merge",
                                     f"server/{msg.key}", t_m0, now,
                                     worker=msg.worker_id)
                    tr.flow(msg.trace_id, "f", f"server/{msg.key}", now)

    def _process(self, msg: _Msg, q: PriorityQueue) -> None:
        st = self._state(msg.key)
        with st.lock:
            if msg.epoch != st.epoch:
                # pre-reset residue: reset_key zeroed the round accounting
                # this message was counted under
                return
            if msg.round_no in st.quarantined_rounds:
                # the round was quarantined after this push was queued;
                # its submitted share was already deducted at quarantine
                return
            st.submitted -= 1
            if st.quarantined_rounds:
                # per-key FIFO: once a later round's message arrives, no
                # more messages of an earlier quarantined round can follow
                st.quarantined_rounds = {
                    r for r in st.quarantined_rounds if r > msg.round_no}
            if st.poisoned:
                return  # drop: messages queued before the poison landed
            if st.count == 0:
                # COPY_FIRST: first worker replaces last round's merge
                st.merge_round = msg.round_no
                st.merged = msg.value.clone()
            else:
                # SUM_RECV: native multithreaded in-place sum
                inplace_add(st.merged, msg.value)
            st.count += 1
            if msg.key == self._debug_key:
                _log.warning(
                    "server debug key=%s recv %d/%d sum=%.6f",
                    msg.key, st.count, msg.num_workers,
                    float(st.merged.double().sum()))
            if st.count >= msg.num_workers:
                # ALL_RECV: screen, publish + flush parked pulls
                st.count = 0
                q.clear_counter(msg.key)
                if (_integrity.enabled() and st.merged.is_floating_point()
                        and not bool(torch.isfinite(st.merged).all())):
                    # contributions screened finite can still merge
                    # non-finite (overflow, inf + -inf); the policy
                    # decides before anything is published
                    if not self._screen_merged(st, msg.key):
                        return
                st.version += 1
                st.published = st.merged
                parked, st.parked = st.parked, []
                out = st.merged
                version = st.version
                for fulfill in parked:
                    fulfill(out.clone(), version)

    def _screen_merged(self, st: _KeyState, key: str) -> bool:
        """Policy gate for a non-finite MERGED result (caller holds
        ``st.lock`` and has already zeroed the round count).  True ->
        publish (possibly zero-patched); False -> the previous completed
        merge was republished in place.  ``raise`` raises — _run's
        handler poisons the key."""
        policy = _integrity.nonfinite_policy()
        if policy == "zero":
            counters.inc("integrity.nonfinite_zeroed")
            _log.warning(
                "server engine: zeroed non-finite elements in merged "
                "result for key %r", key)
            torch.nan_to_num(st.merged, nan=0.0, posinf=0.0, neginf=0.0,
                             out=st.merged)
            return True
        if policy == "skip":
            counters.inc("integrity.nonfinite_skipped")
            _log.error(
                "server engine: merged result for key %r is non-finite — "
                "republishing previous merge version %d", key, st.version)
            st.merged = st.published
            if st.published is not None:
                parked, st.parked = st.parked, []
                for fulfill in parked:
                    fulfill(st.published.clone(), st.version)
            return False
        counters.inc("integrity.nonfinite_rejected")
        raise RuntimeError(
            f"merged result for key {key!r} is non-finite "
            "(BYTEPS_NONFINITE_POLICY=raise); key poisoned")
