"""Host-side KV store: async-PS semantics without a server process; port
of ``byteps_tpu/server/kv_store.py``.

Reference behavior being reproduced (server.cc):
- init-push allocates the store and acks after all workers arrive — a
  barrier (server.cc:261-289); here ``init_key`` is idempotent.
- async mode: pushes are summed into the store on arrival, no per-step
  barrier (server.cc:310-314); pulls return the current value immediately
  (server.cc:371-404).

Where the data lives: the stored values are contiguous CPU tensors,
summed on the host by the native reducer (``native.inplace_add``), as
the JAX store holds numpy arrays and the reference's server is CPU-only.
The key's codec runs on the store's ``device`` (default ``"cuda"``,
which raises without CUDA; tests pass ``device="cpu"``): a compressed
push is decoded there — onebit's unpack is the CUDA kernel of
``csrc/onebit.cu`` on a card — and the decoded delta comes back to the
host to be summed, as the JAX store decodes with ``jnp`` on its default
device.

Data integrity (common/integrity.py, BYTEPS_INTEGRITY):
- every delta crosses a CRC32C-verified envelope hop (chaos site
  ``kv_push``); a corrupt frame is NACKed and retransmitted from the
  sealed source copy, never decoded or summed.  A raw ``push_delta`` is
  sealed and CRC'd in full (seal, then verify on open) whatever the
  chaos state: unlike ``ServerEngine.push`` the store has no loopback
  shortcut, in both packages;
- pushes carrying a ``(worker_id, seq)`` token are **idempotent**: a
  retry after a lost ack (``drop:site=kv_push``, raised to the caller as
  :class:`integrity.AckLost` AFTER the sum applied) is dropped by the
  per-(key, worker) monotonic dedup — async mode can never double-sum;
- non-finite deltas and non-finite merge results go through the
  ``BYTEPS_NONFINITE_POLICY`` quarantine (``skip`` leaves the stored
  value at its previous version);
- :attr:`wire_bytes` counts only bytes that *landed*;
  :attr:`wire_bytes_wasted` counts retransmitted and duplicate-dropped
  frames.  Both are denominated in wire-ENCODED (compressed) bytes —
  raw ``push_delta`` traffic never touches either (its rejects show up
  in ``integrity.crc_reject``/``integrity.retransmit``).

Several workers of one process share a store directly; workers in
other processes reach it through the TCP transport
(``comm/transport.py``), whose server verifies each sealed frame at the
socket and hands the verified delta to :meth:`KVStore.apply_delta` /
:meth:`KVStore.apply_delta_wire`: every semantic but the store's own
envelope hop (stale-epoch drop, seq-token dedup, the non-finite screen,
the chaos ack-drop), the raw value summed on the host where
``push_delta`` sums it, a wire frame decoded on the store's device.  A
push joins the caller's captured trace or samples one at ``kv.push``
and records a ``kv.push`` span (the envelope's wire hop adds its own).
Not ported: the write subscription, ``write_batch``, ``publish_key``,
``snapshot_refs`` and the WAL hooks (the serving and durability planes,
ROADMAP Queue A item 4).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..comm.mesh import resolve_device
from ..common import integrity as _integrity
from ..common import metrics as _metrics
from ..common import tracing as _tracing
from ..common.lock_witness import named_lock
from ..common.telemetry import counters
from ..fault import injector as _fault
from ..fault import membership as _membership
from ..native import inplace_add, load as _native_load
from ..common.logging import get_logger

_log = get_logger()

# debug_state clamp: dedup_floors lists at most this many (key, worker)
# entries — the WORST (lowest-floor) ones, the laggards a postmortem
# cares about — plus a total count.
DEBUG_FLOORS_MAX = 16


def host_copy(value) -> torch.Tensor:
    """A fresh contiguous CPU tensor holding ``value`` (a tensor on any
    device, or anything numpy takes)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        return t.contiguous()
    return torch.from_numpy(np.array(value, copy=True))


def host_view(value):
    """``value`` as a host array without a copy where it already is one:
    a CPU tensor or an ndarray as it is, a device tensor copied to the
    host."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return t if t.device.type == "cpu" else t.cpu()
    return np.asarray(value)


def decode(comp, data: bytes, device: torch.device) -> torch.Tensor:
    """A codec's wire frame decoded on ``device``, back on the host
    (flat, in the codec's dtype)."""
    payload = {k: v.to(device) for k, v in comp.wire_decode(data).items()}
    return comp.decompress(payload).reshape(-1).cpu()


def _copy_outside_lock(ref: torch.Tensor) -> torch.Tensor:
    """The pull path's value copy, a module-level hook so tests can prove
    the copy runs OUTSIDE the store lock (a slow pull of a large key must
    not serialize concurrent pushes).  The reference held by the caller
    is copy-on-write-protected: a concurrent push to the same key
    replaces the stored tensor instead of mutating this one in place."""
    return ref.clone()


class KVStore:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._lock = named_lock("kvstore")
        self._store: Dict[str, torch.Tensor] = {}
        self._versions: Dict[str, int] = {}
        self._codecs: Dict[str, tuple] = {}
        # copy-on-write marks: a key in this set has its stored tensor
        # referenced outside the lock (a pull mid-copy); the NEXT push to
        # it replaces the tensor with a fresh copy before summing, so the
        # outstanding reference stays frozen
        self._cow: set = set()
        self.wire_bytes = 0         # compressed bytes that LANDED (summed)
        self.wire_bytes_wasted = 0  # retransmitted + duplicate-dropped bytes
        # per-(key, worker) highest sequence token seen — the dedup floor
        self._seen: Dict[Tuple[str, int], int] = {}
        self._wire_seq = itertools.count(1)
        # membership-epoch gate: deltas stamped with another epoch are
        # dropped, not summed
        self._membership_epoch = _membership.current_epoch()
        # force the one-time native build/load here, NOT under self._lock
        # in push_delta (the first load may g++-compile core.cc)
        _native_load()
        _metrics.register_component("kv_store", self)

    def _account_wire(self, nbytes: int, wasted: bool = False) -> None:
        """Caller holds the lock.  Wire accounting lands on the instance
        attributes and the process-wide ``wire_bytes`` /
        ``wire_bytes_wasted`` counters."""
        if wasted:
            self.wire_bytes_wasted += nbytes
            counters.inc("wire_bytes_wasted", nbytes)
        else:
            self.wire_bytes += nbytes
            counters.inc("wire_bytes", nbytes)
            counters.inc("wire_bytes", nbytes, leg="push")

    def debug_state(self) -> dict:
        """Postmortem internals: dedup floors, wire accounting, key
        count.  ``dedup_floors`` is CLAMPED to the
        :data:`DEBUG_FLOORS_MAX` lowest floors (the laggards) —
        ``dedup_floor_count`` carries the true total."""
        with self._lock:
            worst = sorted(self._seen.items(), key=lambda kv: kv[1])
            return {"kind": "kv_store",
                    "membership_epoch": self._membership_epoch,
                    "keys": len(self._store),
                    "wire_bytes": self.wire_bytes,
                    "wire_bytes_wasted": self.wire_bytes_wasted,
                    "dedup_floor_count": len(self._seen),
                    "dedup_floors": {f"{k}:{w}": s for (k, w), s
                                     in worst[:DEBUG_FLOORS_MAX]}}

    def set_membership_epoch(self, epoch: int) -> None:
        """Adopt a new membership epoch (monotonic).  The dedup floors
        reset with the world: a rejoined incarnation of a dead rank
        restarts its sequence counter at 1.  The cross-boundary retry-dup
        window this reopens is closed by the mepoch gate: a retry of a
        pre-change push still carries the old epoch and is dropped as
        stale in :meth:`_stale`."""
        with self._lock:
            if epoch > self._membership_epoch:
                self._membership_epoch = epoch
                self._seen.clear()

    def _stale(self, key: str, mepoch: Optional[int]) -> bool:
        """True when the delta crossed an elastic world change; stale
        deltas are dropped and the key's version is left untouched."""
        if mepoch is None or mepoch == self._membership_epoch:
            return False
        counters.inc("membership.stale_pushes_dropped")
        _log.warning(
            "kv store: dropped delta for %r from membership epoch %d "
            "(current %d)", key, mepoch, self._membership_epoch)
        return True

    def _dup(self, key: str, worker_id: int, seq: Optional[int]) -> bool:
        """Idempotence gate (caller holds the lock): a (key, worker)
        token at or below the recorded floor is a duplicate — the retry
        of a push whose ACK was lost — and is dropped, not re-summed.
        Check only; the floor advances via :meth:`_mark_seen`.  Callers
        that pass no token are exempt (and unprotected)."""
        if seq is None:
            return False
        floor = self._seen.get((key, worker_id), 0)
        if seq <= floor:
            counters.inc("integrity.dup_dropped")
            _log.warning(
                "kv store: dropped duplicate delta for %r from worker %d "
                "(seq %d <= %d)", key, worker_id, seq, floor)
            return True
        return False

    def _mark_seen(self, key: str, worker_id: int,
                   seq: Optional[int]) -> None:
        """Advance the dedup floor — called only once the push's fate is
        FINAL (summed, or deliberately dropped by policy).  A push that
        died on the wire must not burn its token."""
        if seq is not None and seq > self._seen.get((key, worker_id), 0):
            self._seen[(key, worker_id)] = seq

    def init_key(self, key: str, value) -> None:
        """Idempotent first-push initialization (reference init-push
        barrier, server.cc:261-289)."""
        with self._lock:
            if key not in self._store:
                self._store[key] = host_copy(value)
                self._versions[key] = 0

    def _push_delta_locked(self, key: str, delta) -> int:
        if key not in self._store:
            raise KeyError(f"key {key!r} not initialized")
        target = self._store[key]
        if key in self._cow:
            # copy-on-write: an outstanding reference (a pull copying
            # outside the lock) holds the current tensor — replace it
            # instead of mutating it in place
            target = self._store[key] = target.clone()
            self._cow.discard(key)
        screened = _integrity.enabled()
        prev = None
        if screened and _integrity.nonfinite_policy() in ("skip", "raise"):
            # skip must UNDO a sum (inf + -inf can merge non-finite from
            # finite inputs); raise must leave the store untouched
            prev = target.clone()
        # the native multithreaded sum (reference server engine threads
        # sum with the C++ CpuReducer, server.cc:77-198)
        inplace_add(target, delta.reshape(tuple(target.shape)))
        if (screened and target.is_floating_point()
                and not bool(torch.isfinite(target).all())):
            policy = _integrity.nonfinite_policy()
            if policy == "skip":
                target.copy_(prev)
                counters.inc("integrity.nonfinite_skipped")
                _log.error(
                    "kv store: merge for %r went non-finite — delta "
                    "dropped, value stays at version %d", key,
                    self._versions[key])
                return self._versions[key]
            if policy == "zero":
                counters.inc("integrity.nonfinite_zeroed")
                _log.warning(
                    "kv store: zeroed non-finite elements in merged "
                    "value for %r", key)
                torch.nan_to_num(target, nan=0.0, posinf=0.0, neginf=0.0,
                                 out=target)
            else:
                counters.inc("integrity.nonfinite_rejected")
                target.copy_(prev)  # version not bumped: pulls stay sane
                raise RuntimeError(
                    f"kv store: merged value for {key!r} is non-finite "
                    "(BYTEPS_NONFINITE_POLICY=raise)")
        self._versions[key] += 1
        return self._versions[key]

    def _maybe_drop_ack(self, key: str, version: int,
                        seq: Optional[int]) -> None:
        """Chaos ``drop:site=kv_push``: the delta HAS been applied; the
        acknowledgement is what gets lost.  The caller retries with the
        same seq token and the dedup absorbs the duplicate.  A token-less
        push never loses its ack — it has no token to retry with."""
        if (seq is not None and _fault.ENABLED
                and _fault.should_drop("kv_push")):
            raise _integrity.AckLost(
                f"push for {key!r} applied as version {version} but the "
                "ack was dropped; retry with the same seq token")

    def _land_delta_locked(self, key: str, delta, worker_id: int,
                           seq: Optional[int],
                           wire_len: Optional[int] = None) -> int:
        """The landing tail every delta path shares (caller holds
        ``_lock``; ``delta`` already verified and screened): merge,
        advance the dedup floor (fate final), account wire bytes on the
        wire-denominated path, maybe chaos-drop the ack."""
        before = self._versions.get(key, -1)
        version = self._push_delta_locked(key, delta)
        self._mark_seen(key, worker_id, seq)
        if wire_len is not None:
            self._account_wire(wire_len, wasted=version == before)
        self._maybe_drop_ack(key, version, seq)
        return version

    def _wire_recv(self, key: str, frame: bytes, worker_id: int, seq: int,
                   opener, wasted_nbytes: int):
        """Envelope hop for a sealed frame (caller holds the lock): the
        shared :func:`integrity.wire_transmit` NACK/retransmit machine at
        chaos site ``kv_push``, with every rejected transmission
        accounting ``wasted_nbytes`` into :attr:`wire_bytes_wasted`."""
        def wasted():
            self._account_wire(wasted_nbytes, wasted=True)

        return _integrity.wire_transmit(
            frame, key=key, worker=worker_id, seq=seq, site="kv_push",
            opener=opener, who="kv store", on_reject=wasted)

    def _traced(self, key: str, worker_id: int, push, **args) -> int:
        """Run ``push()`` under the ``kv.push`` span of the caller's
        captured trace, or of one sampled here."""
        tctx, t0 = _tracing.begin_sample("kv.push")
        try:
            return push()
        finally:
            if tctx is not None:
                _tracing.tracer().record_traced(
                    tctx.trace_id, "kv.push", f"kv/{key}", t0,
                    time.monotonic(), worker=worker_id, **args)

    def push_delta(self, key: str, delta, mepoch: Optional[int] = None,
                   worker_id: int = 0, seq: Optional[int] = None) -> int:
        """Sum a delta (a host tensor or array) into the store (async
        SUM_RECV path); returns the new version.  A stale ``mepoch`` is
        dropped — the current version is returned unchanged.  With
        integrity armed the delta crosses the envelope hop (chaos-visible,
        CRC verified); a ``(worker_id, seq)`` token makes the push
        idempotent (see :meth:`_dup`)."""
        return self._traced(key, worker_id, lambda: self._push_delta(
            key, delta, mepoch, worker_id, seq))

    def _push_delta(self, key, delta, mepoch, worker_id, seq) -> int:
        with self._lock:
            if self._stale(key, mepoch):
                return self._versions.get(key, -1)
            if self._dup(key, worker_id, seq):
                version = self._versions.get(key, -1)
                self._maybe_drop_ack(key, version, seq)
                return version
            arr = host_view(delta)
            if _integrity.enabled():
                seq_env = seq if seq is not None else next(self._wire_seq)
                frame = _integrity.seal_array(arr, key=key, seq=seq_env,
                                              worker=worker_id)
                # wasted_nbytes=0: the wire counters are denominated in
                # wire-ENCODED (compressed) bytes only; raw rejects stay
                # visible in integrity.crc_reject/retransmit
                arr = self._wire_recv(key, frame, worker_id, seq_env,
                                      _integrity.open_array, 0)
                arr = _integrity.screen_nonfinite(
                    arr, what="delta", key=key, worker=worker_id)
                if arr is None:  # skip policy: drop this contribution
                    self._mark_seen(key, worker_id, seq)  # fate final
                    return self._versions.get(key, -1)
            elif _fault.ENABLED:
                # integrity off: the bitflip lands silently in this delta
                # — the unprotected baseline the envelope fixes
                arr = _fault.corrupt("kv_push", arr)
                _fault.fire("kv_push")
            return self._land_delta_locked(key, arr, worker_id, seq)

    def register_compression(self, key: str, kwargs: dict, numel: int,
                             dtype: torch.dtype = torch.float32) -> None:
        """Declare a key's wire codec ON the store (one source of truth
        for the key's format — two workers with diverging kwargs must
        fail loudly, not sum mismatched decodes).  The server chain
        (momentum skipped)."""
        from ..compression import registry as reg
        with self._lock:
            existing = self._codecs.get(key)
            if existing is not None:
                if existing[0] != dict(kwargs):
                    raise ValueError(
                        f"key {key!r} already registered with different "
                        f"compression kwargs {existing[0]}")
                return
            comp = reg.create(dict(kwargs), numel, dtype, for_server=True)
            self._codecs[key] = (dict(kwargs), comp, numel, dtype)

    def codec_info(self, key: str):
        """(kwargs, comp, numel, dtype) of the key's registered wire
        codec, or ``None``."""
        with self._lock:
            return self._codecs.get(key)

    def codec_infos(self) -> Dict[str, tuple]:
        """Every registered codec in one lock acquisition."""
        with self._lock:
            return dict(self._codecs)

    def push_delta_wire(self, key: str, data: bytes,
                        mepoch: Optional[int] = None,
                        worker_id: int = 0,
                        seq: Optional[int] = None) -> int:
        """Sum a wire-encoded compressed delta (the reference's async +
        compressed combination: compressed pushes, decompress-and-sum on
        the server, server.cc:87-113 + 310-314).  The key's codec must
        be registered via :meth:`register_compression`; the bytes are
        accumulated in :attr:`wire_bytes` only for pushes that land.  A
        stale ``mepoch`` is dropped before the decode runs; a corrupt
        frame is NACKed and retransmitted before the decode runs — the
        codec never sees unverified bytes."""
        return self._traced(key, worker_id, lambda: self._push_delta_wire(
            key, data, mepoch, worker_id, seq), compressed=True)

    def _push_delta_wire(self, key, data, mepoch, worker_id, seq) -> int:
        with self._lock:
            if self._stale(key, mepoch):
                return self._versions.get(key, -1)
            codec = self._codecs.get(key)
            if codec is None:
                raise KeyError(f"key {key!r} has no registered compression")
            if self._dup(key, worker_id, seq):
                self._account_wire(len(data), wasted=True)
                version = self._versions.get(key, -1)
                self._maybe_drop_ack(key, version, seq)
                return version
            if _integrity.enabled():
                env_seq = seq if seq is not None else next(self._wire_seq)
                frame = _integrity.seal_bytes(data, key=key, seq=env_seq,
                                              worker=worker_id)
                verified = bytes(self._wire_recv(
                    key, frame, worker_id, env_seq, _integrity.open_bytes,
                    len(data)))
            else:
                verified = data
                if _fault.ENABLED:
                    # integrity off: corruption reaches the codec and
                    # decodes into a many-element error
                    verified = _fault.corrupt_bytes("kv_push", verified)
                    _fault.fire("kv_push")
            delta = decode(codec[1], verified, self.device)
            if _integrity.enabled():
                delta = _integrity.screen_nonfinite(
                    delta, what="delta", key=key, worker=worker_id)
                if delta is None:  # skip policy: dropped, bytes wasted
                    self._account_wire(len(data), wasted=True)
                    self._mark_seen(key, worker_id, seq)  # fate final
                    return self._versions.get(key, -1)
            return self._land_delta_locked(key, delta, worker_id, seq,
                                           wire_len=len(data))

    # The TCP transport verifies the sealed envelope AT THE SOCKET and
    # NACKs corruption back to the sender, so these entry points skip
    # the store's own envelope hop (re-sealing a verified payload would
    # CRC bytes against themselves AND double-fire an armed chaos site)
    # while keeping every other semantic.

    def apply_delta(self, key: str, delta, *,
                    mepoch: Optional[int] = None, worker_id: int = 0,
                    seq: Optional[int] = None) -> int:
        """Sum a transport-delivered (already-verified) raw delta (a host
        array); returns the new version.  Raises
        :class:`integrity.AckLost` AFTER the sum applied when chaos drops
        the ack (``drop:site=kv_push``): the transport server suppresses
        its reply and the sender's same-token retry is dedup-absorbed."""
        with self._lock:
            if self._stale(key, mepoch):
                return self._versions.get(key, -1)
            if self._dup(key, worker_id, seq):
                version = self._versions.get(key, -1)
                self._maybe_drop_ack(key, version, seq)
                return version
            arr = host_view(delta)
            if _integrity.enabled():
                arr = _integrity.screen_nonfinite(
                    arr, what="delta", key=key, worker=worker_id)
                if arr is None:  # skip policy: fate final
                    self._mark_seen(key, worker_id, seq)
                    return self._versions.get(key, -1)
            return self._land_delta_locked(key, arr, worker_id, seq)

    def apply_delta_wire(self, key: str, data: bytes, *,
                         mepoch: Optional[int] = None, worker_id: int = 0,
                         seq: Optional[int] = None) -> int:
        """Sum a transport-delivered (already-verified) wire-encoded
        delta, decoded by the key's registered codec on the store's
        device.  Wire accounting as :meth:`push_delta_wire`: landed bytes
        in :attr:`wire_bytes`, duplicates and screened-out deltas in
        :attr:`wire_bytes_wasted`."""
        with self._lock:
            if self._stale(key, mepoch):
                return self._versions.get(key, -1)
            codec = self._codecs.get(key)
            if codec is None:
                raise KeyError(f"key {key!r} has no registered compression")
            if self._dup(key, worker_id, seq):
                self._account_wire(len(data), wasted=True)
                version = self._versions.get(key, -1)
                self._maybe_drop_ack(key, version, seq)
                return version
            delta = decode(codec[1], bytes(data), self.device)
            if _integrity.enabled():
                delta = _integrity.screen_nonfinite(
                    delta, what="delta", key=key, worker=worker_id)
                if delta is None:  # skip policy: dropped, bytes wasted
                    self._account_wire(len(data), wasted=True)
                    self._mark_seen(key, worker_id, seq)
                    return self._versions.get(key, -1)
            return self._land_delta_locked(key, delta, worker_id, seq,
                                           wire_len=len(data))

    def pull(self, key: str) -> torch.Tensor:
        """Return a copy of the current value (no barrier — async pull,
        server.cc:371-404).  The lock is held only to take the reference
        and mark the key copy-on-write; the copy runs OUTSIDE it."""
        with self._lock:
            ref = self._store[key]
            self._cow.add(key)
        return _copy_outside_lock(ref)

    def pull_versioned(self, key: str) -> Tuple[torch.Tensor, int]:
        """``(value, version)`` with the same outside-the-lock copy as
        :meth:`pull`."""
        with self._lock:
            ref = self._store[key]
            version = self._versions[key]
            self._cow.add(key)
        return _copy_outside_lock(ref), version

    def version(self, key: str) -> int:
        with self._lock:
            return self._versions.get(key, -1)

    def keys(self):
        with self._lock:
            return list(self._store)

    def nbytes(self) -> int:
        """Host bytes of the stored values."""
        with self._lock:
            return sum(t.numel() * t.element_size()
                       for t in self._store.values())

    def clear(self) -> None:
        """Reset the store to empty.  The membership epoch RE-SYNCS to the
        process-wide current epoch: a cleared-and-reused store is a new
        logical store in whatever world exists NOW."""
        with self._lock:
            self._store.clear()
            self._versions.clear()
            self._codecs.clear()
            self._seen.clear()
            self._cow.clear()
            self.wire_bytes = 0
            self.wire_bytes_wasted = 0
            self._membership_epoch = _membership.current_epoch()
