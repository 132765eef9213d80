"""End-to-end data integrity: checksummed wire envelopes + quarantine;
port of ``byteps_tpu/common/integrity.py``.

The reference's PS wire path (ps-lite over ZMQ/RDMA) inherits
transport-level integrity from TCP, but a host-side hop of the parameter
server (``ServerEngine.push``, ``KVStore.push_delta*``) carries raw
arrays with no corruption, duplication or sanity checks.  Gradient
compression makes that worse: one flipped bit in an entropy-coded
payload decodes into a many-element error no value check can localize.
Detection therefore lives in an envelope around the wire bytes, not in
the codec.

**Envelope** — a CRC32C-checksummed, sequence-numbered frame, byte for
byte the JAX package's (a frame sealed by either package opens in the
other)::

    !4s  magic  b"BPSE"
    !B   version (1)
    !B   kind    (1 = ndarray, 2 = opaque bytes)
    !H   key length
    !q   worker rank   (-1 = not a per-worker hop)
    !Q   sequence number
    !H   dtype-string length   (0 for kind=bytes)
    !B   ndim                  (0 for kind=bytes)
    !Q   payload length
    key utf-8 | dtype utf-8 | ndim x !Q dims | payload | !I CRC32C(all prior)

The CRC covers header *and* payload, so a flip that mangles the shape,
the dtype, the sequence token or the data is equally detected.
``open_*`` raises :class:`IntegrityError` — the receiver's NACK — and
:func:`wire_transmit` retransmits from the sealed source copy under
``BYTEPS_INTEGRITY_MAX_RETRANSMITS``.

The dtype travels as numpy's ``dtype.str`` (``'<f4'``).  bfloat16 has
no such name (numpy has no bf16; ``ml_dtypes`` names it ``'<V2'``, a
void dtype), and the JAX package cannot seal it either, so
:func:`seal_array` refuses a bf16 tensor with a ValueError instead of
inventing a wire name.

**Sequence tokens** — a per-(key, worker) monotonic counter lets the
receiver drop duplicates (``KVStore`` dedup): a retry after a lost ack
never double-sums a delta in async mode.

**Non-finite quarantine** — :func:`screen_nonfinite` applies
``BYTEPS_NONFINITE_POLICY=raise|skip|zero`` to a contribution; the
receivers apply it to their merges.

Every call site guards with :func:`enabled` (``BYTEPS_INTEGRITY``):
off, nothing is sealed, hashed or allocated.

CRC32C is the native core's slice-by-8 ``bps_crc32c`` (``native/
core.cc``), built at first use; a failed build raises, as the port's
native loader always does.

:func:`wire_transmit` feeds the observability plane as the JAX one does:
each hop's wall time (retransmits included) is the step's ``wire``
attribution component, a captured operation gets a ``wire:<site>`` span
and a flow step on its arc, a retransmitted hop an
``integrity.retransmit`` span, and each NACK and non-finite screen a
flight-recorder event, and its wall time is a slowness sample
(``utils/slowness.py``) for the hop's worker at the hop's site.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .telemetry import counters
from .logging import get_logger

__all__ = [
    "IntegrityError", "AckLost", "EnvelopeMeta", "enabled",
    "nonfinite_policy", "max_retransmits", "loopback_fast", "crc32c",
    "seal_array", "seal_bytes", "open_array", "open_bytes", "open_frame",
    "is_frame",
    "wire_transmit", "screen_nonfinite", "record_span",
]

_log = get_logger()

MAGIC = b"BPSE"
VERSION = 1
KIND_NDARRAY = 1
KIND_BYTES = 2

# magic, version, kind, key_len, worker, seq, dtype_len, ndim, payload_len
_FIXED = struct.Struct("!4sBBHqQHBQ")
_DIM = struct.Struct("!Q")
_CRC = struct.Struct("!I")
CHECK = 0xE3069283  # CRC32C(b"123456789"), the Castagnoli check value


class IntegrityError(ValueError):
    """A frame failed verification — the receiver's NACK.  The sender
    retransmits from its source copy; past the retransmit budget the
    error propagates to the caller."""


class AckLost(ConnectionError):
    """The receiver applied the push but the acknowledgement was lost
    (chaos ``drop:site=kv_push``).  The sender retries with the SAME
    sequence token; the receiver's dedup makes the retry a no-op, so
    at-most-once summation survives the retry."""


@dataclasses.dataclass(frozen=True)
class EnvelopeMeta:
    """Verified header fields of an opened frame."""

    kind: int
    key: str
    worker: int
    seq: int
    dtype: Optional[np.dtype] = None
    shape: Tuple[int, ...] = ()


# -- config accessors (read through the live process config) ----------------

def enabled() -> bool:
    from .config import get_config
    return get_config().integrity_on


def nonfinite_policy() -> str:
    from .config import get_config
    return get_config().nonfinite_policy


def max_retransmits() -> int:
    from .config import get_config
    return get_config().integrity_max_retransmits


def loopback_fast() -> bool:
    """True when in-process hops may skip the seal->CRC->open round trip
    (``BYTEPS_INTEGRITY_LOOPBACK``, default on) — valid ONLY while no
    chaos is armed: an in-process "wire" is the caller's own memory, so
    the CRC would verify bytes against themselves.  Receivers must still
    snapshot the payload, and re-check ``fault.injector.ENABLED`` at each
    hop."""
    from .config import get_config
    return get_config().integrity_loopback


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, optionally continuing ``crc``."""
    from ..native import crc32c as native_crc
    return native_crc(data, crc)


# -- sealing ----------------------------------------------------------------

def _seal(kind: int, key: str, worker: int, seq: int, dtype_s: str,
          shape: Tuple[int, ...], payload) -> bytes:
    # ``payload`` is any C-contiguous buffer (bytes or a memoryview over
    # the caller's array memory): the CRC runs incrementally over the
    # view and ``join`` copies it exactly once — into the frame itself.
    kb = key.encode("utf-8")
    db = dtype_s.encode("ascii")
    head = _FIXED.pack(MAGIC, VERSION, kind, len(kb), worker, seq,
                       len(db), len(shape), len(payload))
    parts = [head, kb, db, *(_DIM.pack(d) for d in shape), payload]
    crc = 0
    for part in parts:
        crc = crc32c(part, crc)
    parts.append(_CRC.pack(crc))
    return b"".join(parts)


def _host_array(arr) -> np.ndarray:
    """A numpy view of a host tensor or array whose dtype the envelope
    can name; raises ValueError otherwise."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise ValueError(f"seal_array takes host arrays; copy the "
                             f"tensor on {arr.device} to the host first")
        if arr.dtype == torch.bfloat16:
            raise ValueError(
                "cannot seal a bfloat16 array: the envelope names dtypes "
                "by numpy's dtype.str, which has no bfloat16 (the JAX "
                "package cannot seal one either); push float32")
        arr = arr.detach().numpy()
    a = np.asarray(arr)
    if a.dtype.kind not in "biufc":
        raise ValueError(f"cannot seal dtype {a.dtype} ({a.dtype.str!r} "
                         "does not name it on the wire)")
    return a


def seal_array(arr, *, key: str, seq: int = 0, worker: int = -1) -> bytes:
    """Wrap a host array (a CPU tensor or an ndarray) for a host hop;
    shape and dtype ride the header.  The payload is CRC'd and joined
    straight from the array's own memory; only a non-contiguous input
    pays a compaction first."""
    a = _host_array(arr)
    shape = a.shape  # ascontiguousarray promotes 0-d to (1,): keep ours
    a = np.ascontiguousarray(a)
    return _seal(KIND_NDARRAY, key, worker, seq, a.dtype.str, shape,
                 memoryview(a).cast("B"))


def seal_bytes(data: bytes, *, key: str, seq: int = 0,
               worker: int = -1) -> bytes:
    """Wrap an opaque byte payload (a codec's wire frame)."""
    return _seal(KIND_BYTES, key, worker, seq, "", (), bytes(data))


def envelope_overhead(key: str) -> int:
    """Bytes :func:`seal_bytes` adds around a payload, so a sender can
    budget a size clamp without paying the full CRC+copy of a seal that
    the clamp would only throw away."""
    return _FIXED.size + len(key.encode("utf-8")) + _CRC.size


def is_frame(data: bytes) -> bool:
    """Cheap sniff: does this blob start like an envelope?  Lets
    receivers accept both sealed and raw senders."""
    return len(data) >= _FIXED.size + _CRC.size and data[:4] == MAGIC


# -- opening (verify-on-receive) --------------------------------------------

def open_frame(frame: bytes, copy: bool = True) -> Tuple[Any, EnvelopeMeta]:
    """Verify and unwrap one frame; returns ``(payload, meta)`` where
    payload is a read-only ndarray over the frame (kind=1) or bytes
    (kind=2; with ``copy=False`` a memoryview over the frame, for a
    receiver that only reads it once, such as the membership bus's
    unpickle of a 300 MB reply).

    Raises :class:`IntegrityError` — magic/version mismatch, CRC32C
    mismatch, or any internal length inconsistency.  The CRC is checked
    FIRST, so no header field is trusted before it is authenticated."""
    if len(frame) < _FIXED.size + _CRC.size:
        raise IntegrityError(
            f"frame truncated: {len(frame)} bytes < minimum "
            f"{_FIXED.size + _CRC.size}")
    if bytes(frame[:4]) != MAGIC:
        raise IntegrityError(f"bad magic {frame[:4]!r} (not an envelope)")
    mv = memoryview(frame)
    body, trailer = mv[:-_CRC.size], mv[-_CRC.size:]
    (want,) = _CRC.unpack(trailer)
    got = crc32c(body)
    if got != want:
        raise IntegrityError(
            f"CRC32C mismatch: frame carries 0x{want:08x}, payload hashes "
            f"to 0x{got:08x}")
    (magic, version, kind, key_len, worker, seq, dtype_len, ndim,
     payload_len) = _FIXED.unpack_from(body)
    if version != VERSION:
        raise IntegrityError(f"envelope version {version} != {VERSION}")
    off = _FIXED.size
    want_len = off + key_len + dtype_len + ndim * _DIM.size + payload_len
    if want_len != len(body):
        raise IntegrityError(
            f"frame length {len(body)} != header-declared {want_len}")
    key = bytes(body[off:off + key_len]).decode("utf-8", errors="replace")
    off += key_len
    dtype_s = bytes(body[off:off + dtype_len]).decode("ascii",
                                                      errors="replace")
    off += dtype_len
    shape = tuple(_DIM.unpack_from(body, off + i * _DIM.size)[0]
                  for i in range(ndim))
    off += ndim * _DIM.size
    payload = body[off:off + payload_len]
    if kind == KIND_BYTES:
        return (bytes(payload) if copy else payload,
                EnvelopeMeta(kind, key, worker, seq))
    if kind != KIND_NDARRAY:
        raise IntegrityError(f"unknown payload kind {kind}")
    try:
        dtype = np.dtype(dtype_s)
    except TypeError:
        raise IntegrityError(f"bad dtype string {dtype_s!r}") from None
    numel = 1
    for d in shape:
        numel *= d
    if dtype.itemsize == 0 or numel * dtype.itemsize != payload_len:
        raise IntegrityError(
            f"shape-mangled frame: {shape}/{dtype} needs "
            f"{numel * dtype.itemsize} bytes, payload is {payload_len}")
    arr = np.frombuffer(payload, dtype=dtype).reshape(shape)
    return arr, EnvelopeMeta(kind, key, worker, seq, dtype, shape)


def open_array(frame: bytes) -> Tuple[np.ndarray, EnvelopeMeta]:
    payload, meta = open_frame(frame)
    if meta.kind != KIND_NDARRAY:
        raise IntegrityError(
            f"expected an ndarray frame, got kind {meta.kind}")
    return payload, meta


def open_bytes(frame: bytes, copy: bool = True) -> Tuple[bytes, EnvelopeMeta]:
    payload, meta = open_frame(frame, copy=copy)
    if meta.kind != KIND_BYTES:
        raise IntegrityError(f"expected a bytes frame, got kind {meta.kind}")
    return payload, meta


# -- the chaos-instrumented wire hop (shared by every receiver) -------------

def wire_transmit(frame: bytes, *, key: str, worker: int, seq: int,
                  site: str, opener: Callable, who: str,
                  on_reject: Optional[Callable[[], None]] = None):
    """Transmit ``frame`` across the chaos-instrumented hop ``site`` and
    verify on receive; the one NACK/retransmit state machine behind both
    ``ServerEngine`` and ``KVStore``.

    A failed verification is the NACK (``integrity.crc_reject``,
    ``on_reject`` for per-receiver accounting): the frame is
    retransmitted from the sealed SOURCE copy — never from the
    possibly-corrupt received bytes — up to
    ``BYTEPS_INTEGRITY_MAX_RETRANSMITS`` times
    (``integrity.retransmit``); past the budget the
    :class:`IntegrityError` propagates to the caller."""
    from .retry import RetryPolicy
    from ..fault import injector as _fault
    budget = max_retransmits()
    attempts = {"n": 0}
    t0 = time.monotonic()

    def transmit():
        attempts["n"] += 1
        if attempts["n"] > 1:
            counters.inc("integrity.retransmit")
        wire = frame
        if _fault.ENABLED:
            wire = _fault.corrupt_bytes(site, wire)
            _fault.fire(site)
        try:
            payload, _meta = opener(wire)
        except IntegrityError as e:
            counters.inc("integrity.crc_reject")
            from . import flight_recorder as _flight
            _flight.record("integrity.crc_reject", key=key, seq=seq,
                           worker=worker, site=site,
                           attempt=attempts["n"])
            if on_reject is not None:
                on_reject()
            _log.warning(
                "%s: NACK %r seq %d worker %d (attempt %d/%d): %s",
                who, key, seq, worker, attempts["n"], budget + 1, e)
            raise
        return payload

    policy = RetryPolicy(max_attempts=budget + 1, base_delay_s=0.0,
                         max_delay_s=0.0, retry_on=(IntegrityError,))
    out = policy.call(transmit, describe=f"{who} {key!r} wire")
    dt = time.monotonic() - t0
    # the hop's wall time, retransmit rounds included, is the step's
    # "wire" attribution component
    from .telemetry import attribution
    attribution.add("wire", dt * 1e3)
    # a captured operation gets this hop as a span on its arc (flow "t")
    from . import tracing as _tracing
    ctx = _tracing.current()
    if ctx is not None:
        tr = _tracing.tracer()
        if tr.active:
            tr.record_traced(ctx.trace_id, f"wire:{site}", f"wire/{site}",
                             t0, t0 + dt, key=key, worker=worker, seq=seq,
                             attempts=attempts["n"])
            tr.flow(ctx.trace_id, "t", f"wire/{site}", t0)
    if attempts["n"] > 1:
        record_span("retransmit", t0, key=key, worker=worker, seq=seq,
                    attempts=attempts["n"])
    # slowness feed: the hop's wall time, retransmit rounds included,
    # attributed to the hop's worker, so a peer whose frames are
    # chronically slow or corrupt scores as slow before it scores as dead
    from ..utils import slowness as _slowness
    _slowness.tracker().observe(worker, time.monotonic() - t0, site=site)
    return out


# -- non-finite quarantine --------------------------------------------------

def screen_nonfinite(arr, *, what: str, key: str, worker: int):
    """Screen one contribution (a host ndarray or CPU tensor) under the
    process policy.

    Returns the array to merge (possibly zero-patched, of the input's
    kind), or ``None`` when the policy is ``skip`` (the caller
    quarantines the round / drops the delta).  ``raise`` raises
    ValueError naming the blamed worker — the corrupt gradient never
    reaches a merge buffer."""
    is_tensor = isinstance(arr, torch.Tensor)
    a = arr.numpy() if is_tensor else arr
    if not np.issubdtype(a.dtype, np.inexact):
        return arr
    finite = np.isfinite(a)
    if finite.all():
        return arr
    n_bad = int(a.size - np.count_nonzero(finite))
    policy = nonfinite_policy()
    from . import flight_recorder as _flight
    _flight.record("integrity.nonfinite", what=what, key=key,
                   worker=worker, n_bad=n_bad, policy=policy)
    if policy == "zero":
        counters.inc("integrity.nonfinite_zeroed")
        _log.warning(
            "integrity: zeroed %d non-finite element(s) in %s %r from "
            "worker %d", n_bad, what, key, worker)
        out = np.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)
        return torch.from_numpy(out) if is_tensor else out
    if policy == "skip":
        counters.inc("integrity.nonfinite_skipped")
        _log.error(
            "integrity: skipped %s %r — %d non-finite element(s), blamed "
            "worker %d", what, key, n_bad, worker)
        return None
    counters.inc("integrity.nonfinite_rejected")
    raise ValueError(
        f"{what} {key!r}: {n_bad} non-finite element(s) from worker "
        f"{worker} (BYTEPS_NONFINITE_POLICY=raise)")


# -- tracing ----------------------------------------------------------------

def record_span(name: str, t0: float, **meta) -> None:
    """An integrity event span (``integrity.<name>``) into the running
    engine's tracer (best-effort: retransmit storms and quarantines must
    show in the timeline, and tracing must never fail a hop)."""
    try:
        from ..core import api
        eng = api._require()
        eng.tracer.record_span(f"integrity.{name}", t0, time.monotonic(),
                               **meta)
    except Exception:  # noqa: BLE001 — tracing is best-effort
        pass
