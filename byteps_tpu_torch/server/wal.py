"""Durable state plane: crash-consistent WAL + atomic snapshot cuts;
port of ``byteps_tpu/server/wal.py``.

Every robustness layer before this one — coordinator failover, gossip
membership, the fleet reconciler — assumes at least one *survivor*
holds authoritative state in memory.  This module is the layer for the
correlated case (power loss, OOM storm, a bad deploy rolled out to
every host at once): the system's memory outlives its processes.

Three pieces:

**Write-ahead journal** (:class:`WriteAheadLog`).  Segment files of
length-prefixed records; each record is a pickled ``(lsn, kind, data)``
tuple sealed with the integrity envelope
(:func:`~byteps_tpu_torch.common.integrity.seal_bytes`, CRC32C verified at
replay), so a torn tail, a bit flip, or a short write is *detected*,
truncated to the last whole record, and never trusted.  The journal is
written **before** the in-memory merge (classic WAL intent ordering): a
failed append raises with the store untouched and the dedup floor not
advanced, so memory and disk can never disagree about a landed delta.
Fsync policy is the operator's durability/latency dial
(``BYTEPS_WAL_FSYNC=always|interval|off``).

**Atomic snapshot cuts** (:func:`save_snapshot`).  The full store state
(arrays + versions + generation + membership epoch + dedup floors) as
one sealed blob, written to a temp file, fsynced, then *renamed* into
place — readers see the previous complete cut or the new one, never a
torn mix.  A manifest records the version vector and the WAL position
the cut covers; the journal is truncated up to it (whole segments
only), so cold-start replay cost is bounded by one cut interval, not
the life of the run.

**Cold-start recovery** (:func:`attach` / :func:`recover`).  Load the
newest snapshot that verifies (a corrupt one falls back to the next,
counted, never silently used), then replay the journal suffix through
the store's normal merge path — dedup floors and the membership-epoch
gate are rebuilt exactly, so a worker's duplicate retry arriving
*after* a cold restart is still absorbed.  Replay stops at the first
record that fails verification: a torn tail is truncated in place
(appends resume right after the valid prefix); a corrupt mid-log
record truncates there and discards the later segments — recovering to
the last *durable* point with zero silent corruption.  When corruption
leaves the journal's tail **below** the restored snapshot's cut,
recovery advances the LSN past the cut with a sealed ``__advance__``
marker (:meth:`WriteAheadLog.advance_to`): new appends are never
assigned LSNs an existing snapshot already covers, so a later restart
cannot skip them as "already folded in".

Durable blobs (journal records, snapshot cuts) are deserialized through
a **restricted unpickler** limited to numpy's array machinery and plain
builtins: the CRC seal detects corruption but does not *authenticate*,
so the durable dir must be as trusted as the binary — the allowlist
keeps a writable dir from naming arbitrary callables
(docs/fault_tolerance.md, "Trust boundary").

Chaos sites woven here (``fault/injector.py``): ``wal_write``
(``bitflip`` corrupts the on-disk frame, ``drop`` tears the write
short), ``fsync`` (``drop`` skips the fsync the policy promised), and
``disk_full`` (``drop`` fails the append with ``ENOSPC``).

Formats are the JAX package's, byte for byte: the port's
:class:`~byteps_tpu_torch.server.kv_store.KVStore` journals numpy arrays
(a CPU tensor's ``.numpy()``), never a torch object, and the allowlist
below admits numpy and builtins only — so the JAX package recovers a
durable directory the port wrote, and the port recovers the JAX
package's.  :func:`recover` and :func:`ensure_process_store` build the
store on ``device`` (default ``"cuda"``, where a registered codec
decodes; the values stay on the host).
"""

from __future__ import annotations

import errno
import json
import os
import pickle
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..common import integrity as _integrity
from ..common.lock_witness import named_lock
from ..common.logging import get_logger
from ..common.telemetry import counters, gauges
from ..fault import injector as _fault

__all__ = ["WriteAheadLog", "DurableKV", "attach", "recover",
           "save_snapshot", "load_snapshot", "ensure_process_store",
           "recover_process_store", "process_store"]

# record framing: [u32 big-endian frame length][sealed frame]
_LEN = struct.Struct("!I")
# sanity clamp on a length prefix: anything past this is garbage bytes
# read as a length, not a record something in this codebase wrote
_MAX_RECORD = 1 << 30
# marker record kind written by advance_to(): carries no mutation, only
# a verified forward LSN jump (data = {"prev": last LSN before the jump})
_ADVANCE = "__advance__"


class _RestrictedUnpickler(pickle.Unpickler):
    """Unpickler for durable blobs, limited to what the durable plane
    actually serializes: numpy's array reconstruction machinery plus a
    handful of containers pickle names as globals.  The integrity seal
    is corruption DETECTION (CRC), not authentication — without this
    allowlist, write access to BYTEPS_DURABLE_DIR would be arbitrary
    code execution in every process that recovers from it."""

    _SAFE_BUILTINS = {"complex", "set", "frozenset", "bytearray", "slice"}
    _SAFE_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
                   ("numpy.core.multiarray", "_reconstruct"),
                   ("numpy.core.multiarray", "scalar"),
                   ("numpy.core.numeric", "_frombuffer"),
                   ("numpy._core.multiarray", "_reconstruct"),
                   ("numpy._core.multiarray", "scalar"),
                   ("numpy._core.numeric", "_frombuffer")}

    def find_class(self, module, name):
        if module == "builtins" and name in self._SAFE_BUILTINS:
            import builtins
            return getattr(builtins, name)
        if (module, name) in self._SAFE_NUMPY:
            import importlib
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(
            f"durable blob names global {module}.{name}, which is not "
            "on the durable-plane allowlist (the durable dir is "
            "CRC-checked, not authenticated — see "
            "docs/fault_tolerance.md 'Trust boundary')")


def _loads(payload: bytes) -> Any:
    """Deserialize a verified durable blob through the allowlist."""
    import io
    return _RestrictedUnpickler(io.BytesIO(payload)).load()


def _fsync_dir(path: str) -> None:
    """Fsync a directory so a rename/create inside it is durable (the
    file's own fsync does not cover its directory entry)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fsync — best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _maybe_fsync(fh) -> bool:
    """The one fsync choke point, chaos-instrumented: a ``drop:site=fsync``
    rule models a kernel/disk that lied about durability.  Returns True
    when the fsync actually ran."""
    if _fault.ENABLED and _fault.should_drop("fsync"):
        counters.inc("wal.fsync_dropped")
        return False
    fh.flush()
    os.fsync(fh.fileno())
    counters.inc("wal.fsyncs")
    return True


class WriteAheadLog:
    """Append-only segmented journal of sealed records.

    ``replay()`` must run before the first ``append()`` — it scans the
    existing segments (truncating any invalid suffix) and positions the
    log so new appends continue the LSN sequence right after the last
    valid record.
    """

    def __init__(self, dirpath: str, *, fsync: str = "always",
                 fsync_interval_s: float = 0.05,
                 segment_bytes: int = 4 << 20, name: str = "kv"):
        self.dir = dirpath
        self.name = name
        self._fsync = fsync
        self._fsync_interval_s = float(fsync_interval_s)
        self._segment_bytes = int(segment_bytes)
        self._lock = named_lock("wal")
        self._fh = None
        self._seg_path: Optional[str] = None
        self._seg_size = 0
        self._lsn = 0              # last LSN written (0 = empty log)
        self._last_sync = 0.0
        self._replayed = False
        os.makedirs(dirpath, exist_ok=True)

    # -- paths ---------------------------------------------------------------

    def _seg_name(self, first_lsn: int) -> str:
        return os.path.join(self.dir,
                            f"{self.name}-{first_lsn:016d}.wal")

    def segments(self) -> List[Tuple[int, str]]:
        """``[(first_lsn, path)]`` sorted by first LSN."""
        out = []
        prefix, suffix = f"{self.name}-", ".wal"
        for fn in os.listdir(self.dir):
            if fn.startswith(prefix) and fn.endswith(suffix):
                mid = fn[len(prefix):-len(suffix)]
                if mid.isdigit():
                    out.append((int(mid), os.path.join(self.dir, fn)))
        out.sort()
        return out

    # -- append path ---------------------------------------------------------

    @property
    def lsn(self) -> int:
        with self._lock:
            return self._lsn

    def append(self, kind: str, data: Any) -> int:
        """Journal one mutation; returns its LSN.  Raises ``OSError`` on
        a failed or torn write — the caller must NOT apply the mutation
        to memory (journal-before-merge is the crash-consistency
        contract)."""
        with self._lock:
            return self._append_locked(kind, data)

    def _append_locked(self, kind: str, data: Any) -> int:
        if not self._replayed:
            raise RuntimeError("WriteAheadLog.append before replay() "
                               "— the log position is unknown")
        if _fault.ENABLED and _fault.should_drop("disk_full"):
            counters.inc("wal.disk_full_errors")
            raise OSError(errno.ENOSPC,
                          "wal: no space left on device (injected)")
        lsn = self._lsn + 1
        payload = pickle.dumps((lsn, kind, data),
                               protocol=pickle.HIGHEST_PROTOCOL)
        frame = _integrity.seal_bytes(payload, key="wal", seq=lsn)
        buf = _LEN.pack(len(frame)) + frame
        if _fault.ENABLED:
            buf = _fault.corrupt_bytes("wal_write", buf)
        if self._fh is None or self._seg_size >= self._segment_bytes:
            self._roll(lsn)
        if _fault.ENABLED and _fault.should_drop("wal_write"):
            # a torn write: half the record reaches the disk, then
            # the "crash" — the caller sees the failure (mutation
            # not applied) and replay truncates the torn tail
            self._fh.write(buf[:max(1, len(buf) // 2)])
            self._fh.flush()
            counters.inc("wal.torn_writes")
            raise OSError(errno.EIO,
                          "wal: torn write (injected crash)")
        self._fh.write(buf)
        self._seg_size += len(buf)
        self._lsn = lsn
        counters.inc("wal.appends")
        counters.inc("wal.append_bytes", len(buf))
        if self._fsync == "always":
            _maybe_fsync(self._fh)
        elif self._fsync == "interval":
            now = time.monotonic()
            if now - self._last_sync >= self._fsync_interval_s:
                if _maybe_fsync(self._fh):
                    self._last_sync = now
        else:  # "off": the OS page cache decides
            self._fh.flush()
        gauges.set("wal.lsn", lsn)
        return lsn

    def advance_to(self, lsn: int) -> int:
        """Force future appends onto LSNs strictly above ``lsn``.

        Recovery calls this when corruption truncated the journal BELOW
        a restored snapshot's cut: without the jump, new appends would
        reuse LSNs the snapshot already covers and the NEXT recovery's
        ``lsn <= snapshot`` skip would silently discard them.  Rolls a
        fresh segment and seals an explicit :data:`_ADVANCE` marker
        record into it, so the next replay can verify the LSN gap was an
        intentional, snapshot-covered advance — not a missing segment.
        No-op when the log is already at or past ``lsn``."""
        with self._lock:
            if not self._replayed:
                raise RuntimeError("WriteAheadLog.advance_to before "
                                   "replay() — the log position is "
                                   "unknown")
            if lsn <= self._lsn:
                return self._lsn
            prev = self._lsn
            self._lsn = int(lsn)
            self._roll(self._lsn + 1)
            self._append_locked(_ADVANCE, {"prev": prev})
            counters.inc("wal.advances")
            get_logger().warning(
                "wal: advanced LSN %d -> %d past a restored snapshot "
                "cut (journal had truncated below it) — new appends "
                "cannot collide with snapshot-covered LSNs", prev,
                self._lsn)
            return self._lsn

    def _roll(self, first_lsn: int) -> None:
        """Caller holds the lock: close the current segment (fsynced —
        a rolled segment is immutable and must be durable before the
        next one starts) and open a new one named by its first LSN."""
        if self._fh is not None:
            _maybe_fsync(self._fh)
            self._fh.close()
        self._seg_path = self._seg_name(first_lsn)
        self._fh = open(self._seg_path, "ab")
        self._seg_size = self._fh.tell()
        _fsync_dir(self.dir)

    def sync(self) -> None:
        with self._lock:
            if self._fh is not None:
                _maybe_fsync(self._fh)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                _maybe_fsync(self._fh)
                self._fh.close()
                self._fh = None

    # -- replay / recovery ---------------------------------------------------

    def replay(self) -> Tuple[List[Tuple[int, str, Any]], Dict[str, int]]:
        """Scan every segment, verify every record, truncate the first
        invalid suffix, and position the log for appends.  Returns
        ``(records, stats)`` where records is the valid ``(lsn, kind,
        data)`` sequence in order."""
        records: List[Tuple[int, str, Any]] = []
        stats = {"records": 0, "bytes": 0, "truncated_tails": 0,
                 "corrupt_records": 0, "dropped_segments": 0}
        with self._lock:
            segs = self.segments()
            expected = None  # next LSN we must see (None until first)
            stop_at: Optional[Tuple[int, int]] = None  # (seg index, off)
            for i, (first_lsn, path) in enumerate(segs):
                with open(path, "rb") as fh:
                    blob = fh.read()
                off = 0
                while off < len(blob):
                    bad = None
                    if off + _LEN.size > len(blob):
                        bad = "short length prefix"
                    else:
                        (flen,) = _LEN.unpack_from(blob, off)
                        if not 0 < flen <= _MAX_RECORD:
                            bad = f"implausible record length {flen}"
                        elif off + _LEN.size + flen > len(blob):
                            bad = "short record body"
                    if bad is None:
                        frame = blob[off + _LEN.size:
                                     off + _LEN.size + flen]
                        try:
                            payload, _meta = _integrity.open_bytes(frame)
                            lsn, kind, data = _loads(payload)
                        except Exception as e:  # noqa: BLE001 — any
                            # failure here is corruption, by definition
                            bad = f"record failed verification: {e}"
                        else:
                            if expected is not None and lsn != expected:
                                if (kind == _ADVANCE and lsn > expected
                                        and isinstance(data, dict)
                                        and data.get("prev")
                                        == expected - 1):
                                    # a sealed advance marker whose
                                    # "prev" chains to the record before
                                    # it: an intentional, snapshot-
                                    # covered LSN jump (advance_to), not
                                    # a hole in the history
                                    pass
                                else:
                                    bad = (f"LSN discontinuity: got "
                                           f"{lsn}, expected {expected}")
                    if bad is not None:
                        tail = (i == len(segs) - 1)
                        if tail:
                            stats["truncated_tails"] += 1
                            counters.inc("wal.truncated_tails")
                        else:
                            stats["corrupt_records"] += 1
                            counters.inc("wal.corrupt_records")
                        get_logger().warning(
                            "wal: %s segment %s at offset %d (%s) — "
                            "recovering to the last durable point",
                            "torn tail in" if tail else
                            "corrupt record in", path, off, bad)
                        from ..common import flight_recorder as _flight
                        _flight.record(
                            "wal.truncated_tail" if tail
                            else "wal.corrupt_record",
                            segment=os.path.basename(path), offset=off,
                            reason=bad)
                        stop_at = (i, off)
                        break
                    records.append((lsn, kind, data))
                    stats["records"] += 1
                    stats["bytes"] += _LEN.size + flen
                    counters.inc("wal.replay_records")
                    counters.inc("wal.replay_bytes", _LEN.size + flen)
                    expected = lsn + 1
                    off += _LEN.size + flen
                if stop_at is not None:
                    break
            if stop_at is not None:
                i, off = stop_at
                with open(segs[i][1], "r+b") as fh:
                    fh.truncate(off)
                    os.fsync(fh.fileno())
                # everything after the corruption point is not part of
                # the valid prefix: later segments are discarded, never
                # replayed past a hole in the history
                for _, path in segs[i + 1:]:
                    os.remove(path)
                    stats["dropped_segments"] += 1
                    counters.inc("wal.dropped_segments")
                _fsync_dir(self.dir)
            self._lsn = records[-1][0] if records else 0
            # position appends at the end of the last surviving segment
            segs = self.segments()
            if segs:
                self._seg_path = segs[-1][1]
                self._fh = open(self._seg_path, "ab")
                self._seg_size = self._fh.tell()
            self._replayed = True
            gauges.set("wal.lsn", self._lsn)
        return records, stats

    # -- retention -----------------------------------------------------------

    def truncate_upto(self, lsn: int) -> int:
        """Remove whole segments whose records are all covered by a
        durable snapshot at ``lsn`` (a segment is removable when the
        NEXT segment starts at or before ``lsn + 1``).  Returns the
        number of segments removed."""
        removed = 0
        with self._lock:
            segs = self.segments()
            for (start, path), (nxt_start, _) in zip(segs, segs[1:]):
                if nxt_start <= lsn + 1:
                    os.remove(path)
                    removed += 1
                else:
                    break
            if removed:
                _fsync_dir(self.dir)
                counters.inc("wal.truncated_segments", removed)
        return removed

    def lag_bytes(self) -> int:
        """Bytes of journal a cold start would have to replay — the
        on-disk size of the live segments (retention keeps this bounded
        by roughly one cut interval of traffic)."""
        total = 0
        for _, path in self.segments():
            try:
                total += os.path.getsize(path)
            except OSError:
                pass
        return total

    def debug_state(self) -> dict:
        with self._lock:
            lsn, seg = self._lsn, self._seg_path
        return {"kind": "wal", "name": self.name, "dir": self.dir,
                "lsn": lsn, "fsync": self._fsync,
                "segment": os.path.basename(seg) if seg else None,
                "segments": len(self.segments()),
                "lag_bytes": self.lag_bytes()}


# -- atomic snapshot persistence ---------------------------------------------


def _manifest_path(dirpath: str, name: str) -> str:
    return os.path.join(dirpath, f"{name}-manifest.json")


def _snap_path(dirpath: str, name: str, lsn: int) -> str:
    return os.path.join(dirpath, f"{name}-snap-{lsn:016d}.bin")


def _atomic_write(path: str, data: bytes) -> None:
    """write-to-temp + fsync + rename: the path either holds the old
    complete content or the new one, never a torn mix."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        _maybe_fsync(fh)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def save_snapshot(dirpath: str, state: dict, *, lsn: int,
                  generation: int, name: str = "kv",
                  retain: int = 2) -> str:
    """Persist one durable cut atomically and prune old ones.  The
    manifest (itself atomically replaced) names the newest cut and
    carries the version vector, so an operator (or ``bps_doctor``) can
    see what a cold start would restore without opening the blob."""
    os.makedirs(dirpath, exist_ok=True)
    blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    frame = _integrity.seal_bytes(blob, key=f"{name}-snap", seq=lsn)
    path = _snap_path(dirpath, name, lsn)
    _atomic_write(path, frame)
    manifest = {"name": name, "lsn": int(lsn),
                "generation": int(generation),
                "file": os.path.basename(path),
                "ts": time.time(),
                "versions": {str(k): int(v) for k, v in
                             (state.get("versions") or {}).items()}}
    _atomic_write(_manifest_path(dirpath, name),
                  json.dumps(manifest, sort_keys=True).encode())
    counters.inc("wal.snapshot_saves")
    gauges.set("wal.last_snapshot_lsn", int(lsn))
    # retention: newest `retain` cuts stay; the WAL caller separately
    # truncates segments the newest cut covers
    snaps = _list_snaps(dirpath, name)
    for _, old in snaps[:-retain] if retain > 0 else []:
        try:
            os.remove(old)
        except OSError:
            pass
    return path


def _list_snaps(dirpath: str, name: str) -> List[Tuple[int, str]]:
    out = []
    prefix, suffix = f"{name}-snap-", ".bin"
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    for fn in names:
        if fn.startswith(prefix) and fn.endswith(suffix):
            mid = fn[len(prefix):-len(suffix)]
            if mid.isdigit():
                out.append((int(mid), os.path.join(dirpath, fn)))
    out.sort()
    return out


def load_snapshot(dirpath: str, name: str = "kv"
                  ) -> Tuple[Optional[dict], int]:
    """Newest snapshot that VERIFIES, as ``(state, lsn)`` —
    ``(None, 0)`` when no usable cut exists.  A corrupt blob falls back
    to the next-newest (counted, flight-recorded), never silently
    restored."""
    for lsn, path in reversed(_list_snaps(dirpath, name)):
        try:
            with open(path, "rb") as fh:
                frame = fh.read()
            payload, _meta = _integrity.open_bytes(frame)
            state = _loads(payload)
        except Exception as e:  # noqa: BLE001 — corruption, by definition
            counters.inc("wal.snapshot_corrupt")
            get_logger().error(
                "wal: snapshot %s failed verification (%s) — falling "
                "back to an older cut", path, e)
            from ..common import flight_recorder as _flight
            _flight.record("wal.snapshot_corrupt",
                           file=os.path.basename(path), reason=str(e))
            continue
        counters.inc("wal.snapshot_loads")
        return state, lsn
    return None, 0


# -- the KVStore coupling ----------------------------------------------------


class DurableKV:
    """One KVStore's durable plane: the journal, the checkpoint cycle,
    and the recovery stats from open time.  Created via :func:`attach`
    (which recovers the store from disk first, then arms journaling)."""

    def __init__(self, store, dirpath: str, *, fsync: str,
                 fsync_interval_s: float, segment_bytes: int,
                 retain: int):
        self.store = store
        self.dir = dirpath
        self.retain = retain
        self.wal = WriteAheadLog(dirpath, fsync=fsync,
                                 fsync_interval_s=fsync_interval_s,
                                 segment_bytes=segment_bytes, name="kv")
        self.recover_stats: Dict[str, int] = {}
        self._ckpt_lock = threading.Lock()
        self._ckpt_lsn = 0
        # the /debug/state "wal" section lists DurableKV (journal view
        # + checkpoint_lsn + recover_stats), not the bare journal — a
        # standalone WriteAheadLog is a unit-test construction
        from ..common import metrics as _metrics
        _metrics.register_component("wal", self)

    def _recover(self) -> Dict[str, int]:
        """Snapshot restore + journal replay into the store, BEFORE
        journaling is armed (replay must not re-journal itself)."""
        t0 = time.monotonic()
        state, snap_lsn = load_snapshot(self.dir, "kv")
        if state is not None:
            self.store.restore_durable_state(state)
        records, stats = self.wal.replay()
        applied = 0
        for lsn, kind, data in records:
            if lsn <= snap_lsn:
                continue  # covered by the snapshot we restored
            if kind == _ADVANCE:
                continue  # LSN jump marker, not a mutation
            self.store.apply_wal_record(kind, data)
            applied += 1
        if snap_lsn > self.wal.lsn:
            # corruption truncated the journal BELOW the restored cut
            # (a corrupt record between the cut point and the tail, or
            # a fully-corrupt live segment).  Jump the LSN past the
            # snapshot so new appends are never assigned LSNs an
            # existing cut covers — otherwise the next recovery's
            # "lsn <= snap_lsn" skip above would silently discard
            # acknowledged, fsynced mutations.
            stats["advanced_to"] = self.wal.advance_to(snap_lsn)
        self._ckpt_lsn = snap_lsn
        stats.update(snapshot_lsn=snap_lsn, applied=applied,
                     had_snapshot=int(state is not None),
                     elapsed_ms=int((time.monotonic() - t0) * 1000))
        self.recover_stats = stats
        counters.inc("wal.recoveries")
        gauges.set("wal.lag_bytes", self.wal.lag_bytes())
        if state is not None or records:
            from ..common import flight_recorder as _flight
            _flight.record("wal.recovered", dir=self.dir,
                           snapshot_lsn=snap_lsn, applied=applied,
                           **{k: stats[k] for k in
                              ("truncated_tails", "corrupt_records",
                               "dropped_segments")})
            get_logger().warning(
                "wal: cold-start recovery from %s — snapshot lsn %d + "
                "%d replayed record(s) in %dms (%d torn tail(s), %d "
                "corrupt record(s))", self.dir, snap_lsn, applied,
                stats["elapsed_ms"], stats["truncated_tails"],
                stats["corrupt_records"])
        return stats

    def checkpoint(self, force: bool = False) -> bool:
        """Persist a durable cut of the store and truncate the journal
        it covers.  Cheap no-op when nothing was journaled since the
        last cut.  Returns True when a cut was written."""
        with self._ckpt_lock:
            # the cut's LSN comes from durable_state(), which captures it
            # UNDER the store lock — reading self.wal.lsn here and the
            # state separately would let a push journal+merge in between,
            # and replay after restore would then double-apply that delta
            state = self.store.durable_state()
            lsn = int(state.pop("wal_lsn", self.wal.lsn))
            if not force and lsn <= self._ckpt_lsn:
                gauges.set("wal.lag_bytes", self.wal.lag_bytes())
                return False
            save_snapshot(self.dir, state, lsn=lsn,
                          generation=state.get("generation", 0),
                          name="kv", retain=self.retain)
            self.wal.truncate_upto(lsn)
            self._ckpt_lsn = lsn
            gauges.set("wal.lag_bytes", self.wal.lag_bytes())
            return True

    def close(self) -> None:
        self.wal.close()

    def debug_state(self) -> dict:
        d = self.wal.debug_state()
        d.update(checkpoint_lsn=self._ckpt_lsn,
                 recover_stats=dict(self.recover_stats))
        return d


def attach(store, dirpath: str, cfg=None) -> DurableKV:
    """Recover ``store`` from ``dirpath`` (snapshot + journal replay),
    then arm journaling on it — the one call that turns an in-memory
    KVStore into a durable one."""
    if cfg is None:
        from ..common.config import get_config
        cfg = get_config()
    dur = DurableKV(store, dirpath, fsync=cfg.wal_fsync,
                    fsync_interval_s=cfg.wal_fsync_interval_s,
                    segment_bytes=cfg.wal_segment_bytes,
                    retain=cfg.wal_retain_snapshots)
    dur._recover()
    store.bind_wal(dur)
    return dur


def recover(dirpath: str, store=None, cfg=None, device="cuda"):
    """Cold-start helper: build (or fill) a KVStore on ``device`` from
    the durable state at ``dirpath``; returns ``(store, stats)``."""
    if store is None:
        from .kv_store import KVStore
        store = KVStore(device=device)
    dur = attach(store, dirpath, cfg)
    return store, dur.recover_stats


# -- the process-lifetime trainer-side store ---------------------------------
#
# Like the obs server and the time-series sampler, the durable store is
# a PROCESS singleton: it survives suspend/resume (an elastic world
# change must not close and re-replay the journal) and is (re)opened by
# ``init()`` when BYTEPS_DURABLE_DIR is set.

_proc_lock = threading.Lock()
_proc: Optional[Tuple[Any, DurableKV]] = None


def ensure_process_store(cfg=None, device="cuda") -> Tuple[Any, DurableKV]:
    """Open (once per process) the durable trainer-side KVStore, on
    ``device``, under ``<durable_dir>/trainer``; later calls return the
    same pair."""
    global _proc
    if cfg is None:
        from ..common.config import get_config
        cfg = get_config()
    if not cfg.durable_dir:
        raise RuntimeError("BYTEPS_DURABLE_DIR is not set — there is no "
                           "durable state plane to open")
    with _proc_lock:
        if _proc is None:
            from .kv_store import KVStore
            store = KVStore(device=device)
            dur = attach(store, os.path.join(cfg.durable_dir, "trainer"),
                         cfg)
            _proc = (store, dur)
        return _proc


def recover_process_store(cfg=None, device="cuda"
                          ) -> Tuple[Any, DurableKV]:
    """Cold-start recovery of the trainer-side store: close any open
    incarnation and rebuild it from disk.  DESTRUCTIVE to a live
    incarnation: components already holding the old store object keep a
    reference that no longer journals, and any journal tail the chaos
    ``fsync`` site dropped is gone — only call this when no in-memory
    state is authoritative (``fault/recovery.py`` keeps a surviving
    process's open store and rebuilds only when none is open)."""
    global _proc
    with _proc_lock:
        if _proc is not None:
            _proc[1].close()
            _proc = None
    return ensure_process_store(cfg, device)


def process_store():
    """The open durable trainer-side store, or None."""
    return None if _proc is None else _proc[0]


def _reset_for_tests() -> None:
    global _proc
    with _proc_lock:
        if _proc is not None:
            try:
                _proc[1].close()
            except Exception:  # noqa: BLE001 — test teardown best-effort
                pass
            _proc = None
