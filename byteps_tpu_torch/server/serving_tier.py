"""Distributed serving tier: out-of-process serving hosts behind the wire;
port of ``byteps_tpu/server/serving_tier.py``.

The in-process plane (``server/serving.py``) answers from threads of the
trainer's process.  This module is the scale-out: real
**serving-host processes** (``server/serve_host.py``) behind the
supervised TCP transport, fed **snapshot cuts as per-key deltas** and
answering ``PullClient`` storms routed by a client-side
**consistent-hash ring** (``server/serve_ring.py``) — with **admission
control** so a storm degrades to bounded staleness instead of collapse,
and an autoscaler (``server/serve_autoscaler.py``) steering the host set
through the membership bus.

Four roles, one module:

**ServingHostCore** (runs inside each serving host): receives per-key
delta ships (sealed envelopes, hop ``serve_cut``) staged until a
``serve_commit`` atomically publishes a host-local
:class:`~.serving.Snapshot` — so a host holds ONLY its ring arcs' keys,
never the full model ("Automatic Cross-Replica Sharding of Weight
Update", PAPERS.md), and compressed keys travel wire-encoded with the
training codecs so DCN bytes scale with churn, not model size
("Compressed Communication for Distributed Training", PAPERS.md).
Pulls cross :class:`AdmissionControl` — a token bucket plus a
queue-depth watermark; an over-budget pull whose client is still inside
its own staleness bound is answered ``shed`` (keep serving your cache)
at near-zero cost, and a client that would exceed its bound is served
anyway (``serve.shed_bypass``): load-shedding degrades freshness, never
correctness.

**ServingTier** (runs beside the trainer): cuts COW snapshots of the
live :class:`~.kv_store.KVStore` (the machinery, unchanged) and
ships each host exactly the keys the ring assigns it whose version
advanced since the host's last commit — the delta/version-vector
protocol of ``SnapshotServer.pull``, turned around into a push.  Hosts
that fail consecutive ships are retired from the directory so the ring
heals without operator action.

**TierRouter** (one per :class:`~.serve_client.PullClient`): resolves
each key to its owner host on the ring, fails over along the arc's
replica successors, re-resolves the directory on ``ServeUnavailable``
(a dead host's arc remaps in one pull, not at the next cut), and merges
per-host slices into one reply.

**TierDirectory**: the membership-bus client (verbs ``serve_register``
/ ``serve_unregister`` / ``serve_dir`` / ``serve_scale``,
``fault/membership.py``) — hosts register with a TTL, consumers poll
the generation, and the autoscaler's proposals ride the same channel:
the ring follows MEMBERSHIP, not static config.

Where the port differs: a serving host decodes each shipped codec key at
receipt on its ``device`` (default ``"cuda"``: onebit's decompress is the
unpack kernel of ``csrc/onebit.cu``) and holds the decoded value as a
read-only host numpy array beside the shipped bytes, which it serves
unchanged; the publisher encodes a codec key on the store's device (the
pack kernel on a card).  Frames, commits and the persisted ``arc.bin``
are the JAX package's, byte for byte (codec dtypes as numpy dtype
strings), so a JAX host serves behind a port publisher and a port host
behind a JAX one.
"""

from __future__ import annotations

import itertools
import os
import pickle
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..comm.mesh import resolve_device
from ..common import integrity as _integrity
from ..common.lock_witness import named_lock
from ..common.logging import get_logger
from ..common.telemetry import counters, gauges
from ..fault import injector as _fault
from .serve_ring import ServeRing
from .kv_store import decode_on
from .serving import (ServeReply, ServeUnavailable, Snapshot, SnapshotRing,
                      SnapshotServer, SnapshotStore, encode_value,
                      numpy_dtype_str, torch_dtype)

__all__ = ["AdmissionControl", "ServingHostCore", "TierDirectory",
           "ServingTier", "TierRouter", "inproc_host", "SERVE_RANK_BASE",
           "assemble_shard_keys"]


def assemble_shard_keys(pull, name: str) -> np.ndarray:
    """Rebuild one shard-published parameter  from its
    per-owner keys: ``pull`` is any ``key -> ndarray`` callable — a
    :class:`~.kv_store.KVStore`'s ``pull``, a tier client wrapper, or
    ``snapshot.refs.__getitem__``.  Reads the ``{name}@shards``
    manifest (shard count, logical length, column width, shape) and
    concatenates the ``{name}@shard{i}`` slices in offset order; the
    result is bitwise the training master cast to the declared dtype —
    identical to what an unsharded cut of the full parameter would
    serve."""
    meta = np.asarray(pull(f"{name}@shards"))
    nshards, n = int(meta[0]), int(meta[1])
    shape = tuple(int(d) for d in meta[3:])
    parts = [np.asarray(pull(f"{name}@shard{i}")).reshape(-1)
             for i in range(nshards)]
    flat = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    return flat[:n].reshape(shape)

# serving hosts publish bus metrics at host_id + this base (one id space
# for bps_top rows, zero collision with trainer ranks)
from ..fault.membership import SERVE_RANK_BASE  # noqa: E402  (re-export)


# -- admission control -------------------------------------------------------


class AdmissionControl:
    """Per-host pull admission: a token bucket (``rate`` pulls/s refill,
    ``burst`` capacity) AND an in-flight queue-depth watermark.  Either
    tripping sheds.  ``rate=0`` disables the bucket (watermark only);
    the watermark cannot be disabled — unbounded queueing IS the
    collapse mode this exists to rule out.

    ``admit()`` is hot-path cheap: one lock, two float ops.  The
    decision is advisory — the caller chooses between a ``shed`` reply
    and a bypass (staleness floor), never an error."""

    def __init__(self, rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 queue_high: Optional[int] = None):
        from ..common.config import get_config
        cfg = get_config()
        self.rate = cfg.serve_tier_rate if rate is None else float(rate)
        b = cfg.serve_tier_burst if burst is None else float(burst)
        self.burst = b if b > 0 else max(self.rate, 1.0)
        self.queue_high = (cfg.serve_tier_queue_high if queue_high is None
                           else int(queue_high))
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = time.monotonic()
        self._inflight = 0

    def enter(self) -> int:
        with self._lock:
            self._inflight += 1
            return self._inflight

    def exit(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    @property
    def inflight(self) -> int:
        return self._inflight

    def admit(self) -> bool:
        with self._lock:
            if self._inflight > self.queue_high:
                return False
            if self.rate <= 0:
                return True
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {"rate": self.rate, "burst": self.burst,
                    "queue_high": self.queue_high,
                    "tokens": round(self._tokens, 2),
                    "inflight": self._inflight}


# -- the serving host (receiver side) ----------------------------------------


class _Staged:
    __slots__ = ("arr", "version", "codec", "enc")

    def __init__(self, arr, version, codec, enc):
        self.arr = arr
        self.version = version
        self.codec = codec       # (kwargs, numel, dtype_str) or None
        self.enc = enc           # wire-encoded bytes for codec keys


class ServingHostCore:
    """One serving host's state: staged delta ships, the committed
    snapshot ring, and the shed-aware pull path.

    Publication is two-phase: ``serve_cut`` frames stage (idempotent —
    a transport retransmit overwrites with identical bytes), then ONE
    ``serve_commit`` builds the snapshot — staged keys for advanced
    versions, carried-forward refs for unchanged ones — and publishes it
    atomically (the ring swap).  A reader on this host sees the
    previous complete cut or the new one, never a torn mix; a commit
    naming a version the host holds in neither place drops that key
    (``serve.tier_missing_keys``) and the publisher's un-acked ship
    state re-ships it at the next cut."""

    supports_shed = True

    def __init__(self, host_id: int = 0, *,
                 retention: Optional[int] = None,
                 admission: Optional[AdmissionControl] = None,
                 durable_dir: Optional[str] = None, device="cuda"):
        from ..common.config import get_config
        cfg = get_config()
        self.host_id = int(host_id)
        # where shipped codec keys are decoded (and, with no shipped
        # bytes cached, encoded)
        self.device = resolve_device(device)
        self.ring = SnapshotRing(cfg.serve_retention if retention is None
                                 else retention)
        # partial=True: this host holds its arcs, not the model — a key
        # it does not mirror must REFUSE so the router fails over
        self.server = SnapshotServer(self.ring, server_id=self.host_id,
                                     partial=True, device=self.device)
        self.admission = admission if admission is not None \
            else AdmissionControl()
        self._stage_lock = named_lock("serve_tier.stage")
        self._staged: Dict[str, _Staged] = {}
        self._last_commit = 0
        self._decoders: Dict[str, Tuple[tuple, object]] = {}
        self._pull_counts: Dict[str, int] = {}
        self.pulls = 0
        self.sheds = 0
        # graceful-drain latch (``serve_ctl drain``): the owning process
        # (serve_host.py main loop) watches it — marks the directory,
        # lets in-flight pulls finish, unregisters, exits clean
        self.draining = threading.Event()
        # durable arc (server/wal.py, ): when a durable dir is
        # configured, every committed snapshot is persisted atomically
        # and restored at construction — a restarted host rejoins with
        # its arc already published, so the publisher's next cut finds
        # every unchanged key carried forward and ships NOTHING
        # (restart-in-place without the full-arc DCN re-ship)
        dd = cfg.durable_dir if durable_dir is None else durable_dir
        self._arc_path = (os.path.join(dd, f"serve-{self.host_id}",
                                       "arc.bin") if dd else None)
        self.restored_commit = 0
        if self._arc_path is not None:
            self._restore_arc()
        from ..common import metrics as _metrics
        _metrics.register_component("serving_tier", self)

    # -- durable arc persistence (server/wal.py) ----------------------------

    def _persist_arc(self, snap: Snapshot) -> None:
        """Persist the committed snapshot atomically (sealed blob,
        write-to-temp + fsync + rename).  Best-effort AFTER the
        in-memory publish: a failing disk degrades restart-in-place to
        a full re-ship, never a failed commit."""
        from . import wal as _wal
        state = {"id": snap.id, "gen": snap.gen, "host_id": self.host_id,
                 "versions": dict(snap.versions),
                 "arrays": {k: np.array(a, copy=True)
                            for k, a in snap.refs.items()},
                 "codecs": {k: (dict(kw), numel, numpy_dtype_str(dt))
                            for k, (kw, _dec, numel, dt)
                            in snap.codecs.items()},
                 "enc": dict(snap.enc_cache)}
        blob = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        frame = _integrity.seal_bytes(blob, key="serve-arc", seq=snap.id)
        try:
            os.makedirs(os.path.dirname(self._arc_path), exist_ok=True)
            _wal._atomic_write(self._arc_path, frame)
        except OSError:
            counters.inc("wal.arc_save_failures")
            get_logger().error(
                "serve host %d: durable arc persist failed for commit "
                "%d — a restart re-ships the arc", self.host_id,
                snap.id, exc_info=True)
            return
        counters.inc("wal.arc_saves")

    def _restore_arc(self) -> None:
        """Cold-start restore of the last committed snapshot — runs in
        ``__init__`` so the host's ring is populated BEFORE it
        registers with the directory.  A blob that fails verification
        is quarantined (removed, counted), never published."""
        path = self._arc_path
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path, "rb") as fh:
                frame = fh.read()
            blob, _meta = _integrity.open_bytes(frame)
            # restricted unpickler (server/wal.py): the seal is CRC, not
            # authentication — a writable durable dir must not name
            # arbitrary callables
            from . import wal as _wal_mod
            state = _wal_mod._loads(blob)
            refs: Dict[str, np.ndarray] = {}
            for k, a in state["arrays"].items():
                arr = np.array(a, copy=True)
                arr.flags.writeable = False
                refs[k] = arr
            codecs = {}
            for k, (kw, numel, dtype_s) in state["codecs"].items():
                codecs[k] = (dict(kw),
                             self._decoder(k, (dict(kw), numel, dtype_s)),
                             numel, torch_dtype(dtype_s))
            snap = Snapshot(id=int(state["id"]), ts=time.monotonic(),
                            versions=dict(state["versions"]), refs=refs,
                            gen=int(state["gen"]), codecs=codecs,
                            enc_cache=dict(state.get("enc") or {}))
        except Exception as e:  # noqa: BLE001 — any failure here is a
            # corrupt or torn blob; restart-in-place degrades to the
            # full re-ship, never a half-restored arc
            counters.inc("wal.arc_corrupt")
            get_logger().error(
                "serve host %d: durable arc at %s failed verification "
                "(%s) — removed; the publisher re-ships the arc",
                self.host_id, path, e)
            from ..common import flight_recorder as _flight
            _flight.record("wal.arc_corrupt", host=self.host_id,
                           reason=str(e))
            try:
                os.remove(path)
            except OSError:
                pass
            return
        with self._stage_lock:
            self.ring.publish(snap)
            self._last_commit = snap.id
            self.restored_commit = snap.id
        counters.inc("wal.arc_restores")
        gauges.set("serve.snapshot_id", snap.id)
        from ..common import flight_recorder as _flight
        _flight.record("wal.arc_restored", host=self.host_id,
                       snapshot_id=snap.id, keys=len(refs))
        get_logger().warning(
            "serve host %d: restored committed arc from disk — "
            "snapshot %d, %d key(s) (restart-in-place, no re-ship)",
            self.host_id, snap.id, len(refs))

    # -- the publication path (transport hops land here) --------------------

    def _decoder(self, key: str, codec: tuple):
        kwargs, numel, dtype_s = codec
        sig = (tuple(sorted(kwargs.items())), numel, dtype_s)
        ent = self._decoders.get(key)
        if ent is None or ent[0] != sig:
            from ..compression import registry as reg
            ent = (sig, reg.create(dict(kwargs), numel,
                                   torch_dtype(dtype_s), for_server=True))
            self._decoders[key] = ent
        return ent[1]

    def receive_key(self, key: str, payload, meta: dict) -> None:
        """Stage one shipped key (hop ``serve_cut``): an ndarray for raw
        keys, wire-encoded codec bytes otherwise — decoded HERE, on the
        host's device, so the pull path serves materialized values, with
        the encoded bytes kept as the snapshot's encode cache (a client
        pulling the codec key gets the exact bytes the trainer shipped,
        zero re-compression)."""
        codec = meta.get("codec")
        if codec is not None:
            enc = bytes(payload)
            comp = self._decoder(key, tuple(codec))
            arr = decode_on(comp, enc, self.device).cpu().numpy()
            nbytes = len(enc)
        else:
            enc = None
            arr = np.array(payload, copy=True)
            nbytes = arr.nbytes
        arr.flags.writeable = False
        with self._stage_lock:
            self._staged[key] = _Staged(arr, int(meta["version"]),
                                        tuple(codec) if codec else None,
                                        enc)
        counters.inc("serve.tier_recv_keys")
        counters.inc("serve.tier_recv_bytes", nbytes)

    def commit(self, meta: dict) -> dict:
        """Publish one cut (hop ``serve_commit``): ``meta['versions']``
        is this host's FULL owned key->version map for the cut; staged
        entries satisfy advanced versions, the previous snapshot carries
        unchanged ones forward."""
        sid = int(meta["snapshot_id"])
        gen = int(meta.get("gen", 0))
        versions: Dict[str, int] = {k: int(v)
                                    for k, v in meta["versions"].items()}
        with self._stage_lock:
            if sid <= self._last_commit:
                # transport retransmit of an applied commit: idempotent
                return {"snapshot_id": self._last_commit, "dup": True}
            prev = self.ring.latest()
            refs: Dict[str, np.ndarray] = {}
            codecs: Dict[str, tuple] = {}
            enc: Dict[str, bytes] = {}
            kept: Dict[str, int] = {}
            dropped: List[str] = []
            for k, ver in versions.items():
                st = self._staged.get(k)
                if st is not None and st.version == ver:
                    refs[k] = st.arr
                    kept[k] = ver
                    if st.codec is not None:
                        kwargs, numel, dtype_s = st.codec
                        codecs[k] = (dict(kwargs),
                                     self._decoder(k, st.codec), numel,
                                     torch_dtype(dtype_s))
                        enc[k] = st.enc
                elif (prev is not None and prev.gen == gen
                        and prev.versions.get(k) == ver):
                    refs[k] = prev.refs[k]
                    kept[k] = ver
                    if k in prev.codecs:
                        codecs[k] = prev.codecs[k]
                        cached = prev.enc_cache.get(k)
                        if cached is not None:
                            enc[k] = cached
                else:
                    dropped.append(k)
            missing = len(dropped)
            # staged entries at or below the committed version are
            # consumed; newer ones (a racing next cut's early frames)
            # stay for THEIR commit
            for k in list(self._staged):
                st = self._staged[k]
                if st.version <= versions.get(k, st.version):
                    del self._staged[k]
            self._last_commit = sid
            snap = Snapshot(id=sid, ts=time.monotonic(), versions=kept,
                            refs=refs, gen=gen, codecs=codecs,
                            enc_cache=enc)
            self.ring.publish(snap)
        if self._arc_path is not None:
            self._persist_arc(snap)
        if missing:
            counters.inc("serve.tier_missing_keys", missing)
            get_logger().warning(
                "serve host %d: commit %d missing %d key(s) (neither "
                "staged nor carried) — re-shipped at the next cut",
                self.host_id, sid, missing)
        counters.inc("serve.tier_commits")
        gauges.set("serve.snapshot_id", sid)
        # the DROPPED key list travels back so the publisher acks only
        # what the host actually published — acking the full owned map
        # would mean a restarted host's holes (nothing staged, nothing
        # to carry forward) were never re-shipped until the key next
        # changed
        return {"snapshot_id": sid, "keys": len(kept), "missing": missing,
                "dropped": dropped}

    def control(self, meta: dict) -> dict:
        """Ring-aware chaos / management channel (hop ``serve_ctl``):
        ``chaos_arm`` installs a fault spec in THIS host mid-run — the
        harness partitions or throttles one serving host by ring
        identity while a storm is in flight, no restart, no cooperating
        schedule."""
        cmd = meta.get("cmd")
        if cmd == "chaos_arm":
            _fault.arm(meta["spec"], seed=int(meta.get("seed", 0)),
                       rank=self.host_id)
            return {"armed": meta["spec"]}
        if cmd == "chaos_disarm":
            _fault.disarm()
            return {"disarmed": True}
        if cmd == "drain":
            # graceful retirement (the reconciler's scale-down path):
            # flip the latch and ACK with the current in-flight depth —
            # the process-level state machine (serve_host.py) marks the
            # directory, finishes in-flight pulls, unregisters, exits.
            # Idempotent: a retransmitted drain finds the latch set.
            self.draining.set()
            counters.inc("serve.drain_requested")
            return {"draining": True,
                    "inflight": self.admission.inflight}
        if cmd == "arc_info":
            # durable restart-in-place (server/wal.py): the publisher
            # probes a fresh incarnation for what it already publishes
            # — a host restored from its on-disk arc answers with its
            # committed versions, and the publisher ships only the
            # drift instead of the full owned slice
            with self._stage_lock:
                snap = self.ring.latest()
                if snap is None:
                    return {"snapshot_id": 0, "gen": 0, "versions": {}}
                return {"snapshot_id": snap.id, "gen": snap.gen,
                        "versions": dict(snap.versions),
                        "restored": self.restored_commit}
        raise ValueError(f"unknown serve_ctl command {cmd!r}")

    # -- the read path -------------------------------------------------------

    def _can_shed(self, since_id: Optional[int],
                  max_stale_s: Optional[float]) -> bool:
        """Shedding is allowed only when the client keeps its OWN
        guarantee: its delta base is still retained, same generation,
        and young enough that "keep your cache" leaves it inside its
        staleness bound.  Anyone else is served despite the pressure."""
        if since_id is None:
            return False
        latest = self.ring.latest()
        base = self.ring.get(since_id)
        if latest is None or base is None or base.gen != latest.gen:
            return False
        from ..common.config import get_config
        bound = (get_config().serve_max_staleness_s if max_stale_s is None
                 else float(max_stale_s))
        return (latest.ts - base.ts) <= bound

    def pull(self, since_id: Optional[int] = None,
             keys: Optional[List[str]] = None,
             max_stale_s: Optional[float] = None) -> ServeReply:
        self.admission.enter()
        try:
            gauges.set("serve.tier_queue_depth", self.admission.inflight)
            if not self.admission.admit():
                if self._can_shed(since_id, max_stale_s):
                    self.sheds += 1
                    counters.inc("serve.shed")
                    return ServeReply(snapshot_id=since_id, full=False,
                                      items={}, wire_bytes=0,
                                      server_id=self.host_id, shed=True)
                counters.inc("serve.shed_bypass")
            if _fault.ENABLED:
                _fault.fire("serve_host")
                _fault.on_serve()
            reply = self.server.pull(since_id=since_id, keys=keys)
            self.pulls += 1
            # the established serving counter, emitted HERE too: the
            # bps_top PULLS and SHED% cells for a tier row are computed
            # from the host's published registry snapshot, not from the
            # in-process plane this host never runs
            counters.inc("serve.pulls")
            hot = keys if keys else list(reply.items)
            if hot:
                with self._stage_lock:
                    for k in hot:
                        self._pull_counts[k] = \
                            self._pull_counts.get(k, 0) + 1
            return reply
        finally:
            self.admission.exit()
            gauges.set("serve.tier_tokens", self.admission.snapshot()["tokens"])

    def hot_keys(self, top_n: int = 8) -> List[str]:
        with self._stage_lock:
            ranked = sorted(self._pull_counts.items(),
                            key=lambda kv: (-kv[1], kv[0]))
            return [k for k, c in ranked[:top_n] if c > 0]

    def debug_state(self) -> dict:
        snap = self.ring.latest()
        with self._stage_lock:
            staged = len(self._staged)
        return {"kind": "serving_host",
                "host_id": self.host_id,
                "snapshot_id": snap.id if snap is not None else None,
                "keys": len(snap.versions) if snap is not None else 0,
                "durable": self._arc_path is not None,
                "restored_commit": self.restored_commit,
                "staged": staged,
                "pulls": self.pulls,
                "sheds": self.sheds,
                "draining": self.draining.is_set(),
                "hot_keys": self.hot_keys(4),
                "admission": self.admission.snapshot()}


# -- in-process host registry (tests / single-process tiers) ----------------

_inproc: Dict[int, ServingHostCore] = {}
_inproc_lock = threading.Lock()
# every ServingTier/TierRouter that may own TcpEndpoints (they dial
# serving hosts DIRECTLY, outside transport.endpoint_to's cache, so the
# transport module's test reset cannot see them): weakly tracked so the
# test harness can close leaked supervisors between tests
_closables: "weakref.WeakSet" = weakref.WeakSet()


def inproc_host(core: Optional[ServingHostCore] = None,
                host_id: Optional[int] = None):
    """Register (or look up) an in-process serving host.  The publisher
    and router short-circuit transport for registered ids — the
    same-process fast path the loopback endpoint gives the training
    plane, so unit tests exercise the full stage/commit/shed protocol
    without sockets."""
    with _inproc_lock:
        if core is not None:
            _inproc[core.host_id] = core
            return core
        return _inproc.get(host_id)


def _close_endpoint(ep) -> None:
    """Best-effort endpoint teardown (shared by every drop site)."""
    try:
        ep.close(drain=False)
    except Exception:  # noqa: BLE001 — teardown best-effort
        pass


def _resolve_endpoint(host: int, addr, conn_kw: dict):
    """ONE endpoint-resolution policy for publisher and router alike:
    the in-process fast path when the host core lives here, else a
    supervised TCP endpoint at ``SERVE_RANK_BASE + host`` (the tier's
    peer-id namespace)."""
    core = inproc_host(host_id=host)
    if core is not None:
        return _InprocEndpoint(core)
    if addr is None:
        raise ServeUnavailable(f"serve host {host} has no address")
    from ..comm.transport import TcpEndpoint
    return TcpEndpoint(addr, peer=SERVE_RANK_BASE + host, **conn_kw)


class _InprocEndpoint:
    """Direct-call endpoint for a registered in-process host (protocol
    identical to the TCP hops, minus serialization)."""

    def __init__(self, core: ServingHostCore):
        self._core = core

    def serve_cut(self, key, payload, *, snapshot_id, version, codec=None,
                  deadline_s=None, gen=0):
        del snapshot_id, deadline_s, gen
        self._core.receive_key(key, payload,
                               {"version": version, "codec": codec})

    def serve_commit(self, *, snapshot_id, gen, versions, deadline_s=None):
        del deadline_s
        return self._core.commit({"snapshot_id": snapshot_id, "gen": gen,
                                  "versions": versions})

    def serve_ctl(self, **meta):
        return self._core.control(meta)

    def serve_pull(self, since_id=None, keys=None, max_stale_s=None,
                   deadline_s=None):
        del deadline_s
        return self._core.pull(since_id=since_id, keys=keys,
                               max_stale_s=max_stale_s)

    def close(self, drain=True):
        pass


# -- the directory (membership-bus client) -----------------------------------


class TierDirectory:
    """The serving-host directory: who is in the tier, at which address,
    as of which generation.

    Backed by the membership bus when ``bus`` (or
    ``BYTEPS_SERVE_TIER_BUS``) names one — registrations TTL out, the
    autoscaler's target proposal rides the same replies, and a
    coordinator failover carries the directory to the successor
    (``_replica_snapshot``).  With no bus it is a local in-process
    directory — single-process tiers and unit tests."""

    def __init__(self, bus=None, static_hosts=None,
                 ttl_s: Optional[float] = None,
                 poll_interval_s: float = 0.25):
        from ..common.config import get_config
        cfg = get_config()
        if bus is None and cfg.serve_tier_bus:
            bus = cfg.serve_tier_bus
        if isinstance(bus, str):
            host, port = bus.rsplit(":", 1)
            bus = (host, int(port))
        self.bus: Optional[Tuple[str, int]] = bus
        self.ttl_s = cfg.serve_tier_ttl_s if ttl_s is None else float(ttl_s)
        self._poll = poll_interval_s
        self._lock = threading.Lock()
        self._gen = 0
        self._hosts: Dict[int, Tuple[str, int]] = {}
        self._meta: Dict[int, dict] = {}
        self._probation: List[int] = []
        self._draining: List[int] = []
        self._victims: List[int] = []
        self._target: Optional[int] = None
        self._fetched = 0.0
        self._next_id = itertools.count(0)
        if static_hosts:
            for hid, addr in dict(static_hosts).items():
                self._hosts[int(hid)] = (str(addr[0]), int(addr[1]))
            self._gen = 1

    def _request(self, msg: dict) -> dict:
        from ..fault.membership import bus_request
        return bus_request(self.bus, msg, timeout=5.0)

    # -- registration (host side) -------------------------------------------

    def register(self, addr, host_id: Optional[int] = None,
                 meta: Optional[dict] = None,
                 draining: bool = False) -> int:
        """``draining=True`` marks the registration as mid graceful
        drain: the directory keeps the host visible (its in-flight pulls
        still need the address) but every consumer's :meth:`hosts` view
        excludes it, so no NEW pulls route there — the routing half of
        the ``serve_ctl drain`` protocol (docs/serving.md)."""
        addr = (str(addr[0]), int(addr[1]))
        if self.bus is None:
            with self._lock:
                if host_id is None:
                    host_id = (max(self._hosts) + 1 if self._hosts else 0)
                hid = int(host_id)
                changed = self._hosts.get(hid) != addr
                self._hosts[hid] = addr
                self._meta[hid] = dict(meta or {})
                if draining != (hid in self._draining):
                    if draining:
                        self._draining.append(hid)
                    else:
                        self._draining.remove(hid)
                    changed = True
                if changed:
                    self._gen += 1
                return hid
        reply = self._request({"op": "serve_register", "host_id": host_id,
                              "addr": list(addr), "ttl_s": self.ttl_s,
                              "draining": bool(draining),
                              "meta": meta or {}})
        if not reply.get("ok"):
            if reply.get("banned"):
                raise ConnectionError(
                    f"serve host {host_id} is banned for "
                    f"{reply.get('retry_after_s')}s (recently retired — "
                    "the publisher evicted it after ship failures)")
            raise ConnectionError(f"serve_register refused: {reply!r}")
        return int(reply["host_id"])

    def unregister(self, host_id: int,
                   ban_s: Optional[float] = None) -> None:
        if self.bus is None:
            with self._lock:
                hid = int(host_id)
                if self._hosts.pop(hid, None) is not None:
                    self._meta.pop(hid, None)
                    self._gen += 1
                if hid in self._draining:
                    self._draining.remove(hid)
                if hid in self._victims:
                    self._victims.remove(hid)
            return
        try:
            self._request({"op": "serve_unregister",
                           "host_id": int(host_id),
                           "ban_s": ban_s})
        except (ConnectionError, TimeoutError):
            # unreachable OR stalled (bus_request raises
            # MembershipTimeout, a TimeoutError, on a slow established
            # connection): TTL expiry finishes the job either way
            get_logger().warning("serve_unregister(%d) bus unreachable "
                                 "or stalled", host_id)

    # -- consumption (router / publisher / autoscaler side) -----------------

    def refresh(self, force: bool = False) -> None:
        if self.bus is None:
            return
        now = time.monotonic()
        with self._lock:
            if not force and now - self._fetched < self._poll:
                return
            self._fetched = now   # claim the poll slot before the wire
        try:
            reply = self._request({"op": "serve_dir"})
        except (ConnectionError, TimeoutError):
            # unreachable or stalled bus (MembershipTimeout is a
            # TimeoutError): keep the cached view — a bus hiccup must
            # degrade to stale routing, not fail a training push whose
            # write-driven cut landed here or a client read mid-_sync
            return
        if not reply.get("ok"):
            return
        with self._lock:
            self._gen = int(reply["gen"])
            self._hosts = {int(h): (v["addr"][0], int(v["addr"][1]))
                           for h, v in reply["hosts"].items()}
            self._meta = {int(h): dict(v.get("meta") or {})
                          for h, v in reply["hosts"].items()}
            self._probation = [int(r) for r in reply.get("probation") or ()]
            self._draining = [int(h) for h in reply.get("draining") or ()]
            self._victims = [int(h) for h in reply.get("victims") or ()]
            self._target = reply.get("target")

    def hosts(self, force: bool = False) -> Tuple[int, Dict[int,
                                                            Tuple[str, int]]]:
        """``(generation, PLACED hosts)`` — probationed hosts are
        excluded here, for PUBLISHER and ROUTER alike: a host the
        autoscaler demoted stops receiving cuts, so clients must stop
        reading its frozen snapshot too (the asymmetry would serve
        unboundedly stale data as fresh).  Probation changes bump the
        generation, so consumers re-sync exactly when it changes.  The
        raw registration list (probation included) is in
        :meth:`info`.  DRAINING hosts are excluded the same way: a
        draining host finishes its in-flight pulls but must receive no
        new ones — the gen bump at the drain mark re-syncs every
        consumer off its arc."""
        self.refresh(force=force)
        with self._lock:
            return self._gen, {h: a for h, a in self._hosts.items()
                               if h not in self._probation
                               and h not in self._draining}

    def info(self) -> dict:
        self.refresh()
        with self._lock:
            return {"gen": self._gen, "hosts": dict(self._hosts),
                    "meta": {h: dict(m) for h, m in self._meta.items()},
                    "probation": list(self._probation),
                    "draining": list(self._draining),
                    "victims": list(self._victims),
                    "target": self._target}

    def set_target(self, target: Optional[int]) -> None:
        if self.bus is None:
            with self._lock:
                self._target = target
            return
        self._request({"op": "serve_scale", "target": target})

    def set_probation(self, hosts) -> None:
        """Publish the serving-host probation set (autoscaler): rides
        the same ``serve_scale`` verb; the bus bumps the generation on
        change so every ring consumer re-routes the demoted arcs."""
        probation = sorted(int(h) for h in hosts)
        if self.bus is None:
            with self._lock:
                if set(probation) != set(self._probation):
                    self._probation = probation
                    self._gen += 1
            return
        self._request({"op": "serve_scale", "probation": probation})

    def propose_victims(self, hosts) -> None:
        """Publish the autoscaler's scale-down victim PROPOSALS (rides
        ``serve_scale`` like the target): the reconciler reads them from
        ``serve_dir`` and retires each through the graceful drain
        protocol instead of an immediate unregister.  No gen bump —
        routing only changes when a victim actually flips to
        DRAINING."""
        victims = sorted(int(h) for h in hosts)
        if self.bus is None:
            with self._lock:
                self._victims = [h for h in victims if h in self._hosts]
            return
        self._request({"op": "serve_scale", "victims": victims})

    def target(self) -> Optional[int]:
        self.refresh()
        with self._lock:
            return self._target


# -- the publisher (trainer side) --------------------------------------------


class ServingTier:
    """Ships the live store's cuts to the serving hosts and hands out
    ring-routed clients.  ``cut()`` is the publication point (manual, or
    write-driven via ``cut_interval_s`` exactly like the in-process
    plane); each host receives only the keys the ring assigns it whose
    versions advanced since its last acknowledged commit."""

    def __init__(self, store, *, bus=None, directory=None,
                 static_hosts=None, replicas: Optional[int] = None,
                 vnodes: Optional[int] = None,
                 retention: Optional[int] = None,
                 cut_interval_s: Optional[float] = None,
                 ship_deadline_s: float = 2.0,
                 fail_streak: int = 2,
                 conn_kw: Optional[dict] = None,
                 update_slots=None):
        from ..common.config import get_config
        cfg = get_config()
        self.store = store
        # codec keys are encoded on the store's device (the pack kernel
        # on a card)
        self.device = getattr(store, "device", None) or \
            resolve_device("cuda")
        # shard-published cuts : a mapping name -> slot, or a
        # zero-arg callable returning one; None auto-discovers the live
        # engine's sharded-update slots at each cut
        self._update_slots = update_slots
        self._pub_applied: Dict[str, int] = {}
        self.replicas = (cfg.serve_tier_replicas if replicas is None
                         else int(replicas))
        self.directory = directory if directory is not None else \
            TierDirectory(bus=bus, static_hosts=static_hosts)
        self.ring = ServeRing(vnodes=vnodes)
        self._gen = -1
        self._ship_deadline = float(ship_deadline_s)
        self._fail_streak = int(fail_streak)
        self._conn_kw = dict(conn_kw or {})
        self._lock = named_lock("serve_tier.pub")
        self._cut_serial = named_lock("serve_tier.cut")
        self._addrs: Dict[int, Tuple[str, int]] = {}
        self._shipped: Dict[int, Dict[str, int]] = {}
        self._fails: Dict[int, int] = {}
        self._eps: Dict[int, object] = {}
        self._owner_memo: Dict[object, List[int]] = {}
        self._probation: set = set()
        # one encoder per key of a cut: the per-host ship threads share
        # the snapshot's encode cache (the JAX publisher lets them race
        # and encode a key once per host)
        self._encode_lock = threading.Lock()
        # write-driven cutting runs on a DEDICATED publisher thread: a
        # tier cut SHIPS over the network (per-host threads joined up
        # to ship_deadline_s, plus a directory round trip) — inline in
        # the pusher's thread that would stall training pushes seconds
        # per cut whenever a host is dead or the bus is slow.  The
        # in-process plane's inline write-driven cut is fine because it
        # copies nothing; this one talks to real sockets.  The write
        # hook therefore only SIGNALS; bursts coalesce into one cut.
        self._cut_wake = threading.Event()
        self._cut_stop = threading.Event()
        self._cut_thread: Optional[threading.Thread] = None
        self.snapstore = SnapshotStore(store, retention=retention,
                                       cut_interval_s=cut_interval_s,
                                       cut_fn=self._request_cut,
                                       defer_subscribe=True)
        from ..common import metrics as _metrics
        _metrics.register_component("serving_tier", self)
        _closables.add(self)
        if cut_interval_s is not None:
            self._cut_thread = threading.Thread(
                target=self._cut_loop, daemon=True, name="bps-tier-pub")
            self._cut_thread.start()
        self.snapstore.attach()

    def _request_cut(self) -> None:
        self._cut_wake.set()

    def _cut_loop(self) -> None:
        while True:
            self._cut_wake.wait()
            if self._cut_stop.is_set():
                return
            self._cut_wake.clear()
            try:
                self.cut()
            except Exception:  # noqa: BLE001 — a failed publish must
                # not kill the publisher thread; the next write retries
                get_logger().error("serving tier: write-driven cut "
                                   "failed", exc_info=True)

    # -- membership ----------------------------------------------------------

    def refresh_directory(self, force: bool = False) -> None:
        gen, hosts = self.directory.hosts(force=force)
        with self._lock:
            if gen == self._gen:
                return
            self._gen = gen
            placed = set(hosts) - self._probation
            # a host re-registered under the SAME id at a NEW address is
            # a new incarnation (the reconciler's restart-in-place): its
            # staged state is gone, so the cached connection, the acked
            # map, and the fail streak all describe a dead process —
            # drop them, and the next cut re-ships the full owned slice
            moved = {h for h, a in hosts.items()
                     if h in self._addrs and self._addrs[h] != a}
            stale_eps = [self._eps.pop(h) for h in list(self._eps)
                         if h not in hosts or h in moved]
            for h in list(self._shipped):
                if h not in hosts or h in moved:
                    del self._shipped[h]
                    self._fails.pop(h, None)
            self._addrs = dict(hosts)
            self._owner_memo.clear()
        self.ring.set_hosts(placed)
        for ep in stale_eps:
            _close_endpoint(ep)
        gauges.set("serve.tier_hosts", len(self.ring))
        gauges.set("serve.tier_gen", gen)
        for h, share in self.ring.arc_share().items():
            gauges.set("serve.tier_arc_share", round(share, 4), host=h)

    def set_probation(self, hosts) -> None:
        """Exclude ``hosts`` from placement (the autoscaler's gray-
        failure signal): published THROUGH the directory (bus verb
        ``serve_scale``), so the publisher stops shipping AND every
        client router stops reading the demoted arcs — the one-sided
        version would leave clients pinned to a host whose snapshot no
        longer advances, serving unboundedly stale data as fresh.
        Demoted, not unregistered: a recovered host returns on the next
        probation clear without re-registering."""
        with self._lock:
            self._probation = {int(h) for h in hosts}
            self._gen = -1      # force a re-derive at the next cut
        try:
            self.directory.set_probation(hosts)
        except (ConnectionError, TimeoutError):
            get_logger().warning("serving tier: probation update could "
                                 "not reach the bus (will retry at the "
                                 "next autoscaler step)")
        self.refresh_directory(force=True)

    def _endpoint(self, host: int):
        with self._lock:
            ep = self._eps.get(host)
            addr = self._addrs.get(host)
        if ep is not None:
            return ep
        ep = _resolve_endpoint(host, addr, self._conn_kw)
        with self._lock:
            self._eps.setdefault(host, ep)
        return ep

    def retire_host(self, host: int, reason: str = "") -> None:
        """Drop a host NOW: unregister from the directory (gen bumps for
        every consumer) and heal the local ring without waiting for the
        TTL."""
        get_logger().warning("serving tier: retiring host %d (%s)", host,
                             reason)
        counters.inc("serve.tier_retired")
        # the ban outlives a few heartbeat periods: a retired host whose
        # control plane still beats must not flap back into the ring
        self.directory.unregister(host,
                                  ban_s=max(10.0,
                                            3 * self.directory.ttl_s))
        with self._lock:
            ep = self._eps.pop(host, None)
            self._shipped.pop(host, None)
            self._fails.pop(host, None)
            self._owner_memo.clear()
        self.ring.remove(host)
        if ep is not None:
            _close_endpoint(ep)

    # -- publication ---------------------------------------------------------

    def _update_slot_map(self) -> Dict[str, object]:
        src = self._update_slots
        if src is None:
            from ..core import api as _api
            eng = _api._engine
            return dict(getattr(eng, "update_slots", None) or {})
        return dict(src() if callable(src) else src)

    def _publish_update_slots(self) -> None:
        """Shard-published serving cut : under sharded update
        the parameters live as owner-resident flat shards inside the
        engine — there is no replicated copy to snapshot.  Each owner's
        slice is published into the store as its own key
        (``name@shard{i}``, plus a ``name@shards`` manifest for
        read-side reassembly, :func:`assemble_shard_keys`), so the ring
        routes every slice to its arc directly and NO step of this path
        allocates a full-parameter buffer (``ShardedUpdateSlot.
        export_shards`` reads per-device shards; ``publish_key``
        overwrites exactly — a delta-summed refresh would re-round).
        Slots whose ``applied`` counter has not advanced since the last
        cut publish nothing, so steady-state cuts are write-free."""
        try:
            slots = self._update_slot_map()
        except Exception:  # noqa: BLE001 — a torn-down engine mid-cut
            # must not fail the cut of everything else in the store
            get_logger().warning("serving tier: sharded-update slot "
                                 "discovery failed", exc_info=True)
            return
        for name, slot in sorted(slots.items()):
            applied = int(getattr(slot, "applied", 0))
            if self._pub_applied.get(name) == applied:
                continue
            shards = slot.export_shards()
            nbytes = 0
            # a port rank holds its own block (every block under a
            # parameter codec): each key is named by its owner block,
            # and the manifest counts every block of the vector
            for owner, _, arr in shards:
                self.store.publish_key(f"{name}@shard{owner}", arr)
                nbytes += arr.nbytes
            meta = np.array([-(-slot.n // slot.C), slot.n, slot.C]
                            + list(slot.out_shape), np.int64)
            self.store.publish_key(f"{name}@shards", meta)
            self._pub_applied[name] = applied
            counters.inc("serve.shard_publishes")
            counters.inc("serve.shard_publish_bytes", nbytes)

    def _replica_hosts(self, key) -> List[int]:
        memo = self._owner_memo.get(key)
        if memo is None:
            memo = self.ring.replica_hosts(key, self.replicas)
            self._owner_memo[key] = memo
        return memo

    def cut(self) -> Optional[Snapshot]:
        """Snapshot the store and ship every host its changed slice
        (concurrently — one slow host must not serialize the others
        behind its deadline).  Returns the snapshot, or None when the
        tier has no hosts yet."""
        with self._cut_serial:
            self.refresh_directory()
            self._publish_update_slots()
            hosts = sorted(self.ring.hosts())
            probes = self._probe_new_hosts(hosts)
            # a host that committed a higher snapshot id than this
            # publisher's next one (this publisher restarted over a
            # recovered store, its ids back at 1) would drop every
            # commit as a retransmit and serve its old cut: number this
            # cut past every id the hosts report
            self.snapstore.advance_ids(max(
                (int(i.get("snapshot_id", 0)) for i in probes.values()),
                default=0))
            snap = self.snapstore.cut()
            if not hosts:
                return snap
            results: Dict[int, bool] = {}
            threads = []
            for h in hosts:
                t = threading.Thread(target=self._ship_host,
                                     args=(h, snap, results,
                                           probes.get(h)),
                                     daemon=True,
                                     name=f"bps-tier-ship-{h}")
                threads.append(t)
                t.start()
            for t in threads:
                t.join()
            for h, ok in results.items():
                if ok:
                    self._fails[h] = 0
                    continue
                self._fails[h] = self._fails.get(h, 0) + 1
                if self._fails[h] >= self._fail_streak:
                    self.retire_host(h, reason="consecutive ship failures")
            return snap

    def _probe_new_hosts(self, hosts) -> Dict[int, dict]:
        """``arc_info`` of every host without ship history for its
        incarnation: what it already publishes (one restored from its
        durable arc answers with its committed versions).  A host that
        does not answer is left out: its ship is then the conservative
        full one."""
        with self._lock:
            new = [h for h in hosts if not self._shipped.get(h)]
        probes: Dict[int, dict] = {}

        def probe(h: int) -> None:
            try:
                probes[h] = self._endpoint(h).serve_ctl(cmd="arc_info")
            except Exception:  # noqa: BLE001 — the probe is best-effort
                pass

        # concurrently, as the ships: a dead host must not hold the
        # others' probes behind its deadline
        threads = [threading.Thread(target=probe, args=(h,), daemon=True,
                                    name=f"bps-tier-probe-{h}")
                   for h in new]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return probes

    def _encoded(self, snap: Snapshot, key: str, comp) -> bytes:
        """``key``'s codec frame in ``snap``, encoded on the store's
        device by the first ship thread that needs it."""
        wire = snap.enc_cache.get(key)
        if wire is None:
            with self._encode_lock:
                wire = snap.enc_cache.get(key)
                if wire is None:
                    wire = encode_value(comp, snap.refs[key], self.device)
                    snap.enc_cache[key] = wire
        return wire

    def _ship_host(self, host: int, snap: Snapshot,
                   results: Dict[int, bool],
                   probe: Optional[dict] = None) -> None:
        owned = [k for k in snap.versions
                 if host in self._replica_hosts(k)]
        with self._lock:
            acked = dict(self._shipped.get(host, {}))
        shipped_bytes = 0
        try:
            ep = self._endpoint(host)
            if (not acked and probe is not None
                    and int(probe.get("gen", -1)) == snap.gen):
                # no ship history for this incarnation: the host's probe
                # (taken before the cut) names what it already publishes
                # (restored from its durable arc, server/wal.py), and
                # only the drift ships
                acked = {k: int(v) for k, v in
                         (probe.get("versions") or {}).items()}
                if acked:
                    counters.inc("wal.arc_probe_hits")
            changed = [k for k in owned if acked.get(k) != snap.versions[k]]
            for k in changed:
                info = snap.codecs.get(k)
                if info is not None:
                    kwargs, comp, numel, dtype = info
                    wire = self._encoded(snap, k, comp)
                    ep.serve_cut(k, wire, snapshot_id=snap.id,
                                 version=snap.versions[k],
                                 codec=(dict(kwargs), numel,
                                        numpy_dtype_str(dtype)),
                                 deadline_s=self._ship_deadline)
                    shipped_bytes += len(wire)
                else:
                    ep.serve_cut(k, snap.refs[k], snapshot_id=snap.id,
                                 version=snap.versions[k],
                                 deadline_s=self._ship_deadline)
                    shipped_bytes += snap.refs[k].nbytes
            reply = ep.serve_commit(
                snapshot_id=snap.id, gen=snap.gen,
                versions={k: snap.versions[k] for k in owned},
                deadline_s=self._ship_deadline)
        except Exception as e:  # noqa: BLE001 — a dead host fails ITS
            # ship; the commit was never sent, so the host's previous
            # snapshot stays live and nothing is half-published
            counters.inc("serve.tier_ship_failures")
            get_logger().warning("serving tier: ship to host %d failed: %s",
                                 host, e)
            results[host] = False
            return
        # ack only what the host actually PUBLISHED: keys it reported
        # dropped (e.g. a restarted host with nothing to carry forward)
        # stay un-acked and re-ship at the next cut.  A dup reply (this
        # commit was a retransmit) carries no drop list — keep the
        # previous acks and let the next cut reconcile.
        if not reply.get("dup"):
            dropped = set(reply.get("dropped") or ())
            with self._lock:
                self._shipped[host] = {k: snap.versions[k] for k in owned
                                       if k not in dropped}
        counters.inc("serve.tier_ships")
        counters.inc("serve.tier_ship_bytes", shipped_bytes)
        results[host] = True

    # -- clients -------------------------------------------------------------

    def client(self, keys: Optional[List[str]] = None, **kw):
        """A staleness-bounded :class:`~.serve_client.PullClient` routed
        by the tier's ring (fresh router per client — the router keeps
        per-host delta bases)."""
        from .serve_client import PullClient
        router = TierRouter(self.directory, replicas=self.replicas,
                            conn_kw=self._conn_kw,
                            pull_deadline_s=kw.pop("pull_deadline_s",
                                                   self._ship_deadline))
        kw.setdefault("stale_on_error", True)
        return PullClient(router, keys=keys, **kw)

    # -- lifecycle / observability -------------------------------------------

    def close(self) -> None:
        self.snapstore.detach()
        self._cut_stop.set()
        self._cut_wake.set()
        if self._cut_thread is not None:
            self._cut_thread.join(timeout=10)
        with self._lock:
            eps = list(self._eps.values())
            self._eps.clear()
        for ep in eps:
            _close_endpoint(ep)

    def debug_state(self) -> dict:
        snap = self.snapstore.ring.latest()
        with self._lock:
            fails = dict(self._fails)
            shipped = {h: len(v) for h, v in self._shipped.items()}
            probation = sorted(self._probation)
        return {"kind": "serving_tier",
                "gen": self._gen,
                "hosts": sorted(self.ring.hosts()),
                "replicas": self.replicas,
                "snapshot_id": snap.id if snap is not None else None,
                "arc_share": {h: round(s, 4)
                              for h, s in self.ring.arc_share().items()},
                "shipped_keys": shipped,
                "fail_streaks": fails,
                "probation": probation}


# -- the router (client side) ------------------------------------------------


class TierRouter:
    """Plane-shaped router for ONE :class:`~.serve_client.PullClient`:
    resolves keys to hosts on the ring, keeps a per-host delta base
    (``since_id`` is per HOST — each host numbers its own snapshots),
    fails over along each key's replica arc, and merges the per-host
    slices into one reply with a synthetic monotonic snapshot id.

    On ``ServeUnavailable`` from every candidate the client's refresh
    calls :meth:`reroute` — a FORCED directory re-sync — and retries, so
    a dead host's arc remaps within one pull instead of parking on the
    corpse until the next cut (the single-flight background refresh used
    to do exactly that)."""

    accepts_max_stale = True
    client_owned = True     # one router per PullClient; client.close()
    #                         closes it (supervised connections inside)

    def __init__(self, directory: TierDirectory, *,
                 replicas: Optional[int] = None,
                 vnodes: Optional[int] = None,
                 conn_kw: Optional[dict] = None,
                 pull_deadline_s: float = 2.0,
                 sync_interval_s: float = 0.25):
        from ..common.config import get_config
        cfg = get_config()
        self.directory = directory
        self.replicas = (cfg.serve_tier_replicas if replicas is None
                         else int(replicas))
        self.ring = ServeRing(vnodes=vnodes)
        self._conn_kw = dict(conn_kw or {})
        self._deadline = float(pull_deadline_s)
        self._sync_every = float(sync_interval_s)
        self._lock = threading.Lock()
        self._gen = -1
        self._addrs: Dict[int, Tuple[str, int]] = {}
        self._eps: Dict[int, object] = {}
        self._owner_memo: Dict[object, List[int]] = {}
        self._since: Dict[int, Optional[int]] = {}
        self._synced = 0.0
        self._ids = itertools.count(1)
        self.host_pulls: Dict[int, int] = {}
        _closables.add(self)
        # whole-model routing state: the key universe learned from
        # replies.  Once known, a keys=None pull asks each key's OWNER
        # only (a key lives on R hosts; fanning keys=None everywhere
        # would ship every changed key R times), with one ROTATING host
        # per pull still serving its whole slice so keys that appear
        # later are discovered within ~N pulls.
        self._known: set = set()
        self._disc = 0

    def _sync(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if not force and now - self._synced < self._sync_every \
                    and self._gen >= 0:
                return
            self._synced = now
        gen, hosts = self.directory.hosts(force=force)
        with self._lock:
            if gen == self._gen:
                return
            self._gen = gen
            # same-id re-registration at a new address = a RESTARTED
            # host (new incarnation): the cached connection dials a dead
            # port and the delta base refers to the old process's
            # snapshot numbering — both must go, or every pull to the
            # arc parks on the corpse / reads a bogus delta
            moved = {h for h, a in hosts.items()
                     if h in self._addrs and self._addrs[h] != a}
            self._addrs = dict(hosts)
            self._owner_memo.clear()
            dead_eps = [self._eps.pop(h) for h in list(self._eps)
                        if h not in hosts or h in moved]
            for h in list(self._since):
                if h not in hosts or h in moved:
                    del self._since[h]
        self.ring.set_hosts(hosts)
        for ep in dead_eps:
            _close_endpoint(ep)

    def reroute(self) -> None:
        """Forced re-resolution (the ``ServeUnavailable`` path)."""
        self._sync(force=True)

    def _endpoint(self, host: int):
        with self._lock:
            ep = self._eps.get(host)
            addr = self._addrs.get(host)
        if ep is not None:
            return ep
        ep = _resolve_endpoint(host, addr, self._conn_kw)
        with self._lock:
            self._eps.setdefault(host, ep)
        return ep

    def _replica_hosts(self, key) -> List[int]:
        """Gen-memoized replica set (the publisher keeps the identical
        memo): the hot read path must not re-hash and re-walk the ring
        for every known key on every pull when routing only changes
        with the directory generation."""
        memo = self._owner_memo.get(key)
        if memo is None:
            memo = self.ring.replica_hosts(key, self.replicas)
            self._owner_memo[key] = memo
        return memo

    def _pull_group_salvaged(self, cands: Sequence[int], klist,
                             max_stale_s) -> List[ServeReply]:
        """One owner group, with the per-key fallback: grouped keys can
        have DIFFERENT replica successors (A's set [0,1], B's [0,2]),
        so when the shared candidate chain is exhausted — e.g. the
        owner died and the first successor mirrors only some of the
        group — each key retries along its OWN arc before the group is
        declared unreadable.  The salvage first FORCES a directory
        re-sync and skips the candidates that already failed: paying a
        dead owner's full deadline again for every key would turn one
        host failure into a many-second pull that quietly outlives the
        staleness bound."""
        try:
            return [self._pull_group(cands, klist, max_stale_s)]
        except ServeUnavailable:
            if not klist or len(klist) == 1:
                raise
        failed = set(cands)
        self.reroute()
        out = []
        for k in klist:
            chain = [h for h in self._replica_hosts(k)
                     if h not in failed]
            if not chain:
                raise ServeUnavailable(
                    f"no live replica for key {k!r} after owner "
                    "failure")
            out.append(self._pull_group(chain, [k], max_stale_s))
        return out

    def _pull_group(self, cands: Sequence[int], klist,
                    max_stale_s) -> ServeReply:
        last_exc: Optional[BaseException] = None
        for i, h in enumerate(cands):
            if i > 0:
                counters.inc("serve.tier_failover")
            try:
                ep = self._endpoint(h)
                t0 = time.perf_counter()
                r = ep.serve_pull(since_id=self._since.get(h), keys=klist,
                                  max_stale_s=max_stale_s,
                                  deadline_s=self._deadline)
            except ServeUnavailable as e:
                last_exc = e
                continue
            dt = time.perf_counter() - t0
            from ..utils import slowness as _slowness
            _slowness.tracker().observe(h, dt, site="serve_pull")
            with self._lock:
                self._since[h] = r.snapshot_id
                self.host_pulls[h] = self.host_pulls.get(h, 0) + 1
            return r
        raise last_exc if last_exc is not None else ServeUnavailable(
            "serve ring has no candidates")

    def pull(self, since_id: Optional[int] = None,
             keys: Optional[List[str]] = None, record: bool = True,
             hedge: Optional[bool] = None,
             max_stale_s: Optional[float] = None) -> ServeReply:
        # the caller's since_id is its COMPOSITE id — per-host bases are
        # this router's own bookkeeping; record/hedge are plane-router
        # concerns (hotness lives host-side, failover replaces hedging)
        del since_id, record, hedge
        self._sync()
        if not len(self.ring):
            raise ServeUnavailable("serving tier has no hosts")
        groups: Dict[int, Optional[List[str]]] = {}
        cands: Dict[int, List[int]] = {}
        if keys is None:
            with self._lock:
                known = sorted(self._known)
            hosts = sorted(self.ring.hosts())
            if not known:
                # hydration: every host serves its whole slice once
                for h in hosts:
                    groups[h] = None
                    cands[h] = [h]
            else:
                self._disc = (self._disc + 1) % len(hosts)
                disc = hosts[self._disc]
                groups[disc] = None          # the discovery slice
                cands[disc] = [disc]
                for k in known:
                    rh = self._replica_hosts(k)
                    if rh[0] == disc:
                        continue             # covered by the slice
                    g = groups.setdefault(rh[0], [])
                    if g is not None:
                        g.append(k)
                    cands.setdefault(rh[0], rh)
        else:
            for k in keys:
                rh = self._replica_hosts(k)
                g = groups.setdefault(rh[0], [])
                if g is not None:
                    g.append(k)
                cands[rh[0]] = rh
        replies = self._fan_out(groups, cands, max_stale_s)
        if keys is None and replies:
            with self._lock:
                for r in replies:
                    self._known.update(r.items)
        return self._merge(replies)

    def _fan_out(self, groups: Dict[int, Optional[List[str]]],
                 cands: Dict[int, List[int]],
                 max_stale_s) -> List[ServeReply]:
        """Pull every host group CONCURRENTLY: one slow or partitioned
        owner must not serialize the other slices behind its full pull
        deadline (the publisher ships per-host concurrently for the
        same reason).  A single-group pull skips the thread."""
        order = list(groups)
        if len(order) == 1:
            h = order[0]
            return self._pull_group_salvaged(cands[h], groups[h],
                                             max_stale_s)
        results: Dict[int, List[ServeReply]] = {}
        errors: Dict[int, BaseException] = {}

        def run(h: int) -> None:
            try:
                results[h] = self._pull_group_salvaged(cands[h],
                                                       groups[h],
                                                       max_stale_s)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[h] = e

        threads = [threading.Thread(target=run, args=(h,), daemon=True,
                                    name="bps-tier-pull")
                   for h in order]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[min(errors)]
        return [r for h in order for r in results[h]]

    def _merge(self, replies: List[ServeReply]) -> ServeReply:
        items: Dict[str, object] = {}
        wire = 0
        for r in replies:
            wire += r.wire_bytes
            for k, it in r.items.items():
                prev = items.get(k)
                if prev is None or it.version > prev.version:
                    items[k] = it
        # full only when EVERY host answered full and none shed: a
        # whole-model client prunes cache keys absent from a full reply,
        # and a shed host's keys are absent by design, not deletion
        any_shed = any(r.shed for r in replies)
        all_shed = bool(replies) and all(r.shed for r in replies)
        return ServeReply(
            snapshot_id=next(self._ids),
            full=bool(replies) and all(r.full and not r.shed
                                       for r in replies),
            items=items, wire_bytes=wire, server_id=-1,
            shed=all_shed,
            shed_partial=any_shed and not all_shed)

    def close(self) -> None:
        with self._lock:
            eps = list(self._eps.values())
            self._eps.clear()
        for ep in eps:
            _close_endpoint(ep)


def _reset_for_tests() -> None:
    with _inproc_lock:
        _inproc.clear()
    for obj in list(_closables):
        try:
            obj.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
