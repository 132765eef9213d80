"""Parameter-serving plane: versioned snapshots, delta pulls, replicas;
port of ``byteps_tpu/server/serving.py``.

The trajectory so far only ever *trains*: every byte the KV store moves
is a push.  The ROADMAP's north star also **serves** — inference fleets,
feature stores, and continuous-learning consumers pulling fresh
parameters while training pushes continue (ROADMAP open item 4).  This
module is that read plane, layered on :class:`~.kv_store.KVStore`
without touching its write semantics:

**Versioned snapshots** (:class:`SnapshotStore`): a snapshot is a
consistent copy-on-write cut of the whole store at a monotonic
``snapshot_id`` with a per-key version vector.  Cutting copies NOTHING —
``KVStore.snapshot_refs`` marks every key COW under one lock
acquisition, and later pushes replace arrays instead of mutating them,
so a snapshot's arrays stay frozen while the push path keeps running.
Publication is atomic (one ring swap under a lock): a reader either
sees the previous complete snapshot or the new complete snapshot, never
a torn multi-key cut.  Retention is bounded (``BYTEPS_SERVE_RETENTION``).

**Delta pulls** (:meth:`SnapshotServer.pull`): a pull carries the
client's last ``snapshot_id``; the reply ships only keys whose version
advanced since — wire-encoded with the key's registered training codec
when one exists ("Compressed Communication for Distributed Training",
PAPERS.md: reuse the push-path codecs on the read path, turning pull
fan-out from O(model) to O(churn) bytes).  Every reply payload crosses
the sealed-envelope hop with NACK/bounded-retransmit at chaos site
``serve_pull``.  A ``since_id`` that aged out of retention falls back to
a full snapshot (``serve.full_pulls``).

**Hot-key replication** (:class:`ServingPlane` +
``ServerAssigner.replica_set``): keys hot by pull-count histogram are
mirrored to ``BYTEPS_SERVE_REPLICAS`` shards at each cut; reads fan
across the replica endpoints round-robin, writes stay primary-routed,
and a dead replica degrades to primary-served reads
(``serve.replica_fallback``) instead of erroring.  Elastic world
changes re-clamp the endpoint set and rebuild the replica sets
(``ServerAssigner.reshard`` keeps the pull histogram).

**Staleness-bounded async pulls** live client-side in
:mod:`~byteps_tpu_torch.server.serve_client`.

All ``serve.*`` counters/gauges land in the metrics registry, so
they ride ``/metrics``, ``cluster_metrics()``, and ``bps_top``.

Where the port differs: a snapshot's refs are read-only numpy views of
the store's host tensors (``KVStore.snapshot_refs``), so every reply,
frame and cut is the JAX plane's.  A compressed key is encoded as the
JAX plane encodes it, ``comp.wire_encode(comp.compress(value,
comp.init_state())[0])`` with the codec the snapshot captured, on the
plane's ``device`` (default the store's): on the card onebit's compress
is the pack kernel of ``csrc/onebit.cu``.  A codec's dtype travels as
the numpy dtype string (``"<f4"``), as in the JAX reply.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..comm.mesh import resolve_device
from ..common import integrity as _integrity
from ..common.lock_witness import named_lock
from ..common import tracing as _tracing
from ..common.logging import get_logger
from ..common.telemetry import counters, gauges, histograms
from ..fault import injector as _fault
from ..utils.slowness import LatencyQuantile
from ..utils import slowness as _slowness
from .kv_store import KVStore
from .sharding import ServerAssigner

__all__ = ["ServeUnavailable", "Snapshot", "SnapshotRing", "SnapshotStore",
           "ServeItem", "ServeReply", "SnapshotServer", "ServingPlane",
           "active_planes", "notify_world_change", "encode_value",
           "numpy_dtype_str", "torch_dtype"]


def numpy_dtype_str(dtype) -> str:
    """A codec dtype (torch or numpy) as the numpy dtype string the
    serving wire carries (``"<f4"``)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype.str
    return np.dtype(dtype).str


def torch_dtype(dtype_s) -> torch.dtype:
    """The torch dtype of a serving-wire dtype string."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype_s))).dtype


def encode_value(comp, value, device: torch.device) -> bytes:
    """A snapshot value's codec frame, as the JAX plane makes it:
    ``wire_encode(compress(value, init_state())[0])`` over the flat
    value, computed on ``device``."""
    x = torch.tensor(np.asarray(value), device=device).reshape(-1)
    payload, _ = comp.compress(x, comp.init_state(device))
    return comp.wire_encode(payload)


class ServeUnavailable(ConnectionError):
    """The addressed serving endpoint cannot answer (dead replica, or no
    snapshot published yet).  The plane's router treats it as a routing
    signal — fall to the next replica, then the primary — never as a
    client-visible failure while any endpoint lives."""


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One immutable cut of the store.  ``refs`` are read-only
    copy-on-write views (see ``KVStore.snapshot_refs``) — holding a
    snapshot costs no memory until training pushes to its keys.

    ``enc_cache`` memoizes codec wire encodings per key: the arrays are
    frozen, so N clients refreshing against the same cut must not pay N
    identical compressions (replica mirrors SHARE the primary
    snapshot's cache).  Benign race: concurrent encoders of the same
    key compute the same bytes and one write wins."""

    id: int
    ts: float
    versions: Dict[str, int]
    refs: Dict[str, np.ndarray]
    # store generation at cut time (KVStore.clear() bumps it): a delta
    # base from another generation is unusable — versions restarted
    gen: int = 0
    # codecs captured at cut time (one store-lock acquisition per cut),
    # so serving a pull never touches the live store lock
    codecs: Dict[str, tuple] = dataclasses.field(default_factory=dict,
                                                 compare=False)
    enc_cache: Dict[str, bytes] = dataclasses.field(default_factory=dict,
                                                    compare=False)


class SnapshotRing:
    """Bounded retention ring with atomic publish: ``latest()`` swaps in
    one reference assignment under the lock, so a concurrent reader gets
    either the previous complete snapshot or the new one — a torn
    multi-key view is structurally impossible."""

    def __init__(self, retention: int):
        if retention < 1:
            raise ValueError("retention must be >= 1")
        self.retention = retention
        self._lock = named_lock("serve.ring")
        self._snaps: "collections.OrderedDict[int, Snapshot]" = \
            collections.OrderedDict()
        self._latest: Optional[Snapshot] = None

    def publish(self, snap: Snapshot) -> None:
        with self._lock:
            self._snaps[snap.id] = snap
            while len(self._snaps) > self.retention:
                del self._snaps[min(self._snaps)]   # oldest id, not
                #                                     oldest insertion
            if self._latest is None or snap.id >= self._latest.id:
                # never regress: a racing out-of-order publish must not
                # move readers back in time
                self._latest = snap

    def latest(self) -> Optional[Snapshot]:
        with self._lock:
            return self._latest

    def get(self, snapshot_id: int) -> Optional[Snapshot]:
        with self._lock:
            return self._snaps.get(snapshot_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._snaps)


class SnapshotStore:
    """Cuts consistent snapshots of a :class:`KVStore` into a
    :class:`SnapshotRing`.

    With ``cut_interval_s`` set, the store's write-subscription hook
    drives cutting: each consistent write point (push, or
    ``write_batch`` exit) cuts a fresh snapshot unless one younger than
    the interval exists — the cut itself runs in the pusher's thread
    AFTER the store lock is released, and copies nothing (COW).
    ``cut_fn`` lets an owner substitute its own publication step for
    the throttled cut (``ServingPlane`` passes its replica-mirroring
    ``cut`` so write-driven cutting feeds the replicas too); the
    interval throttle lives HERE either way.  :meth:`detach` removes
    the store subscription — subscribers are strongly referenced, so a
    dropped owner must detach or the store pins it forever."""

    def __init__(self, store: KVStore, retention: Optional[int] = None,
                 cut_interval_s: Optional[float] = None, cut_fn=None,
                 defer_subscribe: bool = False):
        from ..common.config import get_config
        cfg = get_config()
        self.store = store
        self.ring = SnapshotRing(cfg.serve_retention if retention is None
                                 else retention)
        self._next_id = 1
        self._cut_lock = named_lock("serve.cut_throttle")
        self._last_cut = 0.0
        self._interval = cut_interval_s
        self._cut_fn = cut_fn if cut_fn is not None else self.cut
        self._subscribed = False
        if cut_interval_s is not None and not defer_subscribe:
            self.attach()

    def attach(self) -> None:
        """Install the write subscription (idempotent).  Split out of
        ``__init__`` so an owner passing ``cut_fn`` into itself can
        finish constructing BEFORE a pusher thread's write hook can
        call back into it (``defer_subscribe=True``)."""
        if not self._subscribed and self._interval is not None:
            self._subscribed = True
            self.store.subscribe(self._on_write)

    def detach(self) -> None:
        """Stop write-driven cutting (idempotent)."""
        if self._subscribed:
            self._subscribed = False
            self.store.unsubscribe(self._on_write)

    def cut(self) -> Snapshot:
        """Cut and atomically publish a snapshot of the store NOW.
        Serialized (concurrent cutters coalesce into a strict id order);
        the store lock is held only for the COW reference grab inside
        ``snapshot_refs`` — never while anything is copied."""
        with self._cut_lock:
            refs, gen = self.store.snapshot_refs()
            sid, self._next_id = self._next_id, self._next_id + 1
            snap = Snapshot(id=sid, ts=time.monotonic(),
                            versions={k: v for k, (_, v) in refs.items()},
                            refs={k: a for k, (a, _) in refs.items()},
                            gen=gen, codecs=self.store.codec_infos())
            self.ring.publish(snap)
            self._last_cut = snap.ts
        counters.inc("serve.snapshot_cuts")
        gauges.set("serve.snapshot_id", snap.id)
        gauges.set("serve.snapshots_retained", len(self.ring))
        # durable state plane (server/wal.py): a store with durability
        # attached persists this cut atomically and truncates the
        # journal it covers — every published snapshot is also the
        # bound on cold-start replay cost.  AFTER publish, outside the
        # cut lock's critical copy path: a failed disk must not fail
        # the in-memory publication readers are waiting on.
        dur = getattr(self.store, "_durable", None)
        if dur is not None:
            try:
                dur.checkpoint()
            except OSError:
                get_logger().error(
                    "serving: durable checkpoint failed after cut %d — "
                    "the journal keeps the history until a later cut "
                    "lands", snap.id, exc_info=True)
        return snap

    def advance_ids(self, past: int) -> None:
        """Number the next cut above ``past`` (a publisher restarted over
        a recovered store meets serving hosts that committed its earlier
        incarnation's ids: ``serving_tier.ServingTier.cut``)."""
        with self._cut_lock:
            self._next_id = max(self._next_id, int(past) + 1)

    def _on_write(self, key: str, version: int) -> None:
        del key, version  # the cut covers the whole store regardless
        if (self._interval is None
                or time.monotonic() - self._last_cut < self._interval):
            return
        self._cut_fn()


@dataclasses.dataclass
class ServeItem:
    """One key in a pull reply.  ``payload`` is the verified wire
    payload: an ndarray for raw keys, the codec's encoded bytes for
    compressed keys (``codec`` then carries the kwargs/numel/dtype the
    client rebuilds its decoder from).  ``wire_nbytes`` is the
    wire-ENCODED size — the figure delta-pull byte accounting is
    denominated in."""

    payload: object
    version: int
    wire_nbytes: int
    codec: Optional[Tuple[dict, int, str]] = None


@dataclasses.dataclass
class ServeReply:
    snapshot_id: int
    full: bool
    items: Dict[str, ServeItem]
    wire_bytes: int
    server_id: int
    # admission control (server/serving_tier.py): True = the host shed
    # this pull — "keep serving your cache, it is still inside your
    # staleness bound" — a deliberate near-zero-cost answer, not data.
    # The plane's in-process endpoints never shed.
    shed: bool = False
    # router-local (never on the wire): SOME of the merged per-host
    # replies were shed.  The client applies the fresh slices but must
    # NOT advance its freshness clock — the shed hosts' keys are only
    # guaranteed inside the bound as of NOW, not for another full bound
    shed_partial: bool = False


class SnapshotServer:
    """One serving endpoint (the primary, or a replica mirror) answering
    pulls from a snapshot ring.  Every payload crosses the
    chaos-instrumented ``serve_pull`` envelope hop on the way out —
    same NACK/retransmit machine as the push paths."""

    def __init__(self, ring: SnapshotRing, store: Optional[KVStore] = None,
                 server_id: int = 0, partial: bool = False, device=None):
        self.ring = ring
        # where a codec key's value is encoded: the caller's device, else
        # the store's, else the card
        self.device = (resolve_device(device) if device is not None
                       else store.device if store is not None
                       else resolve_device("cuda"))
        self.store = store  # back-reference only; codecs ride each
        #                     snapshot (captured at cut time), so the
        #                     read path never touches the store lock
        self.server_id = server_id
        # a PARTIAL endpoint (replica mirror) holds a hot-key subset:
        # asked for a key outside its snapshot it must REFUSE (the
        # router falls through to the primary) — silently skipping the
        # key would stamp the reply with a snapshot id whose version
        # vector already covers the key, and the missed update would
        # never be re-shipped until the key next changes
        self.partial = partial
        self.alive = True
        # gray-failure chaos hook (docs/gray_failures.md): a per-ENDPOINT
        # sustained delay — the slow-but-alive serving replica the
        # hedged-pull path exists for (the injector's `slow` kind is
        # per-process; this hook throttles ONE endpoint of a plane)
        self.delay_s = 0.0

    def kill(self) -> None:
        """Chaos hook: the endpoint stops answering (a dead replica)."""
        self.alive = False

    def revive(self) -> None:
        self.alive = True

    # -- the reply wire hop -------------------------------------------------

    def _ship(self, key: str, payload, sid: int, nbytes: int, opener,
              sealer):
        """The reply hop for one key's payload: sealed envelope +
        NACK/retransmit at site ``serve_pull``, with the same loopback
        fast path as the push receivers (in-process hop + no chaos armed
        = the CRC would verify bytes against themselves)."""
        if not _integrity.enabled():
            if _fault.ENABLED:
                if isinstance(payload, (bytes, memoryview)):
                    payload = _fault.corrupt_bytes("serve_pull",
                                                   bytes(payload))
                else:
                    payload = np.asarray(
                        _fault.corrupt("serve_pull", payload))
                _fault.fire("serve_pull")
            return payload
        if _integrity.loopback_fast() and not _fault.ENABLED:
            # COW-frozen read-only view: safe to hand out without a copy
            return payload

        def wasted():
            counters.inc("serve.pull_bytes_wasted", nbytes)

        frame = sealer(payload, key=key, seq=sid, worker=self.server_id)
        return _integrity.wire_transmit(
            frame, key=key, worker=self.server_id, seq=sid,
            site="serve_pull", opener=opener, who="serve", on_reject=wasted)

    def pull(self, since_id: Optional[int] = None,
             keys: Optional[List[str]] = None) -> ServeReply:
        """Answer one pull: only keys whose version advanced past the
        client's ``since_id`` snapshot, from the LATEST snapshot (never
        the live store — a mid-update multi-key read is impossible by
        construction).  ``since_id`` unknown or aged out of retention →
        full snapshot."""
        tctx = _tracing.current()
        t_ep0 = time.monotonic() if tctx is not None else 0.0
        if not self.alive:
            counters.inc("serve.unavailable")
            raise ServeUnavailable(
                f"serving endpoint {self.server_id} is down")
        if self.delay_s:
            # the slow-but-alive endpoint: answers correctly, late (the
            # per-ENDPOINT gray-failure hook; the injector's per-process
            # `slow`/`delay` kinds keep firing per shipped key at the
            # existing serve_pull hop — a second entry-point fire here
            # would double-inject and burn `n=` budgets off-count)
            counters.inc("serve.slow_endpoint_delays")
            time.sleep(self.delay_s)
        snap = self.ring.latest()
        if snap is None:
            counters.inc("serve.unavailable")
            raise ServeUnavailable(
                f"serving endpoint {self.server_id} has no snapshot yet")
        base = self.ring.get(since_id) if since_id is not None else None
        if base is not None and base.gen != snap.gen:
            # the store was cleared between the client's snapshot and
            # now: versions restarted at 0, so the vectors are not
            # comparable — a "delta" would skip every re-initialized
            # key and serve pre-clear values as fresh
            base = None
        full = base is None
        if since_id is not None and full:
            counters.inc("serve.retention_miss")
        wanted = snap.versions.keys() if keys is None else keys
        if self.partial and any(k not in snap.versions for k in wanted):
            # mirror coverage raced a cut (the key left this replica's
            # set, or was requested before its first mirror): refuse so
            # the router degrades to an endpoint that CAN answer
            counters.inc("serve.unavailable")
            raise ServeUnavailable(
                f"replica {self.server_id} does not mirror every "
                "requested key")
        items: Dict[str, ServeItem] = {}
        wire_total = 0
        for k in wanted:
            if k not in snap.versions:
                continue
            if not full and snap.versions[k] <= base.versions.get(k, -1):
                continue  # unchanged since the client's snapshot
            value = snap.refs[k]
            # codec from the SNAPSHOT (captured at cut time): the hot
            # read path must not contend on the live store lock per key
            info = snap.codecs.get(k)
            if info is not None:
                kwargs, comp, numel, dtype = info
                wire = snap.enc_cache.get(k)
                if wire is None:
                    wire = encode_value(comp, value, self.device)
                    snap.enc_cache[k] = wire
                nbytes = len(wire)
                payload = bytes(self._ship(
                    k, wire, snap.id, nbytes, _integrity.open_bytes,
                    _integrity.seal_bytes))
                items[k] = ServeItem(payload, snap.versions[k], nbytes,
                                     (dict(kwargs), numel,
                                      numpy_dtype_str(dtype)))
            else:
                nbytes = value.nbytes
                payload = self._ship(k, value, snap.id, nbytes,
                                     _integrity.open_array,
                                     _integrity.seal_array)
                items[k] = ServeItem(payload, snap.versions[k], nbytes)
            wire_total += nbytes
        counters.inc("serve.full_pulls" if full else "serve.delta_pulls")
        counters.inc("serve.pull_keys", len(items))
        counters.inc("serve.pull_bytes", wire_total)
        if tctx is not None:
            # the captured pull's serving leg: span on this endpoint's
            # track, closing flow ``f`` — the router opened the arc
            tr = _tracing.tracer()
            now = time.monotonic()
            tr.record_traced(tctx.trace_id, "serve.pull",
                             f"serve/{self.server_id}", t_ep0, now,
                             snapshot_id=snap.id, full=full,
                             keys=len(items))
            tr.flow(tctx.trace_id, "f", f"serve/{self.server_id}", now)
        return ServeReply(snapshot_id=snap.id, full=full, items=items,
                          wire_bytes=wire_total, server_id=self.server_id)


# -- the plane: primary + replicas + routing --------------------------------

_planes: "weakref.WeakSet[ServingPlane]" = weakref.WeakSet()


def active_planes() -> List["ServingPlane"]:
    return list(_planes)


def notify_world_change(view) -> None:
    """Called by :mod:`~byteps_tpu_torch.fault.membership` when the elastic
    world changes: every live plane re-clamps its endpoint set and
    rebuilds replica routing (a dead replica's keys degrade to primary
    reads instead of erroring)."""
    for plane in active_planes():
        try:
            plane.on_world_change(view)
        except Exception:  # noqa: BLE001 — serving must never fail a
            # membership transition
            get_logger().error("serving: on_world_change failed",
                               exc_info=True)


class ServingPlane:
    """The read plane over one :class:`KVStore`: a primary endpoint that
    serves everything plus ``BYTEPS_SERVE_REPLICAS - 1`` replica mirrors
    serving the hot keys, with per-pull routing, fallback, and the
    ``serve.*`` metric surface.

    ``cut()`` is the publication point: it cuts a snapshot, re-ranks
    hotness (``ServerAssigner`` pull histogram), and mirrors the hot
    subset to each replica in the key's replica set.  Call it at your
    consistency boundaries (e.g. once per training step), or pass
    ``cut_interval_s`` to let store writes drive it.  Codec keys are
    encoded on ``device`` (default: the store's)."""

    def __init__(self, store: KVStore, *,
                 replicas: Optional[int] = None,
                 retention: Optional[int] = None,
                 hot_keys: Optional[int] = None,
                 cut_interval_s: Optional[float] = None,
                 assigner: Optional[ServerAssigner] = None,
                 hedge: Optional[bool] = None, device=None):
        from ..common.config import get_config
        cfg = get_config()
        n = cfg.serve_replicas if replicas is None else replicas
        if n < 1:
            raise ValueError("replicas must be >= 1 (the primary)")
        self.store = store
        self.num_endpoints = n
        # Hedged pulls (docs/gray_failures.md): fire a backup
        # pull to the next replica when the first endpoint has not
        # answered within the hedge delay — first response wins, losers
        # are discarded (reads are idempotent; the seq-token machinery
        # that makes PUSHES idempotent is what lets a duplicated wire
        # frame downstream be dropped harmlessly).  Off by default: the
        # per-pull thread costs real throughput, so it is the explicit
        # `hedge=True` / BYTEPS_STRAGGLER_POLICY=hedge trade — bounded
        # tail latency under one slow serving endpoint for overhead on
        # every hedged pull.  Delay: BYTEPS_SERVE_HEDGE_MS fixed, or
        # (default 0) adaptive — the p99 of recent WINNING pull
        # latencies, so the observed-latency ring never learns the slow
        # endpoint's figure as "normal".
        self._hedge = (cfg.straggler_policy == "hedge" if hedge is None
                       else bool(hedge))
        self._hedge_ms = cfg.serve_hedge_ms
        self._hedge_lat = LatencyQuantile()
        self.assigner = assigner if assigner is not None else ServerAssigner(
            num_servers=n, fn="djb2", mixed_mode=False, bound=101,
            replicas=n, hot_keys=(cfg.serve_hot_keys if hot_keys is None
                                  else hot_keys))
        self._lock = named_lock("serving_plane")
        self._cut_serial = named_lock("serving_plane.cut")
        self._rr = 0
        # key -> replica endpoint ids mirroring it (rebuilt at each cut)
        self._mirrored: Dict[str, List[int]] = {}
        self._alive_clamp = n
        # the SnapshotStore comes LAST: with cut_interval_s it
        # subscribes cut_fn=self.cut to the store's write hook, and a
        # pusher thread already landing deltas would invoke a
        # half-constructed plane (cut_fn=self.cut: a write-triggered
        # cut must also re-mirror the replicas — a bare SnapshotStore
        # cut would publish primary-only snapshots and the replicas
        # would idle forever)
        self.snapstore = SnapshotStore(store, retention=retention,
                                       cut_interval_s=cut_interval_s,
                                       cut_fn=self.cut,
                                       defer_subscribe=True)
        self.primary = SnapshotServer(self.snapstore.ring, store,
                                      server_id=0, device=device)
        self.replicas = [
            SnapshotServer(SnapshotRing(self.snapstore.ring.retention),
                           store, server_id=i, partial=True,
                           device=self.primary.device)
            for i in range(1, n)]
        _planes.add(self)
        from ..common import metrics as _metrics
        _metrics.register_component("serving_plane", self)
        # last: only a FULLY constructed plane may receive write hooks
        self.snapstore.attach()

    # -- publication ---------------------------------------------------------

    def close(self) -> None:
        """Detach from the store's write hook and the module plane
        registry so a dropped plane can actually be collected (the
        store's subscriber list holds strong references)."""
        self.snapstore.detach()
        _planes.discard(self)

    def cut(self) -> Snapshot:
        """Publish: snapshot the store, re-rank hotness, mirror the hot
        subset to each replica.  Atomic per endpoint (ring swap); the
        primary is published first so a replica is never AHEAD of the
        endpoint its misses fall back to.  Serialized end to end —
        concurrent cutters (several pusher threads crossing the
        auto-cut interval at once) must not interleave their replica
        publishes out of id order."""
        with self._cut_serial:
            return self._cut_locked()

    def _cut_locked(self) -> Snapshot:
        snap = self.snapstore.cut()
        sets = self.assigner.rebuild_replicas()
        mirrored: Dict[str, List[int]] = {}
        per_replica: Dict[int, Dict[str, int]] = {}
        dead = {r.server_id for r in self.replicas if not r.alive}
        for key, shard_set in sets.items():
            if key not in snap.versions:
                continue
            # a replica discovered dead (ServeUnavailable at pull time)
            # leaves the mirror sets at the NEXT cut: between kill and
            # cut, pulls pay one serve.replica_fallback hop; after it,
            # routing never touches the corpse again
            ids = [s for s in shard_set
                   if s != 0 and s < self._alive_clamp and s not in dead]
            if ids:
                mirrored[key] = ids
                for sid in ids:
                    per_replica.setdefault(sid, {})[key] = \
                        snap.versions[key]
        for rep in self.replicas:
            keys = per_replica.get(rep.server_id, {})
            if not keys:
                continue
            rep.ring.publish(Snapshot(
                id=snap.id, ts=snap.ts, versions=dict(keys),
                refs={k: snap.refs[k] for k in keys},
                gen=snap.gen, codecs=snap.codecs,
                enc_cache=snap.enc_cache))
        with self._lock:
            self._mirrored = mirrored
        gauges.set("serve.hot_keys", len(mirrored))
        gauges.set("serve.dead_replicas",
                   sum(1 for r in self.replicas if not r.alive))
        return snap

    # -- routing -------------------------------------------------------------

    def _read_candidates(self, keys: Optional[List[str]],
                         since_id: Optional[int]) -> List[SnapshotServer]:
        """Replica endpoints that mirror EVERY key in the RESOLVED
        request list AND still retain the client's ``since_id``
        snapshot, rotated round-robin — cold keys, partial coverage, or
        a delta base the replica cannot serve all route to the primary
        (a replica must never silently inflate a delta pull into a full
        one just because its mirror history started later).  The
        ``alive`` flag is deliberately NOT consulted: a dead replica is
        discovered at pull time (``ServeUnavailable`` →
        ``serve.replica_fallback``) and leaves the mirror sets at the
        next :meth:`cut`, exactly like a real router learning of a dead
        peer from a failed read."""
        with self._lock:
            mirrored = self._mirrored
            if not mirrored or not self.replicas:
                return []
            if not keys:
                # no keys resolved (empty request, or no snapshot yet):
                # nothing for a replica to cover — primary answers
                return []
            eligible: Optional[set] = None
            for k in keys:
                ids = set(mirrored.get(k, ()))
                eligible = ids if eligible is None else (eligible & ids)
                if not eligible:
                    return []
            reps = [r for r in self.replicas
                    if r.server_id in eligible
                    and (since_id is None
                         or r.ring.get(since_id) is not None)]
            if not reps:
                return []
            self._rr = (self._rr + 1) % len(reps)
            return reps[self._rr:] + reps[:self._rr]

    def pull(self, since_id: Optional[int] = None,
             keys: Optional[List[str]] = None,
             record: bool = True,
             hedge: Optional[bool] = None) -> ServeReply:
        """One routed pull: fan across the replica set for hot keys,
        degrade to the primary on any replica failure — a pull fails
        only when the PRIMARY cannot answer.  With hedging on (plane
        default or per-call ``hedge=``) and at least one eligible
        replica, the attempts race instead of running sequentially:
        the backup fires after the hedge delay and the first response
        wins, so no single slow endpoint owns the tail."""
        t0 = time.perf_counter()
        # causal tracing : sample this pull; the context is
        # installed around the SEQUENTIAL candidate chain only — hedge
        # attempts run on worker threads the contextvar does not reach
        tctx, t_tr0 = _tracing.begin_sample("serve.route")
        # resolve keys=None to the latest snapshot's key list, NOT
        # store.keys(): the hot read path must not contend on the live
        # store lock — and a partial replica needs the explicit list to
        # verify its coverage
        wanted = keys
        if wanted is None:
            snap = self.snapstore.ring.latest()
            wanted = list(snap.versions) if snap is not None else []
        if record:
            self.assigner.record_pulls(wanted)
        cands = self._read_candidates(wanted, since_id)
        use_hedge = self._hedge if hedge is None else bool(hedge)
        hedged = bool(use_hedge and cands)
        if hedged:
            reply = self._pull_hedged(cands, since_id, keys, wanted)
        else:
            with _tracing.use(tctx):
                reply = None
                for rep in cands:
                    try:
                        reply = rep.pull(since_id=since_id, keys=wanted)
                        counters.inc("serve.replica_reads")
                        break
                    except ServeUnavailable:
                        counters.inc("serve.replica_fallback")
                        continue
                if reply is None:
                    reply = self.primary.pull(since_id=since_id, keys=keys)
                    counters.inc("serve.primary_reads")
        counters.inc("serve.pulls")
        histograms.observe("serve.pull_ms",
                           (time.perf_counter() - t0) * 1e3)
        if tctx is not None:
            tr = _tracing.tracer()
            now = time.monotonic()
            tr.record_traced(tctx.trace_id, "serve.route", "serve/plane",
                             t_tr0, now, keys=len(wanted), hedged=hedged)
            if not hedged:
                # the winning endpoint closed this arc with its ``f``;
                # hedged attempts ran outside the context, so opening an
                # arc here would leave an orphan ``s``
                tr.flow(tctx.trace_id, "s", "serve/plane", t_tr0)
        return reply

    # -- hedging -------------------------------------------------------------

    def _hedge_delay_s(self) -> float:
        """How long the first attempt gets before the backup fires:
        the fixed BYTEPS_SERVE_HEDGE_MS when set, else the p99 of
        recent winning pull latencies (floored so scheduler jitter
        cannot hedge every pull, capped so a cold ring cannot park the
        tail)."""
        if self._hedge_ms > 0:
            return self._hedge_ms / 1e3
        q = self._hedge_lat.quantile(0.99)
        if q is None:
            return 0.002          # cold start: no history yet
        return min(max(q, 0.0005), 0.25)

    def _pull_hedged(self, cands: List[SnapshotServer],
                     since_id: Optional[int], keys: Optional[List[str]],
                     wanted: List[str]) -> ServeReply:
        """Race the read candidates: fire the first, then one more per
        elapsed hedge delay until something answers.  First successful
        response wins; late duplicates are counted and dropped
        (``serve.hedge_discarded``) — a pull is idempotent, so
        discarding is the whole duplicate story.  A candidate that
        FAILS fast (``ServeUnavailable``) does not consume the budget
        forever: once every attempt has failed and none succeeded, the
        primary's error propagates exactly as on the sequential path.
        Every attempt's latency feeds the slowness tracker
        (``site="serve_pull"``), so a chronically slow endpoint is
        visible in ``/debug/state`` and ``bps_top`` even while hedging
        hides it from clients."""
        endpoints: List[Tuple[SnapshotServer, Optional[List[str]]]] = [
            (rep, wanted) for rep in cands]
        endpoints.append((self.primary, keys))
        done = threading.Event()
        wake = threading.Event()   # ANY attempt outcome (win or failure)
        lock = threading.Lock()
        state = {"reply": None, "winner": None, "failed": 0, "exc": None}
        total = len(endpoints)

        def attempt(ep: SnapshotServer, ep_keys, hedged: bool) -> None:
            t0 = time.perf_counter()
            try:
                r = ep.pull(since_id=since_id, keys=ep_keys)
            except Exception as e:  # noqa: BLE001 — ServeUnavailable is
                # the routing signal; anything else still must COUNT
                # (an uncounted dead attempt would park the final wait
                # forever) and propagates if nothing answers
                with lock:
                    state["failed"] += 1
                    state["exc"] = e
                    if state["failed"] >= total and state["reply"] is None:
                        done.set()
                wake.set()
                return
            dt = time.perf_counter() - t0
            _slowness.tracker().observe(ep.server_id, dt, site="serve_pull")
            with lock:
                if state["reply"] is None:
                    state["reply"] = r
                    state["winner"] = ep
                    # winners only: the delay ring must keep describing
                    # HEALTHY latency, not learn the straggler's
                    self._hedge_lat.observe(dt)
                    if hedged:
                        counters.inc("serve.hedge_wins")
                    done.set()
                else:
                    counters.inc("serve.hedge_discarded")
            wake.set()

        delay = self._hedge_delay_s()
        launched = 0
        answered = False
        for i, (ep, ep_keys) in enumerate(endpoints):
            threading.Thread(target=attempt, args=(ep, ep_keys, i > 0),
                             daemon=True, name="bps-serve-hedge").start()
            launched += 1
            if i == 1:
                counters.inc("serve.hedged_pulls")
            if i == total - 1 or answered:
                break
            # wait out the hedge delay — but wake on every attempt
            # outcome: an answer stops hedging, and fast failures
            # covering EVERY launched attempt fire the next candidate
            # immediately (a dead leading replica must not tax each
            # pull the full delay when the sequential path would fall
            # through instantly)
            deadline = time.monotonic() + delay
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not wake.wait(remaining):
                    break   # delay elapsed: hedge
                wake.clear()
                with lock:
                    if state["reply"] is not None:
                        answered = True
                        break
                    if state["failed"] >= launched:
                        break   # everyone so far failed: next, NOW
            if answered:
                break
        done.wait()
        with lock:
            reply, winner = state["reply"], state["winner"]
            exc = state["exc"]
        if reply is None:
            raise exc if exc is not None else ServeUnavailable(
                "no serving endpoint answered the hedged pull")
        counters.inc("serve.primary_reads" if winner is self.primary
                     else "serve.replica_reads")
        return reply

    # -- elastic -------------------------------------------------------------

    def reshard(self, alive_endpoints: int) -> None:
        """Clamp the endpoint set to ``alive_endpoints`` (a shrunk world)
        or re-open it (a rejoin), and re-derive the replica sets over
        the surviving shards — the pull histogram is retained, so
        hotness carries over.  Reads already in flight against a
        now-dead replica fall back through the normal routing path."""
        alive = max(1, min(alive_endpoints, self.num_endpoints))
        with self._lock:
            self._alive_clamp = alive
            self._mirrored = {}
        for rep in self.replicas:
            if rep.server_id >= alive:
                rep.kill()
            else:
                rep.revive()
        self.assigner.reshard(alive)
        counters.inc("serve.reshards")
        if self.snapstore.ring.latest() is not None:
            self.cut()  # re-mirror under the new shape immediately

    def on_world_change(self, view) -> None:
        self.reshard(min(self.num_endpoints, view.num_workers))

    # -- observability -------------------------------------------------------

    def debug_state(self) -> dict:
        snap = self.snapstore.ring.latest()
        with self._lock:
            mirrored = len(self._mirrored)
            clamp = self._alive_clamp
        return {
            "kind": "serving_plane",
            "endpoints": self.num_endpoints,
            "alive_clamp": clamp,
            "dead_replicas": [r.server_id for r in self.replicas
                              if not r.alive],
            "snapshot_id": snap.id if snap is not None else None,
            "snapshots_retained": len(self.snapstore.ring),
            "hot_keys_mirrored": mirrored,
            "load": self.assigner.load_summary(),
        }
