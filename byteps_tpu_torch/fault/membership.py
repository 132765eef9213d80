"""Elastic membership: shrink-to-survivors and in-place rejoin; port of
``byteps_tpu/fault/membership.py``, whole.

The frames are the JAX package's byte for byte (an 8-byte big-endian
length prefix, a pickle, the CRC32C envelope when integrity is on), and
every payload that crosses the bus is numpy or plain Python, never a
torch tensor, so a JAX member and a port member can share one bus.  The
engine resumed for an agreed world is a ``torch.distributed`` group
(:func:`_resume_for_world`) on the suspended engine's device, or
``device``.  Where the port departs from the JAX module (ROADMAP Queue C
21-24), each for a bus whose sync payloads are a model's gradients
(~100 MB a member at ResNet-50):

- :func:`_recv_obj` receives into one buffer (``recv_into``) and
  unpickles from a view of the opened envelope; the JAX loop appends
  64 KiB chunks to an immutable ``bytes``;
- the members of a completed sync round share one encoded reply
  (``_BusServer._round_frame_for``); the JAX bus encodes it per member;
- the standby's replica carries no sync round (a successor re-agrees
  the world, voiding them), where the JAX replica carries them all;
- the ``metrics`` reply adds the bus's gossip ``states`` when it has a
  table;
- a ``reconcile`` reply for an epoch this member already applied
  retries the step instead of re-agreeing one epoch further, and a
  closed bus unregisters its health provider.

The JAX package's description follows.

The reference lets a recovered worker rejoin a running job in place
(``is_recovery``, reference global.cc:291-294, server.cc:486-489) but
offers no survivor-side story: a dead peer means the whole job restarts.
The ingredients are suspend/resume (core/api.py), the
``RecoveryCoordinator`` drain→restore flow, chaos injection and launcher
supervision.  This module composes them into a real membership layer:

- **Membership epoch** — a process-wide monotonic counter
  (:func:`current_epoch`).  Every engine dispatch stamps its pending
  tensor with the epoch at enqueue (core/engine.py) and every
  ServerEngine/KVStore push may carry one; work stamped with a dead
  epoch is *dropped, not summed* — the same residue-vs-fresh-round
  discipline as ``ServerEngine.reset_key``, applied to the whole world.
- **Shrink-to-survivors** — on heartbeat loss every survivor's
  ``on_failure`` runs :meth:`ElasticMembership.shrink`: advance the
  epoch (stale guard up), drain + ``suspend()``, agree on the new world
  through an epoch-tagged rendezvous on the membership bus, then
  ``resume()`` at the smaller size — re-declared keys in original
  order, re-sharded ``ServerAssigner``, training continues from
  in-memory state with **no process exit**.
- **In-place rejoin** — a restarted rank calls
  :meth:`ElasticMembership.rejoin`; it parks on the bus until the
  survivors complete a step-boundary sync, then receives the agreed
  epoch, the declared-key order, and the parameters packed by a
  survivor (``utils.checkpoint.pack_state`` — the wire form of the
  broadcast-after-restore contract) and resumes as a full member.

The **membership bus** is a tiny TCP control-plane endpoint hosted by
the lowest-ranked live member (the *membership coordinator*).  It
serves three verbs: ``sync`` (per-step barrier + small payload
all-gather, the vehicle for both failure evidence and join admission),
``hello`` (the shrink rendezvous), and ``rejoin``.  Clients reach it
with :class:`common.retry.RetryPolicy` full-jitter backoff, so a bus
that moves to a new coordinator mid-shrink is a transient, not an
error.  Control-plane only: gradients ride the XLA collectives; the
bus carries membership state, step digests, and the (rare) rejoin
parameter transfer.

Double failure during a shrink: the rendezvous waits
``membership_rendezvous_timeout_s`` for every proposed survivor; a
member that never checks in (it died after the first detection) is
dropped from the agreed world and the shrink completes without it.  A
member that finds itself outside the agreed world raises
:class:`Evicted` — under ``bpslaunch-dist --elastic`` it exits
restartable and comes back through the rejoin path.

Coordinator survival: the coordinator is no longer a single
point of state.  Every bus mutation — the agreed (epoch, world),
per-step sync payloads, parked rejoin requests, and the cross-rank
metrics cache — is replicated to a **standby** (the
next-lowest live rank) by piggybacking a ``replica`` snapshot on every
reply the bus sends that rank (plus an explicit ``replicate`` verb for
a rank that just *became* standby).  When the coordinator dies, the
standby re-binds the bus — same address on a single host, or its own
``BYTEPS_MEMBERSHIP_HOSTS`` entry on multi-host (``resolve_bus_addr``
is view-aware) — **seeded with the replicated state**, so a mid-step
sync round and a parked joiner survive the failover instead of wedging
until timeout.  The heartbeat plane moves with it: under
:meth:`ElasticMembership.host_heartbeat` every applied world change
rebuilds the monitors with ``server_rank = view.coordinator``, so
"coordinator down" flows through the ordinary shrink path and detection
of *subsequent* failures keeps working.  If the would-be coordinator of
a shrink never serves the bus inside the rendezvous window, the
proposing survivor drops it too and escalates down the rank ladder
until it either reaches a live coordinator or hosts the bus itself —
a double failure during failover converges instead of wedging.

Failure evidence without a named suspect — a data-path deadline trip
(``BYTEPS_SYNC_DEADLINE_S``, core/engine.py), a step-watchdog stall —
arrives as :meth:`ElasticMembership.on_failure` with an *empty* stale
set and becomes a :meth:`reconcile`: a rendezvous over the CURRENT
world at the next epoch.  Members parked in a step sync are released
with ``reconcile=True`` and join it; whoever is wedged-dead never
hellos and is dropped by the rendezvous timeout.  The bus turns
"something is stuck" into "exactly who is gone".

Gray failures — probation-based demotion: a rank that is
slow-but-ALIVE (throttled chip, degraded NIC) completes every quorum,
just late, so nothing above ever fires while every barrier waits on it.
The bus is the one place that SEES this: :meth:`_BusServer._do_sync`
stamps each rank's arrival time per barrier, scores arrival lags with a
phi-accrual tracker (``utils/slowness.py``, ``site="step_sync"``), and
folds in self-reported sync-deadline trips from the metrics piggyback.
Under ``BYTEPS_STRAGGLER_POLICY=demote`` a rank slow for
``straggler_demote_after`` consecutive barriers is **demoted**: the
round answers every member with a ``demote`` signal — survivors reuse
shrink-to-survivors (:meth:`ElasticMembership.demote`), while the
straggler itself raises :class:`Demoted` (NOT :class:`Evicted`): it
stays alive on the bus's **probation list**, recovers at its own pace
(``utils.slowness.wait_recovered``), and returns through the ordinary
:meth:`ElasticMembership.rejoin` step-boundary admission, which clears
its probation entry.  The probation list replicates to the standby with
the rest of the bus state, and the current coordinator is exempt from
demotion (its slowness escalates through the crash-failover path
instead — demoting the process that hosts the bus would race its own
takeover).  See docs/gray_failures.md.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import struct
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

from ..common import flight_recorder as _flight
from ..common.lock_witness import named_lock
from ..common.logging import get_logger
from ..common.retry import RetryPolicy
from ..common.telemetry import counters

__all__ = [
    "MembershipView", "ElasticMembership", "WorldChanged", "Evicted",
    "Demoted", "PartitionMinority", "MembershipTimeout", "current_epoch",
    "advance_epoch", "set_epoch", "resolve_bus_addr", "bus_request",
    "active_membership", "is_parked", "SERVE_RANK_BASE",
]

# Serving hosts (server/serving_tier.py) publish metrics snapshots into
# the same bus-side cache as trainer ranks, keyed at host_id + this base
# so the two id spaces can never collide (a tier of 3 hosts beside a
# 4-rank trainer world must not have host 2 shadow rank 2's row in
# bps_top).  Anything at or above the base is a serving host.
SERVE_RANK_BASE = 1 << 20


# The process's started ElasticMembership (weak: stop()/GC must not be
# blocked by observability readers).  cluster_metrics / the obs endpoint
# / the injector's kill:site=coordinator predicate read the CURRENT view
# through this instead of re-deriving a stale env-derived address.
_active_ref: Optional["weakref.ref[ElasticMembership]"] = None


def active_membership() -> Optional["ElasticMembership"]:
    """The live :class:`ElasticMembership` of this process, if one was
    started (None otherwise) — the handle observability callers use to
    re-resolve the bus from the current view after a coordinator
    change."""
    ref = _active_ref
    return ref() if ref is not None else None


def is_parked() -> bool:
    """True while this process sits parked on the minority side of a
    partition (quorum gate refused the epoch; engine suspended).  The
    engine checks this at enqueue so a parked rank fails loudly instead
    of queueing work no epoch will ever complete."""
    m = active_membership()
    return bool(m is not None and m.parked)


# -- the process-wide membership epoch --------------------------------------
#
# One integer, monotonic, shared by every layer that stamps or checks
# work: engine pendings (core/engine.py), server pushes
# (server/engine.py, server/kv_store.py), and the bus protocol below.
# Epoch 0 is the static world every non-elastic run lives in forever.

_epoch = 0
_epoch_lock = threading.Lock()


def current_epoch() -> int:
    """The membership epoch this process currently lives in."""
    return _epoch


def advance_epoch() -> int:
    """Bump the epoch by one (stale guards trip immediately)."""
    global _epoch
    with _epoch_lock:
        _epoch += 1
        return _epoch


def set_epoch(epoch: int) -> int:
    """Raise the epoch to ``epoch`` (monotonic: never regresses)."""
    global _epoch
    with _epoch_lock:
        if epoch > _epoch:
            _epoch = epoch
        return _epoch


def _reset_epoch_for_tests() -> None:
    global _epoch
    with _epoch_lock:
        _epoch = 0


@dataclasses.dataclass(frozen=True)
class MembershipView:
    """One agreed (epoch, world) pair; world is a sorted rank tuple."""

    epoch: int
    world: Tuple[int, ...]

    @property
    def num_workers(self) -> int:
        return len(self.world)

    @property
    def coordinator(self) -> int:
        return min(self.world)


class WorldChanged(RuntimeError):
    """The world moved under a step_sync; retry the step at the new
    epoch (the local engine has already been re-initialized)."""

    def __init__(self, view: MembershipView):
        super().__init__(f"membership changed: epoch {view.epoch}, "
                         f"world {list(view.world)}")
        self.view = view


class Evicted(RuntimeError):
    """This rank is not in the agreed world (the survivors shrank past
    it).  Exit restartable and come back through rejoin()."""


class Demoted(RuntimeError):
    """The bus demoted THIS rank onto the probation list — a sustained
    straggler under ``BYTEPS_STRAGGLER_POLICY=demote``.  Deliberately
    not an :class:`Evicted`: the rank is slow, not dead — stay alive,
    wait out the local condition (``utils.slowness.wait_recovered``
    against a small data-path probe), then come back through
    :meth:`ElasticMembership.rejoin` at a step boundary; admission
    clears the probation entry."""

    def __init__(self, view: MembershipView, probation):
        super().__init__(
            f"demoted to probation: the world moved on to epoch "
            f"{view.epoch + 1} without this rank (probation list: "
            f"{sorted(probation)}); recover, then rejoin()")
        self.view = view
        self.probation = sorted(probation)


class PartitionMinority(RuntimeError):
    """This rank is on the MINORITY side of a partition: a shrink it
    proposed (or joined) cannot reach a strict majority of the last
    agreed world, so committing it could split-brain the epoch
    (``BYTEPS_GOSSIP_ON`` quorum gate, fault/gossip.py quorum_ok).  The
    rank PARKS — engine suspended, no epoch advanced — and rejoins
    through the ordinary :meth:`ElasticMembership.rejoin` path once the
    partition heals.  Deliberately not an :class:`Evicted`: nobody
    agreed a world without this rank; there is, for now, no agreed new
    world at all on this side."""

    def __init__(self, view: MembershipView, reachable, proposed):
        super().__init__(
            f"partition minority: only {sorted(reachable)} of the last "
            f"agreed world {list(view.world)} (epoch {view.epoch}) are "
            f"reachable — no strict majority, parking instead of "
            f"committing epoch {view.epoch + 1}; rejoin() after the "
            f"partition heals")
        self.view = view
        self.reachable = sorted(reachable)
        self.proposed = sorted(proposed)


class MembershipTimeout(TimeoutError):
    """A bus request did not complete inside its window."""


class _BusUnreachable(ConnectionError):
    """Transient: the coordinator is dead/moving; retried with backoff."""


class _BusFrameError(_BusUnreachable):
    """A RECEIVED bus frame failed a sanity or integrity check.  The
    connection is failed loudly (server side logs and closes; client
    side retries with a fresh connection under the bounded backoff
    policy — the corruption is plausibly transient) — never acted on."""


class _BusFrameTooLarge(ValueError):
    """Deterministic sender-side refusal: the frame WE are about to send
    exceeds ``BYTEPS_BUS_MAX_FRAME``.  Deliberately NOT a
    :class:`_BusUnreachable` (nor an ``OSError``): retrying cannot
    succeed until the operator raises the env var, and each retry would
    re-pickle and re-CRC a multi-gigabyte rejoin state for nothing."""


# -- wire helpers (length-prefixed pickle over a trusted local socket,
#    CRC32C-enveloped when BYTEPS_INTEGRITY is armed) -----------------------

def _encode_obj(obj: Any) -> Tuple[bytes, bytes]:
    """``(prefix, data)``: the frame :func:`_send_obj` writes for ``obj``
    (an 8-byte big-endian length, then the pickle, sealed when integrity
    is on)."""
    from ..common import integrity as _integrity
    from ..common.config import get_config
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sealing = _integrity.enabled()
    max_frame = get_config().bus_max_frame
    wire_len = len(data) + (
        _integrity.envelope_overhead("membership-bus") if sealing else 0)
    if wire_len > max_frame:
        # fail at the SENDER, before shipping gigabytes the receiver's
        # clamp would reject anyway (and misattribute to corruption) —
        # and before CRC'ing and copying them into an envelope this
        # refusal would only discard
        raise _BusFrameTooLarge(
            f"refusing to send a {wire_len}-byte bus frame > "
            f"BYTEPS_BUS_MAX_FRAME={max_frame}; legitimately large rejoin "
            "states need BYTEPS_BUS_MAX_FRAME raised on every member")
    if sealing:
        # membership frames carry epochs, worlds, and rejoin parameter
        # blobs — a silently corrupt one could commit a wrong world or
        # hand a joiner bad weights, so they ride the same envelope as
        # every other host hop
        data = _integrity.seal_bytes(data, key="membership-bus")
    # 8-byte length prefix: a rejoin state payload is a whole model's
    # parameters and can exceed the 4 GiB a 32-bit prefix could frame
    return struct.pack("!Q", len(data)), data


def _send_frame(sock: socket.socket, frame: Tuple[bytes, bytes]) -> None:
    prefix, data = frame
    if len(data) < (1 << 20):
        sock.sendall(prefix + data)
    else:
        # the same bytes without copying a large frame behind the prefix
        sock.sendall(prefix)
        sock.sendall(data)


def _send_obj(sock: socket.socket, obj: Any) -> None:
    _send_frame(sock, _encode_obj(obj))


def _recv_obj(sock: socket.socket) -> Any:
    from ..common import integrity as _integrity
    from ..common.config import get_config
    buf = b""
    while len(buf) < 8:
        chunk = sock.recv(8 - len(buf))
        if not chunk:
            raise _BusUnreachable("bus connection closed mid-frame")
        buf += chunk
    (n,) = struct.unpack("!Q", buf)
    max_frame = get_config().bus_max_frame
    if n > max_frame:
        # an 8-byte prefix is the first thing a corrupt stream mangles:
        # trusting it unconditionally would park this thread on a
        # multi-petabyte recv.  Clamp and fail the connection instead.
        raise _BusFrameError(
            f"bus frame length {n} exceeds BYTEPS_BUS_MAX_FRAME="
            f"{max_frame} — corrupt length prefix or misbehaving peer "
            "(senders clamp too, so a legitimately large rejoin state "
            "would have failed at its sender: raise BYTEPS_BUS_MAX_FRAME "
            "on every member); failing the connection")
    # one buffer of the announced size, filled in place: appending to a
    # bytes object copies everything received so far at every chunk
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 22, n - got))
        if not k:
            raise _BusUnreachable("bus connection closed mid-frame")
        got += k
    view.release()
    data = buf
    if _integrity.is_frame(data):
        try:
            # a view: the unpickle below copies what it keeps
            data, _ = _integrity.open_bytes(data, copy=False)
        except _integrity.IntegrityError as e:
            counters.inc("integrity.crc_reject")
            raise _BusFrameError(
                f"bus frame failed integrity verification: {e}") from None
    try:
        return pickle.loads(data)
    except Exception as e:
        # a flip in the envelope's 4 magic bytes defeats the is_frame
        # sniff and lands the raw envelope (or otherwise-corrupt bytes)
        # here — that is still wire corruption and must fail through the
        # retriable _BusFrameError path, not an unclassified
        # UnpicklingError that skips the caller's backoff/close handling
        counters.inc("integrity.crc_reject")
        raise _BusFrameError(f"bus frame failed to unpickle: {e}") from None


def _membership_host_map() -> List[Tuple[str, Optional[int]]]:
    """BYTEPS_MEMBERSHIP_HOSTS parsed into per-rank ``(host, port)``
    entries (port None = use the default membership port).  Empty list
    when unset — the single-fixed-address deployments."""
    from ..common.config import get_config
    out: List[Tuple[str, Optional[int]]] = []
    for entry in get_config().membership_hosts.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if ":" in entry:
            host, port_s = entry.rsplit(":", 1)
            out.append((host, int(port_s)))
        else:
            out.append((entry, None))
    return out


def resolve_bus_addr(bus: Optional[str] = None,
                     view: Optional[MembershipView] = None) -> Tuple[str, int]:
    """``host:port`` of the membership bus — explicit arg, or resolved
    **from the view**: with ``BYTEPS_MEMBERSHIP_HOSTS`` set, the bus
    lives at the CURRENT coordinator's entry (so a coordinator failover
    moves the address with the coordinator); otherwise the static
    DMLC-root + BYTEPS_MEMBERSHIP_PORT resolution (single host: the
    successor re-binds the same address)."""
    from ..common.config import get_config
    if bus is not None:
        host, port_s = bus.rsplit(":", 1)
        return host, int(port_s)
    cfg = get_config()
    port = cfg.membership_port or (
        int(os.environ.get("DMLC_PS_ROOT_PORT", "9000")) + 2)
    if view is not None and view.world:
        hosts = _membership_host_map()
        coord = min(view.world)
        if hosts and coord < len(hosts):
            host, entry_port = hosts[coord]
            return host, (entry_port if entry_port is not None else port)
    return os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"), port


def bus_request(addr: Tuple[str, int], msg: dict,
                timeout: float = 10.0) -> dict:
    """One single-attempt request/reply round trip to the bus (no
    backoff — read-only observability callers like
    ``core/api.cluster_metrics`` / ``tools/bps_top.py`` decide their own
    retry cadence).  Raises :class:`_BusUnreachable` (a
    ``ConnectionError``) when nothing answers."""
    try:
        s = socket.create_connection(addr, timeout=min(timeout, 3.0))
    except OSError as e:
        raise _BusUnreachable(f"bus {addr}: {e}") from None
    try:
        s.settimeout(timeout)
        _send_obj(s, msg)
        return _recv_obj(s)
    except socket.timeout:
        raise MembershipTimeout(
            f"bus {msg.get('op')} timed out after {timeout:.1f}s") from None
    except _BusUnreachable:
        raise
    except OSError as e:
        raise _BusUnreachable(f"bus {addr}: {e}") from None
    finally:
        s.close()


def estimate_clock_offset(addr: Tuple[str, int],
                          samples: Optional[int] = None,
                          timeout: float = 2.0) -> Optional[Tuple[float,
                                                                  float]]:
    """NTP-style wall-clock offset of THIS process against the bus host
    (the merged cluster timeline): ``samples`` ping
    round-trips, each yielding ``offset = midpoint(local) - t_wall(bus)``;
    the minimum-RTT sample wins (its midpoint bounds the true offset
    tightest).  The estimate is published to
    :func:`byteps_tpu_torch.common.tracing.set_clock_offset` so every trace
    file this process flushes carries it; returns ``(offset_s, err_s)``
    or None when no sample landed.  Cost: ``samples`` sub-ms TCP round
    trips — run at membership start and after coordinator changes, not
    per step."""
    from ..common import tracing as _tracing
    from ..common.config import get_config
    if samples is None:
        samples = get_config().clock_sync_samples
    best: Optional[Tuple[float, float]] = None   # (rtt, offset)
    for _ in range(max(0, samples)):
        t0 = time.time()
        try:
            reply = bus_request(tuple(addr), {"op": "ping"},
                                timeout=timeout)
        except (ConnectionError, MembershipTimeout):
            continue
        t1 = time.time()
        if not reply.get("ok") or "t_wall" not in reply:
            continue
        rtt = t1 - t0
        offset = (t0 + t1) / 2.0 - float(reply["t_wall"])
        if best is None or rtt < best[0]:
            best = (rtt, offset)
    if best is None:
        return None
    rtt, offset = best
    _tracing.set_clock_offset(offset, rtt / 2.0,
                              source="bus %s:%d" % tuple(addr))
    return offset, rtt / 2.0


class _BusServer:
    """The coordinator-side membership endpoint.

    State: the agreed ``(epoch, world)``, per-(epoch, step) sync
    payloads, per-epoch shrink hellos, and parked join requests.  Every
    verb parks its connection thread on one condition variable; any
    state transition (quorum complete, epoch advanced, join admitted)
    wakes everyone and each waiter re-evaluates its own predicate —
    the same pop-time re-evaluation discipline as the server engine's
    PriorityQueue.

    ``seed`` is a replica snapshot from a dead predecessor
    (:meth:`_replica_snapshot`): a bus born from one resumes at the
    replicated epoch/world with the replicated sync rounds,
    parked-joiner set, and metrics cache — the failover is a
    resumption, not a restart.  A stale seed (older epoch than the
    view being hosted) is ignored.
    """

    def __init__(self, addr: Tuple[str, int], view: MembershipView,
                 rendezvous_timeout_s: float, sync_timeout_s: float,
                 seed: Optional[dict] = None,
                 host_rank: Optional[int] = None):
        self.addr = addr
        self.host_rank = host_rank
        self.epoch = view.epoch
        self.world: Set[int] = set(view.world)
        self._rdv_timeout = rendezvous_timeout_s
        self._sync_timeout = sync_timeout_s
        self._cv = threading.Condition(
            named_lock("membership.bus", reentrant=True))
        # (epoch, step) -> {rank: payload}
        self._sync: Dict[Tuple[int, int], Dict[int, Any]] = {}
        # (epoch, step) -> (state bytes, declared names, state's step)
        self._snapshots: Dict[Tuple[int, int], Tuple[bytes, List[str], int]] = {}
        # proposed epoch -> {rank: proposed world}
        self._hellos: Dict[int, Dict[int, frozenset]] = {}
        # rank -> None (parked) | admission info dict
        self._join_wait: Dict[int, Optional[dict]] = {}
        # rank -> (wall time, metrics snapshot): the cross-rank
        # observability cache — members attach a compact snapshot to
        # every sync (and may metrics_put explicitly); the metrics verb
        # answers from here in one round-trip (core/api.cluster_metrics)
        self._metrics: Dict[int, Tuple[float, Any]] = {}
        # rank -> (wall time, windowed time-series summary): the history
        # cache — compact window summaries piggybacked the
        # same way, so cluster_metrics grows a `history` view in the
        # SAME round-trip and the health engine's skew rule can compare
        # ranks without new verbs
        self._history: Dict[int, Tuple[float, Any]] = {}
        # -- gray-failure state (docs/gray_failures.md) ----------
        # The bus scores each rank's STEP-BARRIER ARRIVAL LAG: a
        # slow-but-alive rank completes every quorum, just last — the
        # one cross-rank signal that attributes "everyone waits on R".
        from ..common.config import get_config
        from ..utils.slowness import SlownessTracker
        cfg = get_config()
        # quorum-gated agreement: with the gossip plane on, a
        # shrink commits only when a strict majority of the last agreed
        # world answered the hello — the server-side half of the
        # split-brain gate (fault/gossip.py quorum_ok)
        self._quorum_gate = bool(getattr(cfg, "gossip_on", False))
        # the bus's gossip table (fault/gossip.py): every `gossip` verb
        # merges the caller's digest here and answers with the merged
        # table, so two ranks that never talk directly still converge
        # through the bus.  The hosting ElasticMembership installs its
        # own agent's table; a bare bus lazily builds a relay-only one.
        self.gossip_table = None
        self._straggler_policy = cfg.straggler_policy
        self._phi = cfg.slowness_phi
        self._demote_after = cfg.straggler_demote_after
        self._min_lag = cfg.straggler_min_lag_s
        self._slow = SlownessTracker(window=cfg.slowness_window)
        # (epoch, step) -> {rank: monotonic arrival}; rounds already
        # scored (scoring runs once per completed barrier)
        self._arrive: Dict[Tuple[int, int], Dict[int, float]] = {}
        self._scored: set = set()
        # (epoch, step) -> {rank: flow id}: causal-tracing ids members
        # attached to their syncs — the bus closes each arc
        # when the barrier completes, so the merged cluster timeline
        # shows every rank's step flowing into ONE barrier span
        self._sync_trace: Dict[Tuple[int, int], Dict[int, int]] = {}
        self._slow_rounds: Dict[int, int] = {}   # consecutive slow barriers
        self._deadline_seen: Dict[int, int] = {}  # last seen trip counters
        # rank -> {"since": wall ts, "score": phi at demotion}: demoted
        # ranks awaiting recovery; cleared by rejoin admission
        self._probation: Dict[int, dict] = {}
        self._demote_pending: Optional[Tuple[int, int]] = None  # (epoch, rank)
        # -- serving-host directory (server/serving_tier.py) ---------------
        # host_id -> {"addr": (host, port), "ts": wall-clock refresh,
        # "ttl": seconds, "meta": {...}}.  A generation counter bumps on
        # every membership-visible change (join, leave, TTL expiry, addr
        # move) so ring consumers re-derive routing exactly when it
        # changed and never otherwise.  Wall-clock stamps deliberately:
        # the directory must survive a coordinator failover onto a
        # process with a different monotonic base.
        self._serve_hosts: Dict[int, dict] = {}
        self._serve_gen = 0
        self._serve_target: Optional[int] = None  # autoscaler proposal
        # gray-failing serving hosts the autoscaler excluded from
        # placement (SERVING-HOST ids — a different namespace from the
        # trainer-rank ``_probation`` above; the two must never leak
        # into each other).  Changing it bumps the generation so every
        # ring consumer re-routes the demoted arcs.
        self._serve_probation: set = set()
        # host ids mid graceful drain (launcher/reconciler.py): marked
        # by the host's own re-registration with draining=True; routers
        # and the publisher exclude them exactly like probation (the
        # transition bumps the generation), in-flight pulls finish, and
        # the final unregister clears the mark
        self._serve_draining: set = set()
        # scale-down victims the autoscaler PROPOSED (serve_scale
        # victims=[...]): the reconciler reads them from serve_dir and
        # drains exactly those hosts — cleared as each victim leaves
        self._serve_victims: set = set()
        # host_id -> wall time until which re-registration is refused: a
        # retired host whose CONTROL plane still heartbeats (the gray
        # failure: bus reachable, data plane dead) must not flap back
        # into every client's ring one beat after the publisher evicted
        # it
        self._serve_banned: Dict[int, float] = {}
        if seed and seed.get("epoch", -1) >= view.epoch:
            self.epoch = int(seed["epoch"])
            self.world = set(int(r) for r in (seed.get("world")
                                              or view.world))
            self._sync = {tuple(k): dict(v)
                          for k, v in (seed.get("sync") or {}).items()}
            # parked joiners re-park as None: their connections died with
            # the predecessor, but the ADMISSION intent survives — the
            # next sync reply advertises join_waiting and the retried
            # rejoin request lands on an already-armed bus.  (State
            # snapshots are deliberately not replicated — see
            # _replica_snapshot — so admission waits for the successor's
            # first state-carrying quorum.)
            self._join_wait = {int(r): None
                               for r in (seed.get("join_wait") or ())}
            self._metrics = {int(r): tuple(v)
                             for r, v in (seed.get("metrics") or {}).items()}
            # the history cache survives a coordinator failover with the
            # metrics cache — a postmortem that spans the failover must
            # still see the window leading into it
            self._history = {int(r): tuple(v)
                             for r, v in (seed.get("history") or {}).items()}
            # probation survives a coordinator failover: a demoted rank
            # must still be readmittable (and visible as demoted, not
            # forgotten) through the successor bus
            self._probation = {int(r): dict(v) for r, v in
                               (seed.get("probation") or {}).items()}
            # the serving-host directory survives the failover too — a
            # successor that forgot the tier would empty every client's
            # ring until each host's next re-registration
            srv = seed.get("serve") or {}
            self._serve_hosts = {int(h): dict(v) for h, v in
                                 (srv.get("hosts") or {}).items()}
            self._serve_gen = int(srv.get("gen", 0))
            self._serve_target = srv.get("target")
            self._serve_probation = {int(h) for h in
                                     (srv.get("probation") or ())}
            self._serve_draining = {int(h) for h in
                                    (srv.get("draining") or ())}
            self._serve_victims = {int(h) for h in
                                   (srv.get("victims") or ())}
            self._serve_banned = {int(h): float(t) for h, t in
                                  (srv.get("banned") or {}).items()}
        # the encoded reply of the last completed sync round, keyed by
        # (epoch, step, join_waiting): every member it answers but the
        # standby gets the same bytes, so one pickle, one seal and one
        # CRC serve the round (the JAX bus encodes once per member)
        self._round_frame: Optional[Tuple[tuple, Tuple[bytes, bytes]]] = None
        self._frame_lock = threading.Lock()
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(addr)
        self._sock.listen(32)
        self._sock.settimeout(0.25)
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="bps-membership-bus")
        self._thread.start()
        # cross-rank judgment (common/health.py): the rank hosting this
        # bus holds every member's piggybacked window in-process, so the
        # skew rule runs here (and only here) with no extra round-trips
        from ..common import health as _health
        # one bound-method object: the health module unregisters by
        # identity, and each attribute access builds a fresh one
        self._history_fn = self._history_view
        _health.set_cluster_history_provider(self._history_fn)

    def _history_view(self) -> Dict[int, dict]:
        """``{rank: window summary}`` of the live world — the health
        engine's cluster-skew input (and the doctor's, over the bus)."""
        with self._cv:
            return {r: h for r, (_, h) in self._history.items()
                    if r in self.world and h}

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        from ..common import health as _health
        _health.clear_cluster_history_provider(self._history_fn)
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=2)
        self._sock.close()

    def view(self) -> MembershipView:
        with self._cv:
            return MembershipView(self.epoch, tuple(sorted(self.world)))

    def parked_joiners(self) -> List[int]:
        """Ranks parked on a ``rejoin`` request, not yet admitted."""
        with self._cv:
            return sorted(r for r, v in self._join_wait.items() if v is None)

    # -- replication -------------------------------------------------------

    def _standby_rank(self) -> Optional[int]:
        """The next-lowest live rank — the replica target (caller holds
        the condition)."""
        w = sorted(self.world)
        return w[1] if len(w) > 1 else None

    def _replica_snapshot(self) -> dict:
        """Everything a successor needs to resume this bus (caller holds
        the condition) — the agreed view, the parked-joiner set, the
        metrics and history caches, probation and the serving directory.  Deliberately NOT the packed
        rejoin-state payloads (``_snapshots``): a whole model's
        parameters riding every standby reply would make a large state
        trip ``BYTEPS_BUS_MAX_FRAME`` and fail the healthy standby's
        step sync.  The successor instead re-advertises ``join_waiting``
        from the replicated park set and re-collects state at its next
        state-carrying quorum — the admission moves one boundary later,
        nothing is lost."""
        # The port replicates no sync round (the JAX bus replicates every
        # retained one): a successor always re-agrees the world at the
        # next epoch, which voids every round of the old one, and with a
        # model's gradients as payloads (~100 MB a member at ResNet-50)
        # the rounds would put hundreds of MB on every standby reply
        # and trip BYTEPS_BUS_MAX_FRAME.
        return {
            "epoch": self.epoch,
            "world": sorted(self.world),
            "sync": {},
            "join_wait": sorted(r for r, v in self._join_wait.items()
                                if v is None),
            "metrics": dict(self._metrics),
            "history": dict(self._history),
            "probation": {r: dict(v) for r, v in self._probation.items()},
            "serve": {"hosts": {h: dict(v)
                                for h, v in self._serve_hosts.items()},
                      "gen": self._serve_gen,
                      "target": self._serve_target,
                      "probation": sorted(self._serve_probation),
                      # mid-drain marks and proposed victims survive a
                      # failover: a successor that forgot them would
                      # route new pulls back onto a host that is busy
                      # finishing its last ones and exiting
                      "draining": sorted(self._serve_draining),
                      "victims": sorted(self._serve_victims),
                      # wall-clock expiry stamps, valid on any host —
                      # without them a failover forgets the ban and a
                      # retired-but-heartbeating host flaps back into
                      # the ring through the successor bus
                      "banned": dict(self._serve_banned)},
        }

    # -- serving -----------------------------------------------------------

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True, name="bps-membership-conn")
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(self._sync_timeout + self._rdv_timeout + 30.0)
            msg = _recv_obj(conn)
            op = msg.get("op")
            # ranks-partition chaos: a caller across the cut never
            # reaches this bus — drop the request unanswered (the
            # client's connect/read timeout surfaces the silence), same
            # shape as a real severed control network
            from . import injector as _fault
            if (_fault.ENABLED and msg.get("rank") is not None
                    and _fault.edge_cut(int(msg["rank"]))):
                return
            if op == "sync":
                reply = self._do_sync(msg)
            elif op == "hello":
                reply = self._do_hello(msg)
            elif op == "rejoin":
                reply = self._do_rejoin(msg)
            elif op == "metrics_put":
                reply = self._do_metrics_put(msg)
            elif op == "metrics":
                reply = self._do_metrics()
            elif op == "replicate":
                reply = self._do_replicate()
            elif op == "ping":
                reply = self._do_ping()
            elif op == "serve_register":
                reply = self._do_serve_register(msg)
            elif op == "serve_unregister":
                reply = self._do_serve_unregister(msg)
            elif op == "serve_dir":
                reply = self._do_serve_dir()
            elif op == "serve_scale":
                reply = self._do_serve_scale(msg)
            elif op == "gossip":
                reply = self._do_gossip(msg)
            else:
                reply = {"ok": False, "error": f"unknown op {op!r}"}
            # replication piggyback: every reply to the STANDBY carries a
            # state snapshot — the standby pays one extra payload on
            # traffic it already sends, and the coordinator never opens a
            # connection of its own (no extra round trips, no push path
            # to keep alive)
            rank = msg.get("rank")
            standby = False
            if rank is not None and op != "replicate":
                with self._cv:
                    if rank == self._standby_rank():
                        reply = dict(reply)
                        reply["replica"] = self._replica_snapshot()
                        standby = True
            try:
                if op == "sync" and reply.get("ok") and not standby:
                    _send_frame(conn, self._round_frame_for(msg, reply))
                else:
                    _send_obj(conn, reply)
            except _BusFrameTooLarge as e:
                # the reply (e.g. a rejoin state snapshot) exceeds the
                # coordinator's BYTEPS_BUS_MAX_FRAME: a silent close
                # would have the joiner retry a deterministic failure
                # under backoff — answer with a small error naming the
                # knob instead, so the client fails fast and loudly
                get_logger().warning(
                    "membership bus: reply for op %r too large: %s", op, e)
                _send_obj(conn, {"ok": False, "error": str(e)})
        except Exception:  # noqa: BLE001 — a broken/dead client connection
            # must not take the bus down; the client side has its own
            # retry/timeout story
            get_logger().debug("membership bus: connection handler failed",
                               exc_info=True)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _round_frame_for(self, msg: dict, reply: dict) -> Tuple[bytes,
                                                                 bytes]:
        """The encoded reply of a completed sync round: the members of a
        round receive equal replies (the round's payloads, its epoch and
        the join hint), so the first to be answered encodes it and the
        rest send the same bytes."""
        key = (msg["epoch"], msg["step"], bool(reply.get("join_waiting")))
        with self._frame_lock:
            if self._round_frame is None or self._round_frame[0] != key:
                self._round_frame = (key, _encode_obj(reply))
            return self._round_frame[1]

    def _stale_reply(self) -> dict:
        # probation rides every stale reply so a demoted rank that syncs
        # late (it raced the demote signal) learns it is demoted — not
        # evicted — from the same reply that tells it the world moved
        return {"ok": False, "stale": True, "epoch": self.epoch,
                "world": sorted(self.world),
                "probation": sorted(self._probation)}

    def _pending_rendezvous(self) -> Optional[int]:
        """The highest proposed epoch of an in-flight hello rendezvous
        (caller holds the condition), or None.  Members parked in a sync
        are released with ``reconcile=True`` so they JOIN the rendezvous
        instead of waiting out their quorum — failure evidence propagates
        through the bus faster than every member's own detector."""
        pending = [e for e in self._hellos if e > self.epoch]
        return max(pending) if pending else None

    # -- verb: sync (step barrier + payload all-gather + join admission) ---

    def _do_sync(self, msg: dict) -> dict:
        rank, epoch, step = msg["rank"], msg["epoch"], msg["step"]
        deadline = time.monotonic() + self._sync_timeout
        with self._cv:
            if msg.get("metrics") is not None:
                # observability piggyback: cached even for a stale-epoch
                # sync — a rank mid-transition is exactly one an operator
                # wants to see
                self._metrics[rank] = (time.time(), msg["metrics"])
            if msg.get("history") is not None:
                # the windowed time-series summary rides the same frame
                self._history[rank] = (time.time(), msg["history"])
            if epoch != self.epoch:
                return self._stale_reply()
            if (self._demote_pending is not None
                    and self._demote_pending[0] == self.epoch):
                # a demotion was decided this epoch: every member of the
                # doomed round (and any late sync) gets the signal
                return self._demote_reply()
            pe = self._pending_rendezvous()
            if pe is not None:
                # a shrink/reconcile rendezvous is in flight: this round
                # is doomed — tell the member to join the rendezvous now
                return {"ok": False, "reconcile": True, "pending_epoch": pe,
                        "epoch": self.epoch, "world": sorted(self.world)}
            key = (epoch, step)
            # arrival stamp: the straggler signal is WHEN each rank
            # reached this barrier relative to the round's first arrival
            self._arrive.setdefault(key, {})[rank] = time.monotonic()
            if msg.get("trace"):
                self._sync_trace.setdefault(key, {})[rank] = msg["trace"]
            self._sync.setdefault(key, {})[rank] = msg.get("payload")
            if msg.get("state") is not None:
                # the state a member carries at step s is its state
                # AFTER step s-1 — what a joiner admitted at this
                # boundary resumes from
                self._snapshots[key] = (msg["state"],
                                        list(msg.get("declared") or ()),
                                        step - 1)
            # memory hygiene: completed rounds more than a few steps old
            # can never gain another waiter
            for k in [k for k in self._sync if k[1] < step - 4]:
                self._sync.pop(k, None)
                self._snapshots.pop(k, None)
                self._arrive.pop(k, None)
                self._sync_trace.pop(k, None)
                self._scored.discard(k)
            self._cv.notify_all()
            while not self._stop.is_set():
                if self.epoch != epoch:
                    # a shrink or an admission moved the world while this
                    # round was parked: the payloads are void, retry the
                    # step at the new epoch
                    return self._stale_reply()
                if (self._demote_pending is not None
                        and self._demote_pending[0] == self.epoch):
                    return self._demote_reply()
                pe = self._pending_rendezvous()
                if pe is not None:
                    return {"ok": False, "reconcile": True,
                            "pending_epoch": pe, "epoch": self.epoch,
                            "world": sorted(self.world)}
                got = self._sync.get(key, {})
                joins_parked = any(v is None
                                   for v in self._join_wait.values())
                if set(got) >= self.world:
                    # gray-failure scoring on the COMPLETED barrier (one
                    # pass per round): may decide a demotion, in which
                    # case this round's reply IS the demote signal
                    self._score_round(key)
                    if (self._demote_pending is not None
                            and self._demote_pending[0] == self.epoch):
                        return self._demote_reply()
                    if joins_parked and key in self._snapshots:
                        self._admit(key)
                        continue  # epoch changed: loop → stale reply
                    # join_waiting tells members to attach state on the
                    # NEXT boundary — so the (expensive) state transfer
                    # happens only when someone is actually rejoining
                    return {"ok": True, "epoch": epoch,
                            "payloads": dict(got),
                            "join_waiting": joins_parked}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # quorum never completed: the missing members are
                    # failure evidence (the detector may be inert after
                    # its one firing) — the client turns this into a
                    # shrink
                    return {"ok": False, "timeout": True,
                            "missing": sorted(self.world - set(got)),
                            "epoch": self.epoch,
                            "world": sorted(self.world)}
                self._cv.wait(min(remaining, 0.25))
        return self._stale_reply()

    def _demote_reply(self) -> dict:
        """The demote signal every member of a doomed round receives
        (caller holds the condition): survivors turn it into
        ``ElasticMembership.demote`` (a shrink), the target into
        :class:`Demoted` (park on probation, recover, rejoin)."""
        return {"ok": False, "demote": self._demote_pending[1],
                "probation": sorted(self._probation),
                "epoch": self.epoch, "world": sorted(self.world)}

    def _emit_barrier_trace(self, key: Tuple[int, int]) -> None:
        """Close the round's cross-rank flow arcs: one
        ``bus.step_barrier`` span on this process's timeline covering
        first→last arrival, and a flow ``f`` per member that attached a
        trace id to its sync — the member emitted the matching ``s`` on
        ITS OWN timeline, so after ``tools/bps_trace.py`` merges the
        per-rank files each rank's step visibly flows into the one
        barrier that gated it.  Caller holds the condition; runs once
        per round (the ``_scored`` latch)."""
        flows = self._sync_trace.pop(key, None)
        if not flows:
            return
        try:
            from ..common import tracing as _tracing
            tr = _tracing.tracer()
            if not tr.active:
                return
            arrivals = self._arrive.get(key) or {}
            if not arrivals:
                return
            t_first = min(arrivals.values())
            t_last = max(max(arrivals.values()), t_first + 1e-5)
            epoch, step = key
            tr.record_traced(next(iter(flows.values())),
                             "bus.step_barrier", "bus/step_sync",
                             t_first, t_last, step=step, epoch=epoch,
                             ranks=sorted(flows))
            for r, fid in flows.items():
                ts = min(max(arrivals.get(r, t_last), t_first), t_last)
                tr.flow(fid, "f", "bus/step_sync", ts)
        except Exception:  # noqa: BLE001 — tracing is best-effort
            get_logger().debug("barrier trace emission failed",
                               exc_info=True)

    def _score_round(self, key: Tuple[int, int]) -> None:
        """Score one COMPLETED step barrier (caller holds the condition;
        runs once per round).

        Per-rank arrival lag against the round's first arrival feeds the
        bus-side phi tracker (``site="step_sync"``); the metrics
        piggyback contributes self-reported ``engine.sync_deadline_trips``
        deltas (a rank whose own units blow the data-path deadline is
        slow even if it somehow makes the barrier on time).  A rank is
        *slow this round* when its lag clears BOTH the absolute floor
        (``straggler_min_lag_s`` — phi self-calibrates, so an idle
        world's microsecond jitter must not score) and the phi threshold
        (``slowness_phi``), or when it reported fresh deadline trips.
        ``straggler_demote_after`` consecutive slow rounds under
        ``BYTEPS_STRAGGLER_POLICY=demote`` demote it — except the
        current coordinator (it hosts this bus; its slowness escalates
        through the crash-failover path instead)."""
        if key in self._scored:
            return
        self._scored.add(key)
        self._emit_barrier_trace(key)
        arrivals = self._arrive.get(key) or {}
        if len(arrivals) < 2:
            return
        first = min(arrivals.values())
        slow_now = set()
        for r, t in arrivals.items():
            lag = t - first
            self._slow.observe(r, lag, site="step_sync")
            ent = self._metrics.get(r)
            trips = 0
            if ent is not None and isinstance(ent[1], dict):
                trips = int((ent[1].get("counters") or {}).get(
                    "engine.sync_deadline_trips", 0) or 0)
            tripped = trips > self._deadline_seen.get(r, trips)
            if trips > self._deadline_seen.get(r, 0):
                self._deadline_seen[r] = trips
            if tripped or (lag >= self._min_lag
                           and self._slow.score(r, site="step_sync")
                           >= self._phi):
                slow_now.add(r)
        for r in arrivals:
            self._slow_rounds[r] = (self._slow_rounds.get(r, 0) + 1
                                    if r in slow_now else 0)
        if (self._straggler_policy != "demote"
                or self._demote_pending is not None
                or len(self.world) < 2):
            return
        coordinator = min(self.world)
        candidates = [r for r in sorted(slow_now)
                      if r in self.world and r != coordinator
                      and self._slow_rounds.get(r, 0) >= self._demote_after]
        if not candidates:
            return
        # one demotion at a time, worst straggler first: the world
        # change resets every counter, so a second straggler re-earns
        # its consecutive rounds under the new world
        target = max(candidates, key=lambda r: self._slow_rounds[r])
        score = round(self._slow.score(target, site="step_sync"), 2)
        self._probation[target] = {"since": time.time(), "score": score}
        self._demote_pending = (self.epoch, target)
        self._slow_rounds[target] = 0
        counters.inc("membership.straggler_demote_decided")
        _flight.record("membership.straggler_demote", rank=target,
                       epoch=self.epoch, score=score,
                       consecutive=self._demote_after)
        get_logger().error(
            "membership bus: rank %d is a sustained straggler (phi %.1f, "
            "%d consecutive slow barriers) — demoting to probation, world "
            "shrinks without it", target, score, self._demote_after)
        self._cv.notify_all()

    def _admit(self, key: Tuple[int, int]) -> None:
        """Admit every parked joiner at this completed step boundary
        (caller holds the condition)."""
        state, declared, state_step = self._snapshots[key]
        joiners = sorted(r for r, v in self._join_wait.items() if v is None)
        self.epoch += 1
        self.world |= set(joiners)
        info = {"epoch": self.epoch, "world": sorted(self.world),
                "declared": declared, "step": state_step, "state": state}
        for r in joiners:
            self._join_wait[r] = dict(info)
            # the joiner is a FRESH incarnation: its sync_deadline_trips
            # counter restarts, so the high-water mark from the dead
            # incarnation must go too — otherwise new trips stay masked
            # until they exceed the old lifetime total
            self._deadline_seen.pop(r, None)
            if self._probation.pop(r, None) is not None:
                # a demoted straggler came back healthy: readmission IS
                # the end of probation
                counters.inc("membership.probation_readmitted")
                _flight.record("membership.probation_readmitted",
                               rank=r, epoch=self.epoch)
                get_logger().warning(
                    "membership bus: rank %d readmitted from probation "
                    "(epoch %d)", r, self.epoch)
        counters.inc("membership.rejoin_admitted", len(joiners))
        # the admission moved the world: a stale pending demotion is
        # void and every consecutive-slow counter restarts (a rejoiner
        # must re-earn any accusation under the new world)
        if (self._demote_pending is not None
                and self.epoch > self._demote_pending[0]):
            self._demote_pending = None
        self._slow_rounds.clear()
        get_logger().warning(
            "membership bus: admitted rank(s) %s at step boundary %d — "
            "epoch %d, world %s", joiners, key[1], self.epoch,
            sorted(self.world))
        # void the old epoch's parked rounds
        self._sync = {k: v for k, v in self._sync.items()
                      if k[0] >= self.epoch}
        self._cv.notify_all()

    # -- verb: hello (the shrink rendezvous) -------------------------------

    def _do_hello(self, msg: dict) -> dict:
        rank = msg["rank"]
        proposed_epoch = msg["epoch"]
        proposed_world = frozenset(msg["world"])
        deadline = time.monotonic() + self._rdv_timeout
        with self._cv:
            if proposed_epoch <= self.epoch:
                # agreement already happened (or a stray old proposal):
                # the current view IS the answer
                return {"ok": True, "epoch": self.epoch,
                        "world": sorted(self.world)}
            self._hellos.setdefault(proposed_epoch, {})[rank] = proposed_world
            self._cv.notify_all()
            while not self._stop.is_set():
                if self.epoch >= proposed_epoch:
                    return {"ok": True, "epoch": self.epoch,
                            "world": sorted(self.world)}
                got = self._hellos.get(proposed_epoch, {})
                # the ranks every proposal agrees are alive must all
                # check in; a rank someone still believes dead but that
                # hellos anyway is alive by definition and joins the
                # agreed world
                expected = frozenset.intersection(*got.values())
                if set(got) >= expected:
                    if self._quorum_minority_locked(got):
                        return self._minority_reply(proposed_epoch, got)
                    self._agree(proposed_epoch, sorted(got))
                    return {"ok": True, "epoch": self.epoch,
                            "world": sorted(self.world)}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # double failure during the shrink: whoever never
                    # helloed inside the window is dropped too
                    if self._quorum_minority_locked(got):
                        return self._minority_reply(proposed_epoch, got)
                    get_logger().error(
                        "membership: rendezvous for epoch %d timed out "
                        "waiting for %s — proceeding with responders %s",
                        proposed_epoch, sorted(expected - set(got)),
                        sorted(got))
                    self._agree(proposed_epoch, sorted(got))
                    return {"ok": True, "epoch": self.epoch,
                            "world": sorted(self.world)}
                self._cv.wait(min(remaining, 0.25))
        return self._stale_reply()

    def _quorum_minority_locked(self, got) -> bool:
        """True when the quorum gate is armed and the rendezvous
        responders are NOT a strict majority of the last agreed world
        (caller holds the condition).  The server-side half of the
        split-brain proof: an agreement that this side of a partition
        could commit concurrently with the other side's is refused."""
        return self._quorum_gate and 2 * len(got) <= len(self.world)

    def _minority_reply(self, proposed_epoch: int, got) -> dict:
        """Refuse a minority agreement (caller holds the condition): no
        epoch advances; the caller parks (:class:`PartitionMinority`)."""
        counters.inc("membership.quorum_refused")
        _flight.record("membership.quorum_refused",
                       proposed_epoch=proposed_epoch,
                       responders=sorted(got),
                       world=sorted(self.world), epoch=self.epoch)
        get_logger().error(
            "membership bus: REFUSING epoch %d — responders %s are not "
            "a strict majority of the last agreed world %s (partition "
            "minority); parking instead of split-braining",
            proposed_epoch, sorted(got), sorted(self.world))
        return {"ok": False, "minority": True, "epoch": self.epoch,
                "world": sorted(self.world), "responders": sorted(got)}

    def _agree(self, epoch: int, world: List[int]) -> None:
        """Commit a shrink agreement (caller holds the condition)."""
        self.epoch = epoch
        self.world = set(world)
        # drop THIS agreement's proposals and any stragglers for already-
        # passed epochs — a lingering dead proposal would keep flagging
        # reconcile on every future sync
        self._hellos = {e: v for e, v in self._hellos.items() if e > epoch}
        # release every sync round parked under the dead epoch
        self._sync = {k: v for k, v in self._sync.items() if k[0] >= epoch}
        self._arrive = {k: v for k, v in self._arrive.items()
                        if k[0] >= epoch}
        self._sync_trace = {k: v for k, v in self._sync_trace.items()
                            if k[0] >= epoch}
        self._scored = {k for k in self._scored if k[0] >= epoch}
        # a pending demotion is consumed by the agreement that applied
        # it; consecutive-slow counters restart under the new world
        # (readmitted or resized worlds re-earn any accusation)
        if (self._demote_pending is not None
                and epoch > self._demote_pending[0]):
            self._demote_pending = None
        self._slow_rounds.clear()
        counters.inc("membership.shrink_agreed")
        get_logger().warning("membership bus: agreed epoch %d, world %s",
                             epoch, world)
        self._cv.notify_all()

    # -- verb: rejoin ------------------------------------------------------

    def _do_rejoin(self, msg: dict) -> dict:
        rank = msg["rank"]
        deadline = time.monotonic() + self._sync_timeout
        with self._cv:
            # (re)park — but never clobber an admission that already
            # landed: after a failover the seeded bus re-parks this
            # joiner from the replica, and a state-carrying quorum can
            # admit it BEFORE the retried rejoin reconnects.  The retry
            # must collect that admission (the wait loop below returns
            # it immediately), not overwrite it and stall the world on a
            # member that is still parked.
            self._join_wait.setdefault(rank, None)
            self._cv.notify_all()
            while not self._stop.is_set():
                info = self._join_wait.get(rank)
                if info is not None:
                    del self._join_wait[rank]
                    return {"ok": True, **info}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._join_wait.pop(rank, None)
                    return {"ok": False, "timeout": True}
                self._cv.wait(min(remaining, 0.25))
        return {"ok": False, "timeout": True}

    # -- verbs: metrics (cross-rank observability) -------------------------

    def _do_metrics_put(self, msg: dict) -> dict:
        """Store one rank's snapshot (the explicit form of the sync
        piggyback — background publishers and one-shot tools)."""
        with self._cv:
            self._metrics[msg["rank"]] = (time.time(), msg.get("metrics"))
            if msg.get("history") is not None:
                self._history[msg["rank"]] = (time.time(), msg["history"])
            return {"ok": True, "epoch": self.epoch,
                    "world": sorted(self.world)}

    def _do_metrics(self) -> dict:
        """Every live rank's latest snapshot in one reply.  Ranks outside
        the current world are pruned (their cache entries are residue of
        a shrink); age lets the caller judge freshness.  The reply names
        who hosts the control plane (coordinator / standby / the rank
        actually serving this bus) so ``bps_top`` can show it."""
        now = time.time()
        with self._cv:
            self._prune_serve_locked()
            # serving-host snapshots (rank >= SERVE_RANK_BASE) are kept
            # while their directory registration lives — they are not
            # members of the trainer world and must not be pruned as
            # shrink residue
            self._metrics = {
                r: v for r, v in self._metrics.items()
                if r in self.world
                or (r >= SERVE_RANK_BASE
                    and (r - SERVE_RANK_BASE) in self._serve_hosts)}
            return {"ok": True, "epoch": self.epoch,
                    "serve_gen": self._serve_gen,
                    # fleet reconciliation view (bps_top's banner and
                    # DRAINING rows): the autoscaler's target and who is
                    # mid-drain right now
                    "serve_target": self._serve_target,
                    "serve_draining": sorted(self._serve_draining),
                    "serve_hosts": {
                        h: {"addr": list(v["addr"]),
                            "age_s": round(now - v["ts"], 3)}
                        for h, v in self._serve_hosts.items()},
                    "world": sorted(self.world),
                    "coordinator": min(self.world) if self.world else None,
                    "standby": self._standby_rank(),
                    "bus_rank": self.host_rank,
                    # gray-failure view: per-rank step-barrier phi
                    # scores + who is demoted right now — bps_top's
                    # SLOW/STATE columns read these
                    "slow": {r: round(s, 2) for r, s in
                             self._slow.scores(site="step_sync").items()},
                    "probation": sorted(self._probation),
                    "ranks": {r: {"age_s": round(now - t, 3), "metrics": m}
                              for r, (t, m) in self._metrics.items()},
                    # the retention plane: each live rank's
                    # piggybacked window summary, same freshness rules
                    "history": {r: {"age_s": round(now - t, 3),
                                    "summary": h}
                                for r, (t, h) in self._history.items()
                                if r in self.world},
                    # the bus's gossip table under BYTEPS_GOSSIP_ON (a
                    # port addition: the JAX reply has no such key), so a
                    # bus client sees the SWIM states bps_top renders
                    **({"states": self.gossip_table.snapshot()}
                       if self.gossip_table is not None else {})}

    # -- verb: gossip (anti-entropy relay, fault/gossip.py) ----------------

    def _do_gossip(self, msg: dict) -> dict:
        """Merge the caller's gossip digest into the bus-side table and
        answer with the merged digest — one round trip is one
        anti-entropy exchange, so two ranks that never talk directly
        still converge through the bus.  Metrics/history payloads riding
        the digest seed the bus's own observability caches: the bus is a
        thin compatibility server FED from the gossip table, and
        ``cluster_metrics()``/``bps_top``/``bps_doctor`` keep working
        unchanged."""
        digest = msg.get("digest") or {}
        table = self.gossip_table
        if table is None:
            from .gossip import GossipTable
            with self._cv:
                if self.gossip_table is None:
                    rank = (self.host_rank if self.host_rank is not None
                            else (min(self.world) if self.world else 0))
                    self.gossip_table = GossipTable(rank,
                                                    sorted(self.world))
                table = self.gossip_table
        table.merge(digest)
        with self._cv:
            for kind, cache in (("metrics", self._metrics),
                                ("history", self._history)):
                for r, v in table.payloads_of_kind(kind).items():
                    if not isinstance(v, dict) or "t" not in v:
                        continue
                    cur = cache.get(r)
                    if cur is None or float(v["t"]) > cur[0]:
                        cache[r] = (float(v["t"]), v.get("v"))
        return {"ok": True, "epoch": self.epoch,
                "world": sorted(self.world), "digest": table.digest()}

    # -- verbs: replicate / ping (coordinator-failover support) ------------

    def _do_replicate(self) -> dict:
        """Explicit replica pull: a rank that just BECAME the standby
        (after a world change) bootstraps its copy instead of waiting for
        the next piggybacked reply."""
        with self._cv:
            return {"ok": True, "epoch": self.epoch,
                    "world": sorted(self.world),
                    "replica": self._replica_snapshot()}

    def _do_ping(self) -> dict:
        """Cheap liveness + control-plane identity probe (used by
        ``_ensure_bus`` to distinguish "someone already serves this
        address" from "the world is busless", and by tooling)."""
        with self._cv:
            return {"ok": True, "epoch": self.epoch,
                    "world": sorted(self.world),
                    "coordinator": min(self.world) if self.world else None,
                    "standby": self._standby_rank(),
                    "bus_rank": self.host_rank,
                    # wall-clock sample for the trace clock-offset
                    # estimator: stamped as late as possible
                    "t_wall": time.time(),
                    "probation": sorted(self._probation)}

    # -- verbs: serving-host directory (server/serving_tier.py) ------------

    def _prune_serve_locked(self) -> None:
        """Drop TTL-expired serving hosts (caller holds the condition).
        Expiry is a membership change: the generation bumps so every
        ring consumer re-routes the dead host's arc."""
        now = time.time()
        dead = [h for h, v in self._serve_hosts.items()
                if now - v["ts"] > v["ttl"]]
        for h in dead:
            del self._serve_hosts[h]
            # an expired host's drain/victim marks are residue — a
            # fresh registration under the same id must start clean
            self._serve_draining.discard(h)
            self._serve_victims.discard(h)
        if dead:
            self._serve_gen += 1

    def _do_serve_register(self, msg: dict) -> dict:
        """A serving host joins (or refreshes) the tier directory.
        ``host_id=None`` allocates the next free id; a re-registration
        at the same address refreshes the TTL without bumping the
        generation (steady-state heartbeats must not churn every
        client's ring)."""
        addr = tuple(msg["addr"])
        ttl = float(msg.get("ttl_s") or 10.0)
        now = time.time()
        with self._cv:
            self._prune_serve_locked()
            hid0 = msg.get("host_id")
            if hid0 is not None:
                until = self._serve_banned.get(int(hid0), 0.0)
                if until > now:
                    return {"ok": False, "banned": True,
                            "retry_after_s": round(until - now, 1),
                            "gen": self._serve_gen}
                self._serve_banned.pop(int(hid0), None)
            hid = msg.get("host_id")
            if hid is None:
                hid = (max(self._serve_hosts) + 1 if self._serve_hosts
                       else 0)
            hid = int(hid)
            prev = self._serve_hosts.get(hid)
            self._serve_hosts[hid] = {"addr": addr, "ts": time.time(),
                                      "ttl": ttl,
                                      "meta": dict(msg.get("meta") or {})}
            changed = prev is None or tuple(prev["addr"]) != addr
            # the drain mark rides the registration (the host flips
            # itself to DRAINING and keeps heartbeating the mark until
            # its final unregister); either transition is membership-
            # visible — routers must stop (or resume) sending new pulls
            # at the next gen-driven re-sync
            draining = bool(msg.get("draining"))
            if draining != (hid in self._serve_draining):
                if draining:
                    self._serve_draining.add(hid)
                else:
                    self._serve_draining.discard(hid)
                changed = True
            if changed:
                self._serve_gen += 1
            return {"ok": True, "host_id": hid, "gen": self._serve_gen,
                    "epoch": self.epoch}

    def _do_serve_unregister(self, msg: dict) -> dict:
        """A host leaves (clean shutdown, or the publisher/autoscaler
        retiring it after a failure streak) — its arc remaps NOW instead
        of at TTL expiry.  ``ban_s`` refuses re-registration for that
        window: an evicted-but-heartbeating host (data plane dead, bus
        reachable) must not flap straight back into the ring."""
        with self._cv:
            hid = int(msg["host_id"])
            if self._serve_hosts.pop(hid, None) is not None:
                self._serve_gen += 1
            # the drain handshake completes here: the departing host's
            # final unregister clears its mark (and its victim entry)
            self._serve_draining.discard(hid)
            self._serve_victims.discard(hid)
            ban = float(msg.get("ban_s") or 0.0)
            if ban > 0:
                self._serve_banned[hid] = time.time() + ban
            return {"ok": True, "gen": self._serve_gen}

    def _do_serve_dir(self) -> dict:
        """The tier directory in one round trip: generation, live hosts,
        the autoscaler's current target proposal, and the SERVING-HOST
        probation set (placement and routing exclude these — host ids,
        not trainer ranks)."""
        now = time.time()
        with self._cv:
            self._prune_serve_locked()
            return {"ok": True, "gen": self._serve_gen,
                    "epoch": self.epoch,
                    "target": self._serve_target,
                    "probation": sorted(self._serve_probation),
                    "draining": sorted(self._serve_draining),
                    "victims": sorted(self._serve_victims),
                    "hosts": {h: {"addr": list(v["addr"]),
                                  "age_s": round(now - v["ts"], 3),
                                  "meta": dict(v.get("meta") or {})}
                              for h, v in self._serve_hosts.items()}}

    def _do_serve_scale(self, msg: dict) -> dict:
        """Record the autoscaler's proposals: target tier size and/or
        the serving-host probation set.  The bus only CARRIES them —
        whoever launches host processes (an operator, serve_bench
        ``--hosts``, a k8s controller) reads the target from
        ``serve_dir`` and acts; routers and the publisher exclude the
        probationed hosts from their rings (the change bumps the
        generation so they all re-sync)."""
        with self._cv:
            if "target" in msg:
                t = msg["target"]
                self._serve_target = None if t is None else int(t)
            if "probation" in msg:
                new = {int(h) for h in (msg["probation"] or ())}
                if new != self._serve_probation:
                    self._serve_probation = new
                    self._serve_gen += 1
            if "victims" in msg:
                # scale-down victim PROPOSALS (autoscaler dispose mode):
                # carried, not acted on — the reconciler reads them from
                # serve_dir and runs the drain; no gen bump, routing
                # only changes when a victim actually flips to DRAINING
                self._serve_victims = {int(h)
                                       for h in (msg["victims"] or ())
                                       if int(h) in self._serve_hosts}
            return {"ok": True, "target": self._serve_target,
                    "probation": sorted(self._serve_probation),
                    "victims": sorted(self._serve_victims),
                    "gen": self._serve_gen}


# -- the per-process membership object --------------------------------------


class ElasticMembership:
    """One process's handle on the elastic world.

    Parameters
    ----------
    rank : this process's membership rank (the launcher's
        ``DMLC_WORKER_ID`` numbering — a per-process identity that
        exists before any engine state, same convention as the fault
        injector).
    world : the initial member ranks.
    bus : ``host:port`` of the membership bus; defaults to
        ``DMLC_PS_ROOT_URI`` with ``BYTEPS_MEMBERSHIP_PORT`` (or
        coordinator port + 2).  The lowest-ranked live member hosts it.
    device : the device of a resumed engine (passed through to
        ``api.resume``); default the suspended engine's device.
    assigner / server_engine / kv_store : optional attached components
        re-synced on every world change (``ServerAssigner.reshard``,
        ``set_membership_epoch``).
    on_world_change : callback run with the new :class:`MembershipView`
        after each applied change (keep it short — it can run on the
        detector thread).
    """

    def __init__(self, rank: int, world: Iterable[int],
                 bus: Optional[str] = None, *,
                 device=None,
                 assigner=None, server_engine=None, kv_store=None,
                 on_world_change: Optional[Callable[[MembershipView],
                                                    None]] = None,
                 rendezvous_timeout_s: Optional[float] = None,
                 sync_timeout_s: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 _view: Optional[MembershipView] = None):
        from ..common.config import get_config
        cfg = get_config()
        self.rank = int(rank)
        self._view = _view or MembershipView(
            current_epoch(), tuple(sorted(int(r) for r in world)))
        if self.rank not in self._view.world:
            raise ValueError(f"rank {self.rank} not in world "
                             f"{list(self._view.world)}")
        self._bus_arg = bus
        self.bus_addr = resolve_bus_addr(bus, self._view)
        # the rank serving bus_addr right now (moves with _ensure_bus's
        # re-resolution, AHEAD of the view during a failover rendezvous)
        self._bus_host_rank = self._view.coordinator
        self.device = device
        self.assigner = assigner
        self.server_engine = server_engine
        self.kv_store = kv_store
        self.on_world_change = on_world_change
        self.rendezvous_timeout_s = (
            cfg.membership_rendezvous_timeout_s
            if rendezvous_timeout_s is None else rendezvous_timeout_s)
        self.sync_timeout_s = (cfg.membership_sync_timeout_s
                               if sync_timeout_s is None else sync_timeout_s)
        # The bus client must ride out a coordinator FAILOVER: detection
        # (heartbeat timeout) + successor bind can span many short
        # connect-refused attempts, so the attempt budget is raised well
        # past the bootstrap default (BYTEPS_BUS_RETRIES — the
        # detection-vs-patience dial) and the retry deadline is the
        # real bound.
        self._retry = retry or RetryPolicy.from_config(
            cfg, retry_on=(_BusUnreachable,),
            max_attempts=max(cfg.retry_max_attempts, cfg.bus_retries))
        self._apply_lock = named_lock("membership.apply")
        self._ready_cv = threading.Condition()
        self._bus: Optional[_BusServer] = None
        # True once a sync reply advertised a parked joiner: the next
        # step_sync attaches the (expensive) state payload
        self._join_hint = False
        # the latest replica snapshot piggybacked to this rank while it
        # is the standby — the seed a failover bus resumes from
        self._replica: Optional[dict] = None
        # step_sync retries the trace clock-offset estimate while it is
        # missing, but BOUNDED: each failing attempt costs blocking ping
        # round trips, which must not tax every step barrier forever
        self._clock_retries = 0
        # membership-managed heartbeat (host_heartbeat): rebuilt on every
        # applied world change so the UDP server follows the coordinator
        self._hb = None
        self._hb_args: Optional[dict] = None
        # -- gossip plane (BYTEPS_GOSSIP_ON, fault/gossip.py) --------------
        self._gossip_on = bool(getattr(cfg, "gossip_on", False))
        self._gossip_table = None
        self._gossip_agent = None
        # True after a minority park: the engine is suspended and no
        # epoch was advanced on this side; cleared only by a successful
        # rejoin through a healed world
        self._parked = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ElasticMembership":
        """Adopt the initial view; host the bus when this rank is the
        coordinator."""
        global _active_ref
        set_epoch(self._view.epoch)
        self._ensure_bus(self._view)
        if self._gossip_on:
            self._start_gossip()
        _active_ref = weakref.ref(self)
        self._sync_clock()
        return self

    def stop(self) -> None:
        global _active_ref
        if self._gossip_agent is not None:
            self._gossip_agent.stop()
            self._gossip_agent = None
        if self._hb is not None:
            self._hb.stop()
            self._hb = None
        if self._bus is not None:
            self._bus.close()
            self._bus = None
        if _active_ref is not None and _active_ref() is self:
            _active_ref = None

    def _start_gossip(self) -> None:
        """Arm the SWIM plane: one table + one agent for this rank, the
        bus ``gossip`` verb as the wire, metrics/history snapshots as
        piggybacked payloads, and the health engine's ``quorum_loss``
        provider registered against the LAST AGREED world."""
        from .gossip import GossipAgent, GossipTable
        if self._gossip_table is None:
            self._gossip_table = GossipTable(self.rank, self._view.world)

        def wire(peer: int, digest: dict):
            # the bus is the exchange point; `peer` only scopes chaos
            # (a severed edge to the bus host is already honored in
            # _request) — the reply digest is the anti-entropy return
            reply = self._request({"op": "gossip", "rank": self.rank,
                                   "digest": digest},
                                  timeout=max(2.0, self.sync_timeout_s / 4))
            return reply.get("digest") if reply.get("ok") else None

        def payloads() -> dict:
            # refreshed once per gossip period; values are wall-stamped
            # ``{"t", "v"}`` pairs so _do_gossip can seed the bus caches
            # by freshness; None snapshots are skipped by the agent
            now = time.time()
            out = {}
            m = self._local_metrics()
            if m is not None:
                out["metrics"] = {"t": now, "v": m}
            h = self._local_history()
            if h is not None:
                out["history"] = {"t": now, "v": h}
            bus = self._bus
            if bus is not None:
                # the hosting rank also gossips the serving-tier
                # directory, so routers on the far side of a partition
                # can keep serving from the last-known host map
                try:
                    out["serve_dir"] = {"t": now, "v": bus._do_serve_dir()}
                except Exception:  # noqa: BLE001 — serving is optional
                    pass
            return out

        self._gossip_agent = GossipAgent(
            self._gossip_table, wire,
            world_fn=lambda: self._view.world,
            payload_fn=payloads)
        self._gossip_agent.register_health_provider()
        self._gossip_agent.start()
        if self._bus is not None:
            # the hosting rank's bus serves anti-entropy FROM this same
            # table: verb replies and the local agent converge as one
            self._bus.gossip_table = self._gossip_table

    @property
    def gossip(self):
        """The local :class:`~byteps_tpu_torch.fault.gossip.GossipTable`
        (None unless BYTEPS_GOSSIP_ON armed it) — observability callers
        (cluster_metrics, bps_top) answer from it bus-free."""
        return self._gossip_table

    @property
    def parked(self) -> bool:
        """True while this rank sits parked on the minority side of a
        partition (engine suspended, no epoch agreed)."""
        return self._parked

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def view(self) -> MembershipView:
        return self._view

    def _sync_clock(self) -> None:
        """Trace-timeline clock alignment: estimate this
        rank's wall-clock offset against the bus host.  Gated on an
        active tracer — an untraced run must not pay the ping round
        trips — and entirely best-effort."""
        from ..common import tracing as _tracing
        from ..common.config import get_config
        try:
            if (get_config().clock_sync_samples <= 0
                    or not _tracing.tracer().active):
                return
            estimate_clock_offset(tuple(self.bus_addr))
        except Exception:  # noqa: BLE001 — alignment is best-effort
            get_logger().debug("clock-offset estimation failed",
                               exc_info=True)

    @property
    def is_coordinator(self) -> bool:
        return self.rank == self._view.coordinator

    @property
    def standby_rank(self) -> Optional[int]:
        """The next-lowest live rank — who takes over the bus if the
        coordinator dies (None in a solo world)."""
        w = self._view.world
        return w[1] if len(w) > 1 else None

    @property
    def hosting_bus(self) -> bool:
        """True when THIS process serves the membership bus."""
        return self._bus is not None

    def parked_joiners(self) -> List[int]:
        """Ranks parked on the bus THIS process hosts, waiting for
        admission (empty when it hosts none)."""
        bus = self._bus
        return bus.parked_joiners() if bus is not None else []

    @property
    def heartbeat(self):
        """The membership-managed :class:`HeartbeatMonitor`, if
        :meth:`host_heartbeat` armed one (rebuilt per world change)."""
        return self._hb

    def _ensure_bus(self, view: MembershipView,
                    prev_coordinator: Optional[int] = None) -> None:
        """Re-resolve the bus address for ``view`` (view-aware on
        multi-host, BYTEPS_MEMBERSHIP_HOSTS) and host the bus iff this
        rank is the coordinator of ``view`` and no bus is running here
        yet (idempotent; retried because a just-dead predecessor's
        socket may linger in TIME_WAIT).

        A new bus is **seeded with the replicated state** this rank
        collected as the standby — a coordinator failover resumes the
        mid-step sync round and the parked joiners instead of forgetting
        them — and the takeover is recorded
        (``membership.coordinator_failover`` counter + flight event).

        A bind that stays refused is not necessarily fatal: after a
        failover the old minimum rank can rejoin a world whose bus a
        surviving member already hosts at the fixed address — when the
        address *answers a ping*, this rank joins as a client.  When it
        does NOT answer, the world would be silently busless (every
        future request doomed to time out), so the failure is loud:
        counter + flight event + raise, letting the caller's escalation
        path (shrink failure → restartable exit) take over."""
        addr = resolve_bus_addr(self._bus_arg, view)
        self.bus_addr = addr
        self._bus_host_rank = min(view.world)
        if self.rank != min(view.world) or self._bus is not None:
            return
        if prev_coordinator is None:
            prev_coordinator = self._view.coordinator
        seed = self._replica

        def _bind():
            return _BusServer(addr, view,
                              self.rendezvous_timeout_s,
                              self.sync_timeout_s,
                              seed=seed, host_rank=self.rank)
        try:
            self._bus = RetryPolicy.from_config(
                retry_on=(OSError,)).call(_bind,
                                          describe="membership bus bind")
        except OSError as e:
            try:
                bus_request(addr, {"op": "ping"}, timeout=2.0)
                served = True
            except Exception:  # noqa: BLE001 — any failure means nobody
                served = False  # is usefully serving that address
            if served:
                _flight.record("membership.bus_already_served",
                               rank=self.rank, addr="%s:%d" % addr)
                get_logger().warning(
                    "membership: rank %d is the coordinator of %s but the "
                    "bus address %s:%d is already served (coordinator "
                    "failover kept it) — continuing as a bus client",
                    self.rank, list(view.world), *addr)
                return
            counters.inc("membership.bus_bind_failed")
            _flight.record("membership.bus_bind_failed", rank=self.rank,
                           addr="%s:%d" % addr, error=str(e))
            get_logger().error(
                "membership: rank %d could not bind the bus at %s:%d and "
                "nothing answers there — refusing to leave the world "
                "busless: %s", self.rank, addr[0], addr[1], e)
            raise
        if self._gossip_table is not None and self._bus is not None:
            # a failover successor's bus answers anti-entropy from the
            # SAME table its local agent already converged
            self._bus.gossip_table = self._gossip_table
        if prev_coordinator != self.rank:
            counters.inc("membership.coordinator_failover")
            _flight.record("membership.coordinator_failover",
                           new_coordinator=self.rank,
                           prev_coordinator=prev_coordinator,
                           seeded=seed is not None,
                           epoch=view.epoch, world=list(view.world))
            get_logger().warning(
                "membership: rank %d took over the bus at %s:%d from rank "
                "%s (%s replica state)", self.rank, *addr, prev_coordinator,
                "with" if seed is not None else "without")
        else:
            get_logger().info("membership: rank %d hosting the bus at "
                              "%s:%d", self.rank, *addr)

    # -- bus client --------------------------------------------------------

    def _request(self, msg: dict, timeout: float,
                 retry: Optional[RetryPolicy] = None) -> dict:
        """One request/reply round trip.  Connection-level failures (the
        coordinator died; its successor is still binding) are retried
        with full-jitter backoff; a read that exceeds ``timeout`` is a
        :class:`MembershipTimeout` and is NOT retried — the server
        answers its own timeouts explicitly.  ``retry`` overrides the
        default policy (the shrink path uses a rendezvous-bounded one so
        a dead successor is escalated, not waited out).

        Replica harvesting happens here: while this rank is the standby,
        every reply carries a piggybacked ``replica`` snapshot — it is
        stripped from the reply and cached as the failover seed."""
        def once():
            from . import injector as _fault
            # gate on the rank actually HOSTING the resolved address, not
            # the view's coordinator: during a failover shrink the hello
            # targets the PROPOSED successor while the view still names
            # the severed old coordinator — that edge must stay open
            if (_fault.ENABLED and self._bus is None
                    and _fault.edge_cut(self._bus_host_rank)):
                # ranks-partition chaos: the bus host is across the cut
                # — fail fast instead of waiting out a connect timeout
                # per retry (the real network would blackhole the SYN)
                raise _BusUnreachable(
                    f"bus {self.bus_addr}: severed by injected "
                    f"partition (chaos)")
            try:
                s = socket.create_connection(self.bus_addr, timeout=3.0)
            except OSError as e:
                raise _BusUnreachable(f"bus {self.bus_addr}: {e}") from None
            try:
                s.settimeout(timeout)
                _send_obj(s, msg)
                return _recv_obj(s)
            except socket.timeout:
                raise MembershipTimeout(
                    f"membership {msg.get('op')} timed out after "
                    f"{timeout:.1f}s") from None
            except _BusUnreachable:
                raise
            except OSError as e:
                raise _BusUnreachable(f"bus {self.bus_addr}: {e}") from None
            finally:
                s.close()
        reply = (retry or self._retry).call(
            once, describe=f"membership {msg.get('op')}")
        if isinstance(reply, dict) and "replica" in reply:
            self._replica = reply.pop("replica")
        return reply

    def _discover_bus(self) -> bool:
        """Multi-host rejoin helper: with BYTEPS_MEMBERSHIP_HOSTS set,
        probe entries in rank order and point ``bus_addr`` at the first
        one that answers a ping (the survivors' coordinator).  Returns
        False (keeping the static resolution) when no map is configured
        or nothing answers yet — the rejoin request's own backoff keeps
        retrying the resolved address."""
        _, default_port = resolve_bus_addr()   # the ONE port resolution
        for host_rank, (host, port) in enumerate(_membership_host_map()):
            addr = (host, port if port is not None else default_port)
            try:
                if bus_request(addr, {"op": "ping"}, timeout=2.0).get("ok"):
                    self.bus_addr = addr
                    self._bus_host_rank = host_rank
                    return True
            except Exception:  # noqa: BLE001 — dead entry, try the next
                continue
        return False

    def _pull_replica(self) -> bool:
        """Best-effort explicit replica fetch (the ``replicate`` verb) —
        run when this rank becomes the standby so the failover seed
        exists even before the next piggybacked reply."""
        try:
            reply = bus_request(self.bus_addr,
                                {"op": "replicate", "rank": self.rank},
                                timeout=3.0)
        except Exception:  # noqa: BLE001 — purely opportunistic
            return False
        if reply.get("ok") and reply.get("replica") is not None:
            self._replica = reply["replica"]
            return True
        return False

    def _declared_order(self) -> List[str]:
        from ..core import api
        if api.initialized():
            return api._require().registry.names_in_declaration_order()
        if api._suspended is not None:
            return list(api._suspended[2])
        return list(api._declared_order)

    # -- cross-rank observability ------------------------------------------

    def _local_metrics(self) -> Optional[dict]:
        """The compact snapshot every sync piggybacks (None when
        telemetry is off or the snapshot itself fails — observability
        must never fail a step barrier)."""
        try:
            from ..common.config import get_config
            if not get_config().telemetry_on:
                return None
            from ..core import api
            return api.metrics_snapshot(light=True)
        except Exception:  # noqa: BLE001
            return None

    def _local_history(self) -> Optional[dict]:
        """The compact time-series window summary riding the same sync
        frame; None when the sampler is off or empty —
        history must never fail a step barrier either."""
        try:
            from ..common import timeseries as _ts
            store = _ts.get_store()
            if store is None:
                return None
            summ = store.summary()
            return summ if summ.get("n") else None
        except Exception:  # noqa: BLE001
            return None

    def publish_metrics(self) -> bool:
        """Best-effort explicit snapshot push (``metrics_put``) for
        processes between step barriers; returns False instead of
        raising when the bus is unreachable."""
        try:
            from ..core import api
            bus_request(self.bus_addr,
                        {"op": "metrics_put", "rank": self.rank,
                         "metrics": api.metrics_snapshot(light=True),
                         "history": self._local_history()},
                        timeout=5.0)
            return True
        except Exception:  # noqa: BLE001
            return False

    # -- heartbeat re-hosting ----------------------------------------------

    def host_heartbeat(self, interval: Optional[float] = None,
                       timeout: Optional[float] = None,
                       addr: Optional[str] = None,
                       grace: Optional[float] = None,
                       on_failure: Optional[Callable[[Set[int]], None]]
                       = None):
        """Arm membership-managed heartbeats: the CURRENT view's
        coordinator hosts the UDP server, every member beats to it, and
        after every applied world change the monitors are rebuilt for
        the new view — the new coordinator re-hosts the server,
        survivors re-point their beats, and the fired-once latch resets
        so the failure AFTER the failover is detected too.

        ``addr`` pins ``host:port`` (single-host deployments and tests);
        otherwise the host follows the coordinator's
        ``BYTEPS_MEMBERSHIP_HOSTS`` entry and the port is
        ``BYTEPS_HEARTBEAT_PORT`` (DMLC_PS_ROOT_PORT + 1).
        ``on_failure`` defaults to :meth:`on_failure` (shrink in
        place).  Returns the first monitor."""
        from ..common.config import get_config
        cfg = get_config()
        self._hb_args = {
            "interval": (cfg.heartbeat_interval_s if interval is None
                         else interval),
            "timeout": (cfg.heartbeat_timeout_s if timeout is None
                        else timeout),
            "grace": grace,
            "addr": addr,
            "on_failure": on_failure or self.on_failure,
        }
        self._restart_heartbeat(self._view)
        return self._hb

    def _heartbeat_addr(self, view: MembershipView) -> Tuple[str, int]:
        """The heartbeat endpoint for ``view``: host follows the
        coordinator (BYTEPS_MEMBERSHIP_HOSTS when set), port from the
        pinned ``addr`` or BYTEPS_HEARTBEAT_PORT."""
        host = port = None
        pinned = self._hb_args.get("addr") if self._hb_args else None
        if pinned:
            host, port_s = pinned.rsplit(":", 1)
            port = int(port_s)
        hosts = _membership_host_map()
        if hosts and view.coordinator < len(hosts):
            host = hosts[view.coordinator][0]
        if host is None:
            host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        if port is None:
            port = int(os.environ.get(
                # bpslint: ignore[env-knob] reason=default is derived from DMLC_PS_ROOT_PORT+1 per resolved view; a Config snapshot cannot express it and the bind validates the value
                "BYTEPS_HEARTBEAT_PORT",
                str(int(os.environ.get("DMLC_PS_ROOT_PORT", "9000")) + 1)))
        return host, port

    def _restart_heartbeat(self, view: MembershipView) -> None:
        """Rebuild the managed monitor for ``view`` (no-op unless
        :meth:`host_heartbeat` armed one).  Safe to call from the OLD
        monitor's own beat thread (the detector → shrink → apply path):
        ``stop()`` skips joining the calling thread."""
        if self._hb_args is None:
            return
        from ..utils.failure_detector import HeartbeatMonitor
        old, self._hb = self._hb, None
        if old is not None:
            old.stop()
        if view.num_workers < 2:
            # a solo world has no peer to watch; a rejoin re-arms via the
            # world-change path
            _flight.record("membership.heartbeat_idle", epoch=view.epoch)
            return
        host, port = self._heartbeat_addr(view)
        args = self._hb_args

        def _arm():
            return HeartbeatMonitor(
                self.rank, coordinator=f"{host}:{port}",
                interval=args["interval"], timeout=args["timeout"],
                grace=args["grace"], on_failure=args["on_failure"],
                ranks=view.world, server_rank=view.coordinator).start()
        # the UDP bind races the predecessor server's teardown (a peer
        # that has not applied the new view yet still holds the port);
        # ride it out with a persistent bounded retry
        self._hb = RetryPolicy.from_config(
            retry_on=(OSError,), max_attempts=50, deadline_s=10.0).call(
                _arm, describe="heartbeat rebind")
        counters.inc("membership.heartbeat_rehosted")
        _flight.record("membership.heartbeat_rehosted",
                       server_rank=view.coordinator, epoch=view.epoch,
                       addr=f"{host}:{port}")
        get_logger().warning(
            "membership: heartbeat re-hosted — rank %d serves %s:%d for "
            "world %s (epoch %d)", view.coordinator, host, port,
            list(view.world), view.epoch)

    # -- the step barrier / all-gather ------------------------------------

    def step_sync(self, step: int, payload: Any = None,
                  state: Any = None) -> Tuple[MembershipView, Dict[int, Any]]:
        """Synchronize step ``step`` with every live member.

        Returns ``(view, payloads)`` where ``payloads`` maps rank →
        the small control-plane payload each member posted.  ``state``
        (a checkpoint-style pytree, or pre-packed bytes) is what a
        parked rejoiner would be admitted with; pass it every step to
        make any step a potential rejoin barrier.  It is only
        materialized and shipped when the bus has advertised a parked
        joiner (the previous sync reply's ``join_waiting``), so the
        per-step cost of the offer is one ignored keyword — the real
        pack/transfer happens on the one boundary that needs it
        (admission therefore lands on the *second* quorum after a
        rejoin request).

        Raises :class:`WorldChanged` when the epoch moved — by then the
        local engine has already been suspended/resumed onto the new
        world, so the caller just retries the step.  A quorum timeout
        with missing members is treated as failure evidence and turned
        into a shrink (the heartbeat detector fires only once; this is
        the detection path for failures *after* the first).
        """
        view = self._view
        # causal tracing: attach a flow id so the bus can
        # close the arc when the barrier completes — the ONE hop that
        # genuinely crosses rank boundaries today
        from ..common import tracing as _tracing
        _tr = _tracing.tracer()
        _tctx = _tr.maybe_sample("step_sync") if _tr.active else None
        _t_sync0 = time.monotonic()
        msg: Dict[str, Any] = {"op": "sync", "rank": self.rank,
                               "epoch": view.epoch, "step": step,
                               "payload": payload,
                               "metrics": self._local_metrics(),
                               "history": self._local_history()}
        if _tctx is not None:
            msg["trace"] = _tctx.trace_id
        if state is not None and self._join_hint:
            if not isinstance(state, bytes):
                from ..utils.checkpoint import pack_state
                # seal=False: the bus frame (_send_obj) already envelopes
                # this whole message — double-sealing a multi-GB state
                # would double the rejoin's CRC and copy cost
                state = pack_state(state, seal=False)
            msg["state"] = state
            msg["declared"] = self._declared_order()
        reply = self._request(msg, timeout=self.sync_timeout_s + 15.0)
        if reply.get("ok"):
            self._join_hint = bool(reply.get("join_waiting"))
            if (_tr.active and self._clock_retries < 3
                    and _tracing.clock_offset()["offset_s"] is None):
                # start()'s estimate can race the coordinator's bus
                # bind (nothing answered pings yet); the bus just
                # answered a sync, so the estimate usually lands on the
                # first retry — bounded at 3 attempts so a network that
                # syncs-but-drops-pings cannot tax every later barrier
                # with the full ping budget
                self._clock_retries += 1
                self._sync_clock()
            if _tctx is not None:
                # emitted only for a COMPLETED round: the bus registered
                # the id and closed the arc with its ``f``, so the ``s``
                # here never dangles (a retried/stale sync gets a fresh
                # id next attempt)
                now = time.monotonic()
                _tr.record_traced(_tctx.trace_id, "membership.step_sync",
                                  "membership", _t_sync0, now, step=step,
                                  epoch=view.epoch, rank=self.rank)
                _tr.flow(_tctx.trace_id, "s", "membership", _t_sync0)
            return self._view, reply["payloads"]
        if reply.get("stale"):
            new = MembershipView(reply["epoch"], tuple(reply["world"]))
            if self.rank not in new.world:
                if self.rank in set(reply.get("probation") or ()):
                    # demoted, not dead: a probation rank that syncs
                    # again (it raced the demote signal, or retried)
                    # must not exit restartable — it recovers and
                    # rejoins instead
                    raise Demoted(new, reply.get("probation") or ())
                raise Evicted(
                    f"rank {self.rank} is outside the agreed world "
                    f"{list(new.world)} (epoch {new.epoch})")
            self._maybe_apply(new)
            raise WorldChanged(new)
        if reply.get("demote") is not None:
            # the bus demoted a sustained straggler out of this round:
            # nobody consumes the round's payloads — the target parks on
            # probation, every survivor applies the demotion (a shrink)
            # and retries the step at the new epoch
            target = int(reply["demote"])
            cur = MembershipView(reply["epoch"], tuple(reply["world"]))
            if target == self.rank:
                counters.inc("membership.demoted")
                _flight.record("membership.demoted", rank=self.rank,
                               epoch=cur.epoch,
                               probation=list(reply.get("probation") or ()))
                get_logger().error(
                    "membership: this rank (%d) was demoted to probation "
                    "as a sustained straggler — recover locally, then "
                    "rejoin()", self.rank)
                raise Demoted(cur, reply.get("probation") or ())
            raise WorldChanged(self.demote(target))
        if reply.get("reconcile"):
            pe = reply.get("pending_epoch")
            if pe is not None and self._view.epoch >= pe:
                # the rendezvous this reply names has already been
                # applied here (by the detector thread, while this sync
                # was parked): retry the step at the view in hand — a
                # reconcile from here would re-agree one epoch further
                # for nothing (the JAX module does, ROADMAP Queue C)
                raise WorldChanged(self._view)
            # a shrink/reconcile rendezvous is already in flight on the
            # bus: join it instead of waiting out a doomed quorum — this
            # is how failure evidence reaches members whose own detector
            # has not fired (or already spent its one firing)
            get_logger().warning(
                "membership: step %d sync found a pending rendezvous for "
                "epoch %s — joining it", step, reply.get("pending_epoch"))
            new = self.reconcile()
            raise WorldChanged(new)
        if reply.get("timeout"):
            missing = set(reply.get("missing") or ())
            if missing:
                get_logger().error(
                    "membership: step %d sync timed out; missing rank(s) "
                    "%s treated as failed", step, sorted(missing))
                return_view = self.shrink(missing)
                raise WorldChanged(return_view)
            raise MembershipTimeout(f"step {step} sync timed out")
        raise RuntimeError(f"membership sync failed: {reply!r}")

    # -- shrink ------------------------------------------------------------

    def on_failure(self, stale: Set[int]) -> None:
        """Failure-action entry point (``HeartbeatMonitor.on_failure``,
        ``install_failure_action``): shrink in place when the evidence
        names ranks; an EMPTY set is wedge evidence without a suspect
        (a data-path deadline / step-watchdog trip,
        ``failure_detector.data_path_stalled``) and becomes a
        :meth:`reconcile` — the rendezvous identifies who is gone.
        Escalate to the restartable exit only when the transition itself
        fails (launcher supervision is the outer loop, as with
        ``RecoveryCoordinator``)."""
        try:
            if stale:
                self.shrink(set(stale))
            else:
                self.reconcile()
        except PartitionMinority:
            # NOT a failure exit: this rank parked on the minority side
            # of a partition (engine suspended, no epoch agreed).  The
            # training thread observes the park at its next step_sync;
            # the process stays up to rejoin when the partition heals.
            return
        except Exception:  # noqa: BLE001 — end of the in-process line
            counters.inc("membership.shrink_failed")
            from ..utils.failure_detector import _failure_exit_code
            code = _failure_exit_code()
            get_logger().error(
                "elastic transition failed — exiting %d so the launcher "
                "can restart", code, exc_info=True)
            _exit(code)

    def demote(self, rank: int) -> MembershipView:
        """Apply a bus-decided straggler demotion: move ``rank`` out of
        the data-path world onto probation, reusing shrink-to-survivors
        wholesale — the epoch guard, drain/suspend, rendezvous, and
        resume are exactly a shrink's.  The difference is entirely in
        bookkeeping and intent: the bus keeps the rank on its probation
        list (it is slow, not dead), the rank itself got :class:`Demoted`
        instead of :class:`Evicted`, and it returns through the ordinary
        :meth:`rejoin` admission once ``utils.slowness.wait_recovered``
        says its local data path is healthy again."""
        rank = int(rank)
        counters.inc("membership.straggler_demote")
        _flight.record("membership.straggler_demote_applied",
                       rank=rank, by=self.rank, epoch=self._view.epoch)
        get_logger().warning(
            "membership: demoting straggler rank %d to probation "
            "(shrink-to-survivors; it rejoins when healthy)", rank)
        return self.shrink({rank})

    def _park_minority(self, view: MembershipView, proposed_world,
                       reachable) -> None:
        """Park this rank on the minority side of a partition: engine
        suspended, ``membership.partition_minority`` counter + flight
        event, gossip state ``parked`` — and raise
        :class:`PartitionMinority`.  No epoch is agreed (or even
        proposed further) on this side; the rank returns through the
        ordinary :meth:`rejoin` path when the partition heals."""
        self._parked = True
        counters.inc("membership.partition_minority")
        _flight.record("membership.partition_minority",
                       rank=self.rank, epoch=view.epoch,
                       world=list(view.world),
                       reachable=sorted(reachable),
                       proposed=sorted(proposed_world))
        get_logger().error(
            "membership: rank %d is on the MINORITY side of a partition "
            "(reachable %s of last agreed world %s) — parking; rejoin "
            "when the partition heals", self.rank, sorted(reachable),
            list(view.world))
        if self._gossip_table is not None:
            from .gossip import PARKED
            self._gossip_table.mark(self.rank, PARKED)
        from ..core import api
        if api.initialized():
            api.suspend()
        raise PartitionMinority(view, reachable, proposed_world)

    def shrink(self, stale: Set[int]) -> MembershipView:
        """Drop ``stale`` ranks: epoch guard up → drain/suspend →
        epoch-tagged rendezvous → resume at the survivor world.

        Coordinator failover is part of the rendezvous: if the dead set
        includes the old coordinator, the lowest surviving rank hosts
        the bus (seeded with its standby replica) before helloing to
        itself; everyone else's connect rides backoff until the new bus
        is up.  If the would-be coordinator never serves the bus inside
        the rendezvous window — it died too, mid-failover — it is
        presumed dead, dropped from the proposal, and the ladder
        descends until this rank either reaches a live bus or hosts one
        itself.  (A presumed-dead rank that is merely slow self-heals:
        its own hello marks it alive and the agreement re-admits it.)"""
        view = self._view
        stale = set(stale) & set(view.world)
        if not stale:
            # a late detection of ranks an earlier shrink already
            # removed — the world is current, nothing to do
            return view
        proposed_world = tuple(r for r in view.world if r not in stale)
        proposed_epoch = view.epoch + 1
        if self.rank not in proposed_world:
            raise Evicted(f"rank {self.rank} was declared stale by its "
                          "own detector input")
        if self._gossip_on:
            # quorum gate, BEFORE the epoch guard goes up: a minority
            # proposal must not even stamp a local epoch — park instead
            # (the other side of the partition may be committing the
            # legitimate successor world right now)
            from .gossip import quorum_ok
            if not quorum_ok(proposed_world, view.world):
                self._park_minority(view, proposed_world, proposed_world)
        counters.inc("membership.shrink_started")
        _flight.record("membership.shrink_started", stale=sorted(stale),
                       proposed_epoch=proposed_epoch,
                       proposed_world=list(proposed_world))
        t0 = time.monotonic()
        get_logger().error(
            "membership: rank(s) %s lost — shrinking to %s (epoch %d)",
            sorted(stale), list(proposed_world), proposed_epoch)
        # Guard first: from here every in-flight chunk is stale and gets
        # dropped at dispatch/finish instead of delivered, so the drain
        # below is fast and the results of a half-dead collective never
        # reach a callback.
        set_epoch(proposed_epoch)
        from ..core import api
        if api.initialized():
            api.suspend()
        from ..common.config import get_config
        while True:
            self._ensure_bus(MembershipView(view.epoch, proposed_world),
                             prev_coordinator=view.coordinator)
            # bounded hello: the proposed coordinator gets one rendezvous
            # window to serve the bus; past it, unreachability IS the
            # evidence it died mid-failover
            hello_retry = RetryPolicy.from_config(
                get_config(), retry_on=(_BusUnreachable,),
                max_attempts=get_config().bus_retries,
                deadline_s=max(self.rendezvous_timeout_s, 2.0))
            try:
                reply = self._request(
                    {"op": "hello", "rank": self.rank,
                     "epoch": proposed_epoch,
                     "world": list(proposed_world)},
                    timeout=self.rendezvous_timeout_s + 15.0,
                    retry=hello_retry)
                break
            except _BusUnreachable:
                dead_coord = min(proposed_world)
                if dead_coord == self.rank:
                    # we host the bus ourselves and it is unreachable:
                    # nothing left to escalate to
                    raise
                counters.inc("membership.coordinator_presumed_dead")
                _flight.record("membership.coordinator_presumed_dead",
                               rank=dead_coord,
                               proposed_epoch=proposed_epoch)
                get_logger().error(
                    "membership: proposed coordinator %d never served the "
                    "bus within the rendezvous window — presuming it dead "
                    "too and escalating", dead_coord)
                stale.add(dead_coord)
                proposed_world = tuple(r for r in proposed_world
                                       if r != dead_coord)
                if self.rank not in proposed_world:
                    raise Evicted(
                        f"rank {self.rank} has no surviving world left "
                        f"(every lower rank is unreachable)")
                if self._gossip_on:
                    # the ladder descended below quorum: every bus this
                    # side can reach is gone — a partition, not a pile
                    # of dead coordinators; park instead of committing
                    from .gossip import quorum_ok
                    if not quorum_ok(proposed_world, view.world):
                        self._park_minority(view, proposed_world,
                                            proposed_world)
        if reply.get("minority"):
            # the server-side gate refused the agreement: our local
            # evidence said majority, the actual rendezvous responders
            # were not one (the backstop half of the split-brain proof)
            self._park_minority(view, proposed_world,
                                reply.get("responders") or ())
        agreed = MembershipView(reply["epoch"], tuple(reply["world"]))
        if self.rank not in agreed.world:
            raise Evicted(f"rank {self.rank} is outside the agreed world "
                          f"{list(agreed.world)}")
        out = self._maybe_apply(agreed)
        get_logger().warning(
            "membership: shrink complete in %.2fs — epoch %d, world %s",
            time.monotonic() - t0, out.epoch, list(out.world))
        return out

    def reconcile(self) -> MembershipView:
        """Failure evidence WITHOUT a named suspect (a data-path
        deadline trip, a wedged collective): re-run the rendezvous over
        the CURRENT world at the next epoch.  Every live member joins —
        parked step_syncs are released with ``reconcile=True`` and hello
        too — while a wedged-dead member never checks in and is dropped
        by the rendezvous timeout.  If everyone answers (a transient
        stall, a false alarm) the world re-agrees unchanged at the new
        epoch and training continues.

        The epoch guard goes up FIRST, so the wedged unit's eventual
        result (if it ever lands) is dropped as stale; the engine itself
        stays up through the rendezvous — suspending here would block on
        the very unit that is wedged — and :meth:`_maybe_apply` performs
        the bounded suspend/resume once the agreement is in hand.  Work
        enqueued during the window is stamped with the proposed epoch
        and rides the old mesh: harmless when the world re-agrees
        unchanged, part of the same wedge when it does not."""
        view = self._view
        proposed_epoch = view.epoch + 1
        if current_epoch() >= proposed_epoch:
            # another thread (a detector shrink, a peer-driven apply) is
            # already moving the world — follow it instead of competing
            return self.wait_ready(
                current_epoch(),
                timeout=self.rendezvous_timeout_s + self.sync_timeout_s)
        counters.inc("membership.reconcile_started")
        _flight.record("membership.reconcile_started",
                       epoch=proposed_epoch, world=list(view.world))
        get_logger().error(
            "membership: reconcile — re-agreeing world %s at epoch %d on "
            "data-path failure evidence", list(view.world), proposed_epoch)
        set_epoch(proposed_epoch)
        try:
            self._ensure_bus(view)
            reply = self._request(
                {"op": "hello", "rank": self.rank, "epoch": proposed_epoch,
                 "world": list(view.world)},
                timeout=self.rendezvous_timeout_s + 15.0)
        except (_BusUnreachable, OSError):
            # the bus itself is unreachable: the wedge evidence and the
            # dead coordinator point at the same process — name it and
            # take the shrink path (which owns the failover escalation)
            coord = view.coordinator
            if coord == self.rank:
                raise
            get_logger().error(
                "membership: reconcile could not reach the bus — treating "
                "coordinator %d as failed", coord)
            return self.shrink({coord})
        if reply.get("minority"):
            # the bus answered but refused: this side of a partition
            # mustered only a minority at the rendezvous — park
            self._park_minority(view, view.world,
                                reply.get("responders") or ())
        agreed = MembershipView(reply["epoch"], tuple(reply["world"]))
        if self.rank not in agreed.world:
            raise Evicted(f"rank {self.rank} is outside the agreed world "
                          f"{list(agreed.world)}")
        return self._maybe_apply(agreed)

    # -- applying an agreed view ------------------------------------------

    def _maybe_apply(self, view: MembershipView) -> MembershipView:
        """Re-point this process at ``view``: advance the epoch, rebuild
        mesh+engine on the new world size, re-shard attached components.
        Idempotent and monotonic — concurrent appliers (detector thread
        vs a trainer thread that saw a stale sync reply) serialize here
        and the second is a no-op."""
        with self._apply_lock:
            old = self._view
            if view.epoch <= old.epoch:
                return old
            t0 = time.monotonic()
            grew = len(view.world) > len(old.world)
            set_epoch(view.epoch)
            from ..core import api
            if api.initialized():
                api.suspend()
            _resume_for_world(view, self.device)
            self._view = view
            if self.assigner is not None:
                try:
                    self.assigner.reshard(view.num_workers)
                except Exception:  # noqa: BLE001 — a shape the shrunk
                    # world can't satisfy must not kill a healthy
                    # survivor; routing keeps the old map, service
                    # survives (mixed-mode assigners need an explicit
                    # reshard(num_servers, num_workers) from
                    # on_world_change — the split is deployment-specific)
                    get_logger().error(
                        "membership: ServerAssigner reshard to %d failed; "
                        "keeping the previous assignment (drive "
                        "reshard() from on_world_change for mixed mode)",
                        view.num_workers, exc_info=True)
            if self.server_engine is not None:
                self.server_engine.set_membership_epoch(view.epoch)
            if self.kv_store is not None:
                self.kv_store.set_membership_epoch(view.epoch)
            self._ensure_bus(view, prev_coordinator=old.coordinator)
            if view.coordinator != old.coordinator:
                # the clock reference moved with the coordinator: later
                # trace flushes must carry the offset to the NEW bus
                self._sync_clock()
            # heartbeat re-hosting: the UDP server follows the NEW
            # coordinator and every survivor re-points its beats; fresh
            # monitors also reset the fired-once latch, so "rank 0 down"
            # leaves a world that still detects the NEXT failure
            self._restart_heartbeat(view)
            if self.rank == self.standby_rank:
                # just became (or stayed) the standby of a changed world:
                # bootstrap the replica now instead of waiting for the
                # next piggybacked reply
                self._pull_replica()
            counters.inc("membership.grow" if grew else "membership.shrink")
            _flight.record("membership.applied", epoch=view.epoch,
                           world=list(view.world), grew=grew)
            self._record_span("rejoin" if grew else "shrink", t0, view)
            get_logger().warning(
                "membership: now epoch %d, world %s (%d worker(s))",
                view.epoch, list(view.world), view.num_workers)
        with self._ready_cv:
            self._ready_cv.notify_all()
        if self.on_world_change is not None:
            try:
                self.on_world_change(view)
            except Exception:  # noqa: BLE001 — the transition itself
                # succeeded; a broken user callback must not undo that
                get_logger().error("on_world_change callback raised",
                                   exc_info=True)
        return view

    def wait_ready(self, epoch: int,
                   timeout: Optional[float] = None) -> MembershipView:
        """Block until the local view reaches ``epoch`` (trainer-side
        helper for exception paths where the applying thread is
        elsewhere)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._ready_cv:
            while self._view.epoch < epoch:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise MembershipTimeout(
                        f"world change to epoch {epoch} not applied "
                        f"locally within {timeout:.1f}s")
                self._ready_cv.wait(0.1 if remaining is None
                                    else min(remaining, 0.1))
        return self._view

    def _record_span(self, name: str, t0: float,
                     view: MembershipView) -> None:
        """Membership transition span into the *resumed* engine's tracer
        (same placement as RecoveryCoordinator._record_span)."""
        try:
            from ..core import api
            eng = api._require()
        except Exception:  # noqa: BLE001 — tracing is best-effort
            return
        eng.tracer.record_span(name, t0, time.monotonic(),
                               epoch=view.epoch, world=list(view.world))

    # -- rejoin ------------------------------------------------------------

    @classmethod
    def rejoin(cls, rank: int, bus: Optional[str] = None, *,
               device=None, timeout: Optional[float] = None,
               **kwargs) -> Tuple["ElasticMembership", Optional[int], Any]:
        """Rejoin a running world from a fresh process.

        Parks on the bus until the survivors pass a step boundary, then
        adopts the agreed epoch, re-declares every tensor in the
        received declared-key order (identical key assignment), starts
        the engine (``api.resume`` with nothing suspended starts one,
        on ``device``, default ``"cuda"``), and returns
        ``(membership, step, state)`` — ``state`` is the survivors'
        in-memory parameters (``utils.checkpoint.unpack_state``), the
        elastic counterpart of restore-then-broadcast, and ``step`` the
        training step it corresponds to.
        """
        counters.inc("membership.rejoin_requested")
        t0 = time.monotonic()
        probe = cls(rank, [rank], bus, device=device, **kwargs)
        if bus is None:
            # a rejoiner does not know the current coordinator (its solo
            # probe view resolves to its OWN host-map entry); with a host
            # map configured, ping entries in rank order and park on the
            # first bus that answers
            probe._discover_bus()
        wait_s = probe.sync_timeout_s if timeout is None else timeout
        reply = probe._request({"op": "rejoin", "rank": int(rank)},
                               timeout=wait_s + 15.0)
        if not reply.get("ok"):
            raise MembershipTimeout(
                f"rejoin of rank {rank} was not admitted: {reply!r}")
        view = MembershipView(reply["epoch"], tuple(reply["world"]))
        set_epoch(view.epoch)
        from ..core import api
        for name in reply.get("declared") or ():
            api.declare(name)   # original order ⇒ identical keys
        _resume_for_world(view, device)
        probe._view = view
        probe._ensure_bus(view)   # no-op unless this rank is coordinator
        state = None
        if reply.get("state") is not None:
            from ..utils.checkpoint import unpack_state
            state = unpack_state(reply["state"])
        counters.inc("membership.rejoined")
        _flight.record("membership.rejoined", rank=int(rank),
                       epoch=view.epoch, world=list(view.world),
                       step=reply.get("step"))
        global _active_ref
        _active_ref = weakref.ref(probe)
        probe._record_span("rejoin", t0, view)
        get_logger().warning(
            "membership: rank %d rejoined at epoch %d, world %s, step %s",
            rank, view.epoch, list(view.world), reply.get("step"))
        return probe, reply.get("step"), state


def _resume_for_world(view: MembershipView, device=None) -> None:
    """Resume the engine for the agreed world.

    Multi-process (a ``torch.distributed`` group of several hosts,
    ``DMLC_NUM_WORKER > 1``): the world size IS the host count, so it is
    exported through ``resume(num_workers=)`` exactly as the reference's
    ``BytePSBasics.resume`` would.  Rebuilding an NCCL group of the
    survivors needs a rendezvous per epoch that this module does not
    run (ROADMAP Queue A item 7).

    Single-controller (one process per member, each its own group of one
    — the elastic topology of the CPU chaos tests and of the card's
    elastic phase): the membership world is a *bus-level* fact, not the
    local group; resume re-forms the local group unchanged and must NOT
    rewrite ``DMLC_NUM_WORKER`` (that would send the next bootstrap
    down the multi-process rendezvous path)."""
    from ..core import api
    suspended = api._suspended
    cfg = suspended[0] if suspended is not None else None
    if cfg is not None and cfg.num_hosts > 1:
        api.resume(num_workers=view.num_workers, device=device)
    else:
        api.resume(device=device)


# monkeypatch point for tests (escalation must not kill the test runner)
_exit = os._exit
