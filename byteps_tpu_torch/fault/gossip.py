"""SWIM-style gossip membership plane; port of
``byteps_tpu/fault/gossip.py``, whole.  The table, its merge precedence,
the digest's wire shape (``"from"``, ``"entries"``, ``"payloads"`` keyed
``"<rank>/<kind>"``) and the seeded peer choice are the JAX module's, so
a digest from either package merges into a table of the other.

The JAX package's description follows.

Every rank keeps a local **membership table**

    rank -> {incarnation, state in (alive | suspect | dead | parked),
             heartbeat counter}

and disseminates it by anti-entropy: each gossip period the agent picks
``gossip_fanout`` random live peers and exchanges full digests (the
tables are tiny — a few dozen bytes per rank — so full-state exchange
beats delta bookkeeping at the 64-rank scale this plane targets).  The
wire is pluggable: production rides the membership bus ``gossip`` verb
(fault/membership.py), so envelopes/CRC/frame clamps are reused rather
than reinvented; tests use :class:`InMemoryWire` to run 64 ranks in one
process.

State machine per remote rank (local clock, monotonic):

    alive --no hb progress for gossip_suspect_s--> suspect
    suspect --gossip_dead_s more without progress--> dead
    suspect/dead --higher incarnation from the rank itself--> alive

**Refutation**: a rank that sees ITSELF suspected/declared dead in a
merged digest bumps its own incarnation past the accusation and
re-asserts ``alive`` — a slow-but-live rank un-suspects itself instead
of being shot (``gossip.refutations`` counter + flight event).  Merge
precedence: higher incarnation wins outright; at equal incarnation the
more-damning state wins (dead > parked > suspect > alive), and at equal
state the higher heartbeat counter wins.

World *agreement* stays epoch-based (fault/membership.py) but becomes
quorum-gated when ``BYTEPS_GOSSIP_ON`` is set: :func:`quorum_ok` is the
one shared predicate — a shrink proposal commits only when a STRICT
majority of the last agreed world is reachable.  The minority side of a
partition parks (engine suspended, ``membership.partition_minority``)
and rejoins through the ordinary rejoin path when the partition heals;
two disjoint minorities can never both hold a strict majority of the
same last world, so two epochs can never advance concurrently.

Piggybacked **payloads** (serve_dir, metrics/history windows) ride the
same digests as ``(version, value)`` pairs merged by highest version,
so ``cluster_metrics()`` / ``bps_top`` / ``bps_doctor`` can be answered
from any rank's local table with no bus round-trip fan-in.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..common import flight_recorder as _flight
from ..common import health as _health
from ..common.config import get_config
from ..common.lock_witness import named_lock
from ..common.logging import get_logger
from ..common.telemetry import counters
from . import injector as _fault

log = get_logger()

__all__ = [
    "ALIVE", "SUSPECT", "DEAD", "PARKED",
    "GossipTable", "GossipAgent", "InMemoryWire", "quorum_ok",
]

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
PARKED = "parked"

# Merge precedence at EQUAL incarnation: the more-damning claim wins.
# A rank escapes a damning state only by raising its incarnation
# (refutation), never by re-gossiping a stale happy claim.
_PRECEDENCE = {ALIVE: 0, SUSPECT: 1, PARKED: 2, DEAD: 3}
_STATES = tuple(_PRECEDENCE)


def quorum_ok(proposed_world: Iterable[int],
              last_world: Iterable[int]) -> bool:
    """Strict-majority gate for epoch agreement: the proposed world must
    hold MORE than half of the last agreed world.  Strictness is the
    split-brain proof for even splits: 2-of-4 is not a quorum, so
    neither half of an even partition can commit."""
    return 2 * len(tuple(proposed_world)) > len(tuple(last_world))


class GossipTable:
    """The per-rank membership table plus piggybacked payloads.

    Thread-safe; every mutation happens under one lock.  Time is always
    passed in (``now``) so tests drive the state machine with a fake
    clock — nothing in here reads the wall clock.
    """

    def __init__(self, rank: int, world: Iterable[int], *,
                 suspect_s: Optional[float] = None,
                 dead_s: Optional[float] = None,
                 now: Optional[float] = None):
        cfg = get_config()
        self.rank = int(rank)
        self.suspect_s = float(suspect_s if suspect_s is not None
                               else cfg.gossip_suspect_s)
        self.dead_s = float(dead_s if dead_s is not None
                            else cfg.gossip_dead_s)
        now = time.monotonic() if now is None else now
        self._lock = named_lock("gossip.table")
        # rank -> {"inc": int, "state": str, "hb": int}
        self._entries: Dict[int, Dict[str, Any]] = {}
        # rank -> local monotonic time of last observed hb progress
        self._progress: Dict[int, float] = {}
        # rank -> monotonic time the rank entered suspect (refutation
        # window anchor); cleared on any progress
        self._suspect_at: Dict[int, float] = {}
        # (rank, kind) -> (version, value): serve_dir / metrics / history
        self._payloads: Dict[Tuple[int, str], Tuple[int, Any]] = {}
        for r in world:
            self._entries[int(r)] = {"inc": 0, "state": ALIVE, "hb": 0}
            self._progress[int(r)] = now

    # ------------------------------------------------------------- read

    def snapshot(self) -> Dict[int, Dict[str, Any]]:
        with self._lock:
            return {r: dict(e) for r, e in self._entries.items()}

    def state_of(self, rank: int) -> Optional[str]:
        with self._lock:
            e = self._entries.get(rank)
            return None if e is None else e["state"]

    def alive_ranks(self) -> List[int]:
        """Ranks currently believed reachable-and-well (alive only —
        a suspect rank is still *reachable* for quorum purposes, see
        :meth:`reachable_ranks`)."""
        with self._lock:
            return sorted(r for r, e in self._entries.items()
                          if e["state"] == ALIVE)

    def reachable_ranks(self) -> List[int]:
        """Ranks that count toward quorum: alive or merely suspect.
        Suspicion is a *refutable accusation*, not evidence of
        unreachability — counting suspects keeps a gray blip from
        parking a healthy majority."""
        with self._lock:
            return sorted(r for r, e in self._entries.items()
                          if e["state"] in (ALIVE, SUSPECT))

    def payload(self, rank: int, kind: str) -> Optional[Any]:
        with self._lock:
            ent = self._payloads.get((rank, kind))
            return None if ent is None else ent[1]

    def payloads_of_kind(self, kind: str) -> Dict[int, Any]:
        with self._lock:
            return {r: v for (r, k), (_, v) in self._payloads.items()
                    if k == kind}

    # ------------------------------------------------------------ write

    def beat(self, now: Optional[float] = None) -> None:
        """Advance the local rank's heartbeat counter (self-progress)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            e = self._entries.setdefault(
                self.rank, {"inc": 0, "state": ALIVE, "hb": 0})
            e["hb"] += 1
            if e["state"] in (SUSPECT, DEAD):
                # refute an accusation that arrived while we slept
                e["inc"] += 1
                e["state"] = ALIVE
            self._progress[self.rank] = now
            self._suspect_at.pop(self.rank, None)

    def set_payload(self, kind: str, value: Any) -> None:
        """Attach/refresh this rank's payload of ``kind``; version bumps
        monotonically so remote merges converge on the newest value."""
        with self._lock:
            old = self._payloads.get((self.rank, kind))
            ver = (old[0] + 1) if old else 1
            self._payloads[(self.rank, kind)] = (ver, value)

    def add_rank(self, rank: int, now: Optional[float] = None) -> None:
        """A join observed out-of-band (rejoin admitted by the bus)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            e = self._entries.get(rank)
            if e is None or e["state"] in (DEAD, PARKED):
                inc = (e["inc"] + 1) if e else 0
                self._entries[rank] = {"inc": inc, "state": ALIVE, "hb": 0}
                self._progress[rank] = now
                self._suspect_at.pop(rank, None)

    def mark(self, rank: int, state: str,
             now: Optional[float] = None) -> None:
        """Out-of-band state assertion (e.g. the local rank parking, or
        a kill observed by the bus).  Bumps the incarnation so the claim
        beats any alive claim already circulating."""
        if state not in _PRECEDENCE:
            raise ValueError(f"unknown gossip state {state!r}")
        now = time.monotonic() if now is None else now
        with self._lock:
            e = self._entries.setdefault(
                rank, {"inc": 0, "state": ALIVE, "hb": 0})
            if e["state"] != state:
                e["inc"] += 1
                e["state"] = state
            if state == ALIVE:
                self._progress[rank] = now
                self._suspect_at.pop(rank, None)

    # ------------------------------------------------------ anti-entropy

    def digest(self) -> Dict[str, Any]:
        """The full wire image: entries + payloads.  Small by design —
        O(world) dict-of-smallints plus the bounded payload windows."""
        with self._lock:
            return {
                "from": self.rank,
                "entries": {r: dict(e) for r, e in self._entries.items()},
                "payloads": {f"{r}/{k}": list(v)
                             for (r, k), v in self._payloads.items()},
            }

    def merge(self, digest: Dict[str, Any],
              now: Optional[float] = None) -> List[int]:
        """Merge a remote digest; returns the ranks whose entry changed.

        Refutation happens here: a remote claim that THIS rank is
        suspect/dead (at our incarnation or higher) is answered by
        bumping our incarnation past it and re-asserting alive — the
        next exchanges carry the refutation outward.
        """
        now = time.monotonic() if now is None else now
        changed: List[int] = []
        entries = digest.get("entries") or {}
        with self._lock:
            for r, remote in entries.items():
                r = int(r)
                state = remote.get("state")
                if state not in _PRECEDENCE:
                    continue
                inc = int(remote.get("inc", 0))
                hb = int(remote.get("hb", 0))
                if r == self.rank:
                    if (state in (SUSPECT, DEAD)
                            and inc >= self._entries[r]["inc"]
                            and self._entries[r]["state"] != PARKED):
                        # somebody is accusing us and their claim would
                        # win a merge elsewhere: out-bid it
                        me = self._entries[r]
                        me["inc"] = inc + 1
                        me["state"] = ALIVE
                        self._progress[r] = now
                        self._suspect_at.pop(r, None)
                        counters.inc("gossip.refutations")
                        _flight.record("gossip.refuted", rank=self.rank,
                                       accused_state=state,
                                       new_incarnation=me["inc"])
                        changed.append(r)
                    continue
                mine = self._entries.get(r)
                if mine is None:
                    self._entries[r] = {"inc": inc, "state": state,
                                        "hb": hb}
                    self._progress[r] = now
                    if state == SUSPECT:
                        self._suspect_at[r] = now
                    changed.append(r)
                    continue
                take = False
                if inc > mine["inc"]:
                    take = True
                elif inc == mine["inc"]:
                    if _PRECEDENCE[state] > _PRECEDENCE[mine["state"]]:
                        take = True
                    elif (state == mine["state"] and hb > mine["hb"]):
                        take = True
                if not take:
                    continue
                state_changed = (state != mine["state"]
                                 or inc != mine["inc"])
                hb_progress = hb > mine["hb"]
                mine.update(inc=inc, state=state, hb=hb)
                if hb_progress or state == ALIVE:
                    self._progress[r] = now
                    self._suspect_at.pop(r, None)
                if state == SUSPECT and r not in self._suspect_at:
                    self._suspect_at[r] = now
                if state_changed:
                    changed.append(r)
            # payloads: highest version wins
            for key, pair in (digest.get("payloads") or {}).items():
                try:
                    r_s, kind = str(key).split("/", 1)
                    r, ver, val = int(r_s), int(pair[0]), pair[1]
                except (ValueError, IndexError, TypeError):
                    continue
                cur = self._payloads.get((r, kind))
                if cur is None or ver > cur[0]:
                    self._payloads[(r, kind)] = (ver, val)
        return changed

    def sweep(self, now: Optional[float] = None) -> Dict[int, str]:
        """Apply the suspicion/death timeouts; returns {rank: new state}
        for every transition made this sweep."""
        now = time.monotonic() if now is None else now
        out: Dict[int, str] = {}
        with self._lock:
            for r, e in self._entries.items():
                if r == self.rank or e["state"] in (DEAD, PARKED):
                    continue
                seen = self._progress.get(r, now)
                if e["state"] == ALIVE:
                    if now - seen >= self.suspect_s:
                        e["inc"] += 0  # accusation rides OUR next digest
                        e["state"] = SUSPECT
                        self._suspect_at[r] = now
                        out[r] = SUSPECT
                elif e["state"] == SUSPECT:
                    since = self._suspect_at.get(r, seen)
                    if now - since >= self.dead_s:
                        e["state"] = DEAD
                        out[r] = DEAD
        for r, st in out.items():
            if st == SUSPECT:
                counters.inc("gossip.suspect")
            else:
                counters.inc("gossip.dead")
            _flight.record("gossip.state", rank=r, state=st,
                           by=self.rank)
        return out


class InMemoryWire:
    """Test wire: N tables in one process, exchange = direct merge.
    ``cut(a_side, b_side)`` models a partition (symmetric blackhole)."""

    def __init__(self):
        self.tables: Dict[int, GossipTable] = {}
        self._cut: Optional[Tuple[frozenset, frozenset]] = None

    def register(self, table: GossipTable) -> None:
        self.tables[table.rank] = table

    def cut(self, side_a: Iterable[int], side_b: Iterable[int]) -> None:
        self._cut = (frozenset(side_a), frozenset(side_b))

    def heal(self) -> None:
        self._cut = None

    def _severed(self, a: int, b: int) -> bool:
        if self._cut is None:
            return False
        sa, sb = self._cut
        return (a in sa and b in sb) or (a in sb and b in sa)

    def exchange(self, src: int, dst: int, digest: Dict[str, Any],
                 now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Push ``digest`` from src to dst; returns dst's digest back
        (the anti-entropy round trip), or None when unreachable."""
        if self._severed(src, dst):
            return None
        peer = self.tables.get(dst)
        if peer is None:
            return None
        peer.merge(digest, now=now)
        return peer.digest()


class GossipAgent:
    """Drives one rank's table: beat, pick k peers, exchange, sweep.

    ``wire(peer, digest) -> reply digest | None`` abstracts the
    transport; production passes a closure over the membership bus
    ``gossip`` verb, tests pass :class:`InMemoryWire.exchange`.
    ``step(now)`` is the whole period, callable directly (deterministic
    tests); ``start()`` runs it on a daemon thread every
    ``gossip_interval_s``.
    """

    def __init__(self, table: GossipTable,
                 wire: Callable[[int, Dict[str, Any]],
                                Optional[Dict[str, Any]]],
                 *, fanout: Optional[int] = None,
                 interval_s: Optional[float] = None,
                 seed: Optional[int] = None,
                 world_fn: Optional[Callable[[], Iterable[int]]] = None,
                 payload_fn: Optional[Callable[[], Dict[str, Any]]]
                 = None):
        cfg = get_config()
        self.table = table
        self.wire = wire
        self.fanout = int(fanout if fanout is not None
                          else cfg.gossip_fanout)
        self.interval_s = float(interval_s if interval_s is not None
                                else cfg.gossip_interval_s)
        # deterministic peer choice: seeded per rank, not wall-clock
        self._rng = random.Random(f"gossip/{table.rank}/"
                                  f"{seed if seed is not None else 0}")
        # the quorum denominator: the LAST AGREED world (membership
        # epoch view), not the gossip table — agreement gates against
        # what was committed, not against rumors
        self._world_fn = world_fn
        # {kind: value} refresher called once per period so serve_dir /
        # metrics / history windows ride the digests as payloads
        self._payload_fn = payload_fn
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # pin ONE bound-method object: accessing ``self.quorum_view``
        # builds a fresh bound method each time, and the health module
        # unregisters by identity
        self._provider_fn: Optional[Callable[[], Dict[str, int]]] = None

    # ------------------------------------------------------------ quorum

    def quorum_view(self) -> Dict[str, int]:
        """{"reachable": R, "world": W} for the health quorum_loss rule
        and the shrink gate: R = alive+suspect members of the last
        agreed world (self included), W = that world's size."""
        world = set(int(r) for r in (self._world_fn() if self._world_fn
                                     else self.table.snapshot()))
        reach = set(self.table.reachable_ranks()) | {self.table.rank}
        return {"reachable": len(reach & world) if world else len(reach),
                "world": len(world)}

    def register_health_provider(self) -> None:
        if self._provider_fn is None:
            self._provider_fn = self.quorum_view
        _health.set_quorum_provider(self._provider_fn)

    # -------------------------------------------------------------- run

    def step(self, now: Optional[float] = None) -> Dict[int, str]:
        """One gossip period: beat, exchange with k random peers, sweep.
        Returns the sweep's state transitions."""
        now = time.monotonic() if now is None else now
        if _fault.ENABLED:
            _fault.fire("gossip")
        self.table.beat(now=now)
        if self._payload_fn is not None:
            try:
                for kind, value in (self._payload_fn() or {}).items():
                    if value is not None:
                        self.table.set_payload(kind, value)
            except Exception:  # noqa: BLE001 — observability payloads
                pass           # must never stall the membership plane
        peers = [r for r in self.table.reachable_ranks()
                 if r != self.table.rank]
        self._rng.shuffle(peers)
        for peer in peers[:self.fanout]:
            if _fault.ENABLED and (_fault.should_drop("gossip")
                                   or _fault.edge_cut(peer)):
                continue
            try:
                reply = self.wire(peer, self.table.digest())
            except Exception:
                counters.inc("gossip.exchange_failed")
                continue
            if reply:
                self.table.merge(reply, now=now)
        return self.table.sweep(now=now)

    def start(self) -> "GossipAgent":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"gossip-r{self.table.rank}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        if self._provider_fn is not None:
            _health.clear_quorum_provider(self._provider_fn)
            self._provider_fn = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:
                # the gossip plane must never take the process down
                log.exception("gossip step failed")
                counters.inc("gossip.step_error")
