"""Client-side consistent-hash ring for the distributed serving tier;
port of ``byteps_tpu/server/serve_ring.py`` (pure Python: the same host
set and vnodes route every key to the same host as the JAX ring).

The in-process serving plane (``server/serving.py``) routes reads by a
modulo hash (``ServerAssigner``): any change in the endpoint count
re-routes EVERY key.  That is fine for thread-replicas sharing one
snapshot store, and fatal for a tier of real serving hosts — a host
joining or leaving would invalidate every client's cache affinity and
every host's shipped key set at once, a full-model reshuffle over DCN.

This module is the standard fix: a consistent-hash ring with virtual
nodes.  Each host owns ``BYTEPS_SERVE_TIER_VNODES`` points on a 64-bit
circle (blake2b — deterministic across processes, like
``sharding.key_to_int``; Python's salted ``hash()`` would route the same
key to different hosts on different machines).  A key is owned by the
first point clockwise from its own hash; replicas are the next DISTINCT
hosts clockwise.  Adding or removing a host remaps only the arcs that
host's points bound — ~1/N of the key space — so:

- clients keep their delta bases for every unaffected key,
- the publisher re-ships only the moved arcs' keys,
- and the tier scales host-by-host without a global reshuffle
  (the property the autoscaler's whole economics rest on).

Every process that builds the ring from the same (host set, vnodes)
derives the IDENTICAL routing — the ring is pure data, synchronized via
the membership bus's serving-host directory generation
(``serving_tier.TierDirectory``), never via pickled ring state.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Dict, Iterable, List, Optional

__all__ = ["ServeRing"]

_SPACE = 1 << 64


def _point(data: str) -> int:
    """Deterministic 64-bit circle position (no process hash salt)."""
    digest = hashlib.blake2b(data.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


def _key_point(key) -> int:
    # namespaced apart from vnode points so a key can never collide
    # with a host's own point by construction of the same string
    return _point(f"k/{key}")


class ServeRing:
    """The hash ring: ``{host_id}`` -> ``vnodes`` points on a 64-bit
    circle; ``owner(key)`` walks clockwise.  Thread-safe — the router
    reads it per pull while the directory thread applies membership.

    Mutation is cheap (sorted-list insert/remove of one host's points),
    lookup is a bisect.  Host ids are opaque ints (the serving-host
    directory's ids)."""

    def __init__(self, hosts: Iterable[int] = (),
                 vnodes: Optional[int] = None):
        if vnodes is None:
            from ..common.config import get_config
            vnodes = get_config().serve_tier_vnodes
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._lock = threading.Lock()
        self._points: List[int] = []          # sorted circle positions
        self._owners: Dict[int, int] = {}     # position -> host id
        self._hosts: set = set()
        for h in hosts:
            self.add(h)

    # -- membership ---------------------------------------------------------

    def _host_points(self, host_id: int) -> List[int]:
        return [_point(f"h/{host_id}/{v}") for v in range(self.vnodes)]

    def add(self, host_id: int) -> None:
        host_id = int(host_id)
        with self._lock:
            if host_id in self._hosts:
                return
            self._hosts.add(host_id)
            for p in self._host_points(host_id):
                if p in self._owners:
                    # astronomically unlikely 64-bit collision: lowest
                    # host id wins deterministically on every process
                    if self._owners[p] <= host_id:
                        continue
                    self._owners[p] = host_id
                    continue
                self._owners[p] = host_id
                bisect.insort(self._points, p)

    def remove(self, host_id: int) -> None:
        host_id = int(host_id)
        with self._lock:
            if host_id not in self._hosts:
                return
            self._hosts.discard(host_id)
            for p in self._host_points(host_id):
                if self._owners.get(p) == host_id:
                    del self._owners[p]
                    i = bisect.bisect_left(self._points, p)
                    if i < len(self._points) and self._points[i] == p:
                        del self._points[i]

    def set_hosts(self, hosts: Iterable[int]) -> None:
        """Converge to exactly ``hosts`` (the directory's current view):
        only the difference is touched, so unaffected arcs keep their
        positions."""
        target = {int(h) for h in hosts}
        for h in sorted(self.hosts() - target):
            self.remove(h)
        for h in sorted(target - self.hosts()):
            self.add(h)

    def hosts(self) -> set:
        with self._lock:
            return set(self._hosts)

    def __len__(self) -> int:
        with self._lock:
            return len(self._hosts)

    # -- routing ------------------------------------------------------------

    def owner(self, key) -> int:
        """The host owning ``key`` (its primary).  Raises when the ring
        is empty — routing against no hosts is a caller bug, not a
        silent default."""
        return self.replica_hosts(key, 1)[0]

    def replica_hosts(self, key, n: int) -> List[int]:
        """The first ``min(n, len(hosts))`` DISTINCT hosts clockwise
        from the key's point: entry 0 is the owner, the rest are its
        failover/replica set.  Deterministic on every process."""
        kp = _key_point(key)
        with self._lock:
            if not self._points:
                raise LookupError("serve ring has no hosts")
            want = min(max(1, n), len(self._hosts))
            out: List[int] = []
            start = bisect.bisect_right(self._points, kp)
            for i in range(len(self._points)):
                p = self._points[(start + i) % len(self._points)]
                h = self._owners[p]
                if h not in out:
                    out.append(h)
                    if len(out) == want:
                        break
            return out

    # -- observability ------------------------------------------------------

    def arc_share(self) -> Dict[int, float]:
        """Fraction of the 64-bit circle each host owns (sums to 1.0) —
        the load-balance figure ``bps_top``'s ARC column renders and the
        autoscaler's scale-down victim choice reads.  With enough
        vnodes every share approaches 1/N."""
        with self._lock:
            if not self._points:
                return {}
            shares: Dict[int, float] = {h: 0.0 for h in self._hosts}
            pts = self._points
            for i, p in enumerate(pts):
                prev = pts[i - 1]           # wraps: pts[-1] for i == 0
                arc = (p - prev) % _SPACE
                if len(pts) == 1:
                    arc = _SPACE
                shares[self._owners[p]] += arc / _SPACE
            return shares

    def moved_keys(self, keys, other: "ServeRing", n: int = 1
                   ) -> List:
        """Keys whose replica set differs between this ring and
        ``other`` — the re-ship set after a membership change (test and
        publisher helper)."""
        return [k for k in keys
                if self.replica_hosts(k, n) != other.replica_hosts(k, n)]
