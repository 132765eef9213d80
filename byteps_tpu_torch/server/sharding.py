"""Key -> server/shard assignment: the reference's server-choice hashing;
port of ``byteps_tpu/server/sharding.py``, whole (the same hash functions
and routing, so a key lands on the same shard in both packages).

Reference (global.cc:566-677): each 64-bit chunk key is routed to one of
``num_servers`` by a configurable hash (``BYTEPS_KEY_HASH_FN`` =
naive | built_in | djb2 | sdbm | mixed), with per-server byte-load
accounting logged at shutdown.  Mixed mode splits traffic between
non-colocated and colocated servers by a ratio derived from the cluster
shape (``BYTEPS_ENABLE_MIXED_MODE`` / ``BYTEPS_MIXED_MODE_BOUND``).

The same assignment problem appears when the async KV store is
partitioned across hosts — this module is that router, hash-compatible
with the reference so documented tuning advice carries over.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional

__all__ = ["hash_naive", "hash_built_in", "hash_djb2", "hash_sdbm",
           "key_to_int", "ServerAssigner"]

_MASK = (1 << 64) - 1


def key_to_int(key) -> int:
    """Stable 64-bit identity for a non-integer key (the serving plane
    routes by STRING parameter names, the training plane by declared
    integer keys — both must land in the same hash space
    deterministically across processes)."""
    if isinstance(key, int):
        return key
    digest = hashlib.blake2b(str(key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


def hash_naive(key: int) -> int:
    # global.cc:598 — ((key>>16) + (key%65536)) * 9973
    return (((key >> 16) + (key % 65536)) * 9973) & _MASK


def hash_built_in(key: int) -> int:
    # std::hash<string> is implementation-defined but stable within a
    # build; Python's hash() is salted per process (PYTHONHASHSEED), which
    # would route the same key to different shards on different hosts —
    # use a deterministic digest instead
    digest = hashlib.blake2b(str(key).encode(), digest_size=8).digest()
    return (int.from_bytes(digest, "little") * 9973) & _MASK


def hash_djb2(key: int) -> int:
    h = 5381
    for c in str(key).encode():
        h = ((h << 5) + h + c) & _MASK      # h*33 + c
    return h


def hash_sdbm(key: int) -> int:
    h = 0
    for c in str(key).encode():
        h = (c + (h << 6) + (h << 16) - h) & _MASK  # h*65599 + c
    return h


_FNS = {"naive": hash_naive, "built_in": hash_built_in,
        "djb2": hash_djb2, "sdbm": hash_sdbm}


class ServerAssigner:
    """Stable key->server routing with byte-load accounting.

    ``mixed`` mode (global.cc:566-596): with W workers colocated with
    servers and S total servers, the first ``ratio`` share of hash space
    goes to the S-W non-colocated servers, the rest to colocated ones —
    keeping the colocated machines' NICs from double-duty."""

    def __init__(self, num_servers: int, fn: Optional[str] = None,
                 mixed_mode: Optional[bool] = None, num_workers: int = 0,
                 bound: Optional[int] = None,
                 replicas: Optional[int] = None,
                 hot_keys: Optional[int] = None):
        if num_servers < 1:
            raise ValueError("num_servers must be >= 1")
        if replicas is None or hot_keys is None:
            from ..common.config import get_config
            scfg = get_config()
            replicas = scfg.serve_replicas if replicas is None else replicas
            hot_keys = scfg.serve_hot_keys if hot_keys is None else hot_keys
        if replicas < 1:
            raise ValueError("replicas must be >= 1 (1 = primary only)")
        self.replicas = replicas
        self.hot_key_budget = hot_keys
        if fn is None or mixed_mode is None or bound is None:
            # env-reachable knobs (reference global.cc:159-176, 566-596):
            # BYTEPS_KEY_HASH_FN, BYTEPS_ENABLE_MIXED_MODE,
            # BYTEPS_MIXED_MODE_BOUND — explicit arguments win
            from ..common.config import get_config
            cfg = get_config()
            fn = cfg.key_hash_fn if fn is None else fn
            if mixed_mode is None:
                mixed_mode = cfg.enable_mixed_mode
                if mixed_mode and num_workers == 0:
                    num_workers = cfg.num_hosts
            bound = cfg.mixed_mode_bound if bound is None else bound
        if fn not in _FNS:
            raise ValueError(f"unknown hash fn {fn!r}; one of {list(_FNS)}")
        self.num_servers = num_servers
        self.fn_name = fn
        self._fn = _FNS[fn]
        self._mixed = mixed_mode
        self._bound = bound
        self._num_workers = num_workers
        self._init_mixed()
        self._cache: Dict[int, int] = {}
        self.load_bytes: List[int] = [0] * num_servers
        self._lock = threading.Lock()
        # read-side state (the serving plane): per-key pull-count
        # histogram feeding hot-key replica sets.  Writes stay
        # primary-routed (assign); reads fan across replica_set(key).
        self._pull_counts: Dict[object, int] = {}
        self._replica_sets: Dict[object, List[int]] = {}

    def _init_mixed(self) -> None:
        """(Re)derive the mixed-mode split from the current shape."""
        if not self._mixed:
            return
        nonco = self.num_servers - self._num_workers
        if not 0 < nonco <= self._num_workers:
            raise ValueError(
                "mixed mode needs 0 < num_servers - num_workers <= "
                "num_workers (global.cc ratio constraint)")
        if self._bound < self.num_servers:
            raise ValueError("BYTEPS_MIXED_MODE_BOUND must be >= "
                             "num_servers")
        w = self._num_workers
        self._ratio = (2.0 * nonco * (w - 1)) / (
            w * (w + nonco) - 2 * nonco)
        self._threshold = self._ratio * self._bound
        self._nonco = nonco

    def reshard(self, num_servers: int,
                num_workers: Optional[int] = None) -> None:
        """Re-hash the key space for a changed world (elastic shrink or
        rejoin).  Drops the assignment cache —
        every key re-routes under the new server count — and restarts
        the byte-load accounting.  A mixed-mode assigner REQUIRES an
        explicit ``num_workers``: the colocated/non-colocated split is
        deployment-specific and inferring it would silently misroute
        the key space; a shape the new world cannot satisfy raises and
        the previous shape is kept (the caller decides whether to
        degrade)."""
        if num_servers < 1:
            raise ValueError("num_servers must be >= 1")
        if self._mixed and num_workers is None:
            raise ValueError(
                "mixed-mode reshard needs an explicit num_workers (the "
                "colocated/non-colocated split cannot be inferred from "
                "the server count alone)")
        with self._lock:
            old = (self.num_servers, self._num_workers)
            self.num_servers = num_servers
            if num_workers is not None:
                self._num_workers = num_workers
            try:
                self._init_mixed()
            except ValueError:
                self.num_servers, self._num_workers = old
                raise
            self._cache.clear()
            self.load_bytes = [0] * num_servers
            # replica sets are rebuilt for the new shard count from the
            # RETAINED pull histogram (hotness does not change with the
            # world): a set that named a now-dead shard is replaced, so
            # reads degrade to live shards instead of erroring
            self._rebuild_replicas_locked()

    def _assign_locked(self, key: int, nbytes: int) -> int:
        sid = self._cache.get(key)
        if sid is None:
            if self._mixed:
                r = hash_djb2(key) % self._bound
                if r < self._threshold:
                    sid = hash_djb2(r) % self._nonco
                else:
                    sid = self._nonco + hash_djb2(r) % self._num_workers
            else:
                sid = self._fn(key) % self.num_servers
            self._cache[key] = sid
        self.load_bytes[sid] += nbytes
        return sid

    def assign(self, key: int, nbytes: int = 0) -> int:
        with self._lock:
            return self._assign_locked(key, nbytes)

    # -- read-side replication (the serving plane) ---------------------------

    def record_pull(self, key, nbytes: int = 0) -> None:
        """Count one pull of ``key`` into the hotness histogram (and its
        bytes into the PRIMARY shard's load accounting — routing load
        follows writes; replica reads are deliberately not charged, they
        exist to take load OFF the primary's figure)."""
        with self._lock:
            self._pull_counts[key] = self._pull_counts.get(key, 0) + 1
        if nbytes:
            self.assign(key_to_int(key), nbytes)

    def record_pulls(self, keys) -> None:
        """Bulk form of :meth:`record_pull` for the serving hot path:
        ONE lock acquisition for a whole-model pull's key list instead
        of K acquire/release cycles serializing concurrent clients."""
        with self._lock:
            counts = self._pull_counts
            for key in keys:
                counts[key] = counts.get(key, 0) + 1

    def pull_count(self, key) -> int:
        with self._lock:
            return self._pull_counts.get(key, 0)

    def hot_keys(self, top_n: Optional[int] = None) -> List:
        """The ``top_n`` most-pulled keys (default: the configured
        hot-key budget), hottest first."""
        n = self.hot_key_budget if top_n is None else top_n
        with self._lock:
            ranked = sorted(self._pull_counts.items(),
                            key=lambda kv: (-kv[1], str(kv[0])))
            return [k for k, c in ranked[:n] if c > 0]

    def _replica_set_for(self, key) -> List[int]:
        """Caller holds the lock: ``min(replicas, num_servers)`` DISTINCT
        shards starting at the key's primary — deterministic, so every
        process derives the identical set."""
        primary = self._assign_locked(key_to_int(key), 0)
        n = min(self.replicas, self.num_servers)
        return [(primary + j) % self.num_servers for j in range(n)]

    def _rebuild_replicas_locked(self) -> None:
        self._replica_sets.clear()
        if self.replicas <= 1 or self.hot_key_budget <= 0:
            return
        ranked = sorted(self._pull_counts.items(),
                        key=lambda kv: (-kv[1], str(kv[0])))
        for key, count in ranked[:self.hot_key_budget]:
            if count > 0:
                self._replica_sets[key] = self._replica_set_for(key)

    def rebuild_replicas(self) -> Dict[object, List[int]]:
        """(Re)derive the hot-key replica sets from the current pull
        histogram; returns a copy of ``{key: [shard, ...]}`` (first
        entry is the primary — writes route there, reads fan across the
        whole set)."""
        with self._lock:
            self._rebuild_replicas_locked()
            return {k: list(v) for k, v in self._replica_sets.items()}

    def replica_set(self, key) -> List[int]:
        """Shards ``key`` is readable from: its hot-key replica set, or
        ``[primary]`` for a cold key.  Writes must use
        :meth:`write_target` (always the primary) regardless."""
        with self._lock:
            s = self._replica_sets.get(key)
            if s:
                return list(s)
            return [self._assign_locked(key_to_int(key), 0)]

    def write_target(self, key) -> int:
        """Writes stay primary-routed — replication is a READ fan-out;
        a write landing on a replica would fork the value history."""
        return self.assign(key_to_int(key), 0)

    def load_summary(self) -> str:
        """Per-server accumulated bytes (the reference logs this at
        shutdown for balance debugging)."""
        total = sum(self.load_bytes) or 1
        return ", ".join(
            f"s{i}: {b} ({100.0 * b / total:.1f}%)"
            for i, b in enumerate(self.load_bytes))
