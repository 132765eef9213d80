"""Pull client: staleness-bounded, delta-pulling parameter consumer; port
of ``byteps_tpu/server/serve_client.py``.

The consumer half of the serving plane
(:mod:`~byteps_tpu_torch.server.serving`):
a :class:`PullClient` holds a local cache of parameter values plus the
``snapshot_id`` it was hydrated at, and on every :meth:`pull` chooses its
own consistency point:

- cache younger than ``max_staleness_s`` → served locally
  (``serve.cache_hits``), zero wire traffic;
- stale, ``block=True`` (default) → a DELTA pull against the plane
  (only keys whose version advanced since the cached snapshot travel,
  codec-encoded where the training plane registered one), then serve;
- stale, ``block=False`` or ``prefetch=True`` → the stale cache is
  served immediately (``serve.stale_served``) while a single-flight
  background refresh brings it forward (``serve.async_refresh``) — the
  online-learning consumer's mode: bounded staleness, never a stall.

Byte accounting: :attr:`bytes_received` sums the wire-encoded payload
bytes of every refresh — the figure the delta-pull tests assert
O(churn), not O(model), traffic with.

The cache holds torch tensors on the client's ``device`` (default
``"cuda"``, which raises without CUDA; tests pass ``"cpu"``): a raw key
is copied there, a compressed key is decoded there — onebit's
decompress is the unpack kernel of ``csrc/onebit.cu`` on a card.  A
compressed key comes back flat, as in the JAX client.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..comm.mesh import resolve_device
from ..common.logging import get_logger
from ..common.telemetry import counters

__all__ = ["PullClient"]


class PullClient:
    """One read-side consumer of a :class:`~.serving.ServingPlane`.

    ``keys=None`` tracks the whole model; a list restricts the working
    set (and the delta traffic) to those keys.  Thread-safe: one
    refresh at a time (single-flight), concurrent ``pull`` calls share
    its result."""

    def __init__(self, plane, keys: Optional[List[str]] = None,
                 max_staleness_s: Optional[float] = None,
                 prefetch: bool = False,
                 hedge: Optional[bool] = None,
                 stale_on_error: bool = False, device="cuda"):
        from ..common.config import get_config
        self.device = resolve_device(device)
        self._plane = plane
        self._keys = list(keys) if keys is not None else None
        self.max_staleness_s = (get_config().serve_max_staleness_s
                                if max_staleness_s is None
                                else max_staleness_s)
        self.prefetch = prefetch
        # per-client hedging override (None = the plane's policy): a
        # tail-sensitive consumer opts in even when the plane default
        # is sequential, and vice versa (docs/gray_failures.md)
        self.hedge = hedge
        # distributed-tier degradation (server/serving_tier.py): when a
        # refresh fails even after the router re-resolved the ring, a
        # client with a hydrated cache serves it stale
        # (serve.stale_on_error) instead of failing the read — staleness
        # bounded by the tier's heal time (TTL/retire), correctness
        # never at stake.  Off by default: the in-process plane's
        # callers expect errors.
        self.stale_on_error = stale_on_error
        self._cache: Dict[str, torch.Tensor] = {}
        self._versions: Dict[str, int] = {}
        self._codecs: Dict[str, object] = {}
        self._snapshot_id: Optional[int] = None
        self._fetched_at: float = 0.0
        self._refresh_lock = threading.Lock()
        # single-flight guard for background refreshes: acquired
        # non-blocking by the thread that wins the race, released when
        # its refresh finishes (an Event's check-then-set would let two
        # concurrent stale pulls both spawn refresh threads)
        self._inflight = threading.Lock()
        self.bytes_received = 0
        self.refreshes = 0

    # -- freshness -----------------------------------------------------------

    @property
    def snapshot_id(self) -> Optional[int]:
        return self._snapshot_id

    def staleness_s(self) -> float:
        """Seconds since the cache was last brought forward (``inf``
        before the first refresh)."""
        if self._snapshot_id is None:
            return float("inf")
        return time.monotonic() - self._fetched_at

    def version(self, key: str) -> int:
        return self._versions.get(key, -1)

    # -- the pull ------------------------------------------------------------

    def pull(self, keys: Optional[List[str]] = None,
             max_staleness_s: Optional[float] = None,
             block: bool = True) -> Dict[str, torch.Tensor]:
        """Return ``{key: value}`` no staler than the bound.

        ``block=False`` (or a client built with ``prefetch=True``)
        serves the current cache immediately when stale and refreshes in
        the background; the very first pull always blocks — there is
        nothing to serve yet."""
        bound = (self.max_staleness_s if max_staleness_s is None
                 else max_staleness_s)
        wanted = keys if keys is not None else self._keys
        # the _snapshot_id check keeps the first-pull-always-blocks
        # contract even for an unbounded staleness (inf <= inf would
        # otherwise "hit" an empty cache forever)
        if self._snapshot_id is not None and self.staleness_s() <= bound:
            counters.inc("serve.cache_hits")
            return self._slice(wanted)
        if self._snapshot_id is not None and (self.prefetch or not block):
            counters.inc("serve.stale_served")
            self._refresh_async()
            return self._slice(wanted)
        try:
            self.refresh()
        except Exception:  # noqa: BLE001 — opt-in stale degradation:
            # with a hydrated cache the read succeeds stale rather than
            # failing; an unhydrated client has nothing to degrade to
            if not (self.stale_on_error and self._snapshot_id is not None):
                raise
            counters.inc("serve.stale_on_error")
            get_logger().warning("serve: refresh failed, serving stale "
                                 "cache", exc_info=True)
        return self._slice(wanted)

    def _slice(self, keys: Optional[List[str]]
               ) -> Dict[str, torch.Tensor]:
        cache = self._cache     # bind ONCE: a concurrent refresh swaps
        #                         the reference; re-reading it per key
        #                         could mix two snapshots
        if keys is None:
            return dict(cache)
        return {k: cache[k] for k in keys if k in cache}

    # -- refresh machinery ---------------------------------------------------

    def _routed_pull(self):
        """One plane pull, with the distributed-tier re-resolution fix:
        on ``ServeUnavailable`` a router exposing ``reroute()`` gets ONE
        forced ring/directory re-resolution and the pull retries against
        the healed routing — the background single-flight refresh used
        to park on the dead host until the next cut republished the
        mirror sets.  Tier routers also receive the client's staleness
        bound (``accepts_max_stale``): the host may shed the pull only
        while that bound holds."""
        kw = {"since_id": self._snapshot_id, "keys": self._keys,
              "hedge": self.hedge}
        if getattr(self._plane, "accepts_max_stale", False):
            kw["max_stale_s"] = self.max_staleness_s
        try:
            return self._plane.pull(**kw)
        except Exception as e:
            from .serving import ServeUnavailable
            reroute = getattr(self._plane, "reroute", None)
            if not isinstance(e, ServeUnavailable) or reroute is None:
                raise
            reroute()
            return self._plane.pull(**kw)

    def refresh(self) -> None:
        """Bring the cache forward to the plane's latest snapshot with
        one delta pull (full on first contact or after the cached id
        aged out of retention server-side)."""
        with self._refresh_lock:
            reply = self._routed_pull()
            if getattr(reply, "shed", False):
                # admission control answered "keep your cache": the data
                # did not move, so neither does the freshness clock —
                # the next stale pull retries (cheaply) until the host
                # has budget again
                counters.inc("serve.shed_served")
                return
            # build the updated view ASIDE and publish it with one
            # reference swap: a concurrent non-blocking pull slicing
            # the cache mid-refresh must see snapshot N or N+1 whole,
            # never a torn mix of the two
            cache = dict(self._cache)
            versions = dict(self._versions)
            for k, item in reply.items.items():
                cache[k] = self._decode(k, item)
                versions[k] = item.version
            if reply.full and self._keys is None:
                # a whole-model client's keys absent from a FULL reply
                # no longer exist server-side (store cleared/re-keyed);
                # a restricted client keeps its slice regardless
                for k in list(cache):
                    if k not in reply.items:
                        del cache[k]
                        versions.pop(k, None)
            self._cache = cache
            self._versions = versions
            self._snapshot_id = reply.snapshot_id
            if getattr(reply, "shed_partial", False):
                # SOME hosts shed this merged pull: their keys are only
                # inside the bound as of NOW — advancing the clock would
                # let the whole cache (shed slices included) ride as
                # "fresh" for another full bound.  Apply the fresh
                # slices, keep the clock, retry (cheaply) next pull.
                counters.inc("serve.shed_served")
            else:
                self._fetched_at = time.monotonic()
            self.bytes_received += reply.wire_bytes
            self.refreshes += 1
            counters.inc("serve.cache_misses")

    def _refresh_async(self) -> None:
        """Single-flight background refresh: while one is in flight,
        further stale pulls keep serving the cache instead of piling up
        refresh threads (atomic test-and-set — losers return
        immediately)."""
        if not self._inflight.acquire(blocking=False):
            return
        counters.inc("serve.async_refresh")

        def run():
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 — the cache stays stale;
                # the next blocking pull surfaces the error
                get_logger().error("serve: async refresh failed",
                                   exc_info=True)
            finally:
                self._inflight.release()

        threading.Thread(target=run, daemon=True,
                         name="bps-serve-prefetch").start()

    def close(self) -> None:
        """Release the routing plane's resources when the client OWNS
        it — a per-client tier router (``client_owned = True``) holds
        supervised TCP connections, and dropping the client without
        closing would leak their supervisor threads.  A SHARED plane
        (``ServingPlane``) is never closed from here: clients do not
        own it."""
        if getattr(self._plane, "client_owned", False):
            self._plane.close()

    def _decode(self, key: str, item) -> torch.Tensor:
        """Materialize one reply item into cache memory the client owns,
        on its device (reply payloads may be COW views of server memory
        on the loopback fast path)."""
        from .kv_store import decode_on
        from .serving import torch_dtype
        if item.codec is None:
            return torch.tensor(np.asarray(item.payload), device=self.device)
        kwargs, numel, dtype_s = item.codec
        comp = self._codecs.get(key)
        if comp is None or comp[0] != (kwargs, numel, dtype_s):
            from ..compression import registry as reg
            comp = ((kwargs, numel, dtype_s),
                    reg.create(dict(kwargs), numel, torch_dtype(dtype_s),
                               for_server=True))
            self._codecs[key] = comp
        return decode_on(comp[1], bytes(item.payload), self.device)
