"""Asynchronous parameter-store semantics (reference byteps/server/);
port of ``byteps_tpu/server``.

What needs server semantics is asynchronous training (BYTEPS_ENABLE_ASYNC,
reference server.cc:310-314,417-419): workers push weight *deltas* and
pull fresh weights with no barrier.  ``kv_store.py`` provides that as a
host-side store; ``engine.py`` is the reference's synchronous merge
engine; ``sharding.py`` routes keys to servers.  The read plane serves
the store: ``serving.py`` (snapshots, delta pulls, replicas),
``serve_client.py`` (``PullClient``), ``serving_tier.py`` with
``serve_ring.py``, ``serve_host.py`` and ``serve_autoscaler.py`` (serving
hosts in processes of their own), and ``wal.py`` makes the store durable.
"""

from .engine import ServerEngine  # noqa: F401
from .kv_store import KVStore  # noqa: F401
from .serve_client import PullClient  # noqa: F401
from .serving import ServingPlane, SnapshotStore  # noqa: F401
from .serving_tier import ServingTier  # noqa: F401
