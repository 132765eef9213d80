"""Asynchronous parameter-store semantics (reference byteps/server/);
port of ``byteps_tpu/server``.

What needs server semantics is asynchronous training (BYTEPS_ENABLE_ASYNC,
reference server.cc:310-314,417-419): workers push weight *deltas* and
pull fresh weights with no barrier.  ``kv_store.py`` provides that as a
host-side store; ``engine.py`` is the reference's synchronous merge
engine; ``sharding.py`` routes keys to servers.  The serving plane
(``PullClient`` and its kin) is not ported yet (ROADMAP Queue A item 4).
"""

from .engine import ServerEngine  # noqa: F401
from .kv_store import KVStore  # noqa: F401
