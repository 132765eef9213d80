"""The process-wide membership epoch; port of the epoch part of
``byteps_tpu/fault/membership.py`` (``current_epoch``, ``advance_epoch``,
``set_epoch``).

One integer, monotonic, shared by every layer that stamps or checks
work: the async optimizer stamps each logical push with it, and the
parameter server (``server/kv_store.py``, ``server/engine.py``) drops a
push stamped with another epoch.  Epoch 0 is the static world every
non-elastic run lives in forever.

Not ported yet: the views, the membership bus, elastic shrink and
rejoin, and the gossip plane (ROADMAP Queue A item 3).
"""

from __future__ import annotations

import threading

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
