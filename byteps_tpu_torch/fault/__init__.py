"""Fault injection, the membership epoch and supervised recovery; port of
the ``byteps_tpu/fault`` parts ported so far (``injector.py``, whole;
``membership.py``'s epoch; ``recovery.py``).  The views, the bus, shrink
and rejoin, and gossip are not ported yet."""

from . import injector, membership  # noqa: F401
from .recovery import RecoveryCoordinator, RecoveryResult  # noqa: F401
