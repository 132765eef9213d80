"""Fault injection, elastic membership, gossip and supervised recovery;
port of ``byteps_tpu/fault`` (``injector.py``, ``membership.py``,
``gossip.py`` whole; ``recovery.py``)."""

from . import gossip, injector, membership  # noqa: F401
from .injector import FaultInjector, arm, disarm  # noqa: F401
from .membership import (Demoted, ElasticMembership, Evicted,  # noqa: F401
                         MembershipTimeout, MembershipView,
                         PartitionMinority, WorldChanged)
from .recovery import RecoveryCoordinator, RecoveryResult  # noqa: F401
