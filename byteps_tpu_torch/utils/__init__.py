"""Utilities of the port (``byteps_tpu/utils`` counterparts):
checkpoint/resume, failure detection, slowness scoring, input prefetch,
timing; exported under the JAX package's names."""

from .checkpoint import (  # noqa: F401
    CheckpointManager,
    PendingSave,
    restore_and_broadcast,
    save_checkpoint,
)
from .failure_detector import HeartbeatMonitor, StepWatchdog  # noqa: F401
from .slowness import LatencyQuantile, SlownessTracker  # noqa: F401
from .prefetch import ShardedBatchLoader, prefetch_to_device  # noqa: F401
from .timing import Timer, throughput  # noqa: F401
