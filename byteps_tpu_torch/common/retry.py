"""Retry with exponential backoff, full jitter, and a deadline; port of
``byteps_tpu/common/retry.py``, whole.

The reference has no retry layer at all — a failed ps-lite bind or ssh
dispatch is a dead role the scheduler restarts wholesale.  Here transient
failures are retried in place: ``ServerEngine.pull`` timeouts, the
integrity envelope's NACK/retransmit loop and the async optimizer's
lost-ack retries.

Policy shape is the standard AWS full-jitter scheme: attempt ``k`` sleeps
``uniform(0, min(max_delay, base * 2**k))`` — the jitter decorrelates a
fleet of workers all retrying the same coordinator.  ``deadline_s``
bounds total elapsed time across attempts regardless of the attempt
budget.  Knobs ride ``Config`` (``BYTEPS_RETRY_*``, common/config.py);
``rng`` and ``sleep`` are injectable so tests pin the schedule without
wall-clock waits.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type

from .telemetry import counters
from .logging import get_logger

_log = get_logger()


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff, full jitter, max attempts, optional deadline."""

    max_attempts: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 2.0
    deadline_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)
    rng: random.Random = dataclasses.field(default_factory=random.Random)
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be non-negative")

    @classmethod
    def from_config(cls, cfg=None, **overrides) -> "RetryPolicy":
        """Build from the process config's BYTEPS_RETRY_* knobs."""
        if cfg is None:
            from .config import get_config
            cfg = get_config()
        kw = dict(max_attempts=cfg.retry_max_attempts,
                  base_delay_s=cfg.retry_base_delay_s,
                  max_delay_s=cfg.retry_max_delay_s,
                  deadline_s=cfg.retry_deadline_s)
        kw.update(overrides)
        return cls(**kw)

    def backoff(self, attempt: int) -> float:
        """Full-jitter sleep before retry ``attempt`` (1-based)."""
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** (attempt - 1)))
        return self.rng.uniform(0.0, cap)

    def call(self, fn: Callable, *args, describe: str = "", **kwargs):
        """Run ``fn`` with retries.  Re-raises the last exception when the
        attempt budget or deadline is exhausted."""
        what = describe or getattr(fn, "__name__", "call")
        t0 = time.monotonic()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:  # noqa: PERF203
                elapsed = time.monotonic() - t0
                out_of_time = (self.deadline_s is not None
                               and elapsed >= self.deadline_s)
                if attempt >= self.max_attempts or out_of_time:
                    counters.inc("retry.gave_up")
                    _log.error(
                        "%s failed after %d attempt(s) in %.2fs: %s",
                        what, attempt, elapsed, e)
                    raise
                delay = self.backoff(attempt)
                if (self.deadline_s is not None
                        and elapsed + delay > self.deadline_s):
                    # sleep only what the deadline allows; the next attempt
                    # is the last one the deadline check will admit
                    delay = max(0.0, self.deadline_s - elapsed)
                counters.inc("retry.attempt")
                _log.warning(
                    "%s attempt %d/%d failed (%s); retrying in %.3fs",
                    what, attempt, self.max_attempts, e, delay)
                if delay > 0:
                    self.sleep(delay)
