"""Leveled logging; port of ``byteps_tpu/common/logging.py``.

The reference's stream-macro logger with levels TRACE..FATAL selected by
``BYTEPS_LOG_LEVEL`` rides Python's stdlib logging here, under the
logger ``byteps_tpu_torch``; BPS_CHECK becomes :func:`check`.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "TRACE": logging.DEBUG - 5,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "FATAL": logging.CRITICAL,
}

logging.addLevelName(_LEVELS["TRACE"], "TRACE")

_logger = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        logger = logging.getLogger("byteps_tpu_torch")
        level_name = os.environ.get("BYTEPS_LOG_LEVEL", "WARNING").upper()
        logger.setLevel(_LEVELS.get(level_name, logging.WARNING))
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter(
                    "[%(asctime)s] [%(levelname)s] byteps_tpu_torch: %(message)s"
                )
            )
            logger.addHandler(h)
        logger.propagate = False
        _logger = logger
    return _logger


def check(cond: bool, msg: str = "") -> None:
    """BPS_CHECK equivalent (reference logging.h:44-67)."""
    if not cond:
        get_logger().critical(msg)
        raise AssertionError(f"byteps_tpu_torch check failed: {msg}")
