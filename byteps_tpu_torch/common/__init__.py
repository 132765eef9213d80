"""Common layer: config, types, registry, partitioner, scheduler, handles;
port of ``byteps_tpu/common``, exported under its names."""

from .config import Config, get_config, set_config, reset_config
from .handles import Handle, HandleManager
from .logging import check, get_logger
from .partitioner import chunk_bounds
from .registry import TensorRegistry
from .scheduler import ChunkScheduler
from .types import (
    ChunkTask,
    Stage,
    Status,
    StatusCode,
    TensorContext,
    make_key,
    split_key,
)

__all__ = [
    "Config", "get_config", "set_config", "reset_config",
    "Handle", "HandleManager",
    "check", "get_logger",
    "chunk_bounds",
    "TensorRegistry",
    "ChunkScheduler",
    "ChunkTask", "Stage", "Status", "StatusCode", "TensorContext",
    "make_key", "split_key",
]
