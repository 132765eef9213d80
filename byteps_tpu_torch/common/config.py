"""Typed configuration: the subset of ``byteps_tpu/common/config.py`` that
the data-parallel gradient path reads.

Environment variable names are the ``BYTEPS_*`` / ``DMLC_*`` names of
``docs/env.md`` (the contract both packages share):

  - DMLC_NUM_WORKER / DMLC_WORKER_ID     -> num_hosts / host_id
  - BYTEPS_LOCAL_RANK / BYTEPS_LOCAL_SIZE -> local_rank / local_size
  - DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT -> coordinator_address
  - BYTEPS_PARTITION_BYTES               -> partition_bytes (rounded up to
                                            ALIGN_BYTES, config.py:795)
  - BYTEPS_SCHEDULING_CREDIT             -> scheduling_credit (0 = unlimited)
  - BYTEPS_ENABLE_PRIORITY               -> enable_priority
  - BYTEPS_GROUP_SIZE / BYTEPS_NCCL_GROUP_SIZE -> group_size
  - BYTEPS_MIN_COMPRESS_BYTES            -> min_compress_bytes

Unlike the JAX package there is no process-wide cached config: ``init``
builds one with :meth:`Config.from_env` (or takes the caller's) and the
engine owns it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

# Partition bounds are rounded up to a multiple of this (config.py:73).
ALIGN_BYTES = 4096

# Reference default for BYTEPS_PARTITION_BYTES (config.py:79).
PARTITION_BYTES_DEFAULT = 4096000


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}") from None


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() not in ("0", "false", "no", "off")


@dataclasses.dataclass
class Config:
    # --- topology / bootstrap ---
    num_hosts: int = 1               # DMLC_NUM_WORKER
    host_id: int = 0                 # DMLC_WORKER_ID
    local_rank: int = 0              # BYTEPS_LOCAL_RANK
    local_size: int = 1              # BYTEPS_LOCAL_SIZE
    coordinator_address: Optional[str] = None  # DMLC_PS_ROOT_URI:PORT

    # --- partitioning / scheduling ---
    partition_bytes: int = PARTITION_BYTES_DEFAULT
    scheduling_credit: int = 0       # bytes in flight; 0 = unlimited
    enable_priority: bool = True
    # Chunks per device program in the JAX engine.  Carried for the env
    # contract; the port issues one collective per chunk (chunk-group
    # batching is not ported yet).
    group_size: int = 4

    # --- compression ---
    min_compress_bytes: int = 65536  # smaller tensors skip compression

    def __post_init__(self):
        if self.partition_bytes <= 0:
            raise ValueError("partition_bytes must be positive")
        r = self.partition_bytes % ALIGN_BYTES
        if r and self.partition_bytes < 2**31 - ALIGN_BYTES:
            self.partition_bytes += ALIGN_BYTES - r
        if self.num_hosts < 1:
            raise ValueError("num_hosts must be >= 1")
        if self.local_size < 1:
            raise ValueError("local_size must be >= 1")
        if not 0 <= self.host_id < self.num_hosts:
            raise ValueError(f"host_id {self.host_id} not in "
                             f"[0, {self.num_hosts})")
        if not 0 <= self.local_rank < self.local_size:
            raise ValueError(f"local_rank {self.local_rank} not in "
                             f"[0, {self.local_size})")
        if self.scheduling_credit < 0:
            raise ValueError("scheduling_credit must be >= 0")
        if self.min_compress_bytes < 0:
            raise ValueError("min_compress_bytes must be >= 0")

    @property
    def world_size(self) -> int:
        return self.num_hosts * self.local_size

    @property
    def rank(self) -> int:
        return self.host_id * self.local_size + self.local_rank

    @classmethod
    def from_env(cls) -> "Config":
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        port = os.environ.get("DMLC_PS_ROOT_PORT")
        return cls(
            num_hosts=_env_int("DMLC_NUM_WORKER", 1),
            host_id=_env_int("DMLC_WORKER_ID", 0),
            local_rank=_env_int("BYTEPS_LOCAL_RANK", 0),
            local_size=_env_int("BYTEPS_LOCAL_SIZE", 1),
            coordinator_address=f"{uri}:{port}" if uri and port else None,
            partition_bytes=_env_int("BYTEPS_PARTITION_BYTES",
                                     PARTITION_BYTES_DEFAULT),
            scheduling_credit=_env_int("BYTEPS_SCHEDULING_CREDIT", 0),
            enable_priority=_env_bool("BYTEPS_ENABLE_PRIORITY", True),
            group_size=_env_int("BYTEPS_GROUP_SIZE",
                                _env_int("BYTEPS_NCCL_GROUP_SIZE", 4)),
            min_compress_bytes=_env_int("BYTEPS_MIN_COMPRESS_BYTES", 65536),
        )
