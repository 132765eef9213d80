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
  - BYTEPS_AUTOTUNE                      -> autotune
  - BYTEPS_NATIVE                        -> use_native
  - BYTEPS_MIN_COMPRESS_BYTES            -> min_compress_bytes
  - BYTEPS_COMPRESS_AUTOTUNE             -> compress_autotune
  - BYTEPS_COMPRESS_ERROR_CEILING        -> compress_error_ceiling
  - BYTEPS_SHARDED_UPDATE                -> sharded_update
  - BYTEPS_SHARDED_UPDATE_FUSED          -> sharded_update_fused

``partition_pinned`` / ``credit_pinned`` are set when the environment
variable is present (whatever its value) or the field is given a value
other than its default; the planner never moves a pinned knob
(JAX ``config.py:761-771``, ``1002-1005``).

Unlike the JAX package there is no process-wide cached config: ``init``
builds one with :meth:`Config.from_env` (or takes the caller's) and the
engine owns it.

Not ported: the knobs of the planes the port does not have yet
(membership and the sync deadline, telemetry, tracing, the server), and
``sharded_param_codec`` (``BYTEPS_SHARDED_PARAM_CODEC``), the quantized
parameter leg of the sharded update: the JAX slot compresses the whole
update vector with one codec instance under one controller, where each
of the port's processes holds only its own block, so onebit's scale,
topk's and randomk's selection and PowerSGD's factors would each need a
design of their own across ranks.
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


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {v!r}") from None


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
    # Chunks popped per dispatch iteration (reference
    # BYTEPS_NCCL_GROUP_SIZE): up to this many eligible chunks are popped
    # and neighbours merged into one collective (engine._plan_batch); 0
    # reads as 1; < 0 is drain mode, every iteration pops the whole
    # eligible window.  At more than one rank the engine uses 1.
    group_size: int = 4
    # Auto-tuned chunk size and credit window per size bucket
    # (scheduler.ChunkPlanner); inert at more than one rank.
    autotune: bool = True

    # --- compression ---
    min_compress_bytes: int = 65536  # smaller tensors skip compression
    # The planner's compressor ladder (scheduler.ChunkPlanner): per size
    # bucket, race none/onebit/randomk/topk (with error feedback) and lock
    # the fastest whose golden gradient error is at most
    # compress_error_ceiling.  Off by default: a tuned codec changes
    # gradient values.  Tensors pushed with explicit compression kwargs
    # are pinned and never tuned; inert at more than one rank.
    compress_autotune: bool = False
    compress_error_ceiling: float = 0.55

    # --- sharded weight update (core/sharded_update.py) ---
    # The pull leg returns the owner-updated parameters instead of the
    # merged gradient: the reduce-scatter shard of a tensor declared with
    # ``declare_update`` stays on its owner, a torch.optim optimizer
    # steps that shard against a flat f32 master, and the owners'
    # updated slices are all-gathered.  Wire per tensor and step: push N
    # + pull N/R, where the replicated update ships N + N; optimizer
    # state per rank: 1/local_size.
    sharded_update: bool = False
    # Build each shard optimizer with fused=True (SGD, Adam, AdamW): one
    # fused kernel per step, which drifts from the unfused trajectory by
    # ulps (the default pins nothing and matches the replicated step bit
    # for bit).  Requires sharded_update.
    sharded_update_fused: bool = False

    # --- native core ---
    # The C++ priority/credit queue (native/core.cc).  With True a failed
    # build or load raises; False selects the Python heap.
    use_native: bool = True

    # None: resolved in __post_init__ (pinned when not the default)
    partition_pinned: Optional[bool] = None
    credit_pinned: Optional[bool] = None

    def __post_init__(self):
        if self.partition_bytes <= 0:
            raise ValueError("partition_bytes must be positive")
        if self.partition_pinned is None:
            self.partition_pinned = (self.partition_bytes
                                     != PARTITION_BYTES_DEFAULT)
        if self.credit_pinned is None:
            self.credit_pinned = self.scheduling_credit != 0
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
        if self.sharded_update_fused and not self.sharded_update:
            raise ValueError(
                "sharded_update_fused requires sharded_update "
                "(BYTEPS_SHARDED_UPDATE=1) — there is no update program "
                "to fuse outside sharded-update mode")
        if not 0 < self.compress_error_ceiling <= 1.0:
            raise ValueError(
                "compress_error_ceiling must be in (0, 1] — it is a "
                "relative gradient-error bound")

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
            autotune=_env_bool("BYTEPS_AUTOTUNE", True),
            min_compress_bytes=_env_int("BYTEPS_MIN_COMPRESS_BYTES", 65536),
            compress_autotune=_env_bool("BYTEPS_COMPRESS_AUTOTUNE", False),
            compress_error_ceiling=_env_float(
                "BYTEPS_COMPRESS_ERROR_CEILING", 0.55),
            use_native=_env_bool("BYTEPS_NATIVE", True),
            sharded_update=_env_bool("BYTEPS_SHARDED_UPDATE", False),
            sharded_update_fused=_env_bool("BYTEPS_SHARDED_UPDATE_FUSED",
                                           False),
            # the variable's presence is the pin, whatever its value
            partition_pinned=("BYTEPS_PARTITION_BYTES" in os.environ
                              or None),
            credit_pinned=("BYTEPS_SCHEDULING_CREDIT" in os.environ
                           or None),
        )
