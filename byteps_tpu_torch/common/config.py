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
  - BYTEPS_ENABLE_ASYNC                  -> enable_async
  - BYTEPS_SERVER_ENGINE_THREAD / BYTEPS_SERVER_ENABLE_SCHEDULE /
    BYTEPS_SERVER_DEBUG_KEY              -> server_engine_threads /
                                            server_enable_schedule /
                                            server_debug_key
  - BYTEPS_KEY_HASH_FN / BYTEPS_ENABLE_MIXED_MODE /
    BYTEPS_MIXED_MODE_BOUND              -> key_hash_fn / enable_mixed_mode
                                            / mixed_mode_bound
  - BYTEPS_SERVE_REPLICAS / BYTEPS_SERVE_HOT_KEYS -> serve_replicas /
                                            serve_hot_keys (the
                                            ServerAssigner's replica sets)
  - BYTEPS_INTEGRITY / BYTEPS_INTEGRITY_LOOPBACK /
    BYTEPS_INTEGRITY_MAX_RETRANSMITS / BYTEPS_NONFINITE_POLICY
                                         -> integrity_on /
                                            integrity_loopback /
                                            integrity_max_retransmits /
                                            nonfinite_policy
  - BYTEPS_FAULT_SPEC / BYTEPS_FAULT_SEED -> fault_spec / fault_seed
  - BYTEPS_RETRY_MAX_ATTEMPTS / BYTEPS_RETRY_BASE_DELAY /
    BYTEPS_RETRY_MAX_DELAY / BYTEPS_RETRY_DEADLINE
                                         -> retry_max_attempts /
                                            retry_base_delay_s /
                                            retry_max_delay_s /
                                            retry_deadline_s
  - BYTEPS_SHARDED_PARAM_CODEC           -> sharded_param_codec
  - BYTEPS_LOG_LEVEL                     -> log_level
  - BYTEPS_TRACE_ON / _START_STEP / _END_STEP / _DIR / _JAX / _SAMPLE /
    _CAPACITY                            -> trace_on / trace_start_step /
                                            trace_end_step / trace_dir /
                                            trace_jax (the device profiler,
                                            torch.profiler here) /
                                            trace_sample / trace_capacity
  - BYTEPS_TELEMETRY_ON / BYTEPS_OBS_PORT / BYTEPS_OBS_HOST
                                         -> telemetry_on / obs_port /
                                            obs_host
  - BYTEPS_FLIGHT_RECORDER / _CAPACITY / _DIR / _DUMP_ON_EXIT
                                         -> flight_recorder_on /
                                            flight_capacity / flight_dir /
                                            flight_dump_on_exit
  - BYTEPS_TS_ON / _INTERVAL_S / _WINDOW -> ts_on / ts_interval_s /
                                            ts_window
  - BYTEPS_HEALTH_ON / _WINDOWS / _OVERLAP_FLOOR / _BURN_RATE /
    _SKEW_RATIO                          -> health_on / health_windows /
                                            health_overlap_floor /
                                            health_burn_rate /
                                            health_skew_ratio
  - BYTEPS_LOCK_WITNESS                  -> lock_witness

``partition_pinned`` / ``credit_pinned`` are set when the environment
variable is present (whatever its value) or the field is given a value
other than its default; the planner never moves a pinned knob
(JAX ``config.py:761-771``, ``1002-1005``).

``init`` builds the engine's config with :meth:`Config.from_env` (or
takes the caller's) and the engine owns it.  The planes without an
engine (the parameter server, the integrity envelope, the retry policy,
the tracer, the flight recorder, the lock witness) read the process-wide
config of :func:`get_config`, built from the environment at first use or
installed with :func:`set_config`, as in the JAX package.

``trace_dir`` and ``flight_dir`` default, through
:func:`trace_dir_from_env` and :func:`flight_dir_from_env`, to a per-user
directory under the system's temporary directory, never the working
directory.

Not ported: the knobs of the planes the port does not have yet
(membership and the sync deadline, the clock-offset estimate, serving,
durability, the transport).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

# Partition bounds are rounded up to a multiple of this (config.py:73).
ALIGN_BYTES = 4096

# Reference default for BYTEPS_PARTITION_BYTES (config.py:79).
PARTITION_BYTES_DEFAULT = 4096000


def _per_user_tmp(prefix: str) -> str:
    try:
        who = str(os.getuid())
    except AttributeError:  # no getuid (non-POSIX)
        who = os.environ.get("USERNAME") or os.environ.get("USER") or "user"
    return os.path.join(tempfile.gettempdir(), f"{prefix}_{who}")


def trace_dir_from_env() -> str:
    """``BYTEPS_TRACE_DIR`` if set and non-empty, else a per-user
    directory under the system's temporary directory (JAX
    ``config.py:82-100``): shared by the field's default,
    :meth:`Config.from_env` and ``tools/bps_trace.py``."""
    return os.environ.get("BYTEPS_TRACE_DIR") or _per_user_tmp(
        "byteps_traces")


def flight_dir_from_env() -> str:
    """``BYTEPS_FLIGHT_DIR`` if set and non-empty, else a per-user
    directory under the system's temporary directory (JAX
    ``config.py:103-121``)."""
    return os.environ.get("BYTEPS_FLIGHT_DIR") or _per_user_tmp(
        "byteps_flight")


def _parse_trace_sample(spec: str) -> int:
    """``BYTEPS_TRACE_SAMPLE``: '' / '0' = off; 'N' or '1/N' = capture
    every Nth push (JAX ``config.py:124-142``)."""
    s = (spec or "").strip()
    if not s or s == "0":
        return 0
    if s.startswith("1/"):
        s = s[2:]
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"BYTEPS_TRACE_SAMPLE must be '1/N' or an integer N (0 = "
            f"off), got {spec!r}") from None
    if n < 0:
        raise ValueError(f"BYTEPS_TRACE_SAMPLE must be >= 0, got {spec!r}")
    return n


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


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


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
    # The quantized parameter leg: a codec spec ("onebit", "topk:0.25",
    # "randomk:64", "dithering:16", "powersgd:2") applied, with error
    # feedback, to each slot's update before it crosses the pull leg;
    # "auto" lets the planner pick per size (plan_param_codec); "" = full
    # precision.  Requires sharded_update.
    sharded_param_codec: str = ""

    # --- native core ---
    # The C++ priority/credit queue (native/core.cc).  With True a failed
    # build or load raises; False selects the Python heap.
    use_native: bool = True

    # --- modes ---
    enable_async: bool = False       # async-PS weight deltas
    #                                  (torch/async_opt.py)

    # --- server engine (reference server.cc) ---
    server_engine_threads: int = 4
    server_enable_schedule: bool = False
    server_debug_key: str = ""
    key_hash_fn: str = "djb2"        # server/sharding.py ServerAssigner
    enable_mixed_mode: bool = False
    mixed_mode_bound: int = 101
    serve_replicas: int = 1          # hot-key replica set size
    serve_hot_keys: int = 8          # keys eligible for a replica set

    # --- data integrity (common/integrity.py) ---
    # CRC32C envelopes and the non-finite quarantine on every host hop of
    # the parameter server; False = nothing sealed, hashed or screened
    integrity_on: bool = True
    # in-process ServerEngine pushes skip the seal->CRC->open round trip
    # while no chaos is armed (one plain copy instead)
    integrity_loopback: bool = True
    integrity_max_retransmits: int = 3
    nonfinite_policy: str = "raise"  # raise | skip | zero

    # --- fault injection (fault/injector.py) ---
    fault_spec: str = ""             # armed by init(); empty = disabled
    fault_seed: int = 0

    # --- retry/backoff (common/retry.py) ---
    retry_max_attempts: int = 3
    retry_base_delay_s: float = 0.1
    retry_max_delay_s: float = 2.0
    retry_deadline_s: float = 60.0

    # --- observability (JAX config.py:650-756, same defaults) ---
    log_level: str = "WARNING"
    trace_on: bool = False           # the step window [start, end)
    trace_start_step: int = 10
    trace_end_step: int = 20
    trace_dir: str = dataclasses.field(default_factory=trace_dir_from_env)
    trace_jax: bool = False          # the device profiler over the window
    trace_sample: str = ""           # '1/N': every Nth push, no window
    trace_sample_n: int = -1         # resolved form of trace_sample
    trace_capacity: int = 65536      # in-memory events before the spill
    telemetry_on: bool = True        # wire counters, step statistics
    obs_port: Optional[int] = None   # HTTP endpoint; None = off, 0 = any
    obs_host: str = "127.0.0.1"
    flight_recorder_on: bool = True
    flight_capacity: int = 4096
    flight_dir: str = dataclasses.field(default_factory=flight_dir_from_env)
    flight_dump_on_exit: bool = False
    ts_on: bool = True               # the time-series sampler
    ts_interval_s: float = 2.0
    ts_window: int = 256
    health_on: bool = True           # the SLO rules, each sampler tick
    health_windows: int = 3
    health_overlap_floor: float = 0.2
    health_burn_rate: float = 1.0
    health_skew_ratio: float = 4.0
    # the runtime lock-order witness (common/lock_witness.py); read when
    # a lock is built, so the env var backs the default of every Config
    lock_witness: bool = dataclasses.field(
        default_factory=lambda: _env_bool("BYTEPS_LOCK_WITNESS", False))

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
        if self.serve_replicas < 1:
            raise ValueError("serve_replicas must be >= 1 (1 = primary "
                             "only, no replication)")
        if self.serve_hot_keys < 0:
            raise ValueError("serve_hot_keys must be >= 0")
        if self.nonfinite_policy not in ("raise", "skip", "zero"):
            raise ValueError(
                f"BYTEPS_NONFINITE_POLICY must be raise, skip, or zero — "
                f"got {self.nonfinite_policy!r}")
        if self.integrity_max_retransmits < 0:
            raise ValueError("integrity_max_retransmits must be >= 0")
        if self.sharded_param_codec not in ("", "auto"):
            # "name" or "name:param": the name and the parameter meet the
            # registry and the quality gate at declare_update
            parts = self.sharded_param_codec.split(":")
            if (len(parts) > 2 or not parts[0]
                    or any(ch.isspace() for ch in self.sharded_param_codec)):
                raise ValueError(
                    "sharded_param_codec must be '', 'auto', 'name' or "
                    f"'name:param', got {self.sharded_param_codec!r}")
        if self.sharded_param_codec and not self.sharded_update:
            raise ValueError(
                "sharded_param_codec requires sharded_update "
                "(BYTEPS_SHARDED_UPDATE=1) — the parameter all-gather "
                "leg only exists in sharded-update mode")
        if self.obs_port is not None and not 0 <= self.obs_port < 65536:
            raise ValueError("obs_port must be in 0..65535 (0 = ephemeral)")
        if self.flight_capacity <= 0:
            raise ValueError("flight_capacity must be positive")
        if self.trace_sample_n < 0:
            self.trace_sample_n = _parse_trace_sample(self.trace_sample)
        if self.trace_capacity < 256:
            raise ValueError("trace_capacity must be >= 256")
        if self.ts_interval_s <= 0:
            raise ValueError("ts_interval_s must be positive")
        if self.ts_window < 8:
            raise ValueError("ts_window must be >= 8 — the health rules "
                             "need at least a few windows of history to "
                             "judge a trend")
        if self.health_windows < 1:
            raise ValueError("health_windows must be >= 1")
        if not 0 <= self.health_overlap_floor <= 1:
            raise ValueError("health_overlap_floor must be in [0, 1] — "
                             "it is a fraction of the step wall")
        if self.health_burn_rate <= 0:
            raise ValueError("health_burn_rate must be positive")
        if self.health_skew_ratio <= 1:
            raise ValueError("health_skew_ratio must be > 1 — a ratio at "
                             "or below the median can never mean skew")

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
            sharded_param_codec=_env_str("BYTEPS_SHARDED_PARAM_CODEC", ""),
            enable_async=_env_bool("BYTEPS_ENABLE_ASYNC", False),
            server_engine_threads=_env_int("BYTEPS_SERVER_ENGINE_THREAD", 4),
            server_enable_schedule=_env_bool("BYTEPS_SERVER_ENABLE_SCHEDULE",
                                             False),
            server_debug_key=_env_str("BYTEPS_SERVER_DEBUG_KEY", ""),
            key_hash_fn=_env_str("BYTEPS_KEY_HASH_FN", "djb2"),
            enable_mixed_mode=_env_bool("BYTEPS_ENABLE_MIXED_MODE", False),
            mixed_mode_bound=_env_int("BYTEPS_MIXED_MODE_BOUND", 101),
            serve_replicas=_env_int("BYTEPS_SERVE_REPLICAS", 1),
            serve_hot_keys=_env_int("BYTEPS_SERVE_HOT_KEYS", 8),
            integrity_on=_env_bool("BYTEPS_INTEGRITY", True),
            integrity_loopback=_env_bool("BYTEPS_INTEGRITY_LOOPBACK", True),
            integrity_max_retransmits=_env_int(
                "BYTEPS_INTEGRITY_MAX_RETRANSMITS", 3),
            nonfinite_policy=_env_str("BYTEPS_NONFINITE_POLICY",
                                      "raise").strip().lower(),
            fault_spec=_env_str("BYTEPS_FAULT_SPEC", ""),
            fault_seed=_env_int("BYTEPS_FAULT_SEED", 0),
            retry_max_attempts=_env_int("BYTEPS_RETRY_MAX_ATTEMPTS", 3),
            retry_base_delay_s=_env_float("BYTEPS_RETRY_BASE_DELAY", 0.1),
            retry_max_delay_s=_env_float("BYTEPS_RETRY_MAX_DELAY", 2.0),
            retry_deadline_s=_env_float("BYTEPS_RETRY_DEADLINE", 60.0),
            log_level=_env_str("BYTEPS_LOG_LEVEL", "WARNING"),
            trace_on=_env_bool("BYTEPS_TRACE_ON", False),
            trace_start_step=_env_int("BYTEPS_TRACE_START_STEP", 10),
            trace_end_step=_env_int("BYTEPS_TRACE_END_STEP", 20),
            trace_dir=trace_dir_from_env(),
            trace_jax=_env_bool("BYTEPS_TRACE_JAX", False),
            trace_sample=_env_str("BYTEPS_TRACE_SAMPLE", ""),
            trace_capacity=_env_int("BYTEPS_TRACE_CAPACITY", 65536),
            telemetry_on=_env_bool("BYTEPS_TELEMETRY_ON", True),
            obs_port=(_env_int("BYTEPS_OBS_PORT", 0)
                      if os.environ.get("BYTEPS_OBS_PORT") not in (None, "")
                      else None),
            obs_host=_env_str("BYTEPS_OBS_HOST", "127.0.0.1"),
            flight_recorder_on=_env_bool("BYTEPS_FLIGHT_RECORDER", True),
            flight_capacity=_env_int("BYTEPS_FLIGHT_CAPACITY", 4096),
            flight_dir=flight_dir_from_env(),
            flight_dump_on_exit=_env_bool("BYTEPS_FLIGHT_DUMP_ON_EXIT",
                                          False),
            ts_on=_env_bool("BYTEPS_TS_ON", True),
            ts_interval_s=_env_float("BYTEPS_TS_INTERVAL_S", 2.0),
            ts_window=_env_int("BYTEPS_TS_WINDOW", 256),
            health_on=_env_bool("BYTEPS_HEALTH_ON", True),
            health_windows=_env_int("BYTEPS_HEALTH_WINDOWS", 3),
            health_overlap_floor=_env_float(
                "BYTEPS_HEALTH_OVERLAP_FLOOR", 0.2),
            health_burn_rate=_env_float("BYTEPS_HEALTH_BURN_RATE", 1.0),
            health_skew_ratio=_env_float("BYTEPS_HEALTH_SKEW_RATIO", 4.0),
            lock_witness=_env_bool("BYTEPS_LOCK_WITNESS", False),
            # the variable's presence is the pin, whatever its value
            partition_pinned=("BYTEPS_PARTITION_BYTES" in os.environ
                              or None),
            credit_pinned=("BYTEPS_SCHEDULING_CREDIT" in os.environ
                           or None),
        )


_config: Optional[Config] = None


def get_config() -> Config:
    """The process-wide config, built from the environment on first use."""
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def set_config(cfg: Config) -> None:
    """Install an explicit process-wide config (tests, embedding
    applications)."""
    global _config
    _config = cfg


def reset_config() -> None:
    global _config
    _config = None
