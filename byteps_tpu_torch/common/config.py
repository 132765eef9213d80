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
  - BYTEPS_SERVE_REPLICAS / _RETENTION / _HOT_KEYS / _MAX_STALENESS /
    _CUT_INTERVAL / _HEDGE_MS            -> serve_replicas /
                                            serve_retention /
                                            serve_hot_keys /
                                            serve_max_staleness_s /
                                            serve_cut_interval_s /
                                            serve_hedge_ms (the serving
                                            plane, server/serving.py)
  - BYTEPS_SERVE_TIER_VNODES / _REPLICAS / _RATE / _BURST / _QUEUE_HIGH /
    _TTL / _MIN_HOSTS / _MAX_HOSTS / _COOLDOWN / _BUS
                                         -> serve_tier_vnodes /
                                            serve_tier_replicas /
                                            serve_tier_rate /
                                            serve_tier_burst /
                                            serve_tier_queue_high /
                                            serve_tier_ttl_s /
                                            serve_tier_min_hosts /
                                            serve_tier_max_hosts /
                                            serve_tier_cooldown_s /
                                            serve_tier_bus (the serving
                                            tier, server/serving_tier.py)
  - BYTEPS_RECONCILE_INTERVAL / _FLAP_LIMIT / _FLAP_WINDOW /
    _DRAIN_DEADLINE / _BAN               -> reconcile_interval_s /
                                            reconcile_flap_limit /
                                            reconcile_flap_window_s /
                                            reconcile_drain_deadline_s /
                                            reconcile_ban_s
                                            (launcher/reconciler.py)
  - BYTEPS_DURABLE_DIR / BYTEPS_WAL_FSYNC / _FSYNC_INTERVAL /
    _SEGMENT_BYTES / _RETAIN             -> durable_dir / wal_fsync /
                                            wal_fsync_interval_s /
                                            wal_segment_bytes /
                                            wal_retain_snapshots
                                            (server/wal.py)
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
  - BYTEPS_HEARTBEAT_ON / _INTERVAL / _TIMEOUT -> heartbeat_on /
                                            heartbeat_interval_s /
                                            heartbeat_timeout_s
  - BYTEPS_FAILURE_EXIT_CODE             -> failure_exit_code
  - BYTEPS_SYNC_DEADLINE_S               -> sync_deadline_s
  - BYTEPS_SLOWNESS_PHI / _WINDOW        -> slowness_phi / slowness_window
  - BYTEPS_TRANSPORT_HOSTS / _PORT_BASE / _CONNECT_TIMEOUT /
    _SEND_DEADLINE / _KEEPALIVE / _MAX_INFLIGHT
                                         -> transport_hosts /
                                            transport_port_base /
                                            transport_connect_timeout_s /
                                            transport_send_deadline_s /
                                            transport_keepalive_s /
                                            transport_max_inflight
  - BYTEPS_BUS_MAX_FRAME                 -> bus_max_frame (the
                                            transport's and the membership
                                            bus's frame clamp)
  - BYTEPS_ELASTIC / BYTEPS_MEMBERSHIP_PORT / _HOSTS /
    _RENDEZVOUS_TIMEOUT / _SYNC_TIMEOUT  -> elastic / membership_port /
                                            membership_hosts /
                                            membership_rendezvous_timeout_s /
                                            membership_sync_timeout_s
  - BYTEPS_BUS_RETRIES                   -> bus_retries
  - BYTEPS_GOSSIP_ON / _INTERVAL_S / _FANOUT / _SUSPECT_S / _DEAD_S
                                         -> gossip_on / gossip_interval_s /
                                            gossip_fanout / gossip_suspect_s
                                            / gossip_dead_s
  - BYTEPS_STRAGGLER_POLICY / _DEMOTE_AFTER / _MIN_LAG
                                         -> straggler_policy /
                                            straggler_demote_after /
                                            straggler_min_lag_s
  - BYTEPS_CLOCK_SYNC_SAMPLES            -> clock_sync_samples

``host_id`` is not bounded by ``num_hosts``, as in the JAX ``Config``:
the elastic topology runs one process per member at ``DMLC_NUM_WORKER=1``
with ``DMLC_WORKER_ID`` set to the member's rank, and a bootstrap at one
host forms a group of one whatever ``host_id`` says.

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

The serving, tier, reconciler and durable knobs carry the JAX
``Config``'s defaults, environment names and validation messages.
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

    # --- parameter serving (server/serving.py, server/serve_client.py) ---
    serve_retention: int = 8         # snapshots kept per ring
    serve_max_staleness_s: float = 0.5   # PullClient's default bound
    # minimum seconds between write-driven snapshot cuts (0 = every
    # consistent write point)
    serve_cut_interval_s: float = 0.05
    serve_hedge_ms: float = 0.0      # fixed hedge delay; 0 = adaptive

    # --- distributed serving tier (server/serving_tier.py) ---
    serve_tier_vnodes: int = 64      # ring points per serving host
    serve_tier_replicas: int = 2     # hosts each key is shipped to
    serve_tier_rate: float = 0.0     # admission refill, pulls/s (0 = off)
    serve_tier_burst: float = 0.0    # bucket capacity (0 = 1 s of refill)
    serve_tier_queue_high: int = 64  # in-flight pulls before shedding
    serve_tier_ttl_s: float = 10.0   # directory registration TTL
    serve_tier_min_hosts: int = 1    # autoscaler floor
    serve_tier_max_hosts: int = 8    # autoscaler ceiling
    serve_tier_cooldown_s: float = 5.0   # between autoscaler decisions
    serve_tier_bus: str = ""         # "host:port" of the membership bus

    # --- fleet reconciler (launcher/reconciler.py) ---
    reconcile_interval_s: float = 0.5
    reconcile_flap_limit: int = 3    # crashes in the window -> ban
    reconcile_flap_window_s: float = 30.0
    reconcile_drain_deadline_s: float = 10.0
    reconcile_ban_s: float = 30.0    # directory ban of a flapping id

    # --- durable state plane (server/wal.py) ---
    durable_dir: str = ""            # empty = durability off
    wal_fsync: str = "always"        # always | interval | off
    wal_fsync_interval_s: float = 0.05
    wal_segment_bytes: int = 4 << 20
    wal_retain_snapshots: int = 2

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

    # --- failure detection (utils/failure_detector.py) ---
    heartbeat_on: bool = False       # arm the heartbeat at init (world > 1)
    heartbeat_interval_s: float = 1.0
    heartbeat_timeout_s: float = 30.0
    # the detector's restartable exit: the launchers' --restart
    # supervision restarts exactly this code (a crash exits 1)
    failure_exit_code: int = 17
    # per-unit deadline in the engine's sync loop (0 = off): a unit the
    # syncer stays blocked on past it is reported as data-path failure
    # evidence to the installed failure action; os._exit is the last
    # resort when none is installed
    sync_deadline_s: float = 0.0

    # --- slowness scoring (utils/slowness.py) ---
    slowness_phi: float = 8.0        # phi above which a peer is slow
    slowness_window: int = 64        # samples kept per (site, peer)
    # what the stack does about a slow-but-alive rank: wait (observe
    # only) | hedge (serving pulls fire a backup) | demote (the membership
    # bus moves a sustained straggler onto its probation list)
    straggler_policy: str = "wait"
    straggler_demote_after: int = 3  # consecutive slow barriers to demote
    # absolute floor a step-barrier lag must clear to count as slow (phi
    # self-calibrates, so an idle world's jitter must not score)
    straggler_min_lag_s: float = 0.25

    # --- elastic membership (fault/membership.py) ---
    elastic: bool = False            # survivors shrink in place
    membership_port: int = 0         # bus port; 0 = DMLC_PS_ROOT_PORT + 2
    # per-rank "host[:port]" list making the bus address view-aware; empty
    # = one fixed address (a single-host failover re-binds it)
    membership_hosts: str = ""
    # how long the shrink rendezvous waits for every proposed survivor
    membership_rendezvous_timeout_s: float = 10.0
    # the step barrier's quorum window: a member missing past it is
    # failure evidence
    membership_sync_timeout_s: float = 60.0
    bus_retries: int = 64            # bus-client attempts (rides a failover)
    # ping round trips of the clock-offset estimate against the bus host
    # (min-RTT sample wins); 0 = off
    clock_sync_samples: int = 5

    # --- gossip membership (fault/gossip.py) ---
    # SWIM table anti-entropy over the bus, and quorum-gated agreement: a
    # shrink commits only with a strict majority of the last agreed world
    gossip_on: bool = False
    gossip_interval_s: float = 0.2   # exchange period
    gossip_fanout: int = 3           # peers contacted per period
    gossip_suspect_s: float = 1.0    # no progress this long -> suspect
    gossip_dead_s: float = 3.0       # suspect this long -> dead

    # --- TCP transport (comm/transport.py) ---
    transport_hosts: str = ""        # per-rank "host[:port]", by rank
    transport_port_base: int = 0     # rank R listens on base + R; 0 = any
    transport_connect_timeout_s: float = 5.0
    # a request unanswered past it raises integrity.AckLost, never hangs
    transport_send_deadline_s: float = 10.0
    transport_keepalive_s: float = 5.0   # idle keepalive; 0 = none
    # unacknowledged request bytes per connection before a sender blocks
    transport_max_inflight: int = 64 << 20
    # frame-size clamp on both ends of a connection: a corrupt length
    # prefix fails the connection instead of parking a huge recv
    bus_max_frame: int = 1 << 30

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
        if self.host_id < 0:
            raise ValueError(f"host_id {self.host_id} must be >= 0")
        if not 0 <= self.local_rank < self.local_size:
            raise ValueError(f"local_rank {self.local_rank} not in "
                             f"[0, {self.local_size})")
        if self.scheduling_credit < 0:
            raise ValueError("scheduling_credit must be >= 0")
        if not 0 < self.failure_exit_code < 256:
            raise ValueError(
                f"failure_exit_code {self.failure_exit_code} is not "
                "restartable: it must survive a process exit status "
                "(1..255)")
        if self.failure_exit_code == 1:
            # 1 is the generic Python-crash code: supervision could not
            # tell a detector-requested restart from an ordinary crash
            raise ValueError(
                "failure_exit_code 1 is not restartable: it is "
                "indistinguishable from a generic crash to the "
                "launcher's --restart supervision; pick a code in "
                "2..255")
        if self.sync_deadline_s < 0:
            raise ValueError("sync_deadline_s must be >= 0 (0 = off)")
        if not 0 <= self.transport_port_base < 65536:
            raise ValueError("transport_port_base must be in 0..65535 "
                             "(0 = ephemeral)")
        if self.transport_connect_timeout_s <= 0:
            raise ValueError("transport_connect_timeout_s must be positive")
        if self.transport_send_deadline_s <= 0:
            raise ValueError(
                "transport_send_deadline_s must be positive — the "
                "per-send deadline is what turns a partitioned peer "
                "into AckLost instead of a hang")
        if self.transport_keepalive_s < 0:
            raise ValueError("transport_keepalive_s must be >= 0 (0 = "
                             "no keepalives)")
        if self.transport_max_inflight <= 0:
            raise ValueError("transport_max_inflight must be positive")
        if self.bus_max_frame <= 0:
            raise ValueError("bus_max_frame must be positive")
        if self.slowness_phi <= 0:
            raise ValueError("slowness_phi must be positive")
        if self.slowness_window < 8:
            raise ValueError("slowness_window must be >= 8")
        if self.straggler_policy not in ("wait", "hedge", "demote"):
            raise ValueError(
                f"BYTEPS_STRAGGLER_POLICY must be wait, hedge, or demote "
                f"— got {self.straggler_policy!r}")
        if self.straggler_demote_after < 1:
            raise ValueError("straggler_demote_after must be >= 1")
        if self.straggler_min_lag_s < 0:
            raise ValueError("straggler_min_lag_s must be >= 0")
        if (self.membership_rendezvous_timeout_s <= 0
                or self.membership_sync_timeout_s <= 0):
            raise ValueError("membership timeouts must be positive")
        if self.bus_retries < 1:
            raise ValueError("bus_retries must be >= 1 (at least one "
                             "attempt)")
        if self.gossip_interval_s <= 0:
            raise ValueError("gossip_interval_s must be positive")
        if self.gossip_fanout < 1:
            raise ValueError("gossip_fanout must be >= 1")
        if self.gossip_suspect_s <= 0:
            raise ValueError("gossip_suspect_s must be positive")
        if self.gossip_dead_s <= self.gossip_suspect_s:
            raise ValueError(
                "gossip_dead_s must exceed gossip_suspect_s — a rank "
                "must pass through suspect (the refutation window) "
                "before it can be declared dead")
        if not 0 <= self.membership_port < 65536:
            raise ValueError("membership_port must be in 0..65535")
        if self.clock_sync_samples < 0:
            raise ValueError("clock_sync_samples must be >= 0 (0 = off)")
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
        if self.serve_retention < 1:
            raise ValueError("serve_retention must be >= 1 (at least the "
                             "latest snapshot must stay pullable)")
        if self.serve_hot_keys < 0:
            raise ValueError("serve_hot_keys must be >= 0")
        if self.serve_max_staleness_s < 0:
            raise ValueError("serve_max_staleness_s must be >= 0")
        if self.serve_cut_interval_s < 0:
            raise ValueError("serve_cut_interval_s must be >= 0")
        if self.serve_hedge_ms < 0:
            raise ValueError("serve_hedge_ms must be >= 0 (0 = adaptive)")
        if self.serve_tier_vnodes < 1:
            raise ValueError("serve_tier_vnodes must be >= 1")
        if self.serve_tier_replicas < 1:
            raise ValueError("serve_tier_replicas must be >= 1 (the "
                             "owning host)")
        if self.serve_tier_rate < 0:
            raise ValueError("serve_tier_rate must be >= 0 (0 = no token "
                             "bucket, queue watermark only)")
        if self.serve_tier_burst < 0:
            raise ValueError("serve_tier_burst must be >= 0 (0 = one "
                             "second of refill)")
        if self.serve_tier_queue_high < 1:
            raise ValueError("serve_tier_queue_high must be >= 1")
        if self.serve_tier_ttl_s <= 0:
            raise ValueError("serve_tier_ttl_s must be positive — a "
                             "non-expiring directory entry would pin a "
                             "dead host in every client's ring forever")
        if self.serve_tier_min_hosts < 1:
            raise ValueError("serve_tier_min_hosts must be >= 1")
        if self.serve_tier_max_hosts < self.serve_tier_min_hosts:
            raise ValueError("serve_tier_max_hosts must be >= "
                             "serve_tier_min_hosts")
        if self.serve_tier_cooldown_s < 0:
            raise ValueError("serve_tier_cooldown_s must be >= 0")
        if self.reconcile_interval_s <= 0:
            raise ValueError("reconcile_interval_s must be positive")
        if self.reconcile_flap_limit < 1:
            raise ValueError("reconcile_flap_limit must be >= 1 (the "
                             "crash count that triggers the ban)")
        if self.reconcile_flap_window_s <= 0:
            raise ValueError("reconcile_flap_window_s must be positive")
        if self.reconcile_drain_deadline_s <= 0:
            raise ValueError("reconcile_drain_deadline_s must be "
                             "positive — a 0 deadline would kill every "
                             "drain before its first in-flight pull "
                             "finished")
        if self.reconcile_ban_s < 0:
            raise ValueError("reconcile_ban_s must be >= 0")
        if self.wal_fsync not in ("always", "interval", "off"):
            raise ValueError(
                "wal_fsync must be one of always|interval|off — an "
                "unknown policy would silently weaken the durability "
                "guarantee the operator thinks they have")
        if self.wal_fsync_interval_s <= 0:
            raise ValueError("wal_fsync_interval_s must be positive")
        if self.wal_segment_bytes < 4096:
            raise ValueError("wal_segment_bytes must be >= 4096 — a "
                             "sub-page segment rolls on every record")
        if self.wal_retain_snapshots < 1:
            raise ValueError("wal_retain_snapshots must be >= 1 (the "
                             "latest durable cut must survive pruning)")
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
            serve_retention=_env_int("BYTEPS_SERVE_RETENTION", 8),
            serve_max_staleness_s=_env_float("BYTEPS_SERVE_MAX_STALENESS",
                                             0.5),
            serve_cut_interval_s=_env_float("BYTEPS_SERVE_CUT_INTERVAL",
                                            0.05),
            serve_hedge_ms=_env_float("BYTEPS_SERVE_HEDGE_MS", 0.0),
            serve_tier_vnodes=_env_int("BYTEPS_SERVE_TIER_VNODES", 64),
            serve_tier_replicas=_env_int("BYTEPS_SERVE_TIER_REPLICAS", 2),
            serve_tier_rate=_env_float("BYTEPS_SERVE_TIER_RATE", 0.0),
            serve_tier_burst=_env_float("BYTEPS_SERVE_TIER_BURST", 0.0),
            serve_tier_queue_high=_env_int(
                "BYTEPS_SERVE_TIER_QUEUE_HIGH", 64),
            serve_tier_ttl_s=_env_float("BYTEPS_SERVE_TIER_TTL", 10.0),
            serve_tier_min_hosts=_env_int("BYTEPS_SERVE_TIER_MIN_HOSTS", 1),
            serve_tier_max_hosts=_env_int("BYTEPS_SERVE_TIER_MAX_HOSTS", 8),
            serve_tier_cooldown_s=_env_float(
                "BYTEPS_SERVE_TIER_COOLDOWN", 5.0),
            serve_tier_bus=_env_str("BYTEPS_SERVE_TIER_BUS", ""),
            reconcile_interval_s=_env_float("BYTEPS_RECONCILE_INTERVAL",
                                            0.5),
            reconcile_flap_limit=_env_int("BYTEPS_RECONCILE_FLAP_LIMIT",
                                          3),
            reconcile_flap_window_s=_env_float(
                "BYTEPS_RECONCILE_FLAP_WINDOW", 30.0),
            reconcile_drain_deadline_s=_env_float(
                "BYTEPS_RECONCILE_DRAIN_DEADLINE", 10.0),
            reconcile_ban_s=_env_float("BYTEPS_RECONCILE_BAN", 30.0),
            durable_dir=_env_str("BYTEPS_DURABLE_DIR", ""),
            wal_fsync=_env_str("BYTEPS_WAL_FSYNC",
                               "always").strip().lower(),
            wal_fsync_interval_s=_env_float("BYTEPS_WAL_FSYNC_INTERVAL",
                                            0.05),
            wal_segment_bytes=_env_int("BYTEPS_WAL_SEGMENT_BYTES", 4 << 20),
            wal_retain_snapshots=_env_int("BYTEPS_WAL_RETAIN", 2),
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
            heartbeat_on=_env_bool("BYTEPS_HEARTBEAT_ON", False),
            heartbeat_interval_s=_env_float("BYTEPS_HEARTBEAT_INTERVAL",
                                            1.0),
            heartbeat_timeout_s=_env_float("BYTEPS_HEARTBEAT_TIMEOUT",
                                           30.0),
            failure_exit_code=_env_int("BYTEPS_FAILURE_EXIT_CODE", 17),
            sync_deadline_s=_env_float("BYTEPS_SYNC_DEADLINE_S", 0.0),
            slowness_phi=_env_float("BYTEPS_SLOWNESS_PHI", 8.0),
            slowness_window=_env_int("BYTEPS_SLOWNESS_WINDOW", 64),
            straggler_policy=_env_str("BYTEPS_STRAGGLER_POLICY",
                                      "wait").strip().lower(),
            straggler_demote_after=_env_int(
                "BYTEPS_STRAGGLER_DEMOTE_AFTER", 3),
            straggler_min_lag_s=_env_float("BYTEPS_STRAGGLER_MIN_LAG",
                                           0.25),
            elastic=_env_bool("BYTEPS_ELASTIC", False),
            membership_port=_env_int("BYTEPS_MEMBERSHIP_PORT", 0),
            membership_hosts=_env_str("BYTEPS_MEMBERSHIP_HOSTS", ""),
            membership_rendezvous_timeout_s=_env_float(
                "BYTEPS_MEMBERSHIP_RENDEZVOUS_TIMEOUT", 10.0),
            membership_sync_timeout_s=_env_float(
                "BYTEPS_MEMBERSHIP_SYNC_TIMEOUT", 60.0),
            bus_retries=_env_int("BYTEPS_BUS_RETRIES", 64),
            clock_sync_samples=_env_int("BYTEPS_CLOCK_SYNC_SAMPLES", 5),
            gossip_on=_env_bool("BYTEPS_GOSSIP_ON", False),
            gossip_interval_s=_env_float("BYTEPS_GOSSIP_INTERVAL_S", 0.2),
            gossip_fanout=_env_int("BYTEPS_GOSSIP_FANOUT", 3),
            gossip_suspect_s=_env_float("BYTEPS_GOSSIP_SUSPECT_S", 1.0),
            gossip_dead_s=_env_float("BYTEPS_GOSSIP_DEAD_S", 3.0),
            transport_hosts=_env_str("BYTEPS_TRANSPORT_HOSTS", ""),
            transport_port_base=_env_int("BYTEPS_TRANSPORT_PORT_BASE", 0),
            transport_connect_timeout_s=_env_float(
                "BYTEPS_TRANSPORT_CONNECT_TIMEOUT", 5.0),
            transport_send_deadline_s=_env_float(
                "BYTEPS_TRANSPORT_SEND_DEADLINE", 10.0),
            transport_keepalive_s=_env_float(
                "BYTEPS_TRANSPORT_KEEPALIVE", 5.0),
            transport_max_inflight=_env_int(
                "BYTEPS_TRANSPORT_MAX_INFLIGHT", 64 << 20),
            bus_max_frame=_env_int("BYTEPS_BUS_MAX_FRAME", 1 << 30),
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
