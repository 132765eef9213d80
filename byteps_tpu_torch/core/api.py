"""Top-level API: init / shutdown / rank / size / push_pull / ...; port of
``byteps_tpu/core/api.py``.

One process per device, as in the original BytePS: ``rank()`` is this
process's global rank and ``size()`` the number of processes.
``init()`` runs on the card (``device="cuda"``) and raises where CUDA is
absent; the CPU (gloo) is used only when the caller asks for it with
``device="cpu"``.

``engine()`` reaches the running engine, as ``api._engine`` does in the
JAX package: ``engine().pause_dispatch()`` / ``resume_dispatch()``,
``engine().stats`` and ``engine().planner.snapshot()``.

The sharded weight update (``BYTEPS_SHARDED_UPDATE``):
:func:`declare_update` and :func:`push_pull_update[_async]`.  Its slots
hold the only copy of the master and optimizer state, so
:func:`suspend` stashes their export and the next
:func:`declare_update` of each name after :func:`resume` consumes it,
re-padded to the new world: that re-import is the elastic re-shard.

``init()`` arms the fault injector from ``Config.fault_spec``
(``BYTEPS_FAULT_SPEC``, validated eagerly) and ``shutdown()`` disarms it,
as in the JAX package.

``init()`` installs its config as the process-wide one
(``common.config.set_config``) and starts the observability plane, as
the JAX ``init`` does (``byteps_tpu/core/api.py:60-95``): the flight
recorder's knobs and its crash, SIGTERM and exit hooks; the HTTP
endpoint when ``obs_port`` asks for one; the health engine and the
time-series sampler.  The endpoint, the sampler and the process tracer
are process-lifetime: ``shutdown()`` leaves them, so an elastic
suspend/resume keeps the window and the port.  :func:`metrics_snapshot`
is this process's counters, gauges and last step.

``init()`` arms the heartbeat (``utils/failure_detector.py``
``HeartbeatMonitor``, one beat per process) when ``heartbeat_on`` is set
and the world has more than one process; the UDP bind runs under the
``RetryPolicy`` (it can race the previous incarnation's socket teardown
after a resume), and a bind that still fails fails ``init()``.
``suspend()`` and ``shutdown()`` stop it.  A dead peer then reaches the
default failure action: the installed one
(``failure_detector.install_failure_action``, e.g. a
``fault.recovery.RecoveryCoordinator``), else the restartable exit.

Across processes, ``comm/transport.py`` carries the parameter server's
hops over TCP (``TransportServer``, ``TcpEndpoint``): a worker reaches a
``KVStore`` or ``ServerEngine`` in another process through the endpoint
API, as the JAX package's transport workers do.

Elastic membership (``fault/membership.py``) drives this module:
:func:`suspend` and :func:`resume` are the two halves of every shrink,
rejoin and reconcile, and :func:`resume` with nothing suspended starts
an engine, as the JAX one does, which is how a rejoining process comes
up.  :func:`membership_epoch` reads the epoch and
:func:`cluster_metrics` every live rank's snapshot in one bus round
trip (or from the gossip table, bus-free).

The serving and durability planes (JAX ``api.py:130-150, 384-420``):
with ``BYTEPS_DURABLE_DIR`` set, ``init()`` opens the process-lifetime
durable store (``server/wal.py``) on the engine's device — on a cold
start it restores the last cut and replays the journal before any push
lands — and :func:`durable_kv_store` returns it; :func:`start_serving`
and :func:`start_serving_tier` stand up the read plane over a store,
with or without an engine.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..comm.mesh import bootstrap, resolve_device
from ..common import flight_recorder as _flight
from ..common import health as _health
from ..common import metrics as _metrics
from ..common import obs_server as _obs
from ..common import timeseries as _ts
from ..common.config import Config, set_config
from ..common.handles import Handle
from ..fault import injector as _fault
from .engine import PushPullEngine

_engine: Optional[PushPullEngine] = None
_heartbeat = None  # the HeartbeatMonitor init() arms (heartbeat_on)
_lock = threading.Lock()
# names declared before init, declared again in order at init
_declared_order: List[str] = []
# what suspend() leaves for resume(): the engine's config, device and
# declaration order
_suspended: Optional[Tuple[Config, torch.device, List[str]]] = None
# the sharded-update slots' snapshots that suspend() takes, by name: each
# is consumed by the next declare_update() of that name
_suspended_update_state: Dict[str, dict] = {}


def init(config: Optional[Config] = None, device="cuda") -> None:
    """Join the process group (from ``config`` or the BYTEPS_*/DMLC_*
    environment) and start the engine on ``device``."""
    _start(config, device, _declared_order)


def _start(config: Optional[Config], device, names: List[str]) -> None:
    """Start the engine with ``names`` declared first, in order."""
    global _engine, _heartbeat
    with _lock:
        if _engine is not None:
            return
        cfg = config or Config.from_env()
        set_config(cfg)
        if cfg.fault_spec:
            # eager validation: a chaos-spec typo fails init() with the
            # valid kind/site lists instead of silently injecting nothing
            _fault.arm(cfg.fault_spec, seed=cfg.fault_seed,
                       rank=cfg.host_id)
        else:
            _fault.disarm(engine_scoped_only=True)
        comm = bootstrap(cfg, resolve_device(device, cfg.local_rank))
        try:
            engine = PushPullEngine(comm, cfg)
        except BaseException:
            comm.close()
            raise
        if cfg.heartbeat_on and comm.size > 1:
            # armed before the engine is published: a bind that fails
            # fails init(), never a running engine that believes liveness
            # is on
            try:
                _heartbeat = _arm_heartbeat(cfg, comm)
            except BaseException:
                engine.shutdown(wait=False)
                comm.close()
                raise
        # the observability plane: the flight recorder's knobs and dump
        # hooks, then the endpoint (a bind failure fails init: the
        # operator asked for it), then the health rules and the sampler
        _flight.configure_from_config(cfg)
        _flight.install_hooks()
        try:
            _obs.ensure_started(cfg)
        except BaseException:
            _stop_heartbeat()
            engine.shutdown(wait=False)
            comm.close()
            raise
        _health.configure(cfg)
        _ts.ensure_started(cfg)
        if cfg.durable_dir:
            # process-lifetime like the endpoint: an elastic
            # suspend/resume must not close and re-replay the journal
            from ..server import wal as _wal
            try:
                _wal.ensure_process_store(cfg, comm.device)
            except BaseException:
                _stop_heartbeat()
                engine.shutdown(wait=False)
                comm.close()
                raise
        for name in names:
            engine.registry.declare(name)
        _engine = engine


def _arm_heartbeat(cfg: Config, comm):
    """One heartbeat monitor for this process, its UDP bind retried under
    the config's RetryPolicy."""
    from ..common.retry import RetryPolicy
    from ..utils.failure_detector import HeartbeatMonitor

    def arm():
        # a fresh monitor per attempt: a failed bind leaves the old
        # instance's socket unusable
        return HeartbeatMonitor(rank=comm.rank, num_ranks=comm.size,
                                interval=cfg.heartbeat_interval_s,
                                timeout=cfg.heartbeat_timeout_s).start()

    return RetryPolicy.from_config(cfg, retry_on=(OSError,)).call(
        arm, describe="heartbeat UDP bind")


def _stop_heartbeat() -> None:
    global _heartbeat
    if _heartbeat is not None:
        _heartbeat.stop()
        _heartbeat = None


def initialized() -> bool:
    return _engine is not None


def durable_kv_store():
    """The process-lifetime durable trainer-side KVStore that
    :func:`init` opens when ``BYTEPS_DURABLE_DIR`` is set
    (``server/wal.py``); None when the durable plane is off."""
    import sys
    wal_mod = sys.modules.get("byteps_tpu_torch.server.wal")
    return None if wal_mod is None else wal_mod.process_store()


def start_serving(store, **kwargs):
    """Stand up the parameter-serving plane over ``store`` (a
    :class:`~byteps_tpu_torch.server.kv_store.KVStore`): versioned
    snapshots, delta pulls, hot-key replicas (``server/serving.py``).
    Keyword arguments go to ``ServingPlane`` (``replicas``,
    ``retention``, ``hot_keys``, ``cut_interval_s``, ``device``);
    ``cut_interval_s`` defaults to ``BYTEPS_SERVE_CUT_INTERVAL``, so the
    plane is write-driven (pass ``cut_interval_s=None`` for manual
    ``cut()``).  Build consumers with ``PullClient``."""
    from ..common.config import get_config
    from ..server.serving import ServingPlane
    kwargs.setdefault("cut_interval_s", get_config().serve_cut_interval_s)
    return ServingPlane(store, **kwargs)


def start_serving_tier(store, **kwargs):
    """Stand up the distributed serving tier over ``store``
    (``server/serving_tier.py``): serving hosts in processes of their
    own (``python -m byteps_tpu_torch.server.serve_host``) behind the
    TCP transport, fed the cuts' changed keys along the consistent-hash
    ring.  Keyword arguments go to ``ServingTier`` (``bus``,
    ``static_hosts``, ``replicas``, ``retention``, ``cut_interval_s``,
    ...); ``cut_interval_s`` defaults as in :func:`start_serving`.
    Build consumers with ``tier.client()``."""
    from ..common.config import get_config
    from ..server.serving_tier import ServingTier
    kwargs.setdefault("cut_interval_s", get_config().serve_cut_interval_s)
    return ServingTier(store, **kwargs)


def shutdown(wait: bool = True) -> None:
    """Drain outstanding handles, stop the engine, leave the group."""
    global _engine
    with _lock:
        if _engine is None:
            return
        _stop_heartbeat()
        try:
            _engine.shutdown(wait=wait)
        finally:
            _engine.comm.close()
            _engine = None
            # chaos disarms with the engine; the next init() re-arms from
            # its config (a persist-armed injector stays)
            _fault.disarm(engine_scoped_only=True)


def suspend(wait: bool = True) -> None:
    """Drain (``wait``) and stop the engine, keeping the declared order so
    that :func:`resume` assigns the same keys (reference byteps_suspend,
    operations.cc:96-105; JAX ``api.suspend``), and the sharded-update
    slots' state for the :func:`declare_update` calls after the resume
    (a collective: every rank suspends).  ``wait=False`` skips the drain
    of outstanding handles; the slots' export then needs none in flight."""
    global _suspended
    eng = _require()
    if wait:
        eng.drain()
    _suspended_update_state.update(eng.export_update_slots())
    _suspended = (eng.cfg, eng.device,
                  eng.registry.names_in_declaration_order())
    shutdown(wait=wait)


def resume(config: Optional[Config] = None,
           num_workers: Optional[int] = None,
           global_rank: Optional[int] = None,
           device=None,
           num_servers: Optional[int] = None) -> None:
    """Start the engine again after :func:`suspend`, with the tensors
    declared again in their original order (reference byteps_resume,
    operations.cc:107-119; JAX ``api.resume``).  With nothing suspended
    it starts an engine as :func:`init` does, with the names declared
    before it, as the JAX ``resume`` does (a rejoining process declares
    the survivors' names, then resumes).

    ``num_workers`` / ``num_servers`` / ``global_rank`` update the
    environment as the reference's ``BytePSBasics.resume`` does
    (``common/__init__.py:75-81``; ``DMLC_NUM_WORKER``,
    ``DMLC_NUM_SERVER``, ``DMLC_WORKER_ID`` and ``BYTEPS_GLOBAL_RANK``),
    and the config is then read from the environment; ``num_servers`` is
    written and otherwise ignored (the port runs no server processes), as
    in the JAX package.  With no ``num_workers``, no ``global_rank`` and
    no ``config`` the suspended engine's config is used again (the
    environment's, when nothing was suspended).  ``device`` (the JAX
    ``devices``) defaults to the suspended engine's device, else
    ``"cuda"``."""
    global _suspended
    if initialized():
        raise RuntimeError("resume() while the engine is running: call "
                           "suspend() first")
    if num_workers is not None:
        os.environ["DMLC_NUM_WORKER"] = str(num_workers)
    if num_servers is not None:
        os.environ["DMLC_NUM_SERVER"] = str(num_servers)
    if global_rank is not None:
        # bpslint: ignore[env-knob] reason=reference-parity marker WRITTEN for BytePSBasics.resume compatibility, never read by this stack; recorded in the env.md disposition table
        os.environ["BYTEPS_GLOBAL_RANK"] = str(global_rank)
        os.environ["DMLC_WORKER_ID"] = str(global_rank)
    if _suspended is None:
        _start(config or Config.from_env(),
               "cuda" if device is None else device, _declared_order)
        return
    cfg, dev, names = _suspended
    if config is None:
        config = (Config.from_env() if num_workers is not None
                  or global_rank is not None else cfg)
    _start(config, dev if device is None else device, names)
    _suspended = None


def membership_epoch() -> int:
    """The current elastic-membership epoch (``fault/membership.py``): 0
    for the static world every non-elastic run lives in; advanced by each
    shrink, rejoin and reconcile.  Work stamped with a dead epoch is
    dropped, not delivered."""
    from ..fault import membership as _membership
    return _membership.current_epoch()


def get_pushpull_speed() -> Tuple[float, float]:
    """(timestamp, MB/s) of push_pull wire traffic, pushed plus pulled
    (reference byteps_get_pushpull_speed)."""
    return _require().speed.speed()


def metrics_snapshot(light: bool = False) -> Dict[str, Any]:
    """This process's observability snapshot (JAX ``api.py:347-381``):
    counters and gauges (one consistent registry view), the membership
    epoch, push_pull speed and the last completed step.  ``light=True``
    drops the histogram buckets, the slowness scores and the planner."""
    import time

    from ..common.config import get_config
    from ..fault import membership as _membership
    reg = _metrics.registry.snapshot()
    snap: Dict[str, Any] = {
        "ts": time.time(),
        "pid": os.getpid(),
        "rank": get_config().host_id,
        "epoch": _membership.current_epoch(),
        "counters": reg["counters"],
        "gauges": reg["gauges"],
    }
    if not light:
        snap["histograms"] = reg["histograms"]
        from ..utils import slowness as _slowness
        snap["slowness"] = _slowness.tracker().snapshot()
    eng = _engine
    if eng is not None:
        snap["speed_mbps"] = round(eng.speed.speed()[1], 3)
        snap["sched_pending"] = eng.scheduler.pending
        snap["bytes_in_flight"] = eng.scheduler.bytes_in_flight
        last = eng.step_stats.last()
        snap["step"] = last.as_dict() if last is not None else None
        if not light:
            snap["planner"] = eng.planner.snapshot()
    return snap


def _require() -> PushPullEngine:
    if _engine is None:
        raise RuntimeError("byteps_tpu_torch is not initialized: call init()")
    return _engine


def engine() -> PushPullEngine:
    """The running engine (its registry holds per-tensor state)."""
    return _require()


def size() -> int:
    return _require().comm.size


def rank() -> int:
    return _require().comm.rank


def local_size() -> int:
    return _require().comm.local_size


def local_rank() -> int:
    return _require().comm.local_rank


def device() -> torch.device:
    return _require().device


def declare(name: str, shape=None, dtype: torch.dtype = torch.float32,
            compression: Optional[Dict[str, str]] = None) -> int:
    """Declare a tensor; returns its declared key.  Usable before init.
    With ``shape`` on a running engine the tensor's chunks and compressor
    state are built now."""
    if _engine is not None:
        if shape is not None:
            return _engine.declare_tensor(
                name, shape, dtype, compression=compression).declared_key
        return _engine.registry.declare(name).declared_key
    if name not in _declared_order:
        _declared_order.append(name)
    return _declared_order.index(name)


def declare_update(name: str, shape, dtype: torch.dtype = torch.float32,
                   *, optimizer, init_value=None) -> int:
    """Declare a tensor whose pull leg is the sharded weight update
    (``BYTEPS_SHARDED_UPDATE``): its reduce-scatter shard stays on its
    owner, the ``torch.optim`` optimizer named by ``optimizer`` (``(cls,
    hyperparameters)``) steps it against an owner-resident f32 master,
    and :func:`push_pull_update` returns the updated parameters.  If
    :func:`suspend` stashed this name's slot, the snapshot is restored
    here, re-padded to the current world.  Needs a running engine (the
    slot is device state); returns the declared key."""
    eng = _require()
    restore = _suspended_update_state.pop(name, None)
    return eng.declare_update(name, shape, dtype, optimizer=optimizer,
                              init_value=init_value,
                              restore=restore).declared_key


def push_pull_update_async(x: torch.Tensor, name: str,
                           hyperparameters=None) -> Handle:
    """Push this rank's gradient ``x`` of a :func:`declare_update` tensor; the
    handle resolves to the owner-updated parameters.
    ``hyperparameters`` (a param group's lr, betas, ...) reach the slot's
    optimizer before this push's step."""
    return _require().push_pull_update_async(
        x, name, hyperparameters=hyperparameters)


def push_pull_update(x: torch.Tensor, name: str,
                     hyperparameters=None) -> torch.Tensor:
    return push_pull_update_async(
        x, name, hyperparameters=hyperparameters).wait()


def push_pull_async(tensor: torch.Tensor, name: str, op: str = "average",
                    priority: Optional[int] = None,
                    compression: Optional[Dict[str, str]] = None) -> Handle:
    return _require().push_pull_async(tensor, name, priority=priority, op=op,
                                      compression=compression)


def push_pull(tensor: torch.Tensor, name: str, op: str = "average",
              priority: Optional[int] = None,
              compression: Optional[Dict[str, str]] = None) -> torch.Tensor:
    return push_pull_async(tensor, name, op=op, priority=priority,
                           compression=compression).wait()


def poll(handle: Handle) -> bool:
    return handle.poll()


def synchronize(handle: Handle, timeout: Optional[float] = None):
    return handle.wait(timeout=timeout)


def cluster_metrics(bus: Optional[str] = None,
                    timeout: float = 10.0) -> Dict[str, Any]:
    """Every live rank's metrics snapshot in ONE round-trip to the
    membership bus (the ``metrics`` verb, fault/membership.py): returns
    ``{"epoch", "world", "ranks": {rank: {"age_s", "metrics"}}}`` where
    each rank's entry is the snapshot it last attached to a
    ``step_sync`` (or pushed with ``metrics_put``), stamped with its
    age.  ``bus`` is ``host:port`` of the membership bus; default is the
    same resolution :class:`~byteps_tpu_torch.fault.membership.ElasticMembership`
    uses (DMLC root + BYTEPS_MEMBERSHIP_PORT).

    The bus address is re-resolved from the ACTIVE membership view
    (``fault.membership.active_membership()``) so a coordinator change
    re-points the query at the successor instead of the static
    env-derived address.  While an elastic world's bus is not answering
    (a failover in progress), the answer degrades gracefully to a
    local-only view flagged ``failover_in_progress`` instead of
    raising; a run with no bus at all (single process, non-elastic)
    falls back to the plain local-only view — so ``tools/bps_top.py``
    works against anything.  The JAX function, whole."""
    import time

    from ..fault import membership as _membership
    m = _membership.active_membership()
    view = m.view() if (bus is None and m is not None) else None
    if view is not None and getattr(m, "gossip", None) is not None:
        # gossip-local answer: the SWIM table already holds
        # every rank's piggybacked metrics/history payloads, so the
        # query needs NO bus round-trip — and keeps working on either
        # side of a partition, where the bus may be unreachable
        table = m.gossip
        now = time.time()
        out = {"epoch": _membership.current_epoch(),
               "world": list(view.world), "gossip": True,
               "states": table.snapshot(), "ranks": {}, "history": {}}
        for kind, dest in (("metrics", out["ranks"]),
                           ("history", out["history"])):
            for r, v in table.payloads_of_kind(kind).items():
                if not isinstance(v, dict) or "t" not in v:
                    continue
                age = max(0.0, now - float(v["t"]))
                dest[int(r)] = (
                    {"age_s": round(age, 3), "metrics": v.get("v")}
                    if kind == "metrics"
                    else {"age_s": round(age, 3), "summary": v.get("v")})
        sd = table.payloads_of_kind("serve_dir")
        if sd:
            newest = max(sd.values(),
                         key=lambda p: p.get("t", 0)
                         if isinstance(p, dict) else 0)
            if isinstance(newest, dict):
                d = newest.get("v") or {}
                out["serve_hosts"] = {int(h): v for h, v in
                                      (d.get("hosts") or {}).items()}
                out["serve_gen"] = d.get("gen", 0)
        return out
    if view is not None:
        # the live membership already tracks the bus through failovers
        # (including explicitly-constructed addresses no env resolution
        # could re-derive)
        addr = m.bus_addr
    else:
        addr = _membership.resolve_bus_addr(bus, view)
    try:
        reply = _membership.bus_request(
            addr, {"op": "metrics"}, timeout=timeout)
    except ConnectionError:
        snap = metrics_snapshot()
        out: Dict[str, Any] = {
            "epoch": _membership.current_epoch(),
            "world": (list(view.world) if view is not None
                      else [snap["rank"]]),
            "ranks": {snap["rank"]: {"age_s": 0.0, "metrics": snap}},
            "local_only": True}
        from ..common import timeseries as _ts
        store = _ts.get_store()
        out["history"] = (
            {snap["rank"]: {"age_s": 0.0, "summary": store.summary()}}
            if store is not None and store.points() else {})
        if view is not None and view.num_workers > 1:
            # an elastic world exists but its bus is not answering: the
            # standby is (or should be) rebinding right now
            out["failover_in_progress"] = True
            out["coordinator"] = view.coordinator
            out["standby"] = m.standby_rank
        return out
    if not reply.get("ok"):
        raise RuntimeError(f"cluster_metrics failed: {reply!r}")
    # serving hosts publish at SERVE_RANK_BASE + host_id (one metrics
    # cache, two id spaces): split them into their own section so
    # bps_top renders trainer ranks and tier rows as what they are
    base = _membership.SERVE_RANK_BASE
    all_ranks = {int(r): v for r, v in reply["ranks"].items()}
    out = {"epoch": reply["epoch"], "world": reply["world"],
           "ranks": {r: v for r, v in all_ranks.items() if r < base},
           "serve_ranks": {r - base: v for r, v in all_ranks.items()
                           if r >= base},
           "serve_hosts": {int(h): v for h, v in
                           (reply.get("serve_hosts") or {}).items()},
           "serve_gen": reply.get("serve_gen", 0),
           # fleet reconciliation view: the autoscaler's
           # target and the DRAINING set — bps_top's fleet banner
           # (target=N actual=M) and per-host DRAINING state read these
           "serve_target": reply.get("serve_target"),
           "serve_draining": [int(h) for h in
                              (reply.get("serve_draining") or ())]}
    for k in ("coordinator", "standby", "bus_rank"):
        if reply.get(k) is not None:
            out[k] = reply[k]
    # gray-failure columns: per-rank step-barrier slowness
    # scores and the probation list — bps_top renders SLOW/STATE from
    # these, and empty is meaningful ("nobody is slow")
    out["slow"] = {int(r): v for r, v in (reply.get("slow") or {}).items()}
    out["probation"] = [int(r) for r in (reply.get("probation") or ())]
    # the history view: each rank's piggybacked time-series
    # window summary — bps_top's TREND column and bps_doctor's live
    # diagnosis read these, again with no extra round-trip
    out["history"] = {int(r): v
                      for r, v in (reply.get("history") or {}).items()}
    if reply.get("states") is not None:
        # the hosting rank's gossip table (BYTEPS_GOSSIP_ON)
        out["states"] = {int(r): v for r, v in reply["states"].items()}
    return out
