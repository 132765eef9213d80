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

Not ported: the membership, serving and cluster-metrics entry points of
the planes not ported yet (``cluster_metrics`` needs the membership
bus).
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
    global _engine
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
        # the observability plane: the flight recorder's knobs and dump
        # hooks, then the endpoint (a bind failure fails init: the
        # operator asked for it), then the health rules and the sampler
        _flight.configure_from_config(cfg)
        _flight.install_hooks()
        try:
            _obs.ensure_started(cfg)
        except BaseException:
            engine.shutdown(wait=False)
            comm.close()
            raise
        _health.configure(cfg)
        _ts.ensure_started(cfg)
        for name in names:
            engine.registry.declare(name)
        _engine = engine


def initialized() -> bool:
    return _engine is not None


def shutdown(wait: bool = True) -> None:
    """Drain outstanding handles, stop the engine, leave the group."""
    global _engine
    with _lock:
        if _engine is None:
            return
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
           global_rank: Optional[int] = None) -> None:
    """Start the engine again after :func:`suspend`, on the same device,
    with the tensors declared again in their original order (reference
    byteps_resume, operations.cc:107-119; JAX ``api.resume``).

    ``num_workers`` / ``global_rank`` update the DMLC environment as the
    reference's ``BytePSBasics.resume`` does, and the config is then read
    from the environment; with neither and no ``config`` the suspended
    engine's config is used again."""
    global _suspended
    if initialized():
        raise RuntimeError("resume() while the engine is running: call "
                           "suspend() first")
    if _suspended is None:
        raise RuntimeError("resume() without a suspend()")
    cfg, dev, names = _suspended
    if num_workers is not None:
        os.environ["DMLC_NUM_WORKER"] = str(num_workers)
    if global_rank is not None:
        os.environ["DMLC_WORKER_ID"] = str(global_rank)
    if config is None:
        config = (Config.from_env() if num_workers is not None
                  or global_rank is not None else cfg)
    _start(config, dev, names)
    _suspended = None


def get_pushpull_speed() -> Tuple[float, float]:
    """(timestamp, MB/s) of push_pull wire traffic, pushed plus pulled
    (reference byteps_get_pushpull_speed)."""
    return _require().speed.speed()


def metrics_snapshot(light: bool = False) -> Dict[str, Any]:
    """This process's observability snapshot (JAX ``api.py:347-381``):
    counters and gauges (one consistent registry view), the membership
    epoch, push_pull speed and the last completed step.  ``light=True``
    drops the histogram buckets and the planner.  The JAX snapshot's
    ``slowness`` section waits for ``utils/slowness.py``."""
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


def push_pull_update_async(tensor: torch.Tensor, name: str,
                           hyperparameters=None) -> Handle:
    """Push this rank's gradient of a :func:`declare_update` tensor; the
    handle resolves to the owner-updated parameters.
    ``hyperparameters`` (a param group's lr, betas, ...) reach the slot's
    optimizer before this push's step."""
    return _require().push_pull_update_async(
        tensor, name, hyperparameters=hyperparameters)


def push_pull_update(tensor: torch.Tensor, name: str,
                     hyperparameters=None) -> torch.Tensor:
    return push_pull_update_async(
        tensor, name, hyperparameters=hyperparameters).wait()


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
