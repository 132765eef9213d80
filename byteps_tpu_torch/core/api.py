"""Top-level API: init / shutdown / rank / size / push_pull / ...; port of
``byteps_tpu/core/api.py``.

One process per device, as in the original BytePS: ``rank()`` is this
process's global rank and ``size()`` the number of processes.
``init()`` runs on the card (``device="cuda"``) and raises where CUDA is
absent; the CPU (gloo) is used only when the caller asks for it with
``device="cpu"``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from ..comm.mesh import bootstrap, resolve_device
from ..common.config import Config
from ..common.handles import Handle
from .engine import PushPullEngine

_engine: Optional[PushPullEngine] = None
_lock = threading.Lock()
# names declared before init, declared again in order at init
_declared_order: List[str] = []


def init(config: Optional[Config] = None, device="cuda") -> None:
    """Join the process group (from ``config`` or the BYTEPS_*/DMLC_*
    environment) and start the engine on ``device``."""
    global _engine
    with _lock:
        if _engine is not None:
            return
        cfg = config or Config.from_env()
        comm = bootstrap(cfg, resolve_device(device, cfg.local_rank))
        try:
            engine = PushPullEngine(comm, cfg)
        except BaseException:
            comm.close()
            raise
        for name in _declared_order:
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
