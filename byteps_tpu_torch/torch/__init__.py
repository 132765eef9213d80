"""PyTorch adapter; port of ``byteps_tpu/torch/__init__.py``.

The Horovod-style surface of the reference's byteps.torch plugin:
``push_pull[_async]``, the differentiable ``BytePSPushPull``,
``broadcast_parameters`` / ``broadcast_optimizer_state`` and
``DistributedOptimizer``, whose per-parameter hooks enqueue each gradient
the moment autograd has accumulated it, so communication overlaps the
rest of backward; ``DistributedDataParallel`` and ``CrossBarrier``
(``parallel.py``), ``HalfPrecisionDistributedOptimizer``
(``half_precision.py``) and the ``Compression`` shim
(``compression.py``).  Everything stays on the device: there is no host
round trip (the JAX adapter's numpy conversion is gone).  The async
parameter-server mode is ``AsyncDistributedOptimizer`` (``async_opt.py``)
over a ``KVStore``; ``ServerEngine`` is the reference's synchronous
merge engine (both from ``server/``).
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..comm.collectives import broadcast
from ..common.config import Config
from ..common.handles import Handle
from ..core import api as _api
from ..server import KVStore, ServerEngine
from .async_opt import AsyncDistributedOptimizer
from .compression import Compression
from .half_precision import HalfPrecisionDistributedOptimizer
from .parallel import CrossBarrier, DistributedDataParallel, _remove, _weak

__all__ = [
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "declare", "push_pull", "push_pull_async", "poll", "synchronize",
    "declare_update", "push_pull_update", "push_pull_update_async",
    "suspend", "resume", "get_pushpull_speed", "metrics_snapshot",
    "BytePSPushPull", "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "Compression", "DistributedDataParallel",
    "CrossBarrier", "HalfPrecisionDistributedOptimizer",
    "AsyncDistributedOptimizer", "KVStore", "ServerEngine",
]

init = _api.init
shutdown = _api.shutdown
rank = _api.rank
size = _api.size
local_rank = _api.local_rank
local_size = _api.local_size
declare = _api.declare
declare_update = _api.declare_update
push_pull_update = _api.push_pull_update
push_pull_update_async = _api.push_pull_update_async
poll = _api.poll
synchronize = _api.synchronize
suspend = _api.suspend
resume = _api.resume
get_pushpull_speed = _api.get_pushpull_speed
metrics_snapshot = _api.metrics_snapshot

_anon_ids = itertools.count(1)


def _anon_name() -> str:
    # monotonic, never reused (id()-based names collide when CPython
    # recycles the addresses of freed tensors)
    return f"torch.tensor_{next(_anon_ids)}"


def push_pull_async(tensor: torch.Tensor, average: bool = True,
                    name: Optional[str] = None,
                    priority: Optional[int] = None,
                    compression: Optional[Dict[str, str]] = None) -> Handle:
    """Async reduce of this process's tensor across all processes."""
    return _api.push_pull_async(tensor, name or _anon_name(),
                                op="average" if average else "sum",
                                priority=priority, compression=compression)


class BytePSPushPull(torch.autograd.Function):
    """Differentiable push_pull: forward reduces the tensor, backward
    reduces the incoming gradient under the same name and op."""

    @staticmethod
    def forward(ctx, tensor, average, name, compression):
        ctx.average = average
        ctx.name = name
        ctx.compression = compression
        return push_pull_async(tensor, average=average, name=name,
                               compression=compression).wait()

    @staticmethod
    def backward(ctx, grad_output):
        out = push_pull_async(grad_output.contiguous(), average=ctx.average,
                              name=ctx.name,
                              compression=ctx.compression).wait()
        return out, None, None, None


def push_pull(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None,
              compression: Optional[Dict[str, str]] = None) -> torch.Tensor:
    """Reduce ``tensor`` across processes; differentiable."""
    # one name for forward and backward: both key the same engine tensor
    return BytePSPushPull.apply(tensor, average, name or _anon_name(),
                                compression)


def _sharded_update_default() -> bool:
    """``Config.sharded_update`` of the running engine, else of the
    environment."""
    if _api.initialized():
        return _api.engine().cfg.sharded_update
    return Config.from_env().sharded_update


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """In-place broadcast of a state_dict or a named_parameters iterable.
    Call it before training: it issues collectives from the caller's
    thread, beside the engine's."""
    if isinstance(params, dict):
        items = [(k, v) for k, v in sorted(params.items())
                 if torch.is_tensor(v)]
    else:
        items = [(k, v) for k, v in params if torch.is_tensor(v)]
    comm = _api.engine().comm
    for _, t in items:
        out = broadcast(comm, t.detach().to(comm.device), root=root_rank)
        with torch.no_grad():
            t.copy_(out)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast the optimizer's state tensors in place."""
    tensors = {}
    for pid, pstate in optimizer.state_dict()["state"].items():
        for k, v in pstate.items():
            if torch.is_tensor(v) and v.numel() > 0:
                tensors[f"opt.{pid}.{k}"] = v
    if tensors:
        broadcast_parameters(tensors, root_rank=root_rank)


class DistributedOptimizer(torch.optim.Optimizer):
    """Wraps a torch optimizer: gradients are push_pull-averaged through
    the engine before every step.

    Each parameter's post-accumulate-grad hook enqueues an async
    push_pull as its gradient materializes; ``step()`` waits for every
    handle, writes the averaged gradient into ``p.grad`` and runs the
    inner optimizer.  ``backward_passes_per_step`` defers communication
    across gradient-accumulation micro-steps.

    With ``sharded_update=True`` (``None``: follow
    ``Config.sharded_update`` of the running engine, else of the
    environment) the optimizer's work moves into the engine: the
    constructor declares one sharded-update slot per parameter (in the
    same order on every rank, seeded with the parameter's value, so
    broadcast the parameters first) running the inner optimizer's class
    and hyperparameters on this rank's shard; the hooks push through
    ``push_pull_update_async``, carrying the parameter's param-group
    hyperparameters at that moment (so an ``lr_scheduler`` attached to
    the wrapped optimizer still steers the steps); and ``step()`` waits
    and ``copy_``s the emitted parameters into each parameter.  The inner
    optimizer never steps and its ``state`` stays empty: the moments live
    1/L on each rank.  Under ``backward_passes_per_step`` the pushed
    gradient is the accumulated one divided by the count, as the JAX
    adapter does before its push.  After a suspend/resume the slots are
    declared again on the new engine at the next push, from the stash.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[
                     Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                 compression: Optional[Dict[str, str]] = None,
                 backward_passes_per_step: int = 1,
                 sharded_update: Optional[bool] = None):
        self._inner = optimizer
        self.param_groups = optimizer.param_groups
        self.defaults = optimizer.defaults
        self.state = optimizer.state
        self._compression = compression
        self._bpps = max(1, int(backward_passes_per_step))
        self._counts: Dict[torch.nn.Parameter, int] = {}
        self._handles: Dict[torch.nn.Parameter, Handle] = {}
        self._hooks = []
        self._lock = threading.Lock()
        if named_parameters is not None:
            named = [(n, p) for n, p in named_parameters if p.requires_grad]
        else:
            named = [(f"param.{gi}.{pi}", p)
                     for gi, g in enumerate(optimizer.param_groups)
                     for pi, p in enumerate(g["params"]) if p.requires_grad]
        self._name_of = {p: n for n, p in named}
        self._sharded = (_sharded_update_default() if sharded_update is None
                         else bool(sharded_update))
        if self._sharded:
            if compression:
                raise ValueError(
                    "sharded update does not take gradient compression: "
                    "the gradient never leaves its owner")
            self._group_of = {p: g for g in optimizer.param_groups
                              for p in g["params"]}
            self._named = named
            self._declared_engine = None
            self._declare_slots()
        else:
            # the same order on every process, so keys and priorities
            # agree
            for n, _ in named:
                _api.declare(f"torch.grad.{n}")
        # the hooks reach the optimizer through a weak reference: a hook
        # list lives in C++, where Python's cycle collector cannot see it,
        # so a strong one would keep a dropped optimizer, and through it
        # the model, its gradients and its optimizer state, alive forever
        # (__del__ removes the hooks)
        hook = _weak(self, "_hook")
        for _, p in named:
            self._hooks.append(p.register_post_accumulate_grad_hook(hook))

    def _hyperparameters(self, p) -> dict:
        return {k: v for k, v in self._group_of[p].items() if k != "params"}

    def _declare_slots(self) -> None:
        """One sharded-update slot per parameter, in the constructor's
        order; again on a new engine (after suspend/resume, where each
        declaration consumes its stashed state)."""
        if not _api.initialized():
            raise RuntimeError(
                "DistributedOptimizer(sharded_update=True) needs a running "
                "engine: call init() first (the optimizer's state lives in "
                "the engine)")
        for n, p in self._named:
            _api.declare_update(
                f"torch.grad.{n}", p.shape, p.dtype,
                optimizer=(type(self._inner), self._hyperparameters(p)),
                init_value=p.detach())
        self._declared_engine = _api.engine()

    def _hook(self, p: torch.nn.Parameter) -> None:
        with self._lock:
            self._counts[p] = self._counts.get(p, 0) + 1
            if self._counts[p] % self._bpps != 0:
                return  # accumulation micro-step: no communication
            name = f"torch.grad.{self._name_of[p]}"
            if not self._sharded:
                self._handles[p] = push_pull_async(
                    p.grad, average=True, name=name,
                    compression=self._compression)
                return
            if self._declared_engine is not _api.engine():
                self._declare_slots()
            grad = p.grad if self._bpps == 1 else p.grad / self._bpps
            self._handles[p] = _api.push_pull_update_async(
                grad, name, hyperparameters=self._hyperparameters(p))

    def zero_grad(self, set_to_none: bool = True):
        return self._inner.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        if self._sharded:
            loss = None
            if closure is not None:
                with torch.enable_grad():
                    loss = closure()
            with self._lock:
                handles, self._handles = self._handles, {}
            with torch.no_grad():
                for p, h in handles.items():
                    p.copy_(h.wait())
            # the inner optimizer's step ran in the engine: tell an
            # lr_scheduler attached to it that it did
            self._inner._opt_called = True
            return loss
        with self._lock:
            handles, self._handles = self._handles, {}
        if not handles and self._bpps > 1:
            return None  # micro-step: nothing was communicated
        with torch.no_grad():
            for p, h in handles.items():
                avg = h.wait()
                if self._bpps > 1:
                    avg = avg / self._bpps
                p.grad.copy_(avg)
        return self._inner.step(closure)

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, sd):
        return self._inner.load_state_dict(sd)

    def __del__(self):
        _remove(self.__dict__.get("_hooks", ()))
