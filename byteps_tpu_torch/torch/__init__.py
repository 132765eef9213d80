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

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from ..comm.collectives import broadcast
from ..common import tracing as _tracing
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
    "membership_epoch", "cluster_metrics", "device",
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
device = _api.device
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
membership_epoch = _api.membership_epoch
cluster_metrics = _api.cluster_metrics

_anon_ids = itertools.count(1)


def _anon_name() -> str:
    # monotonic, never reused (id()-based names collide when CPython
    # recycles the addresses of freed tensors)
    return f"torch.tensor_{next(_anon_ids)}"


def _averaged(average: Optional[bool], op: Optional[str]) -> bool:
    """Whether ``push_pull[_async]`` averages.  ``op`` (``"average"`` or
    ``"sum"``, the JAX top level's keyword) and ``average`` (the
    reference byteps.torch's bool) name one choice: either may be given,
    both only where they agree, and neither means average."""
    if isinstance(average, str):
        # bps.push_pull(x, "name") in the JAX top level's order
        raise TypeError(f"push_pull's second argument is average (a bool), "
                        f"got {average!r}: pass the name as name=")
    if op is None:
        return True if average is None else bool(average)
    if op not in ("average", "sum"):
        raise ValueError(f"op must be 'average' or 'sum', got {op!r}")
    if average is not None and bool(average) != (op == "average"):
        raise ValueError(f"average={average!r} contradicts op={op!r}")
    return op == "average"


def push_pull_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None,
                    priority: Optional[int] = None,
                    compression: Optional[Dict[str, str]] = None,
                    op: Optional[str] = None) -> Handle:
    """Async reduce of this process's tensor across all processes;
    ``average`` / ``op`` as :func:`_averaged` reads them."""
    return _api.push_pull_async(
        tensor, name or _anon_name(),
        op="average" if _averaged(average, op) else "sum",
        priority=priority, compression=compression)


class BytePSPushPull(torch.autograd.Function):
    """Differentiable push_pull: forward reduces the tensor, backward
    reduces the incoming gradient under the same name and op."""

    @staticmethod
    def forward(ctx, tensor, average, name, compression, priority=None):
        ctx.average = average
        ctx.name = name
        ctx.compression = compression
        ctx.priority = priority
        return push_pull_async(tensor, average=average, name=name,
                               priority=priority,
                               compression=compression).wait()

    @staticmethod
    def backward(ctx, grad_output):
        out = push_pull_async(grad_output.contiguous(), average=ctx.average,
                              name=ctx.name, priority=ctx.priority,
                              compression=ctx.compression).wait()
        return out, None, None, None, None


def push_pull(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None,
              compression: Optional[Dict[str, str]] = None,
              op: Optional[str] = None,
              priority: Optional[int] = None) -> torch.Tensor:
    """Reduce ``tensor`` across processes; differentiable.  ``average`` /
    ``op`` as :func:`_averaged` reads them."""
    # one name for forward and backward: both key the same engine tensor
    return BytePSPushPull.apply(tensor, _averaged(average, op),
                                name or _anon_name(), compression, priority)


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


def _engine_stats() -> dict:
    """The running engine's ``stats``, which the optimizer's waits and
    update add to (a throwaway dict with no engine running)."""
    if _api.initialized():
        return _api.engine().stats
    return {"wait_ms": 0.0, "update_ms": 0.0}


@contextlib.contextmanager
def _update(stats: dict):
    """``DistributedOptimizer``'s work after its waits: a ``bps.update``
    span, counted in ``update_ms``."""
    rf = _tracing.span_begin("bps.update")
    t0 = time.monotonic()
    try:
        yield
    finally:
        stats["update_ms"] += (time.monotonic() - t0) * 1e3
        _tracing.span_end(rf)


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

    ``synchronize()`` waits for the pushes and writes the averaged
    gradients without stepping, and ``step()`` inside
    ``skip_synchronize()`` then only runs the inner optimizer (the
    reference's ``byteps.torch`` API): room to work on the averaged
    gradients between the two, as an elastic member does when it
    all-gathers them over the membership bus.

    The running engine's ``stats`` count the host time of both halves:
    ``wait_ms``, blocked on the handles (each wait a ``bps.wait`` span),
    and ``update_ms``, the rest after the waits: the copies into
    ``p.grad`` (sharded: into ``p``) and the inner optimizer's step
    (``bps.update``).
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
        self._skip_sync = False
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

    def _results(self, stats: dict) -> List[tuple]:
        """Wait for every outstanding handle, in the hooks' order:
        ``(parameter, result)`` pairs.  Each wait is a ``bps.wait`` span
        and counts in ``wait_ms``."""
        with self._lock:
            handles, self._handles = self._handles, {}
        out = []
        for p, h in handles.items():
            rf = _tracing.span_begin("bps.wait")
            t0 = time.monotonic()
            try:
                out.append((p, h.wait()))
            finally:
                stats["wait_ms"] += (time.monotonic() - t0) * 1e3
                _tracing.span_end(rf)
        return out

    def _write_grads(self, results: List[tuple]) -> None:
        with torch.no_grad():
            for p, avg in results:
                if self._bpps > 1:
                    avg = avg / self._bpps
                p.grad.copy_(avg)

    def synchronize(self) -> None:
        """Wait for every outstanding push_pull and write the averaged
        gradients into ``p.grad``."""
        if self._sharded:
            raise ValueError("synchronize() has no gradient to write under "
                             "sharded_update: the engine steps")
        stats = _engine_stats()
        results = self._results(stats)
        with _update(stats):
            self._write_grads(results)

    @contextlib.contextmanager
    def skip_synchronize(self):
        """``step()`` in this block runs the inner optimizer on the
        gradients as they are (after :meth:`synchronize`)."""
        self._skip_sync = True
        try:
            yield
        finally:
            self._skip_sync = False

    def step(self, closure=None):
        if self._sharded:
            loss = None
            if closure is not None:
                with torch.enable_grad():
                    loss = closure()
            stats = _engine_stats()
            results = self._results(stats)
            with _update(stats), torch.no_grad():
                for p, new in results:
                    p.copy_(new)
            # the inner optimizer's step ran in the engine: tell an
            # lr_scheduler attached to it that it did
            self._inner._opt_called = True
            return loss
        if self._skip_sync:
            with _update(_engine_stats()):
                return self._inner.step(closure)
        with self._lock:
            if not self._handles and self._bpps > 1:
                return None  # micro-step: nothing was communicated
        stats = _engine_stats()
        results = self._results(stats)
        with _update(stats):
            self._write_grads(results)
            return self._inner.step(closure)

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, sd):
        return self._inner.load_state_dict(sd)

    def __del__(self):
        _remove(self.__dict__.get("_hooks", ()))
