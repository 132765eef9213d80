"""PyTorch adapter; port of ``byteps_tpu/torch/__init__.py``.

The Horovod-style surface of the reference's byteps.torch plugin:
``push_pull[_async]``, the differentiable ``BytePSPushPull``,
``broadcast_parameters`` / ``broadcast_optimizer_state`` and
``DistributedOptimizer``, whose per-parameter hooks enqueue each gradient
the moment autograd has accumulated it, so communication overlaps the
rest of backward.  Everything stays on the device: there is no host
round trip (the JAX adapter's numpy conversion is gone).
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..comm.collectives import broadcast
from ..common.handles import Handle
from ..core import api as _api

__all__ = [
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "declare", "push_pull", "push_pull_async", "poll", "synchronize",
    "BytePSPushPull", "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state",
]

init = _api.init
shutdown = _api.shutdown
rank = _api.rank
size = _api.size
local_rank = _api.local_rank
local_size = _api.local_size
declare = _api.declare
poll = _api.poll
synchronize = _api.synchronize

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
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[
                     Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                 compression: Optional[Dict[str, str]] = None,
                 backward_passes_per_step: int = 1):
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
        # the same order on every process, so keys and priorities agree
        for n, _ in named:
            _api.declare(f"torch.grad.{n}")
        self._name_of = {p: n for n, p in named}
        for _, p in named:
            self._hooks.append(
                p.register_post_accumulate_grad_hook(self._hook))

    def _hook(self, p: torch.nn.Parameter) -> None:
        with self._lock:
            self._counts[p] = self._counts.get(p, 0) + 1
            if self._counts[p] % self._bpps != 0:
                return  # accumulation micro-step: no communication
            self._handles[p] = push_pull_async(
                p.grad, average=True, name=f"torch.grad.{self._name_of[p]}",
                compression=self._compression)

    def zero_grad(self, set_to_none: bool = True):
        return self._inner.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
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
        for h in getattr(self, "_hooks", []):
            h.remove()
