"""``DistributedDataParallel`` and ``CrossBarrier``; port of
``byteps_tpu/torch/parallel.py``.

- ``DistributedDataParallel`` wraps a module: each gradient is pushed as
  autograd produces it, and the averaged gradients are written back in an
  autograd callback that runs once the whole backward has executed, so
  any optimizer can step right after ``loss.backward()``.  ``no_sync()``
  skips communication for gradient-accumulation steps.
- ``CrossBarrier`` (the ByteScheduler idea) removes the barrier at the
  end of an iteration: ``step()`` returns at once, and each module's
  forward pre-hook, when the next iteration first reaches it, waits for
  its own parameters' averaged gradients and steps only those, so the
  communication of late layers overlaps the next forward.
  ``synchronize()`` applies everything still pending.

Every hook reaches its wrapper through a weak reference, as the port's
``DistributedOptimizer`` does: a parameter's hook list lives in C++,
where Python's cycle collector cannot see it, so a strong one would keep
a dropped wrapper, its model and its gradients allocated forever.  The
wrappers remove their hooks when they are collected.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, List, Optional

import torch

from ..common.handles import Handle
from ..core import api as _api


def _declare_grad(name: str, p: torch.nn.Parameter, compression) -> None:
    """Declare a gradient's key with its geometry, so that its chunks and
    compressor state exist before the first backward."""
    _api.declare(name, shape=tuple(p.shape), dtype=p.dtype,
                 compression=compression)


def _weak(obj, method: str):
    """A hook that calls ``obj.<method>(*args)`` while ``obj`` lives."""
    ref = weakref.ref(obj)

    def hook(*args):
        o = ref()
        if o is not None:
            return getattr(o, method)(*args)
        return None
    return hook


def _remove(hooks) -> None:
    for h in hooks:
        h.remove()


class DistributedDataParallel(torch.nn.Module):
    """Drop-in DDP over the push_pull engine."""

    def __init__(self, module: torch.nn.Module,
                 compression: Optional[Dict[str, str]] = None):
        super().__init__()
        self.module = module
        self._compression = compression
        self._sync = True
        self._handles: Dict[torch.nn.Parameter, Handle] = {}
        self._callback_queued = False
        self._lock = threading.Lock()
        self._name_of = {p: n for n, p in module.named_parameters()
                         if p.requires_grad}
        for p, n in self._name_of.items():
            _declare_grad(f"ddp.grad.{n}", p, compression)
        hook = _weak(self, "_hook")
        self._hooks = [p.register_post_accumulate_grad_hook(hook)
                       for p in self._name_of]

    @contextlib.contextmanager
    def no_sync(self):
        """Skip gradient synchronization inside the context; the next
        backward outside it communicates the accumulated gradients."""
        old = self._sync
        self._sync = False
        try:
            yield
        finally:
            self._sync = old

    def _hook(self, p: torch.nn.Parameter) -> None:
        if not self._sync:
            return
        with self._lock:
            self._handles[p] = _api.push_pull_async(
                p.grad, f"ddp.grad.{self._name_of[p]}",
                compression=self._compression)
            if not self._callback_queued:
                # once, after the whole backward graph has executed: where
                # the reference DDP's reducer finalizes
                torch.autograd.Variable._execution_engine.queue_callback(
                    _weak(self, "_finalize_backward"))
                self._callback_queued = True

    def _finalize_backward(self) -> None:
        with self._lock:
            handles, self._handles = self._handles, {}
            self._callback_queued = False
        with torch.no_grad():
            for p, h in handles.items():
                p.grad.copy_(h.wait())

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    def __del__(self):
        _remove(self.__dict__.get("_hooks", ()))


class CrossBarrier:
    """Cross-iteration scheduling over (model, optimizer).  Stepping one
    module's parameters uses torch optimizers' skip of parameters whose
    ``grad`` is None, so any optimizer works unmodified."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 compression: Optional[Dict[str, str]] = None):
        self.model = model
        self.optimizer = optimizer
        self._compression = compression
        self._pending: Dict[torch.nn.Parameter, Handle] = {}
        self._lock = threading.Lock()
        self._name_of = {p: n for n, p in model.named_parameters()
                         if p.requires_grad}
        for p, n in self._name_of.items():
            _declare_grad(f"xb.grad.{n}", p, compression)
        hook = _weak(self, "_grad_hook")
        self._hooks = [p.register_post_accumulate_grad_hook(hook)
                       for p in self._name_of]
        # forward pre-hooks: each module waits for its own parameters
        ref = weakref.ref(self)
        for mod in model.modules():
            own = [p for p in mod.parameters(recurse=False)
                   if p in self._name_of]
            if own:
                self._hooks.append(mod.register_forward_pre_hook(
                    self._make_gate(ref, own)))

    @staticmethod
    def _make_gate(ref, params: List[torch.nn.Parameter]):
        def gate(module, inputs):
            xb = ref()
            if xb is not None:
                xb._apply_params(params)
        return gate

    def _grad_hook(self, p: torch.nn.Parameter) -> None:
        with self._lock:
            # a copy: the handle resolves at the next forward, and the
            # caller may zero or reuse p.grad before then
            self._pending[p] = _api.push_pull_async(
                p.grad.detach().clone(), f"xb.grad.{self._name_of[p]}",
                compression=self._compression)

    def step(self) -> None:
        """Returns at once: the updates apply at the next forward."""
        return None

    def _apply_params(self, params: List[torch.nn.Parameter]) -> None:
        with self._lock:
            todo = [(p, self._pending.pop(p)) for p in params
                    if p in self._pending]
        if not todo:
            return
        with torch.no_grad():
            for p, h in todo:
                avg = h.wait()
                if p.grad is None:      # zero_grad(set_to_none=True) ran
                    p.grad = avg.clone()
                else:
                    p.grad.copy_(avg)
        # step only these: every other parameter's gradient is hidden
        chosen = {id(p) for p, _ in todo}
        saved = []
        for g in self.optimizer.param_groups:
            for q in g["params"]:
                if id(q) not in chosen and q.grad is not None:
                    saved.append((q, q.grad))
                    q.grad = None
        try:
            self.optimizer.step()
        finally:
            for q, grad in saved:
                q.grad = grad
        for p, _ in todo:
            p.grad = None

    def synchronize(self) -> None:
        """Apply every pending update now (end of training, evaluation,
        a checkpoint)."""
        self._apply_params(list(self._name_of))

    def __del__(self):
        _remove(self.__dict__.get("_hooks", ()))
