"""fp16 model, fp32 master weights; port of
``byteps_tpu/torch/half_precision.py``.

The reference's ``_HalfPrecisionDistributedOptimizer``: the model holds
fp16 parameters, their fp16 gradients go on the wire (half the bytes of
f32), the optimizer steps fp32 master copies, and the result is copied
back into the fp16 model.  ``scale_loss`` multiplies the loss by the
loss scale against fp16 underflow; ``step`` divides it out of the fp32
master gradient.  The hooks reach the optimizer through a weak
reference, as ``DistributedOptimizer``'s do.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..common.handles import Handle
from ..core import api as _api
from .parallel import _remove, _weak


class HalfPrecisionDistributedOptimizer(torch.optim.Optimizer):
    """fp16 model / fp32 master distributed optimizer.  ``optimizer`` is
    built over the fp32 masters, one per fp16 parameter in the same
    order::

        model.half()
        fp16 = [p for p in model.parameters() if p.requires_grad]
        fp32 = [p.detach().float().requires_grad_() for p in fp16]
        opt = HalfPrecisionDistributedOptimizer(
            torch.optim.SGD(fp32, lr=0.1), fp16_params=fp16,
            fp32_params=fp32, loss_scale=1024.0)
        opt.scale_loss(loss).backward(); opt.step(); opt.zero_grad()
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 fp16_params: Iterable[torch.nn.Parameter],
                 fp32_params: Iterable[torch.nn.Parameter],
                 loss_scale: float = 1024.0,
                 named_parameters: Optional[
                     Iterable[Tuple[str, torch.nn.Parameter]]] = None,
                 compression: Optional[Dict[str, str]] = None):
        self._inner = optimizer
        self.param_groups = optimizer.param_groups
        self.defaults = optimizer.defaults
        self.state = optimizer.state
        self.fp16_params = list(fp16_params)
        self.fp32_params = list(fp32_params)
        if len(self.fp16_params) != len(self.fp32_params):
            raise ValueError("fp16_params and fp32_params must pair up")
        self.loss_scale = float(loss_scale)
        self._compression = compression
        self._handles: Dict[torch.nn.Parameter, Handle] = {}
        self._lock = threading.Lock()
        if named_parameters is not None:
            names = {p: n for n, p in named_parameters}
            if len(names) != len(set(names.values())):
                raise ValueError("parameter names must be unique")
        else:
            names = {p: f"param.{i}" for i, p in
                     enumerate(self.fp16_params)}
        self._name_of = names
        # the same order on every process; two loops, as the reference
        # declares gradients and then parameters
        for p in self.fp16_params:
            _api.declare(f"Gradient.{self._name_of[p]}")
        for p in self.fp16_params:
            _api.declare(f"Parameter.{self._name_of[p]}")
        hook = _weak(self, "_hook")
        self._hooks = [p.register_post_accumulate_grad_hook(hook)
                       for p in self.fp16_params if p.requires_grad]

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.loss_scale

    def _hook(self, p: torch.nn.Parameter) -> None:
        with self._lock:
            # the fp16 gradient goes on the wire
            self._handles[p] = _api.push_pull_async(
                p.grad, f"Gradient.{self._name_of[p]}",
                compression=self._compression)

    def zero_grad(self, set_to_none: bool = True):
        self._inner.zero_grad(set_to_none=set_to_none)
        for p in self.fp16_params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.detach_().zero_()

    def step(self, closure=None):
        with self._lock:
            handles, self._handles = self._handles, {}
        inv = 1.0 / self.loss_scale
        with torch.no_grad():
            for p16, p32 in zip(self.fp16_params, self.fp32_params):
                h = handles.get(p16)
                if h is not None:
                    p16.grad.copy_(h.wait())
                if p16.grad is None:
                    continue
                # the unscaled fp32 master gradient
                p32.grad = p16.grad.float().mul_(inv)
        out = self._inner.step(closure)
        with torch.no_grad():
            for p16, p32 in zip(self.fp16_params, self.fp32_params):
                p16.copy_(p32.to(p16.dtype))
        return out

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, sd):
        return self._inner.load_state_dict(sd)

    def __del__(self):
        _remove(self.__dict__.get("_hooks", ()))
