"""ZeRO-sharded data parallelism: the optimizer state (and, under FSDP,
the parameters) live sharded across ranks as one flat f32 master vector;
port of ``byteps_tpu/parallel/zero.py``.

- **ZeRO-1** (:func:`make_zero_train_step`): the model's parameters stay
  replicated in their own dtype; the f32 master and the whole optimizer
  state are sharded 1/R.  Per step: reduce-scatter the flat gradient
  (each rank receives its shard, summed), step the shard, all-gather the
  updated master into the parameters.  RS + AG is the all-reduce's own
  wire, so the memory saving is free.
- **FSDP / ZeRO-3** (:func:`make_fsdp_train_step`): only the master
  persists.  Each step all-gathers it into the model's parameters (cast
  to ``compute_dtype``), runs forward and backward, reduce-scatters the
  gradient and releases the parameters again.  The whole vector is
  gathered at once: the transient peak is the whole model's.

The JAX steps are one jitted ``shard_map`` over the ``(dcn, ici)`` mesh.
Here each process runs the step on its own batch and the collectives are
``torch.distributed`` calls over the groups of
:func:`~..comm.shard_math.resolve_axes`: the world (``"all"``), or HSDP
(``"ici"``), sharded within a node and summed across nodes on the shard
alone.  The idiom is torch's: an ``nn.Module`` and ``loss_fn(model,
batch) -> scalar`` (this rank's loss), flattened through an explicit
view map (:class:`ParamViews`, the model's ``named_parameters`` order).

The master is always f32 and the parameters keep their own dtype (or
FSDP's ``compute_dtype``): with a bf16 model this is master-weight
mixed precision, sharded.

Optimizer contract: the optimizer steps the 1/R gradient shard, so
elementwise optimizers (SGD, Adam, AdamW, weight decay, schedules) are
exact.  A transform that needs a whole-model statistic must be
sharding-aware: pass :func:`clip_by_global_norm` (with the step's
``shard_axes``) as the step's ``grad_transform`` in place of
``torch.nn.utils.clip_grad_norm_``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from ..comm.mesh import CommContext
from ..comm.shard_math import ShardGroups, padded_size, resolve_axes

__all__ = [
    "ParamViews",
    "ZeroState",
    "clip_by_global_norm",
    "init_zero_state",
    "make_zero_train_step",
    "make_fsdp_train_step",
    "zero_params",
]

GradTransform = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class ZeroState:
    """This rank's shard of the flat f32 master (``[padded / shards]``)
    and the ``torch.optim`` optimizer over it, whose per-element state is
    born at the shard's length."""

    master: torch.Tensor
    optimizer: torch.optim.Optimizer


@dataclasses.dataclass(frozen=True)
class ParamViews:
    """The flat layout of a model's parameters: ``(name, shape, dtype,
    offset)`` in ``named_parameters`` order, ``n`` elements in all.  Kept
    apart from the module, since FSDP releases the parameters' storage
    between steps."""

    views: Tuple[Tuple[str, torch.Size, torch.dtype, int], ...]
    n: int

    @classmethod
    def of(cls, model: nn.Module) -> "ParamViews":
        views, off = [], 0
        for name, p in model.named_parameters():
            views.append((name, p.shape, p.dtype, off))
            off += p.numel()
        return cls(tuple(views), off)

    def flatten(self, tensors, length: int,
                device: torch.device) -> torch.Tensor:
        """``tensors`` (one per view, None for zeros) as one f32 vector of
        ``length`` (the padded length) elements."""
        out = torch.zeros(length, dtype=torch.float32, device=device)
        for (_, shape, _, off), t in zip(self.views, tensors):
            if t is not None:
                out[off:off + math.prod(shape)].copy_(t.reshape(-1))
        return out

    def unflatten(self, vec: torch.Tensor,
                  dtype: Optional[torch.dtype] = None
                  ) -> Dict[str, torch.Tensor]:
        """Each parameter's slice of ``vec``, shaped, in its own dtype or
        ``dtype`` (fresh tensors: never views of ``vec``)."""
        return {name: vec[off:off + math.prod(shape)].view(shape).to(
                    dtype or pdt, copy=True)
                for name, shape, pdt, off in self.views}


def _views(template: Union[nn.Module, ParamViews]) -> ParamViews:
    return template if isinstance(template, ParamViews) else \
        ParamViews.of(template)


def _gather(g: ShardGroups, shard: torch.Tensor) -> torch.Tensor:
    """The whole padded vector from every rank's shard."""
    if g.size == 1:
        return shard
    full = shard.new_empty(shard.numel() * g.size)
    dist.all_gather_into_tensor(full, shard, group=g.group)
    return full


def _reduce_scatter(comm: CommContext, g: ShardGroups,
                    gvec: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the gradient averaged over every rank: a
    reduce-scatter over the shard group, the rest of the sum over the
    extra group (HSDP), then the division by R (the reference's
    ``gshard / ranks``)."""
    if g.size > 1:
        shard = gvec.new_empty(gvec.numel() // g.size)
        dist.reduce_scatter_tensor(shard, gvec, group=g.group)
    else:
        shard = gvec
    if g.extra_size > 1:
        dist.all_reduce(shard, group=g.extra_group)
    return shard / comm.size


def _mean_loss(comm: CommContext, loss: torch.Tensor) -> torch.Tensor:
    """The loss averaged over every rank (the reference's pmean)."""
    loss = loss.detach().float()
    if comm.size > 1:
        loss = loss.clone()
        dist.all_reduce(loss)
        loss = loss / comm.size
    return loss


def _update(zstate: ZeroState, gshard: torch.Tensor,
            grad_transform: Optional[GradTransform]) -> None:
    if grad_transform is not None:
        gshard = grad_transform(gshard)
    zstate.master.grad = gshard
    zstate.optimizer.step()
    zstate.master.grad = None


def clip_by_global_norm(max_norm: float,
                        comm: Optional[CommContext] = None,
                        shard_axes: str = "all") -> GradTransform:
    """Sharding-aware global-norm clip of a gradient shard, the ZeRO
    steps' ``grad_transform``: ``g * min(1, max_norm / max(|g|, 1e-16))``
    where the squared norm is summed over the shard group first, so the
    clip matches the replicated trajectory's.  ``shard_axes`` must be the
    step's: under HSDP (``"ici"``) every shard is replicated across
    nodes, and a sum over the world would count each one ``num_nodes``
    times, inflating the norm by sqrt(num_nodes) and over-clipping
    (invisible with Adam, which is scale-invariant; visible with SGD).
    With ``comm=None`` it is the plain global norm of one tensor."""
    g = resolve_axes(comm, shard_axes) if comm is not None else None

    def clip(grad: torch.Tensor) -> torch.Tensor:
        sq = torch.sum(torch.square(grad.float()))
        if g is not None and g.size > 1:
            dist.all_reduce(sq, group=g.group)
        scale = torch.clamp(
            max_norm / torch.clamp(torch.sqrt(sq), min=1e-16), max=1.0)
        return grad * scale

    return clip


def init_zero_state(comm: CommContext, model: nn.Module,
                    optimizer_factory: Callable[[List[torch.Tensor]],
                                                torch.optim.Optimizer],
                    shard_axes: str = "all") -> ZeroState:
    """The sharded f32 master and its optimizer from ``model``'s current
    parameters (the same on every rank): the flat vector padded to
    ``padded_size(n, shards)``, this rank's shard of it, and
    ``optimizer_factory([master])``.  ``shard_axes`` must match the
    train step's."""
    g = resolve_axes(comm, shard_axes)
    views = ParamViews.of(model)
    padded = padded_size(views.n, g.size)
    with torch.no_grad():
        vec = views.flatten([p.detach() for p in model.parameters()],
                            padded, comm.device)
    S = padded // g.size
    master = vec[g.index * S:(g.index + 1) * S].clone()
    return ZeroState(master=master, optimizer=optimizer_factory([master]))


def make_zero_train_step(comm: CommContext, model: nn.Module,
                         loss_fn: Callable, shard_axes: str = "all",
                         grad_transform: Optional[GradTransform] = None
                         ) -> Callable:
    """ZeRO-1: ``step(zstate, batch) -> loss`` (the mean over ranks).

    ``model``'s parameters stay replicated in their own dtype and are
    refreshed each step from the sharded f32 master, so a bf16 model
    trains against f32 master weights.  ``loss_fn(model, batch)`` is this
    rank's loss on its own batch.  ``shard_axes="ici"`` is HSDP."""
    g = resolve_axes(comm, shard_axes)
    views = ParamViews.of(model)

    def step(zstate: ZeroState, batch) -> torch.Tensor:
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        padded = zstate.master.numel() * g.size
        gvec = views.flatten([p.grad for p in model.parameters()], padded,
                             zstate.master.device)
        _update(zstate, _reduce_scatter(comm, g, gvec), grad_transform)
        pvec = _gather(g, zstate.master)
        with torch.no_grad():
            for p, (_, shape, _, off) in zip(model.parameters(),
                                             views.views):
                p.copy_(pvec[off:off + math.prod(shape)].view(shape))
        model.zero_grad(set_to_none=True)
        return _mean_loss(comm, loss)

    return step


def make_fsdp_train_step(comm: CommContext, model: nn.Module,
                         loss_fn: Callable,
                         compute_dtype: Optional[torch.dtype] = None,
                         shard_axes: str = "all",
                         grad_transform: Optional[GradTransform] = None
                         ) -> Callable:
    """FSDP / ZeRO-3: ``step(zstate, batch) -> loss``.

    ``model`` gives the structure (read now, as :class:`ParamViews`, the
    step's ``views``); each step gathers the master into its parameters,
    in their own dtype or ``compute_dtype``, and after the backward
    releases them (zero-size storage) and their gradients, so between
    steps only the 1/R master and its optimizer state persist.  Use
    :func:`zero_params` for the parameters.  ``shard_axes="ici"`` is
    HSDP: the parameter gather never crosses nodes."""
    g = resolve_axes(comm, shard_axes)
    views = ParamViews.of(model)

    def step(zstate: ZeroState, batch) -> torch.Tensor:
        params = views.unflatten(_gather(g, zstate.master), compute_dtype)
        for name, p in model.named_parameters():
            p.data = params[name]
        del params
        loss = loss_fn(model, batch)
        loss.backward()
        padded = zstate.master.numel() * g.size
        gvec = views.flatten([p.grad for p in model.parameters()], padded,
                             zstate.master.device)
        for p in model.parameters():
            p.grad = None
            p.data = p.data.new_empty(0)
        _update(zstate, _reduce_scatter(comm, g, gvec), grad_transform)
        return _mean_loss(comm, loss)

    step.views = views
    return step


def zero_params(comm: CommContext, zstate: ZeroState,
                template: Union[nn.Module, ParamViews],
                compute_dtype: Optional[torch.dtype] = None,
                shard_axes: str = "all") -> Dict[str, torch.Tensor]:
    """The replicated parameters from a sharded master, by name (for a
    checkpoint or evaluation): in ``template``'s dtypes, or
    ``compute_dtype``.  ``template`` is the model (its current parameter
    shapes) or a :class:`ParamViews` (an FSDP step's ``views``).  A
    collective over the shard group."""
    g = resolve_axes(comm, shard_axes)
    return _views(template).unflatten(_gather(g, zstate.master),
                                      compute_dtype)
