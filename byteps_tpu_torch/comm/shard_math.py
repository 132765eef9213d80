"""Shard geometry shared by the sharded weight update and ZeRO; port of
``byteps_tpu/comm/shard_math.py``.

Two paths keep optimizer state as a flat padded f32 vector sharded over
ranks: ``parallel/zero.py`` (the whole model as one vector) and
``core/sharded_update.py`` (one vector per declared tensor, on the
engine's push_pull pipeline).  The padding rule, the group resolution
and the rule of which optimizer-state tensors are sharded are the same
in both, so a state exported from one layout can be imported into the
other.

The JAX package shards ``optax`` state over mesh axes under one
controller.  Here each process holds its own shard, and the optimizer is
a ``torch.optim`` optimizer built over that shard alone: its per-element
state (momentum, Adam's moments) is born at the shard's length, so the
rule of ``spec_of_opt`` (vectors of the padded length are sharded,
counters are replicated) becomes a predicate on the tensors of the
optimizer's state: 1-D tensors of the shard's length are shards, the
rest (``step``) is replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Type

import torch

from .mesh import CommContext

__all__ = [
    "ShardGroups",
    "padded_size",
    "resolve_axes",
    "is_sharded_state",
    "init_sharded_opt_state",
    "set_hyperparameters",
]

# Optimizer arguments fixed at construction (the implementation), which
# the per-step hyperparameter copy leaves alone.
IMPL_FLAGS = ("foreach", "fused")
# torch.optim optimizers that take fused=True (the sharded_update_fused
# mode).
FUSED_OPTIMIZERS = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW)


def padded_size(n: int, ranks: int) -> int:
    """Pad to a multiple of ranks*128 so every shard is lane-aligned (the
    partitioner's 512-element tile rule scaled to the shard grid)."""
    quantum = ranks * 128
    return (n + quantum - 1) // quantum * quantum


@dataclasses.dataclass(frozen=True)
class ShardGroups:
    """Where a flat vector is sharded and where its shards are summed.

    ``group`` / ``size`` / ``index``: the process group the vector is
    reduce-scattered and all-gathered over, its size (the shard count)
    and this rank's shard.  ``extra_group`` / ``extra_size``: the group
    that completes the sum of each shard (HSDP's cross-node all-reduce);
    a size of 1 issues nothing.  A group of ``None`` is the world group,
    as in ``CommContext``."""

    group: Any
    size: int
    index: int
    extra_group: Any
    extra_size: int


def resolve_axes(comm: CommContext, shard_axes: str) -> ShardGroups:
    """The groups of a shard layout.

    ``"all"``: shard over every rank (the world group), minimum memory
    (1/R).  ``"ici"``: HSDP, shard within a node (``intra_group``) and
    replicate across nodes; the rest of the sum runs over ``inter_group``
    on just the shard."""
    if shard_axes == "all":
        return ShardGroups(None, comm.size, comm.rank, None, 1)
    if shard_axes == "ici":
        return ShardGroups(comm.intra_group, comm.local_size,
                           comm.local_rank, comm.inter_group,
                           comm.num_nodes)
    raise ValueError(
        f"shard_axes must be 'all' or 'ici', got {shard_axes!r}")


def is_sharded_state(value, shard_len: int) -> bool:
    """``spec_of_opt``'s rule for one state tensor of a shard optimizer:
    a 1-D tensor of the shard's length is a shard of the flat vector;
    anything else (a step counter, a scalar) is replicated."""
    return (torch.is_tensor(value) and value.dim() == 1
            and value.numel() == shard_len)


def init_sharded_opt_state(optimizer: Tuple[Type[torch.optim.Optimizer],
                                            Dict[str, Any]],
                           master: torch.Tensor, *, fused: bool = False,
                           state: Optional[Dict[str, Any]] = None
                           ) -> torch.optim.Optimizer:
    """Build the optimizer over this rank's shard of the f32 master.

    ``optimizer`` names it: ``(cls, hyperparameters)``, the class of a
    ``torch.optim`` optimizer and a param group's hyperparameters (what
    ``param_groups[i]`` holds, less ``params``).  ``foreach`` / ``fused``
    pin the implementation at construction; ``fused=True`` asks for the
    fused kernels (SGD, Adam and AdamW have them) and raises for other
    classes.  ``state`` (tensors at the shard's length, counters) seeds
    the optimizer's state, as a restore does."""
    cls, hyper = optimizer
    kw = {k: hyper[k] for k in IMPL_FLAGS if hyper.get(k) is not None}
    if fused:
        if not issubclass(cls, FUSED_OPTIMIZERS):
            raise ValueError(
                f"sharded_update_fused needs an optimizer with fused "
                f"kernels (SGD, Adam, AdamW), got {cls.__name__}")
        kw.pop("foreach", None)
        kw["fused"] = True
    opt = cls([master], **kw)
    set_hyperparameters(opt, hyper)
    if state is not None:
        sd = opt.state_dict()
        sd["state"] = {0: dict(state)}
        # load_state_dict places each tensor as the class wants it
        # (moments on the master's device and dtype, ``step`` where the
        # implementation keeps it)
        opt.load_state_dict(sd)
    return opt


def set_hyperparameters(opt: torch.optim.Optimizer,
                        hyper: Dict[str, Any]) -> None:
    """Copy a param group's hyperparameters (lr, betas, weight_decay,
    momentum, ...) onto ``opt``'s group; keys the group does not have,
    ``params`` and the implementation flags are left alone."""
    group = opt.param_groups[0]
    for k, v in hyper.items():
        if k in group and k != "params" and k not in IMPL_FLAGS:
            group[k] = v
