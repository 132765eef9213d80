"""The sharded weight update on the push_pull pipeline; port of
``byteps_tpu/core/sharded_update.py``.

Under ``Config.sharded_update`` (``BYTEPS_SHARDED_UPDATE``) a tensor
declared with ``declare_update`` is pushed like any gradient, but its pull
leg returns the owner-updated *parameters* instead of the merged
gradient:

- the scatter accumulator (``comm/collectives.py``) leaves block
  ``local_rank`` of the summed gradient on this rank: the owner-resident
  gradient shard, never gathered;
- a ``torch.optim`` optimizer steps that shard against a flat f32 master
  block, with per-element state born at the block's length
  (``comm/shard_math.py``, the geometry ``parallel/zero.py`` shares);
- the owners' updated blocks, cast to the declared dtype, are
  all-gathered over the node, and the caller ``copy_``s the result into
  its parameter.

The JAX slot emits optax *updates*, which the caller adds to its
parameters.  A torch optimizer writes the new value itself, so emitting
``new - old`` and adding it on the replica would round a second time and
the sharded trajectory would leave the replicated one; the port emits
the parameters.

Wire accounting (the reference's): the replicated update ships push N +
pull N (the merged gradient comes back whole and every replica runs the
same optimizer); the sharded update ships push N + pull N/R.  The parts
fallback (chunk bounds the column view cannot express, or a small
single-chunk tensor) all-reduces the merged gradient as the replicated
path does, so its pull leg is accounted at full size.

Geometry: ``C = ceil(n / L)``, ``n_pad = C * L`` with ``L =
local_size``: the slot is sharded within a node and replicated across
nodes (zero.py's ``"ici"`` layout), because the cross-node all-reduce
of each slab leaves every node with the same sum.

The pad region ``[n, n_pad)`` of the last block carries zero gradients
forever.  SGD (with momentum, dampening, Nesterov and weight decay),
Adam and AdamW keep its master and state at exactly 0.0: every update is
a product with the zero gradient or the zero master (``0 * (1 - lr*wd)``
for AdamW's decoupled decay), and Adam's step there is ``0 / (0 + eps)``.
An optimizer whose update depends on anything but the element's own
gradient and value could move it; the pad is never emitted either way.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Type

import torch
import torch.distributed as dist

from ..comm.collectives import assemble_scatter
from ..comm.mesh import CommContext
from ..comm.shard_math import (init_sharded_opt_state, is_sharded_state,
                               set_hyperparameters)
from ..common.config import Config

__all__ = ["ShardedUpdateSlot"]

OptimizerSpec = Tuple[Type[torch.optim.Optimizer], Dict[str, Any]]


class ShardedUpdateSlot:
    """Owner-resident optimizer state for one declared tensor.

    ``master`` is this rank's f32 block ``[C]`` of the flat parameter
    vector (block ``local_rank``, elements ``[b*C, b*C + C)``), seeded
    from ``init_value``; ``optimizer`` is the ``torch.optim`` optimizer
    over it, named by ``(cls, hyperparameters)``.  ``applied`` counts the
    steps taken (carried through ``export``/``restore``).

    The slot's step and its all-gather are issued by the engine's
    dispatcher thread, on the engine stream, after the tensor's last
    reduce-scatter (a process group's collectives must come in the same
    order on every rank, and only the dispatcher issues them)."""

    def __init__(self, comm: CommContext, cfg: Config, name: str, shape,
                 dtype: torch.dtype, optimizer: OptimizerSpec, *,
                 init_value=None, restore: Optional[Dict[str, Any]] = None):
        self.comm = comm
        self.name = name
        self.out_shape = tuple(shape)
        self.dtype = dtype
        self.n = math.prod(self.out_shape)
        self.nbytes = self.n * dtype.itemsize
        L = comm.local_size
        self.C = -(-self.n // L)
        self.n_pad = self.C * L
        self.block = comm.local_rank
        self.applied = int(restore["applied"]) if restore else 0
        seed = restore["master"] if restore is not None else init_value
        self.master = self._my_block(seed, torch.float32)
        state = None
        if restore is not None:
            state = {k: (self._my_block(v, v.dtype)
                         if k in restore["sharded"] else v)
                     for k, v in restore["state"].items()}
        self.optimizer = init_sharded_opt_state(
            optimizer, self.master, fused=cfg.sharded_update_fused,
            state=state)

    def _my_block(self, value, dtype: torch.dtype) -> torch.Tensor:
        """This rank's ``[C]`` block of a logical-length vector (zeros
        where it runs past ``n``, and for ``value=None``), on the
        engine's device."""
        out = torch.zeros(self.C, dtype=dtype, device=self.comm.device)
        if value is not None:
            flat = torch.as_tensor(value).detach().reshape(-1)
            lo = self.block * self.C
            hi = min(lo + self.C, self.n)
            if hi > lo:
                out[:hi - lo].copy_(flat[lo:hi])
        return out

    # ------------------------------------------------------------ the step
    def _step(self, grad: torch.Tensor,
              hyperparameters: Optional[Dict[str, Any]]) -> torch.Tensor:
        if hyperparameters:
            set_hyperparameters(self.optimizer, hyperparameters)
        self.master.grad = grad
        self.optimizer.step()
        self.master.grad = None
        self.applied += 1
        return assemble_scatter(self.comm, self.master, self.n, self.C,
                                self.out_shape, self.dtype)

    def apply_buffer(self, buf: torch.Tensor, scale: Optional[float],
                     hyperparameters: Optional[Dict[str, Any]] = None
                     ) -> torch.Tensor:
        """One completed buffer-mode push: the accumulator ``buf`` (this
        rank's summed block, f32) times the fused 1/R ``scale`` is the
        master's gradient.  Returns the updated parameters, gathered."""
        grad = buf * scale if scale is not None else buf
        return self._step(grad.to(torch.float32), hyperparameters)

    def apply_full(self, merged: torch.Tensor,
                   hyperparameters: Optional[Dict[str, Any]] = None
                   ) -> torch.Tensor:
        """The parts fallback: the fully merged, averaged gradient (in the
        declared dtype); this rank steps its own block of it."""
        return self._step(self._my_block(merged, torch.float32),
                          hyperparameters)

    # ------------------------------------------------------------ state io
    def _gather(self, block: torch.Tensor) -> torch.Tensor:
        """The logical-length vector from every rank's block (collective
        over the node)."""
        if self.comm.local_size > 1:
            full = block.new_empty(self.n_pad)
            dist.all_gather_into_tensor(full, block.contiguous(),
                                        group=self.comm.intra_group)
        else:
            full = block
        return full[:self.n]

    def export(self) -> Dict[str, Any]:
        """Snapshot for suspend/resume, on the host: the master and every
        sharded state tensor at logical length ``n`` (the pad is layout,
        not state), gathered so every rank holds the same snapshot; the
        replicated state (``step``) as it is.  A collective over the
        node: every rank calls it, with nothing in flight."""
        st = self.optimizer.state.get(self.master, {})
        sharded = [k for k, v in st.items() if is_sharded_state(v, self.C)]
        state = {k: (self._gather(v) if k in sharded else v)
                 for k, v in st.items()}
        return {
            "master": self._gather(self.master).cpu().clone(),
            "state": {k: (v.cpu().clone() if torch.is_tensor(v) else v)
                      for k, v in state.items()},
            "sharded": sharded,
            "applied": self.applied,
            "shape": self.out_shape,
            "dtype": str(self.dtype),
        }

    def sync_master(self, value) -> None:
        """Re-seed this rank's f32 block from externally authoritative
        parameters (the async-PS pull leg, ``torch/async_opt.py``: the
        store's fresh weights absorb OTHER workers' deltas the local
        master never saw).  In place: the optimizer holds ``master``."""
        with torch.no_grad():
            self.master.copy_(self._my_block(value, torch.float32))

    def params(self) -> torch.Tensor:
        """The current parameters: the gathered master, shaped and cast
        to the declared dtype (a collective over the node, as
        :meth:`export`)."""
        return self._gather(self.master).view(self.out_shape).to(self.dtype)

    def state_nbytes(self) -> int:
        """Bytes this rank holds: its master block and the optimizer's
        tensors."""
        st = self.optimizer.state.get(self.master, {})
        return (self.master.numel() * self.master.element_size()
                + sum(v.numel() * v.element_size() for v in st.values()
                      if torch.is_tensor(v)))

    # ------------------------------------------------------------ wire
    def pull_share(self, task_nbytes: int, buffered: bool) -> int:
        """Pull-leg wire bytes of one completed chunk of ``task_nbytes``
        push-leg bytes: the owner's slice, 1/R, in buffer mode; full size
        on the parts fallback, which all-reduced the merged gradient.
        (At more than one node each rank's all-gather sends its block of
        N/L; the reference's accounting, kept here, is N/R.)"""
        if not buffered:
            return task_nbytes
        return task_nbytes // self.comm.size
