"""The fused data-parallel training step; port of
``byteps_tpu/parallel/data_parallel.py``.

The JAX step is one XLA program over the mesh: forward, backward, the
gradient push_pull and the optimizer, with the parameters replicated and
the batch sharded.  Here each process is one rank with its own replica
of the module and its own rows of the batch, and the step is one Python
function: forward and backward on the local rows, the gradients'
push_pull (``ops/collective_ops.py``), then ``optimizer.step()``.  It is
the step the benchmark trains with (``tools/bert_mlm.py``).

- :func:`replicate` broadcasts a module's parameters and buffers from
  rank 0, in place;
- :func:`shard_batch` moves this rank's rows of a global batch onto
  ``comm.device``;
- :func:`make_dp_train_step` returns ``step(batch) -> loss``.
  Uncompressed, the gradients are coalesced into one flat buffer per
  dtype after the backward and all-reduced (:func:`push_pull_tree`);
  overlapping that with the backward is later performance work.  With
  ``compress_dcn`` every gradient takes :func:`hierarchical_push_pull`
  with that pair on its cross-node hop.  The loss returned is the ranks'
  average, as the JAX step's ``pmean``;
- :func:`make_dp_train_step_with_state` is the step for BatchNorm
  models, whose state is the module's buffers: the forward updates them
  in place, and a model built with a ``bn_group`` keeps them
  replica-identical.

``dp_specs`` returns JAX ``PartitionSpec``s for the mesh; it has no
counterpart in the port, which places nothing by annotation.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
import torch.nn as nn

from ..comm.mesh import CommContext
from ..ops.collective_ops import (broadcast_tree, hierarchical_push_pull,
                                  push_pull_tree)
from ..utils.tree import local_rows, tree_leaves, tree_map

__all__ = ["replicate", "shard_batch", "make_dp_train_step",
           "make_dp_train_step_with_state"]

LossFn = Callable  # (module, batch) -> scalar loss, the mean over the rows


def replicate(comm: CommContext, module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers on every rank, in place."""
    broadcast_tree(comm, module, root=0)
    return module


def shard_batch(comm: CommContext, batch):
    """This rank's rows of the global ``batch`` on ``comm.device``."""
    return tree_map(lambda x: torch.as_tensor(x).to(comm.device),
                    local_rows(comm, batch))


def _grads(model: nn.Module):
    """(name, parameter) of every trainable parameter, in module order."""
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def _local_loss_and_grads(model: nn.Module, loss_fn: LossFn, batch,
                          accum_steps: int) -> torch.Tensor:
    """Forward and backward on this rank's rows, the gradients left in
    ``.grad``.  ``accum_steps > 1`` splits the rows into that many
    microbatches and backpropagates each (the reference's
    ``backward_passes_per_step``); gradients and losses are summed in
    order and scaled by ``1 / accum_steps``, as the JAX scan does."""
    for _, p in _grads(model):
        p.grad = None
    if accum_steps == 1:
        loss = loss_fn(model, batch)
        loss.backward()
        return loss.detach()
    for leaf in tree_leaves(batch):
        if leaf.shape[0] % accum_steps:
            raise ValueError(
                f"per-shard batch {leaf.shape[0]} not divisible by "
                f"accum_steps={accum_steps} (global batch must be a "
                f"multiple of ranks * accum_steps)")
    total = None
    for i in range(accum_steps):
        def micro(x, i=i):
            k = x.shape[0] // accum_steps
            return x[i * k:(i + 1) * k]
        loss = loss_fn(model, tree_map(micro, batch))
        loss.backward()
        loss = loss.detach().float()
        total = loss if total is None else total + loss
    scale = 1.0 / accum_steps
    for _, p in _grads(model):
        if p.grad is not None:
            p.grad.mul_(scale)
    return total * scale


def _mean_over_ranks(comm: CommContext, loss: torch.Tensor) -> torch.Tensor:
    if comm.size > 1:
        loss = loss.clone()
        dist.all_reduce(loss)
        loss = loss / comm.size
    return loss


def make_dp_train_step(comm: CommContext, model: nn.Module, loss_fn: LossFn,
                       optimizer: torch.optim.Optimizer, compress_dcn=None,
                       accum_steps: int = 1) -> Callable:
    """``step(batch) -> loss``: forward and backward of
    ``loss_fn(model, batch)`` on this rank's rows (already on the device,
    e.g. from :func:`shard_batch`), the gradients averaged over all ranks,
    then ``optimizer.step()``.  ``compress_dcn`` is a ``(compress,
    decompress)`` pair (:func:`make_onebit_pair`,
    :func:`make_powersgd_pair`) for each gradient's cross-node hop.
    Returns the loss averaged over ranks (a 0-d tensor on the device)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(batch) -> torch.Tensor:
        loss = _local_loss_and_grads(model, loss_fn, batch, accum_steps)
        grads = {n: p.grad for n, p in _grads(model) if p.grad is not None}
        if compress_dcn is not None:
            comp, decomp = compress_dcn
            for g in grads.values():
                g.copy_(hierarchical_push_pull(comm, g, "average", comp,
                                               decomp))
        else:
            push_pull_tree(comm, grads, "average", inplace=True)
        optimizer.step()
        return _mean_over_ranks(comm, loss)

    return step


def make_dp_train_step_with_state(comm: CommContext, model: nn.Module,
                                  loss_fn: LossFn,
                                  optimizer: torch.optim.Optimizer
                                  ) -> Callable:
    """``step(batch) -> loss`` for a model with BatchNorm running
    statistics (its buffers, updated in place by the forward).  Built
    with a ``bn_group`` (``models/resnet.py``), the model takes its batch
    statistics over the group inside the forward, so the buffers stay
    replica-identical with no collective here, as in the JAX step."""
    return make_dp_train_step(comm, model, loss_fn, optimizer)
