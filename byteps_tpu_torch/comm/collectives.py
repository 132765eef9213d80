"""Collectives of the push_pull data plane; port of
``byteps_tpu/comm/collectives.py``.

Each rank contributes its own tensor and receives the reduction:

- :func:`all_reduce`: one all-reduce over the world group;
- :func:`hierarchical_all_reduce`: reduce-scatter inside the node, an
  all-reduce of the shard across nodes, then an all-gather inside the
  node (the reference's NCCL RS -> push/pull -> NCCL AG flow), with the
  flat tensor zero-padded to a multiple of ``local_size``;
- :func:`broadcast`: every rank receives rank ``root``'s tensor.

Two numeric rules carry over from the JAX package.  ``_acc``: f16 and
bf16 summands are cast to f32 before the collective, because NCCL's own
bf16 sum rounds at every hop and an R-way fp16 sum overflows at
``|x| > 65504 / R``.  ``_epilogue``: a fused scale (the engine's 1/R) is
applied to the accumulation-dtype sum before any downcast.

Collectives run in place in torch, so every entry point reduces a copy
and never writes the caller's tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import CommContext

_HALF = (torch.float16, torch.bfloat16)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """A fresh buffer for the collective in the accumulation dtype."""
    if x.dtype in _HALF:
        return x.to(torch.float32)
    return x.clone()


def _epilogue(r: torch.Tensor, x_dtype, comm: CommContext, average: bool,
              keep_acc: bool, scale: Optional[float]) -> torch.Tensor:
    if scale is not None:
        return r.mul_(scale).to(x_dtype)
    if average:
        return (r / comm.size).to(x_dtype)
    if keep_acc:
        # engine-internal SUM: f16/bf16 stays f32 so the caller's
        # division happens before the downcast
        return r
    return r.to(x_dtype)


def all_reduce(comm: CommContext, x: torch.Tensor, op: str = "sum",
               keep_acc: bool = False,
               scale: Optional[float] = None) -> torch.Tensor:
    """Sum (or average) ``x`` over all ranks."""
    buf = _acc(x)
    dist.all_reduce(buf)
    return _epilogue(buf, x.dtype, comm, op == "average", keep_acc, scale)


def hierarchical_all_reduce(comm: CommContext, x: torch.Tensor,
                            op: str = "sum", keep_acc: bool = False,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Two-level reduction: RS inside the node, all-reduce of the shard
    across nodes, AG inside the node."""
    flat = _acc(x).reshape(-1)
    n, L = flat.numel(), comm.local_size
    pad = (-n) % L
    if pad:
        flat = F.pad(flat, (0, pad))
    if L > 1:
        shard = flat.new_empty(flat.numel() // L)
        dist.reduce_scatter_tensor(shard, flat, group=comm.intra_group)
    else:
        shard = flat
    if comm.num_nodes > 1:
        dist.all_reduce(shard, group=comm.inter_group)
    shard = _epilogue(shard, x.dtype, comm, op == "average", keep_acc, scale)
    if L > 1:
        out = shard.new_empty(shard.numel() * L)
        dist.all_gather_into_tensor(out, shard, group=comm.intra_group)
    else:
        out = shard
    return out[:n].reshape(x.shape)


def broadcast(comm: CommContext, x: torch.Tensor,
              root: int = 0) -> torch.Tensor:
    """Every rank receives rank ``root``'s ``x``."""
    if not 0 <= root < comm.size:
        raise ValueError(f"root {root} out of range")
    out = x.clone()
    dist.broadcast(out, src=root)
    return out


def push_pull_array(comm: CommContext, x: torch.Tensor, op: str = "sum",
                    hierarchical: Optional[bool] = None,
                    keep_acc: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The collective behind push_pull: the strategy follows the topology
    (hierarchical once the world spans more than one node)."""
    if hierarchical is None:
        hierarchical = comm.num_nodes > 1
    fn = hierarchical_all_reduce if hierarchical else all_reduce
    return fn(comm, x, op, keep_acc=keep_acc, scale=scale)
