"""Collectives of the push_pull data plane; port of
``byteps_tpu/comm/collectives.py``.

Each rank contributes its own tensor and receives the reduction:

- :func:`all_reduce`: one all-reduce over the world group;
- :func:`hierarchical_all_reduce`: reduce-scatter inside the node, an
  all-reduce of the shard across nodes, then an all-gather inside the
  node (the reference's NCCL RS -> push/pull -> NCCL AG flow), with the
  flat tensor zero-padded to a multiple of ``local_size``;
- :func:`broadcast`: every rank receives rank ``root``'s tensor;
- :func:`push_pull_arrays_batched`: k equal-length chunks, one buffer,
  one reduction, k results (the engine's chunk groups);
- the scatter accumulator (:func:`scatter_layout`,
  :func:`push_pull_chunk_scatter`, :func:`assemble_scatter`): the flat
  tensor viewed as ``[L, C]`` (``L = local_size``), each chunk a column
  slab whose reduce-scatter lands at its final owner's position, so
  rank ``local_rank`` ends up holding block ``local_rank`` of the sum
  (the sharded weight update's owner-resident gradient shard).

Two numeric rules carry over from the JAX package.  ``_acc``: f16 and
bf16 summands are cast to f32 before the collective, because NCCL's own
bf16 sum rounds at every hop and an R-way fp16 sum overflows at
``|x| > 65504 / R``.  ``_epilogue``: a fused scale (the engine's 1/R) is
applied to the accumulation-dtype sum before any downcast.

Collectives run in place in torch, so every entry point reduces a copy
and never writes the caller's tensor.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..fault import injector as _fault
from .mesh import CommContext

_HALF = (torch.float16, torch.bfloat16)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in _HALF else dtype


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


def _all_reduce_acc(comm: CommContext, buf: torch.Tensor, x_dtype,
                    average: bool, keep_acc: bool,
                    scale: Optional[float]) -> torch.Tensor:
    """All-reduce the accumulation buffer ``buf`` (owned: reduced in
    place), then the epilogue."""
    dist.all_reduce(buf)
    return _epilogue(buf, x_dtype, comm, average, keep_acc, scale)


def _hierarchical_acc(comm: CommContext, flat: torch.Tensor, x_dtype,
                      average: bool, keep_acc: bool,
                      scale: Optional[float]) -> torch.Tensor:
    """The two-level reduction of the flat accumulation buffer ``flat``."""
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
    shard = _epilogue(shard, x_dtype, comm, average, keep_acc, scale)
    if L > 1:
        out = shard.new_empty(shard.numel() * L)
        dist.all_gather_into_tensor(out, shard, group=comm.intra_group)
    else:
        out = shard
    return out[:n]


def all_reduce(comm: CommContext, x: torch.Tensor, op: str = "sum",
               keep_acc: bool = False,
               scale: Optional[float] = None) -> torch.Tensor:
    """Sum (or average) ``x`` over all ranks."""
    return _all_reduce_acc(comm, _acc(x), x.dtype, op == "average",
                           keep_acc, scale)


def hierarchical_all_reduce(comm: CommContext, x: torch.Tensor,
                            op: str = "sum", keep_acc: bool = False,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Two-level reduction: RS inside the node, all-reduce of the shard
    across nodes, AG inside the node."""
    return _hierarchical_acc(comm, _acc(x).reshape(-1), x.dtype,
                             op == "average", keep_acc,
                             scale).reshape(x.shape)


def broadcast(comm: CommContext, x: torch.Tensor,
              root: int = 0) -> torch.Tensor:
    """Every rank receives rank ``root``'s ``x``."""
    if not 0 <= root < comm.size:
        raise ValueError(f"root {root} out of range")
    out = x.clone()
    dist.broadcast(out, src=root)
    return out


def broadcast_host(comm: CommContext, arr, root: int = 0):
    """Rank ``root``'s host array on every rank (JAX ``broadcast_host``,
    ``byteps_tpu/comm/collectives.py:351-362``): staged onto the group's
    device, broadcast there, read back in ``arr``'s shape and dtype.  The
    frameworks' ``broadcast_variables`` go through it."""
    from ..common.host import host_to_tensor, tensor_to_host
    arr = np.asarray(arr)
    t = host_to_tensor(arr).to(comm.device, copy=True)
    return tensor_to_host(broadcast(comm, t, root=root), arr.shape,
                          arr.dtype)


def _reduce_acc(comm: CommContext, buf: torch.Tensor, x_dtype,
                average: bool, keep_acc: bool, scale: Optional[float],
                hierarchical: Optional[bool]) -> torch.Tensor:
    """The push_pull strategy on an owned flat accumulation buffer: the
    hierarchical form once the world spans more than one node."""
    if hierarchical is None:
        hierarchical = comm.num_nodes > 1
    fn = _hierarchical_acc if hierarchical else _all_reduce_acc
    return fn(comm, buf, x_dtype, average, keep_acc, scale)


def push_pull_array(comm: CommContext, x: torch.Tensor, op: str = "sum",
                    hierarchical: Optional[bool] = None,
                    keep_acc: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The collective behind push_pull: the strategy follows the topology
    (hierarchical once the world spans more than one node)."""
    # the dcn chaos site, as JAX ``push_pull_array`` and
    # ``push_pull_scaled`` fire it (``collectives.py:371-372``, ``:394-395``)
    if _fault.ENABLED:
        _fault.fire("dcn")
    return _reduce_acc(comm, _acc(x).reshape(-1), x.dtype, op == "average",
                       keep_acc, scale, hierarchical).reshape(x.shape)


def push_pull_array_scaled(comm: CommContext, x: torch.Tensor, scale: float,
                           hierarchical: Optional[bool] = None
                           ) -> torch.Tensor:
    """The sum over ranks times ``scale``, in ``x``'s dtype: the JAX
    package's name for ``push_pull_array(..., scale=)`` (the scale is
    applied to the accumulation-dtype sum, before any downcast)."""
    return push_pull_array(comm, x, hierarchical=hierarchical, scale=scale)


def push_pull_arrays_batched(comm: CommContext, xs: Sequence[torch.Tensor],
                             scale: Optional[float] = None
                             ) -> List[torch.Tensor]:
    """Reduce ``k`` equal-length chunks with ONE collective; returns the
    k results, flat views of one buffer.

    The chunks are cast-copied into one accumulation-dtype buffer (one
    copy each, in place of a clone each), which gets the reduction and
    the epilogue a single dispatch of each chunk would get (the same
    strategy; ``scale=None`` keeps the accumulation dtype, as the
    engine's ``keep_acc`` sum).  Every step is elementwise, so each
    chunk's result has the bits its own dispatch would give at one rank;
    at more than one rank the engine forms no group (a collective's
    summation order may depend on where an element lies in the buffer,
    JAX ``collectives.py:713-718``)."""
    if not xs:
        raise ValueError("push_pull_arrays_batched of no chunks")
    # JAX ``push_pull_arrays_batched`` (``collectives.py:776-777``)
    if _fault.ENABLED:
        _fault.fire("dcn")
    x0 = xs[0]
    n = x0.numel()
    if any(x.numel() != n or x.dtype != x0.dtype for x in xs):
        raise ValueError("push_pull_arrays_batched needs chunks of one "
                         "length and dtype")
    buf = torch.empty(len(xs) * n, dtype=_acc_dtype(x0.dtype),
                      device=x0.device)
    for i, x in enumerate(xs):
        buf[i * n:(i + 1) * n].copy_(x.reshape(-1))
    out = _reduce_acc(comm, buf, x0.dtype, False, True, scale, None)
    return list(out.split(n))


# ---------------------------------------------------------------------------
# The scatter accumulator (JAX ``collectives.py:582-881``, buffer mode).
#
# The flat [n] tensor, padded to n_pad = C * L, is viewed as [L, C]: row d
# is block d of the tensor, the block rank ``local_rank == d`` owns.
# Chunk i becomes the column slab [col_off_i, col_off_i + col_ln_i) of all
# rows; its reduce-scatter over the node hands each rank the summed slab
# of its own block, written in place into the rank's accumulator [C] at
# col_off_i.  The accumulator's layout depends on n and L only, not on the
# chunk bounds, so a repartition between pushes never moves ownership.
# ---------------------------------------------------------------------------


def scatter_layout(chunk_bounds, n_ici: int):
    """Column-space chunk layout for the scatter accumulator, or ``None``
    when the tensor's chunk bounds don't admit it.

    The flat tensor is viewed as ``[n_ici, C]`` with ``C = ceil(n /
    n_ici)`` columns (``n_ici`` is the port's ``local_size``).  Eligible
    when every non-tail chunk's offset and length, and the tail's offset,
    are divisible by ``n_ici`` (the partitioner's 512-element alignment
    guarantees it for power-of-2 nodes).  The tail slab runs to column
    ``C``, over the padding.  Returns ``([(col_off, col_ln), ...], C)``."""
    n = chunk_bounds[-1][0] + chunk_bounds[-1][1]
    C = -(-n // n_ici)
    for off, ln in chunk_bounds[:-1]:
        if off % n_ici or ln % n_ici:
            return None
    if chunk_bounds[-1][0] % n_ici:
        return None
    layout = []
    for i, (off, ln) in enumerate(chunk_bounds):
        col_off = off // n_ici
        col_ln = (C - col_off if i == len(chunk_bounds) - 1
                  else ln // n_ici)
        layout.append((col_off, col_ln))
    return layout, C


def push_pull_chunk_scatter(comm: CommContext, flat: torch.Tensor,
                            buf: Optional[torch.Tensor], col_off: int,
                            w: int, k: int, C: int) -> torch.Tensor:
    """Reduce ``k`` contiguous ``w``-column slabs of ``flat`` (the padded
    ``[C * L]`` contribution, viewed as ``[L, C]``) starting at column
    ``col_off`` into this rank's accumulator ``buf`` (``[C]`` in the
    accumulation dtype; ``None`` allocates it).  Returns ``buf``.

    The slab is copied contiguous in the accumulation dtype (f32 for
    f16/bf16, as ``_acc``), reduce-scattered over the node into
    ``buf[col_off:col_off + k*w]``, and at more than one node that slice
    is all-reduced across nodes.  At one rank per node the view is
    ``[1, C]`` and nothing is scattered: the slab is copied into place."""
    # JAX ``push_pull_chunk_scatter`` (``collectives.py:697-698``)
    if _fault.ENABLED:
        _fault.fire("dcn")
    L = comm.local_size
    if buf is None:
        buf = torch.empty(C, dtype=_acc_dtype(flat.dtype),
                          device=flat.device)
    kw = k * w
    out = buf[col_off:col_off + kw]
    cols = flat.view(L, C)[:, col_off:col_off + kw]
    if L > 1:
        slab = torch.empty((L, kw), dtype=buf.dtype, device=buf.device)
        slab.copy_(cols)
        dist.reduce_scatter_tensor(out, slab.view(-1),
                                   group=comm.intra_group)
    else:
        out.copy_(cols[0])
    if comm.num_nodes > 1:
        dist.all_reduce(out, group=comm.inter_group)
    return buf


def assemble_scatter(comm: CommContext, buf: torch.Tensor, n: int, C: int,
                     out_shape, dtype: torch.dtype,
                     scale: Optional[float] = None,
                     denom: int = 1) -> torch.Tensor:
    """Final assembly from an accumulator block: the scale (or divisor,
    floored for an integer dtype, as JAX ``_assemble_program``) in the
    accumulation dtype, the cast to ``dtype``, then an all-gather of the
    blocks over the node, trimmed to ``n`` and shaped ``out_shape``.
    The gather ships each rank's block in ``dtype``; the result is a
    fresh tensor (it never aliases ``buf``)."""
    x = buf
    if scale is not None:
        x = x * scale
    elif denom != 1:
        x = (x / denom if x.is_floating_point()
             else torch.div(x, denom, rounding_mode="floor"))
    block = x.to(dtype, copy=x is buf)
    L = comm.local_size
    if L > 1:
        full = block.new_empty(C * L)
        dist.all_gather_into_tensor(full, block, group=comm.intra_group)
    else:
        full = block
    return full[:n].view(out_shape)
