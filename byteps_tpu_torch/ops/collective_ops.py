"""push_pull and broadcast over a model's tensors, and the two-level
reduction with a compressed cross-node hop; port of
``byteps_tpu/ops/collective_ops.py``.

The JAX functions run inside a ``shard_map`` body over named mesh axes.
Here each process holds its own tensors, as in every collective of the
port (``comm/collectives.py``): the node axis (``ici``) is
``comm.intra_group`` and the cross-node axis (``dcn``) is
``comm.inter_group``.

- :func:`push_pull_tree` sums or averages every tensor of a dict (or a
  module's parameters) over the world, coalesced into one flat buffer
  per dtype and device: one all-reduce each;
- :func:`broadcast_tree` gives every rank rank ``root``'s tensors, in
  place, coalesced the same way;
- :func:`hierarchical_push_pull` reduce-scatters inside the node,
  exchanges the shard across nodes (compressed when a pair is given and
  the shard is large enough), and all-gathers inside the node;
- :func:`make_onebit_pair` and :func:`make_powersgd_pair` build the
  compressor pairs of that hop.  Each decompress carries ``.sum_fn``, the
  codec's fused merge of the gathered payloads (onebit's
  ``onebit_unpack_sum`` kernel), which the hop uses in place of a
  decompress per rank.

Half-precision tensors are reduced in f32 and cast back, the port's rule
(``comm/collectives.py`` ``_acc``); the JAX collectives reduce in the
tensor's dtype.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..comm.collectives import _acc_dtype
from ..comm.compressed import all_gather_bytes
from ..comm.mesh import CommContext
from ..common.logging import get_logger

__all__ = ["push_pull_tree", "broadcast_tree", "hierarchical_push_pull",
           "make_onebit_pair", "make_powersgd_pair",
           "dcn_compress_min_bytes", "DCN_COMPRESS_MIN_BYTES"]

# The shard size (bytes, per rank) from which the compressed cross-node
# hop engages: the JAX package's measured crossover (collective_ops.py:
# 20-28); BYTEPS_DCN_COMPRESS_MIN_BYTES overrides it.
DCN_COMPRESS_MIN_BYTES = 2 * 1024 * 1024


def dcn_compress_min_bytes() -> int:
    """``BYTEPS_DCN_COMPRESS_MIN_BYTES``, read at every call (the JAX
    function reads it at every trace), else the default."""
    # bpslint: ignore[env-knob] reason=read per call (the JAX function reads it per trace) so a mid-session env override re-gates the next call; a Config snapshot would freeze it — documented in env.md Compression table
    v = os.environ.get("BYTEPS_DCN_COMPRESS_MIN_BYTES")
    if v is None or v == "":
        return DCN_COMPRESS_MIN_BYTES
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"BYTEPS_DCN_COMPRESS_MIN_BYTES must be an "
                         f"integer, got {v!r}") from None


def _leaves(tree, buffers: bool = False) -> Dict[str, torch.Tensor]:
    """A dict of tensors as it is; a module's parameters (and, with
    ``buffers``, its buffers) by name."""
    if isinstance(tree, nn.Module):
        out = {n: p.data for n, p in tree.named_parameters()}
        if buffers:
            out.update((n, b) for n, b in tree.named_buffers())
        return out
    if isinstance(tree, Mapping):
        return dict(tree)
    raise TypeError(f"expected a dict of tensors or a module, got "
                    f"{type(tree).__name__}")


def _by_dtype(leaves: Dict[str, torch.Tensor]):
    """Names grouped by (dtype, device), in the dict's order."""
    groups: Dict[tuple, list] = {}
    for name, t in leaves.items():
        groups.setdefault((t.dtype, t.device), []).append(name)
    return groups.values()


def push_pull_tree(comm: CommContext, tree, op: str = "average",
                   inplace: bool = False,
                   axis=None) -> Dict[str, torch.Tensor]:
    """Sum (``op="sum"``) or average every tensor of ``tree`` over all
    ranks: a dict of tensors, or a module's parameters.  The tensors of
    one dtype and device are concatenated into one buffer (f32 for
    f16/bf16), all-reduced once and split.  Returns the results by name;
    with ``inplace`` they are written into ``tree``'s tensors, which are
    returned.  ``axis`` (a mesh axis, ``parallel/mesh_util.MeshAxis``)
    reduces over that axis's group alone, as the JAX function's ``axes``
    name mesh axes."""
    if op not in ("average", "sum"):
        raise ValueError(f"op must be 'average' or 'sum', got {op!r}")
    group, size = (None, comm.size) if axis is None else (axis.group,
                                                           axis.size)
    leaves = _leaves(tree)
    out: Dict[str, torch.Tensor] = {}
    for names in _by_dtype(leaves):
        ts = [leaves[n] for n in names]
        dtype = ts[0].dtype
        if op == "average" and not dtype.is_floating_point:
            raise TypeError(f"push_pull_tree: cannot average {dtype} "
                            f"tensors ({names[0]}); use op='sum'")
        flat = torch.cat([t.reshape(-1).to(_acc_dtype(dtype)) for t in ts])
        if size > 1:
            dist.all_reduce(flat, group=group)
        if op == "average":
            flat = flat / size
        for n, t, r in zip(names, ts, flat.split([t.numel() for t in ts])):
            r = r.view(t.shape).to(dtype)
            out[n] = t.copy_(r) if inplace else r
    return out


@torch.no_grad()
def broadcast_tree(comm: CommContext, tree,
                   root: int = 0) -> Dict[str, torch.Tensor]:
    """Give every rank rank ``root``'s tensors, in place: a dict of
    tensors, or a module's parameters and buffers.  One broadcast per
    dtype and device, of the concatenated tensors."""
    if not 0 <= root < comm.size:
        raise ValueError(f"root {root} out of range for {comm.size} ranks")
    leaves = _leaves(tree, buffers=True)
    if comm.size == 1:
        return leaves
    for names in _by_dtype(leaves):
        ts = [leaves[n] for n in names]
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=root)
        for t, r in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(r.view(t.shape))
    return leaves


class _CompressorPair:
    """``(compress, decompress)`` closures over one codec of
    ``compression/`` for :func:`hierarchical_push_pull`.  The hop calls
    compress before decompress for each tensor, so the pair carries the
    shard's size from one to the other: the payload has no numel field.

    ``compress`` starts from the codec's initial state at every call, as
    the JAX pair does (``collective_ops.py:99-102``): this hop keeps no
    error feedback."""

    def __init__(self, factory):
        self._factory = factory
        self._comp = None

    def compress(self, shard: torch.Tensor):
        self._comp = self._factory(shard.numel())
        payload, _ = self._comp.compress(
            shard, self._comp.init_state(shard.device))
        return payload

    def decompress(self, payload):
        return self._comp.decompress(payload)

    def decompress_sum(self, gathered):
        """The f32 sum of the gathered ``[n_nodes, ...]`` payloads'
        decompressions, in one fused merge (onebit's ``unpack_sum``
        kernel, PowerSGD's batched product)."""
        return self._comp.decompress_sum(gathered)

    def as_pair(self):
        def decompress(payload):
            return self.decompress(payload)
        decompress.sum_fn = self.decompress_sum
        return self.compress, decompress


def make_onebit_pair(scaling: bool = True):
    """Onebit (sign and L1 scale) for the cross-node hop: 32x fewer
    bytes cross the nodes, the node's own collectives stay full
    precision."""
    from ..compression.onebit import OnebitCompressor
    return _CompressorPair(
        lambda n: OnebitCompressor(n, scaling=scaling)).as_pair()


def make_powersgd_pair(rank: int = 4, iters: int = 2):
    """Low-rank (PowerSGD) pair for the cross-node hop: ``(n + m) * r``
    floats cross instead of ``n * m``.  The pair cold-starts at every
    call, so ``iters`` power iterations run inside compress."""
    from ..compression.powersgd import PowerSGDCompressor
    return _CompressorPair(
        lambda n: PowerSGDCompressor(n, rank=rank, iters=iters)).as_pair()


def hierarchical_push_pull(comm: CommContext, x: torch.Tensor,
                           op: str = "average", compress=None,
                           decompress=None,
                           compress_min_bytes: Optional[int] = None
                           ) -> torch.Tensor:
    """Two-level reduction of ``x`` with an optional compressed
    cross-node hop; returns a new tensor of ``x``'s shape and dtype.

    The flat tensor, zero-padded to a multiple of ``local_size``, is
    reduce-scattered over the node.  When ``compress`` is given and the
    shard is at least ``compress_min_bytes`` (default
    :func:`dcn_compress_min_bytes`), each rank compresses its shard, the
    payloads' bytes are all-gathered across the nodes and merged by
    ``decompress.sum_fn`` (else by a decompress per node, summed);
    otherwise the shard is all-reduced across the nodes.  ``"average"``
    divides by the world size; the shards are all-gathered over the node
    and the padding dropped."""
    if op not in ("average", "sum"):
        raise ValueError(f"op must be 'average' or 'sum', got {op!r}")
    L, N = comm.local_size, comm.num_nodes
    shape, dtype = x.shape, x.dtype
    # a copy: the collectives below reduce in place
    flat = x.reshape(-1).to(_acc_dtype(dtype), copy=True)
    n = flat.numel()
    pad = (-n) % L
    if pad:
        flat = F.pad(flat, (0, pad))
    if L > 1:
        shard = flat.new_empty(flat.numel() // L)
        dist.reduce_scatter_tensor(shard, flat.contiguous(),
                                   group=comm.intra_group)
    else:
        shard = flat
    if compress is not None:
        if compress_min_bytes is None:
            compress_min_bytes = dcn_compress_min_bytes()
        nbytes = shard.numel() * shard.element_size()
        if nbytes < compress_min_bytes:
            get_logger().debug(
                "hierarchical_push_pull: cross-node shard %d B < "
                "compress_min_bytes %d B; compressed hop disabled for this "
                "tensor (pass compress_min_bytes=0 to force)", nbytes,
                compress_min_bytes)
            compress = None
    if compress is not None:
        payload = compress(shard)
        if N > 1:
            gathered = {k: all_gather_bytes(v, N, comm.inter_group)
                        for k, v in payload.items()}
        else:
            # one node: no cross-node collective (the JAX all_gather over
            # a dcn axis of size 1 is the identity)
            gathered = {k: v[None] for k, v in payload.items()}
        sum_fn = getattr(decompress, "sum_fn", None)
        if sum_fn is not None:
            shard = sum_fn(gathered)
        else:
            shard = sum(decompress({k: v[i] for k, v in gathered.items()})
                        .to(torch.float32) for i in range(N))
        shard = shard.to(flat.dtype)
    elif N > 1:
        dist.all_reduce(shard, group=comm.inter_group)
    if op == "average":
        shard = shard / (L * N)
    if L > 1:
        out = shard.new_empty(shard.numel() * L)
        dist.all_gather_into_tensor(out, shard.contiguous(),
                                    group=comm.intra_group)
    else:
        out = shard
    return out[:n].view(shape).to(dtype)
