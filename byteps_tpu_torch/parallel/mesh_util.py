"""Two-dimensional layouts of ranks for the composite-parallelism modules;
port of ``byteps_tpu/parallel/mesh_util.py``.

The JAX package builds a 2-D ``Mesh`` of devices, ``(outer, inner)``,
with the inner axis over the fastest-varying device dimension, the one
with neighbouring ICI links: every inner axis (sp's K/V ring, ep's
all-to-all) is latency-bound, dp's once-a-step gradient sum is not.  Here
each process is one rank, and a mesh is the process groups of those two
axes: rank ``o * n_inner + i`` sits at ``(o, i)``, so the inner axis takes
consecutive ranks, which ``comm/mesh.py`` numbers within a node.

The groups take the world's backend, the one ``bootstrap`` was given:
the layout picks none itself.  ``torch.distributed.new_group`` is
collective, so every rank creates every group, in the same order, the
groups it is not in as well.

``jit_mapped_step`` and ``check_params_on_mesh`` are GSPMD machinery;
their counterpart here is explicit placement (which rank holds which
slice, ``parallel/expert.py``, ``parallel/moe_lm.py``).  The check of
placed parameters waits for the tensor and pipeline layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.distributed as dist

from ..comm.mesh import CommContext

__all__ = ["MeshAxis", "Mesh2D", "make_2d_mesh", "shift", "shift_path",
           "all_to_all"]


@dataclasses.dataclass(eq=False)
class MeshAxis:
    """One axis of a mesh as this rank sees it: its name and size, this
    rank's index along it, the process group of this rank's line along
    it and that line's global ranks in axis order."""

    name: str
    size: int
    index: int
    group: Any
    ranks: Tuple[int, ...]

    def peer(self, offset: int) -> int:
        """The global rank ``offset`` places along this axis (cyclic)."""
        return self.ranks[(self.index + offset) % self.size]


@dataclasses.dataclass(eq=False)
class Mesh2D:
    """A ``(outer, inner)`` layout of the world's ranks."""

    comm: CommContext
    outer: MeshAxis
    inner: MeshAxis

    @property
    def size(self) -> int:
        return self.comm.size

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def device(self) -> torch.device:
        return self.comm.device

    def axis(self, name: str) -> MeshAxis:
        for a in (self.outer, self.inner):
            if a.name == name:
                return a
        raise KeyError(f"mesh has axes {self.outer.name!r} and "
                       f"{self.inner.name!r}, not {name!r}")


def make_2d_mesh(comm: CommContext, n_inner: int,
                 axis_names: Tuple[str, str]) -> Mesh2D:
    """The ``(world / n_inner, n_inner)`` layout of ``comm``'s world."""
    world = comm.size
    if n_inner <= 0 or world % n_inner:
        raise ValueError(f"{world} ranks not divisible by "
                         f"{axis_names[1]}={n_inner}")
    n_outer = world // n_inner
    o_idx, i_idx = divmod(comm.rank, n_inner)
    inner = outer = None
    # every rank creates every group, in the same order
    for o in range(n_outer):
        ranks = tuple(o * n_inner + i for i in range(n_inner))
        g = dist.new_group(list(ranks))
        if o == o_idx:
            inner = MeshAxis(axis_names[1], n_inner, i_idx, g, ranks)
    for i in range(n_inner):
        ranks = tuple(o * n_inner + i for o in range(n_outer))
        g = dist.new_group(list(ranks))
        if i == i_idx:
            outer = MeshAxis(axis_names[0], n_outer, o_idx, g, ranks)
    return Mesh2D(comm, outer, inner)


# --- collectives along an axis ------------------------------------------------
#
# The explicit counterparts of ``lax.ppermute`` and ``lax.all_to_all`` over
# a named axis.  A gloo group takes CUDA tensors in its collectives (it
# stages them through the host) but not in send and recv, which hand the
# device pointer to a socket ("writev ... Bad address" on torch 2.11): on
# such a group a shift runs as an all_to_all_single with one non-empty
# split instead.

def shift_path(axis: MeshAxis, device: torch.device) -> str:
    """How :func:`shift` moves a tensor of ``device`` along ``axis``:
    ``"p2p"`` (batched isend/irecv) where the backend takes the device's
    tensors, else ``"all_to_all"``."""
    if device.type == "cuda" and dist.get_backend(axis.group) == "gloo":
        return "all_to_all"
    return "p2p"


def shift(tensors, axis: MeshAxis, offset: int = 1):
    """Each of ``tensors`` sent ``offset`` places along ``axis`` (to
    ``peer(offset)``), and the same-shaped tensors received from
    ``peer(-offset)``; one batch of sends and receives for the list, on
    the path of :func:`shift_path`."""
    tensors = [t.contiguous() for t in tensors]
    n = axis.size
    if n == 1 or offset % n == 0:
        return tensors
    dst, src = axis.peer(offset), axis.peer(-offset)
    path = shift_path(axis, tensors[0].device)
    outs = [torch.empty_like(t) for t in tensors]
    if path == "p2p":
        ops = []
        for t, o in zip(tensors, outs):
            ops.append(dist.P2POp(dist.isend, t, dst, axis.group))
            ops.append(dist.P2POp(dist.irecv, o, src, axis.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs
    if path != "all_to_all":
        raise ValueError(f"unknown shift path {path!r}")
    d, s = axis.ranks.index(dst), axis.ranks.index(src)
    for t, o in zip(tensors, outs):
        rows = t.shape[0]
        send = [rows if i == d else 0 for i in range(n)]
        recv = [rows if i == s else 0 for i in range(n)]
        dist.all_to_all_single(o, t, output_split_sizes=recv,
                               input_split_sizes=send, group=axis.group)
    return outs


def _all_to_all(x: torch.Tensor, axis: MeshAxis, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = axis.size
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all over {axis.name}={n}: dimension "
                         f"{split_dim} of {tuple(x.shape)} does not split")
    send = torch.stack(torch.tensor_split(x, n, dim=split_dim))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, concat_dim, split_dim)
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a tiled all-to-all is the one the other way
        return _all_to_all(g.contiguous(), *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, axis: MeshAxis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` cut into ``axis.size`` equal blocks along ``split_dim``, block
    ``j`` sent to the axis's rank ``j``, and the received blocks joined
    along ``concat_dim`` in the senders' order.  Differentiable."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)
