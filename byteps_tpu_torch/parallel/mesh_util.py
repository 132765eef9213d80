"""Layouts of ranks for the composite-parallelism modules; port of
``byteps_tpu/parallel/mesh_util.py``.

The JAX package builds a ``Mesh`` of devices with the innermost axis over
the fastest-varying device dimension, the one with neighbouring ICI links:
every inner axis (sp's K/V ring, tp's per-layer all-reduces, pp's stage
hops) is latency-bound, dp's once-a-step gradient sum is not.  Here each
process is one rank, and a mesh is the process groups of its axes: rank
``r`` sits at the coordinates of ``r`` in the mesh's shape with the last
axis fastest, so the innermost axis takes consecutive ranks, which
``comm/mesh.py`` numbers within a node.  :func:`make_mesh` lays out any
number of axes; :func:`make_2d_mesh` (``(outer, inner)``, a
:class:`Mesh2D`) keeps the two-axis form of the sequence and expert
layouts.  :meth:`Mesh.plane` gives the group of several axes at once (the
``(dp, pp)`` plane at a fixed ``tp``, over which a pipeline sums its
embedding and head gradients).

The groups take the world's backend, the one ``bootstrap`` was given:
the layout picks none itself.  ``torch.distributed.new_group`` is
collective, so every rank creates every group, in the same order, the
groups it is not in as well.

:func:`check_params_on_mesh` is the counterpart of the JAX guard: a train
step built for a mesh refuses a model that holds full, unsliced
parameters (built without the mesh's axes), a model laid out on another
mesh, and parameters on another device than the mesh's.
``jit_mapped_step`` has no counterpart: it wraps a step body in
``shard_map`` and ``jit`` with specs derived from the pytrees, and the
port's layouts instead write their step bodies out (``tensor_parallel``,
``pipeline``, ``three_d``, ``fsdp_tp``), each rank holding its slices and
stating every collective.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..comm.mesh import CommContext

__all__ = ["MeshAxis", "Mesh", "Mesh2D", "make_mesh", "make_2d_mesh",
           "check_params_on_mesh", "shard_rows", "shift", "shift_path",
           "all_to_all", "all_reduce", "all_gather", "reduce_scatter"]


@dataclasses.dataclass(eq=False)
class MeshAxis:
    """One axis of a mesh as this rank sees it: its name and size, this
    rank's index along it, the process group of this rank's line along
    it and that line's global ranks in axis order.  A group of None is
    the world's."""

    name: str
    size: int
    index: int
    group: Any
    ranks: Tuple[int, ...]

    def peer(self, offset: int) -> int:
        """The global rank ``offset`` places along this axis (cyclic)."""
        return self.ranks[(self.index + offset) % self.size]


@dataclasses.dataclass(eq=False)
class Mesh:
    """A layout of the world's ranks on named axes, the last fastest."""

    comm: CommContext
    axes: Tuple[MeshAxis, ...]

    def __post_init__(self):
        self._planes: Dict[Tuple[str, ...], MeshAxis] = {}

    @property
    def size(self) -> int:
        return self.comm.size

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def device(self) -> torch.device:
        return self.comm.device

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return {a.name: a.size for a in self.axes}

    def axis(self, name: str) -> MeshAxis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"mesh has axes {self.names}, not {name!r}")

    def plane(self, names: Sequence[str]) -> MeshAxis:
        """The group of this rank's ranks that differ only along
        ``names``, as one axis (its index the row-major index of this
        rank's coordinates there).  Collective at its first call for a
        set of names: every rank must ask for the same planes in the same
        order."""
        key = tuple(n for n in self.names if n in names)
        if len(key) != len(set(names)):
            raise KeyError(f"mesh has axes {self.names}, not all of {names}")
        if key not in self._planes:
            self._planes[key] = _plane(self, key)
        return self._planes[key]


@dataclasses.dataclass(eq=False)
class Mesh2D(Mesh):
    """A ``(outer, inner)`` layout of the world's ranks."""

    @property
    def outer(self) -> MeshAxis:
        return self.axes[0]

    @property
    def inner(self) -> MeshAxis:
        return self.axes[1]


def _coords(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for n in reversed(sizes):
        rank, i = divmod(rank, n)
        out.append(i)
    return tuple(reversed(out))


def _rank_of(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for i, n in zip(coords, sizes):
        r = r * n + i
    return r


def _lines(sizes: Sequence[int], dims: Sequence[int]):
    """Every group of ranks that differ only along ``dims``: (the fixed
    coordinates, the ranks in row-major order over ``dims``), in a fixed
    order."""
    rest = [d for d in range(len(sizes)) if d not in dims]
    for fixed in _product([sizes[d] for d in rest]):
        ranks = []
        for moving in _product([sizes[d] for d in dims]):
            c = [0] * len(sizes)
            for d, i in zip(rest, fixed):
                c[d] = i
            for d, i in zip(dims, moving):
                c[d] = i
            ranks.append(_rank_of(c, sizes))
        yield dict(zip(rest, fixed)), tuple(ranks)


def _product(sizes: Sequence[int]):
    if not sizes:
        yield ()
        return
    for i in range(sizes[0]):
        for rest in _product(sizes[1:]):
            yield (i,) + rest


def _group(mesh_size: int, ranks: Tuple[int, ...]):
    """A new group of ``ranks``; the world's (None) where they are all of
    it, so a plane or axis that spans the world creates nothing."""
    if len(ranks) == mesh_size:
        return None
    return dist.new_group(list(ranks))


def _axis_over(comm: CommContext, sizes, names, dims) -> MeshAxis:
    """This rank's group along ``dims`` (every rank creates every such
    group, in the same order)."""
    my = _coords(comm.rank, sizes)
    mine = None
    for fixed, ranks in _lines(sizes, dims):
        g = _group(comm.size, ranks)
        if all(my[d] == i for d, i in fixed.items()):
            index = _rank_of([my[d] for d in dims], [sizes[d] for d in dims])
            mine = MeshAxis("+".join(names[d] for d in dims),
                            math.prod(sizes[d] for d in dims), index, g,
                            ranks)
    return mine


def _plane(mesh: Mesh, key: Tuple[str, ...]) -> MeshAxis:
    names = mesh.names
    sizes = [a.size for a in mesh.axes]
    dims = [names.index(n) for n in key]
    return _axis_over(mesh.comm, sizes, names, dims)


def make_mesh(comm: CommContext, shape: Sequence[int],
              names: Sequence[str], cls=Mesh) -> Mesh:
    """The layout of ``comm``'s world on axes ``names`` of sizes ``shape``
    (their product the world size), the last axis fastest."""
    shape, names = tuple(shape), tuple(names)
    if len(shape) != len(names) or any(n <= 0 for n in shape):
        raise ValueError(f"mesh shape {shape} does not fit axes {names}")
    if math.prod(shape) != comm.size:
        raise ValueError(f"{comm.size} ranks do not fill a "
                         f"{'x'.join(map(str, shape))} mesh of {names}")
    return cls(comm, tuple(_axis_over(comm, shape, names, [d])
                           for d in range(len(shape))))


def make_2d_mesh(comm: CommContext, n_inner: int,
                 axis_names: Tuple[str, str]) -> Mesh2D:
    """The ``(world / n_inner, n_inner)`` layout of ``comm``'s world."""
    world = comm.size
    if n_inner <= 0 or world % n_inner:
        raise ValueError(f"{world} ranks not divisible by "
                         f"{axis_names[1]}={n_inner}")
    return make_mesh(comm, (world // n_inner, n_inner), axis_names,
                     cls=Mesh2D)


def check_params_on_mesh(mesh: Mesh, model: torch.nn.Module,
                         axes: Dict[str, Optional[str]],
                         reshard_hint: str,
                         layers: Optional[Iterable[int]] = None) -> None:
    """Refuse a model a step built for ``mesh`` cannot run, as the JAX
    guard refuses unsharded or misplaced arrays.  ``axes`` maps each
    layout role of the model (``model.mesh_axes``, e.g. ``"tp"``) to the
    mesh axis it must be built with; ``layers`` are the blocks this rank
    must hold (a pipeline stage's).  Raises ValueError when the model
    holds full, unsliced parameters where the mesh slices them (built
    without the axis, or holding every layer), when it was laid out on
    another mesh, or when a parameter is on another device than the
    mesh's."""
    got = getattr(model, "mesh_axes", {})
    for role, name in axes.items():
        want = mesh.axis(name)
        have = got.get(role)
        if have is None:
            if want.size > 1:
                raise ValueError(
                    f"params are not mesh-sharded (a model built without "
                    f"its {name} axis holds them whole) — place them with "
                    f"{reshard_hint} first")
        elif have is not want:
            raise ValueError(
                "params are placed on a different mesh than the one this "
                f"train step was built for — re-shard with {reshard_hint}")
    if layers is not None:
        held = tuple(getattr(model, "layers", ()))
        if held != tuple(layers):
            raise ValueError(
                f"params are not mesh-sharded (this rank holds layers "
                f"{list(held)}, its stage is {list(layers)}) — place them "
                f"with {reshard_hint} first")
    for n, p in model.named_parameters():
        if p.device != mesh.device:
            raise ValueError(
                f"params are placed on different devices than this train "
                f"step's mesh ({n} on {p.device}, the mesh on "
                f"{mesh.device}) — re-shard with {reshard_hint}")


def shard_rows(mesh: Mesh, axis_name: str, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch along ``axis_name`` (whole over
    the other axes), on the mesh's device."""
    axis = mesh.axis(axis_name)
    out = {}
    for key, x in batch.items():
        x = torch.as_tensor(x)
        if x.shape[0] % axis.size:
            raise ValueError(f"{key} {tuple(x.shape)} does not split over "
                             f"{axis_name}={axis.size}")
        rows = x.shape[0] // axis.size
        out[key] = x[axis.index * rows:(axis.index + 1) * rows].to(
            mesh.device)
    return out


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


# --- reductions and gathers along an axis ----------------------------------
#
# The explicit counterparts of ``lax.psum``, ``lax.all_gather(tiled=True)``
# and ``lax.psum_scatter(tiled=True)`` over a named axis, for the tensor
# and fully-sharded layouts.  An axis of one rank moves nothing.

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, axis: MeshAxis,
               op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over ``axis``, in place."""
    if axis.size > 1:
        dist.all_reduce(x, op=_REDUCE_OPS[op], group=axis.group)
    return x


def all_gather(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The axis's blocks of ``x`` joined along ``dim`` in axis order."""
    n = axis.size
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    # gloo wants the flat form of the output
    dist.all_gather_into_tensor(out, x.reshape(-1), group=axis.group)
    parts = out.view(n, *x.shape)
    if dim == 0:
        return parts.reshape(n * x.shape[0], *x.shape[1:])
    return torch.cat(parts.unbind(0), dim=dim)


def reduce_scatter(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """``x`` summed over ``axis``, and this rank's block of the sum along
    ``dim`` (``axis.size`` equal blocks, in axis order)."""
    n = axis.size
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter over {axis.name}={n}: dimension "
                         f"{dim} of {tuple(x.shape)} does not split")
    blocks = torch.stack(x.chunk(n, dim=dim))
    out = torch.empty(blocks.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out.view(-1), blocks.view(-1),
                               group=axis.group)
    return out
