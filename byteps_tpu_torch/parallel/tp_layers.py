"""Building blocks of the tensor-parallel and fully-sharded layouts: where
a parameter lives, and the collectives the layers state themselves.

The JAX package annotates each parameter with a ``PartitionSpec`` and lets
XLA place the collectives (``tensor_parallel.py``, ``fsdp_tp.py``,
``three_d.py``).  Here a model built with mesh axes holds only its rank's
slice of each parameter, and its layers call the collectives:

- a :class:`Layout` turns a rule table (a flax path to a spec, a tuple of
  axis names per dimension, as ``PartitionSpec``) into each parameter's
  :data:`Placement`: the mesh axis (or None) each dimension is sliced
  over.  Axes named in ``gather`` (``fsdp``) are all-gathered before use,
  ZeRO-3 style; the others (``tp``) split the computation, Megatron style;
- :func:`copy_to` (identity forward, sum over the axis backward) and
  :func:`reduce_from` (sum forward, identity backward): the pair that
  brackets a column-parallel product and the row-parallel one after it;
- :func:`gathered_matmul`: one autograd Function that all-gathers a
  kernel's fsdp slice, multiplies, and in the backward gathers it again
  and reduce-scatters the kernel's gradient; it saves only the slice, so
  a layer's gathered weight does not outlive its use;
- :func:`gather_param`: all-gather forward, reduce-scatter backward (the
  embedding table's fsdp slice, which the lookup does not save);
- :func:`vocab_parallel_lookup` and :func:`vocab_parallel_token_nll`: an
  embedding table and a head sliced on the vocabulary.  The NLL takes the
  max, the sum of exponentials and the target logit each summed (max'd)
  over the axis, so no rank ever holds the ``[B, T, V]`` logits.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .mesh_util import MeshAxis, all_gather, all_reduce, reduce_scatter

__all__ = ["Placement", "Layout", "at", "place", "local_shape", "take",
           "bounds", "copy_to", "reduce_from", "gathered_matmul",
           "gather_param", "vocab_parallel_lookup",
           "vocab_parallel_token_nll", "param_placements", "shard_state",
           "init_opt_state"]

# the mesh axis (or None) each dimension of a parameter is sliced over
Placement = Tuple[Optional[MeshAxis], ...]
Rule = Callable[[str, Tuple[int, ...], Dict[str, int]],
                Sequence[Optional[str]]]


class Layout:
    """The placement of a model's parameters on mesh ``axes`` (by name):
    ``rule(path, shape, sizes)`` is a leaf's spec (axis names or None per
    dimension; shorter specs are padded with None), with ``path`` the
    flax path (``"h3/attn/qkv/kernel"``) and ``sizes`` the axes' sizes.
    Axes named in ``gather`` are all-gathered before use.  An axis of
    size 1 slices nothing.  :meth:`at` scopes the layout to a sub-module,
    as flax scopes names."""

    def __init__(self, rule: Rule, axes: Dict[str, MeshAxis],
                 gather: Iterable[str] = (), prefix: str = ""):
        self.rule, self.axes = rule, dict(axes)
        self.gather = frozenset(gather)
        self.prefix = prefix

    def at(self, scope: str) -> "Layout":
        return Layout(self.rule, self.axes, self.gather,
                      self.prefix + scope + "/")

    def place(self, leaf: str, shape: Sequence[int]) -> Placement:
        shape = tuple(shape)
        path = self.prefix + leaf
        sizes = {n: a.size for n, a in self.axes.items()}
        spec = tuple(self.rule(path, shape, sizes))
        if len(spec) > len(shape):
            raise ValueError(f"{path}: spec {spec} longer than {shape}")
        spec = spec + (None,) * (len(shape) - len(spec))
        out = []
        for d, name in enumerate(spec):
            axis = None if name is None else self.axes[name]
            if axis is not None and axis.size > 1:
                if shape[d] % axis.size:
                    raise ValueError(f"{path}: dimension {d} of {shape} "
                                     f"does not split over "
                                     f"{name}={axis.size}")
                out.append(axis)
            else:
                out.append(None)
        return tuple(out)

    def is_gathered(self, axis: MeshAxis) -> bool:
        return axis.name in self.gather


def at(layout: Optional[Layout], scope: str) -> Optional[Layout]:
    return None if layout is None else layout.at(scope)


def place(layout: Optional[Layout], leaf: str,
          shape: Sequence[int]) -> Placement:
    """``layout``'s placement of a leaf; nothing sliced without one."""
    if layout is None:
        return (None,) * len(shape)
    return layout.place(leaf, shape)


def local_shape(shape: Sequence[int], placement: Placement):
    return tuple(n // (1 if a is None else a.size)
                 for n, a in zip(shape, placement))


def bounds(shape: Sequence[int], placement: Placement):
    """``[(start, stop)]`` of this rank's slice, a pair per dimension."""
    out = []
    for n, a in zip(shape, placement):
        if a is None:
            out.append((0, n))
        else:
            k = n // a.size
            out.append((a.index * k, (a.index + 1) * k))
    return out


def take(full: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's slice of a full tensor (a view)."""
    for d, (lo, hi) in enumerate(bounds(full.shape, placement)):
        if hi - lo != full.shape[d]:
            full = full.narrow(d, lo, hi - lo)
    return full


def param_placements(model: torch.nn.Module) -> Dict[str, Placement]:
    """Every parameter's placement (``module.place``; unplaced modules'
    parameters are whole), by ``named_parameters`` name."""
    out = {}
    for mname, m in model.named_modules():
        places = getattr(m, "place", {})
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            out[name] = places.get(pname, (None,) * p.dim())
    return out


def shard_state(state: Dict[str, torch.Tensor], layout: Layout,
                path_of: Callable[[str], str]) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full ``state`` (a ``state_dict``), each
    leaf placed by ``layout`` at ``path_of(name)``, its flax path; fresh
    contiguous tensors."""
    out = {}
    for name, x in state.items():
        x = torch.as_tensor(x)
        path = path_of(name)
        scope, _, leaf = path.rpartition("/")
        lay = layout.at(scope) if scope else layout
        out[name] = take(x, lay.place(leaf, x.shape)).contiguous().clone()
    return out


def init_opt_state(make_optimizer: Callable,
                   model: torch.nn.Module) -> torch.optim.Optimizer:
    """``make_optimizer`` over this rank's slices (the counterpart of the
    JAX ``init_*_opt_state``, which pin the moments' shardings to the
    parameters'): the optimizer's state takes each slice's shape, so a
    rank holds the state of its slices only."""
    return make_optimizer([p for p in model.parameters()
                           if p.requires_grad])


# --- the Megatron pair ------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """Identity forward; the gradient summed over ``axis`` backward: the
    input of a column-parallel product, whose gradient each rank holds a
    part of."""
    if axis is None or axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """``x`` summed over ``axis`` forward; identity backward: the output
    of a row-parallel product, of which each rank holds a partial sum."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFrom.apply(x, axis)


# --- fully-sharded parameters ---------------------------------------------

class _GatheredMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, axis, dim, dtype):
        full = all_gather(w.to(dtype), axis, dim)
        ctx.save_for_backward(x2d, w)
        ctx.args = (axis, dim, dtype)
        return x2d @ full.reshape(x2d.shape[1], -1)

    @staticmethod
    def backward(ctx, gy):
        x2d, w = ctx.saved_tensors
        axis, dim, dtype = ctx.args
        full = all_gather(w.to(dtype), axis, dim)
        gx = gy @ full.reshape(x2d.shape[1], -1).t()
        gw = (x2d.t() @ gy).reshape(full.shape)
        return (gx, reduce_scatter(gw, axis, dim).to(w.dtype), None, None,
                None)


def gathered_matmul(x2d: torch.Tensor, w: torch.Tensor, axis: MeshAxis,
                    dim: int, dtype: torch.dtype) -> torch.Tensor:
    """``x2d @ W`` where ``W`` is the kernel whose ``axis`` slice along
    ``dim`` this rank holds (``w``), cast to ``dtype`` and gathered
    first; ``x2d`` is ``[N, n_in]`` in ``dtype`` and ``W`` reshapes to
    ``[n_in, n_out]``.  The backward gathers again and returns ``W``'s
    gradient reduce-scattered over ``axis`` in ``dtype`` (the product's
    type, as the unsharded layer's gradient is): the sum over the axis's
    ranks of their partial gradients, this rank's block of it."""
    return _GatheredMatmul.apply(x2d, w, axis, dim, dtype)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axis, dim):
        ctx.args = (axis, dim)
        return all_gather(w, axis, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.args
        return reduce_scatter(g.contiguous(), axis, dim), None, None


def gather_param(w: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The full parameter along ``dim`` from each rank's ``axis`` slice;
    its gradient reduce-scattered back to the slices."""
    return _GatherParam.apply(w, axis, dim)


# --- the vocabulary sliced over an axis -----------------------------------

def vocab_parallel_lookup(ids: torch.Tensor, table: torch.Tensor,
                          axis: MeshAxis, dtype: torch.dtype) -> torch.Tensor:
    """Rows of a table whose vocabulary is sliced over ``axis`` (this rank
    holds ``table``, rows ``[index * V_loc, (index + 1) * V_loc)``): the
    ids outside the slice give zeros, and the sum over the axis gives
    every row exactly once."""
    v = table.shape[0]
    start = axis.index * v
    inside = (ids >= start) & (ids < start + v)
    rows = F.embedding((ids - start).clamp(0, v - 1), table).to(dtype)
    return reduce_from(rows.masked_fill(~inside[..., None], 0), axis)


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, axis, ignore):
        n, v = logits.shape
        start = axis.index * v
        m = logits.max(dim=-1).values
        all_reduce(m, axis, "max")
        p = torch.exp(logits - m[:, None])
        se = all_reduce(p.sum(dim=-1), axis)
        valid = labels != ignore
        inside = valid & (labels >= start) & (labels < start + v)
        idx = (labels - start).clamp(0, v - 1)
        tgt = torch.where(inside, logits.gather(1, idx[:, None])[:, 0],
                          torch.zeros_like(m))
        all_reduce(tgt, axis)
        nll = torch.where(valid, torch.log(se) + m - tgt,
                          torch.zeros_like(m))
        p.div_(se[:, None])
        ctx.save_for_backward(p, idx, inside, valid)
        return nll.sum()

    @staticmethod
    def backward(ctx, g):
        p, idx, inside, valid = ctx.saved_tensors
        # softmax minus the one-hot of the target (on the rank holding
        # it), in place of the saved softmax: the backward runs once
        grad = p
        grad.scatter_add_(1, idx[:, None], -inside.to(grad.dtype)[:, None])
        grad.mul_((valid.to(grad.dtype) * g)[:, None])
        return grad, None, None, None


def vocab_parallel_token_nll(logits: torch.Tensor, labels: torch.Tensor,
                             axis: MeshAxis, ignore: int = -1):
    """``models.gpt.token_nll`` of logits whose vocabulary is sliced over
    ``axis`` (``[..., V_loc]``, this rank's slice): (the sum of the NLL
    over valid positions, the valid-token count), the same on every rank
    of the axis.  Differentiable in the logits."""
    s = _VocabNLL.apply(logits.reshape(-1, logits.shape[-1]).float(),
                        labels.reshape(-1), axis, ignore)
    return s, (labels != ignore).sum().float()
