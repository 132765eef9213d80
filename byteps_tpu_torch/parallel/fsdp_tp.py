"""``(fsdp, tp)`` composite parallelism for the Llama family, the flagship
layout (Llama-3-8B, ``BASELINE.json`` configs[4]); port of
``byteps_tpu/parallel/fsdp_tp.py``.

Two axes shard every large weight, by :data:`_RULES` (the JAX module's,
each rule carrying both axes):

- **tp** (Megatron): attention heads and SwiGLU width column- and
  row-parallel, the word table and the head sliced on the vocabulary;
- **fsdp** (ZeRO-3): the other large axis of every weight.  Each product
  all-gathers its kernel's fsdp slice, and the backward gathers it again
  and reduce-scatters the kernel's gradient
  (``tp_layers.gathered_matmul``): only the slice is saved, so a layer's
  gathered weight does not outlive its use.  XLA derives this streaming
  from the annotation; the flat FSDP of ``zero.py`` gathers the whole
  vector.  The batch is sharded over fsdp too (fsdp doubles as dp).

Leaves that are whole over fsdp (the RMSNorm scales, an axis dropped by
the fallbacks) hold partial gradients and are summed over fsdp; the K/V
kernels, when their heads are whole under split query heads, hold partial
gradients over tp and are summed over tp.  The optimizer sees only the
rank's slices: the state a rank holds is ``1 / (n_fsdp * n_tp)`` of every
leaf sliced on both axes.

:func:`llama_spec` keeps ``llama_shardings``' two fallbacks: an axis that
does not divide its dimension is dropped for that dimension (GQA's K/V
heads when ``num_kv_heads < n_tp``, odd vocabularies), and an unmatched
leaf of more than 2**16 elements is sliced over fsdp on its largest
divisible axis.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ..comm.mesh import CommContext
from ..ops.collective_ops import push_pull_tree
from .long_context import global_token_loss
from .mesh_util import (Mesh2D, MeshAxis, check_params_on_mesh, make_2d_mesh,
                        shard_rows)
from .tensor_parallel import flax_path
from .tp_layers import Layout, init_opt_state, param_placements, shard_state

__all__ = ["FSDP_AXIS", "TP_AXIS", "make_fsdp_tp_mesh", "fsdp_tp_spec_for",
           "init_llama_opt_state", "llama_spec", "llama_shardings",
           "llama_layout", "shard_llama_params", "init_llama_params_sharded",
           "shard_llama_batch", "make_fsdp_tp_train_step", "grad_groups"]

FSDP_AXIS = "fsdp"
TP_AXIS = "tp"

# the optimizer over this rank's slices
init_llama_opt_state = init_opt_state


def make_fsdp_tp_mesh(comm: CommContext, n_tp: int) -> Mesh2D:
    """A ``(fsdp, tp)`` layout of ``comm``'s world, tp over consecutive
    ranks."""
    return make_2d_mesh(comm, n_tp, (FSDP_AXIS, TP_AXIS))


# Sharding rules matched against the flax param path, the JAX module's
# own.  Every rule carries BOTH axes: tp on the Megatron axis, fsdp on the
# complementary large axis.  First match wins.
_RULES = [
    # attention projections: q/k/v kernels are [hidden, heads, head_dim]
    (r"attn/[qkv]/kernel$", (FSDP_AXIS, TP_AXIS, None)),
    (r"attn/out/kernel$", (TP_AXIS, None, FSDP_AXIS)),
    # SwiGLU: gate/up column-parallel, down row-parallel
    (r"mlp/(gate|up)/kernel$", (FSDP_AXIS, TP_AXIS)),
    (r"mlp/down/kernel$", (TP_AXIS, FSDP_AXIS)),
    # embedding / unembedding: vocab over tp, hidden over fsdp
    (r"wte/embedding$", (TP_AXIS, FSDP_AXIS)),
    (r"lm_head/kernel$", (FSDP_AXIS, TP_AXIS)),
    (r"norm/scale$|_norm/scale$|norm_f/scale$", ()),
]


def fsdp_tp_spec_for(path: str) -> Tuple:
    for pat, spec in _RULES:
        if re.search(pat, path):
            return spec
    return ()


def llama_spec(path: str, shape: Sequence[int],
               sizes: Dict[str, int]) -> Tuple:
    """A leaf's spec with ``llama_shardings``' fallbacks (the module
    docstring), for axes of ``sizes``."""
    p = fsdp_tp_spec_for(path)
    if all(ax is None for ax in p) and math.prod(shape) > 1 << 16:
        # unmatched large leaf: fsdp-slice the largest divisible axis
        # rather than silently replicating gigabytes per rank
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if shape[d] % sizes.get(FSDP_AXIS, 1) == 0:
                p = tuple(FSDP_AXIS if i == d else None
                          for i in range(len(shape)))
                break
    return tuple(ax if ax is None or shape[d] % sizes.get(ax, 1) == 0
                 else None for d, ax in enumerate(p))


def llama_shardings(mesh: Mesh2D, params) -> Dict:
    """The spec tree of a flax Llama tree (arrays or shapes), by
    :func:`llama_spec`."""
    sizes = mesh.shape

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, prefix + k + "/")
            else:
                shape = tuple(getattr(v, "shape", v))
                out[k] = llama_spec(prefix + k, shape, sizes)
        return out

    return walk(params, "")


def llama_layout(tp_axis: Optional[MeshAxis],
                 fsdp_axis: Optional[MeshAxis]) -> Layout:
    """The layout of a Llama over the given axes (fsdp gathered)."""
    axes = {n: a for n, a in ((TP_AXIS, tp_axis), (FSDP_AXIS, fsdp_axis))
            if a is not None}
    return Layout(llama_spec, axes, gather=(FSDP_AXIS,))


def shard_llama_params(mesh: Mesh2D, state: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a whole Llama's ``state`` (a ``state_dict``)
    for ``load_state_dict`` into ``Llama(cfg, tp_axis=..., fsdp_axis=...)``
    on ``mesh``."""
    layout = llama_layout(mesh.axis(TP_AXIS), mesh.axis(FSDP_AXIS))
    return shard_state(state, layout, flax_path)


def init_llama_params_sharded(mesh: Mesh2D, cfg, generator: torch.Generator,
                              attn_fn: Optional[Callable] = None,
                              device=None) -> nn.Module:
    """A Llama laid out on ``mesh`` with weights from ``generator``: each
    rank draws the whole model leaf by leaf, keeps its slice and frees the
    rest, so the whole tree is never on one rank and every rank draws the
    same bits (``models.gpt.init_params``)."""
    from ..models.llama import Llama
    return Llama(cfg, attn_fn=attn_fn, device=device or mesh.device,
                 generator=generator, tp_axis=mesh.axis(TP_AXIS),
                 fsdp_axis=mesh.axis(FSDP_AXIS))


def shard_llama_batch(mesh: Mesh2D, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """This rank's rows: over fsdp (it doubles as dp), whole over tp."""
    return shard_rows(mesh, FSDP_AXIS, batch)


def grad_groups(model: nn.Module):
    """The parameters whose gradients the step sums after the backward:
    (names whole over fsdp, to sum over fsdp; names whose gradient is a
    partial sum over tp, to sum over tp)."""
    places = param_placements(model)
    partial = set()
    for mname, m in model.named_modules():
        if getattr(m, "partial_axis", None) is not None:
            partial.update(f"{mname}.{p}" for p, _ in
                           m.named_parameters(recurse=False))
    whole = [n for n, pl in places.items()
             if not any(a is not None and a.name == FSDP_AXIS for a in pl)]
    return whole, sorted(partial)


def make_fsdp_tp_train_step(mesh: Mesh2D, model: nn.Module,
                            optimizer: torch.optim.Optimizer) -> Callable:
    """``step(batch) -> loss`` for ``Llama(cfg, attn_fn, tp_axis=...,
    fsdp_axis=...)`` on ``mesh`` (:func:`init_llama_params_sharded`, or
    ``load_flax_llama`` / :func:`shard_llama_params`), on this rank's rows
    (:func:`shard_llama_batch`).  The loss is the rank's NLL over the
    count summed over fsdp; the fsdp-sliced gradients arrive summed from
    the products' backward, the rest are summed as :func:`grad_groups`
    says; then ``optimizer.step()``.  Returns the global mean NLL."""
    fsdp, tp = mesh.axis(FSDP_AXIS), mesh.axis(TP_AXIS)
    named = dict((n, p) for n, p in model.named_parameters()
                 if p.requires_grad)
    whole, partial = grad_groups(model)

    def step(batch) -> torch.Tensor:
        check_params_on_mesh(mesh, model, {"tp": TP_AXIS,
                                           "fsdp": FSDP_AXIS},
                             "Llama(cfg, tp_axis=..., fsdp_axis=...)")
        ids, labels = batch["input_ids"], batch["labels"]
        for p in named.values():
            p.grad = None
        loss_local = global_token_loss(mesh, model(ids), labels, axis=fsdp,
                                       nll=model.token_nll)
        loss_local.backward()
        push_pull_tree(mesh.comm, {n: named[n].grad for n in whole
                                   if named[n].grad is not None},
                       op="sum", inplace=True, axis=fsdp)
        push_pull_tree(mesh.comm, {n: named[n].grad for n in partial
                                   if named[n].grad is not None},
                       op="sum", inplace=True, axis=tp)
        optimizer.step()
        loss = loss_local.detach().clone()
        if fsdp.size > 1:
            dist.all_reduce(loss, group=fsdp.group)
        return loss

    return step
