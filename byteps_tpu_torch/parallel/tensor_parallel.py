"""Tensor parallelism for the GPT family over a ``(dp, tp)`` layout; port
of ``byteps_tpu/parallel/tensor_parallel.py``.

The JAX module annotates the parameters with Megatron-style shardings and
lets XLA's propagation place the collectives.  Here each rank holds its
slice (``GPT(cfg, tp_axis=mesh.axis("tp"))``, built by :data:`_TP_RULES`)
and the layers state the collectives (``tp_layers.py``):

- ``qkv`` and ``mlp_in`` are column-parallel (heads and width): their
  input passes ``copy_to`` (identity forward, the gradient summed over
  tp backward);
- ``out`` and ``mlp_out`` are row-parallel: each rank's product is a
  partial sum, summed over tp (``reduce_from``) before the bias, which is
  whole and added once;
- ``wte`` and ``lm_head`` are sliced on the vocabulary: the lookup masks
  the ids outside the rank's rows and sums over tp, and the loss takes
  the max, the sum of exponentials and the target logit over tp
  (``tp_layers.vocab_parallel_token_nll``), never the whole logits;
- everything else (``wpe``, the LayerNorms) is whole, and its gradient is
  the same on every tp rank.

The batch is sharded over ``dp`` and whole over ``tp``.  The loss is each
dp rank's NLL sum over the valid-token count summed over dp
(``long_context.global_token_loss``), so every gradient is a partial sum
over dp: the step sums every gradient over dp (``push_pull_tree``) and
none over tp.  Axis layout: tp takes consecutive ranks (its all-reduces
are per layer), dp the rest.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from ..comm.mesh import CommContext
from ..ops.collective_ops import push_pull_tree
from .long_context import global_token_loss
from .mesh_util import (Mesh2D, MeshAxis, check_params_on_mesh, make_2d_mesh,
                        shard_rows)
from .tp_layers import Layout, init_opt_state, shard_state

__all__ = ["DP_AXIS", "TP_AXIS", "make_tp_mesh", "tp_spec_for",
           "init_tp_opt_state", "gpt_layout", "flax_path",
           "shard_gpt_params", "shard_tp_batch", "make_dp_tp_train_step"]

DP_AXIS = "dp"
TP_AXIS = "tp"

# the optimizer over this rank's slices
init_tp_opt_state = init_opt_state


def make_tp_mesh(comm: CommContext, n_tp: int) -> Mesh2D:
    """A ``(dp, tp)`` layout of ``comm``'s world, tp over consecutive
    ranks."""
    return make_2d_mesh(comm, n_tp, (DP_AXIS, TP_AXIS))


# Megatron-style rules, matched against the flax param path
# ("h3/attn/qkv/kernel"), the JAX module's own.  First match wins;
# unmatched -> replicated.
_TP_RULES = [
    # attention: shard heads (qkv column-parallel, out row-parallel)
    (r"attn/qkv/kernel$", (None, None, TP_AXIS, None)),
    (r"attn/qkv/bias$", (None, TP_AXIS, None)),
    (r"attn/out/kernel$", (TP_AXIS, None, None)),
    # mlp: column-parallel in, row-parallel out
    (r"mlp_in/kernel$", (None, TP_AXIS)),
    (r"mlp_in/bias$", (TP_AXIS,)),
    (r"mlp_out/kernel$", (TP_AXIS, None)),
    # embeddings / unembedding: shard the vocab (wte) and hidden-free
    # axis of the head; wpe stays replicated (tiny)
    (r"wte/embedding$", (TP_AXIS, None)),
    (r"lm_head/kernel$", (None, TP_AXIS)),
    (r"lm_head/bias$", (TP_AXIS,)),
]


def tp_spec_for(path: str) -> Tuple:
    """The spec (axis name or None per dimension; ``()`` replicated) of a
    GPT parameter at flax ``path``."""
    for pat, spec in _TP_RULES:
        if re.search(pat, path):
            return spec
    return ()


def gpt_layout(tp_axis: MeshAxis) -> Layout:
    """The layout of a GPT over ``tp_axis`` (every axis of the rules
    splits; nothing is gathered)."""
    return Layout(lambda path, shape, sizes: tp_spec_for(path),
                  {TP_AXIS: tp_axis})


def flax_path(name: str, layers=None) -> str:
    """A port parameter name (``h.3.attn.qkv.kernel``) as its flax path
    (``h3/attn/qkv/kernel``); with ``layers``, ``h.{j}`` is block
    ``layers[j]``."""
    m = re.match(r"h\.(\d+)\.(.*)", name)
    if m:
        i = int(m.group(1))
        i = layers[i] if layers is not None else i
        return f"h{i}/" + m.group(2).replace(".", "/")
    return name.replace(".", "/")


def shard_gpt_params(mesh: Mesh2D, state: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a whole GPT's ``state`` (a ``state_dict``)
    by :data:`_TP_RULES`, for ``load_state_dict`` into
    ``GPT(cfg, tp_axis=mesh.axis("tp"))``."""
    return shard_state(state, gpt_layout(mesh.axis(TP_AXIS)), flax_path)


def shard_tp_batch(mesh: Mesh2D, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: over dp, whole over tp."""
    return shard_rows(mesh, DP_AXIS, batch)


def make_dp_tp_train_step(mesh: Mesh2D, model: nn.Module,
                          optimizer: torch.optim.Optimizer) -> Callable:
    """``step(batch) -> loss`` for ``GPT(cfg, tp_axis=mesh.axis("tp"))``
    holding this rank's slices (``load_flax_gpt`` or
    :func:`shard_gpt_params`), on this rank's rows
    (:func:`shard_tp_batch`): forward and backward, every gradient summed
    over dp, then ``optimizer.step()``.  Returns the loss summed over dp
    (the global mean NLL), a 0-d tensor.  A model holding whole
    parameters, or laid out on another mesh or device, raises ValueError
    at the call."""
    dp = mesh.axis(DP_AXIS)
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    def step(batch) -> torch.Tensor:
        check_params_on_mesh(mesh, model, {"tp": TP_AXIS},
                             "GPT(cfg, tp_axis=mesh.axis('tp'))")
        ids, labels = batch["input_ids"], batch["labels"]
        for _, p in params:
            p.grad = None
        loss_local = global_token_loss(mesh, model(ids), labels, axis=dp,
                                       nll=model.token_nll)
        loss_local.backward()
        push_pull_tree(mesh.comm, {n: p.grad for n, p in params
                                   if p.grad is not None},
                       op="sum", inplace=True, axis=dp)
        optimizer.step()
        loss = loss_local.detach().clone()
        if dp.size > 1:
            dist.all_reduce(loss, group=dp.group)
        return loss

    return step
