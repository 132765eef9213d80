"""Mixture-of-experts language-model training over a ``(dp, ep)`` layout;
port of ``byteps_tpu/parallel/moe_lm.py``.

The GPT family's switch blocks (``models/gpt.py``, ``moe_experts > 0``)
meet expert parallelism: sequences are sharded over both axes (plain data
parallelism for the dense layers: attention and the embeddings see only
their own sequences), the expert stacks over ``ep``, and every switch
block's tokens cross the ep axis as all-to-alls (``parallel/expert.py``).
The blocks' load-balance losses (:meth:`GPT.moe_aux_losses`) join the
objective here.

Routing is shard-local (capacity per token shard), so the math does not
depend on the mesh size.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from .expert import (DP_AXIS, EP_AXIS, _ep_slice, make_ep_mesh,  # noqa: F401
                     reduce_expert_grads)
from .long_context import global_token_loss
from .mesh_util import Mesh2D

__all__ = ["moe_lm_pspec", "shard_moe_lm_params", "shard_moe_lm_batch",
           "make_moe_lm_train_step"]


def moe_lm_pspec(name: str, leaf: torch.Tensor) -> Optional[str]:
    """Expert stacks (under a ``.moe.`` scope, except the replicated
    router) are sharded over ``"ep"`` on their leading expert axis;
    everything else is replicated (None)."""
    parts = name.split(".")
    if "moe" in parts and parts[-1] != "router" and leaf.dim() > 0:
        return EP_AXIS
    return None


def shard_moe_lm_params(mesh: Mesh2D, state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """What this rank holds of a full model's ``state`` (a
    ``state_dict``): its ep slice of each expert stack, the rest whole;
    for ``load_state_dict`` into a GPT built with the mesh's ep axis."""
    ep = mesh.axis(EP_AXIS)
    return {name: (_ep_slice(x, ep) if moe_lm_pspec(name, x) == EP_AXIS
                   else x) for name, x in state.items()}


def shard_moe_lm_batch(mesh: Mesh2D, batch: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """This rank's sequences of a global batch, split over ``(dp, ep)``
    (every rank carries distinct data), on the mesh's device."""
    out = {}
    for key, x in batch.items():
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.size:
            raise ValueError(f"{key} {tuple(x.shape)} does not split over "
                             f"{mesh.size} ranks")
        rows = x.shape[0] // mesh.size
        out[key] = x[mesh.rank * rows:(mesh.rank + 1) * rows].to(mesh.device)
    return out


def make_moe_lm_train_step(mesh: Mesh2D, model: nn.Module,
                           optimizer: torch.optim.Optimizer,
                           aux_weight: float = 0.01) -> Callable:
    """``step(batch) -> loss`` for an MoE GPT built with the mesh's ep
    axis (``GPT(cfg, ep_axis=mesh.axis("ep"))``) holding this rank's
    parameters (:func:`shard_moe_lm_params`), on this rank's sequences
    (:func:`shard_moe_lm_batch`).

    The objective is ``s / sum(count) + aux_weight * aux / n_shards``: the
    local NLL sum over the valid-token count summed over the world (no
    gradient through the count), plus the mean over shards of the summed
    load-balance losses.  Gradients follow ``expert.reduce_expert_grads``:
    dense and router leaves summed over the world, expert leaves over
    ``dp`` alone.  Returns the objective summed over the world."""
    cfg = model.cfg
    if cfg.moe_experts <= 0:
        raise ValueError("cfg.moe_experts must be > 0 for the MoE step")
    n_shards = mesh.size
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    def step(batch) -> torch.Tensor:
        ids, labels = batch["input_ids"], batch["labels"]
        for _, p in params:
            p.grad = None
        logits = model(ids)
        aux = sum(model.moe_aux_losses())
        obj = (global_token_loss(mesh, logits, labels)
               + aux_weight * aux / n_shards)
        obj.backward()
        reduce_expert_grads(mesh, {n: p.grad for n, p in params
                                   if p.grad is not None}, moe_lm_pspec)
        optimizer.step()
        loss = obj.detach().clone()
        if mesh.size > 1:
            dist.all_reduce(loss)
        return loss

    return step
