"""Long-context language-model training over a ``(dp, sp)`` layout: data
parallelism times sequence parallelism; port of
``byteps_tpu/parallel/long_context.py``.

The batch is sharded over ``dp`` (rows) and ``sp`` (the sequence), and
attention runs as a ring (K/V rotating between sp neighbours), a striped
ring, a ring of flash kernels or Ulysses (all-to-all head resharding),
``sequence.resolve_sp_attention``.  Every rank holds a (rows, sequence)
sliver of the loss, so the true gradient is the sum over the whole
world.

The loss is normalized globally, as the JAX step does: each rank sums
its tokens' NLL and divides by the valid-token count summed over the
world (an all-reduce of the counts, outside the gradient: a count has
none), so uneven masking across shards does not reweight the objective.
The gradients are then summed over the world with
``ops/collective_ops.push_pull_tree``, and the reported loss is the sum
of the ranks' locally normalized losses: the global mean NLL.

- :func:`shard_lm_batch` cuts this rank's ``[B/dp, T/sp]`` shard of a
  global batch (``striped=True`` round-robins the sequence first, the
  layout ``attention="striped"`` needs);
- :func:`replicate` gives every rank rank 0's parameters;
- :func:`make_dp_sp_train_step` returns ``step(batch) -> loss``;
- :func:`synthetic_lm_batch` draws token ids and shifted labels.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
import torch.nn as nn

from ..ops.collective_ops import broadcast_tree, push_pull_tree
from .mesh_util import Mesh2D
from .sequence import DP_AXIS, SP_AXIS, resolve_sp_attention, stripe_batch

__all__ = ["shard_lm_batch", "replicate", "make_dp_sp_train_step",
           "synthetic_lm_batch", "set_attention"]


def shard_lm_batch(mesh: Mesh2D, batch: Dict[str, torch.Tensor],
                   striped: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's shard of a global ``{input_ids, labels}`` batch (``[B,
    T]``): rows of its dp index, sequence of its sp index, on the mesh's
    device.  ``striped=True`` round-robins the sequence first
    (:func:`~.sequence.stripe_batch`); ids and labels permute together, so
    each label stays with its token."""
    dp, sp = mesh.axis(DP_AXIS), mesh.axis(SP_AXIS)
    out = {}
    for key, x in batch.items():
        x = torch.as_tensor(x)
        b, t = x.shape[:2]
        if b % dp.size or t % sp.size:
            raise ValueError(f"{key} {tuple(x.shape)} does not split over "
                             f"dp={dp.size}, sp={sp.size}")
        if striped:
            x = stripe_batch(x, sp.size)
        rb, rt = b // dp.size, t // sp.size
        out[key] = x[dp.index * rb:(dp.index + 1) * rb,
                     sp.index * rt:(sp.index + 1) * rt].to(mesh.device)
    return out


def replicate(mesh: Mesh2D, module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers on every rank, in place."""
    broadcast_tree(mesh.comm, module, root=0)
    return module


def _model_for(cfg, attn=None, **kw) -> nn.Module:
    """GPT or Llama by the config's type: both take a pluggable
    ``attn_fn`` and explicit ``positions``, so every sp attention composes
    with either, RoPE included (it takes the shard's absolute positions
    before K/V rotate)."""
    from ..models.gpt import GPT
    from ..models.llama import Llama, LlamaConfig
    if isinstance(cfg, LlamaConfig):
        return Llama(cfg, attn_fn=attn, **kw)
    return GPT(cfg, attn_fn=attn, **kw)


def set_attention(model: nn.Module, attn: Callable) -> nn.Module:
    """Install ``attn`` as the attention callable of every attention
    layer of a GPT or Llama ``model``, in place."""
    n = 0
    for m in model.modules():
        if hasattr(m, "attn_fn"):
            m.attn_fn = attn
            n += 1
    if n == 0:
        raise ValueError(f"{type(model).__name__} has no attention layer "
                         f"with an attn_fn")
    return model


def _positions(mesh: Mesh2D, t_local: int, striped: bool,
               device) -> torch.Tensor:
    """The absolute positions of this rank's tokens, ``[1, t_local]``:
    ``my * t_local + l`` for contiguous shards, ``l * sp + my`` for the
    striped layout."""
    sp = mesh.axis(SP_AXIS)
    ell = torch.arange(t_local, device=device)
    pos = ell * sp.size + sp.index if striped else sp.index * t_local + ell
    return pos[None]


def global_token_loss(mesh: Mesh2D, logits: torch.Tensor,
                      labels: torch.Tensor, axis=None,
                      nll: Callable = None) -> torch.Tensor:
    """This rank's NLL sum over the valid-token count summed over the
    world (over ``axis`` alone where the other axes hold the same tokens,
    as tp does): the rank's share of the global mean.  The count's
    all-reduce carries no gradient, so the gradient is the exact local
    partial of the global loss, which the sum of the gradients over the
    data axes completes.  ``nll(logits, labels) -> (sum, count)`` defaults
    to ``models.gpt.token_nll`` (a vocabulary-parallel head passes its
    own, ``GPT.token_nll``)."""
    from ..models.gpt import token_nll
    s, c = (nll or token_nll)(logits, labels)
    c = c.detach().clone()
    size, group = (mesh.size, None) if axis is None else (axis.size,
                                                          axis.group)
    if size > 1:
        dist.all_reduce(c, group=group)
    return s / c.clamp_min(1.0)


def make_dp_sp_train_step(mesh: Mesh2D, model: nn.Module,
                          optimizer: torch.optim.Optimizer,
                          attention: str = "ring") -> Callable:
    """``step(batch) -> loss`` for a GPT or Llama ``model`` over a ``(dp,
    sp)`` mesh: this rank's shard of ``{input_ids, labels}`` (labels
    already shifted, -1 ignored; :func:`shard_lm_batch`) forward and
    backward, the gradients summed over the world (``push_pull_tree``,
    ``op="sum"``), then ``optimizer.step()``.  Returns the loss summed
    over the world (the global mean NLL), a 0-d tensor.

    ``attention`` is bound into ``model``'s attention layers
    (:func:`set_attention`): ``"ring"``, ``"striped"`` (pass the batch
    through ``shard_lm_batch(..., striped=True)``; the step computes
    striped positions, so RoPE and the causal mask stay exact with no
    re-striping per layer), ``"ring_flash"``, ``"ulysses"``,
    ``"ulysses_flash"`` or ``"flash"`` (local kernels, sp=1 only)."""
    sp = mesh.axis(SP_AXIS)
    set_attention(model, resolve_sp_attention(attention, axis=sp))
    striped = attention == "striped"
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    def step(batch) -> torch.Tensor:
        ids, labels = batch["input_ids"], batch["labels"]
        for _, p in params:
            p.grad = None
        pos = _positions(mesh, ids.shape[1], striped, ids.device)
        loss_local = global_token_loss(mesh, model(ids, positions=pos),
                                       labels)
        loss_local.backward()
        # each rank's gradient is its partial sum: the world's sum
        # completes it
        push_pull_tree(mesh.comm, {n: p.grad for n, p in params
                                   if p.grad is not None},
                       op="sum", inplace=True)
        optimizer.step()
        loss = loss_local.detach().clone()
        if mesh.size > 1:
            dist.all_reduce(loss)
        return loss

    return step


def synthetic_lm_batch(generator: torch.Generator, cfg, batch: int,
                       seq_len: int) -> Dict[str, torch.Tensor]:
    """``[B, T]`` token ids drawn from ``generator`` (on its device), and
    the labels shifted by one with the last position ignored (-1)."""
    ids = torch.randint(0, cfg.vocab_size, (batch, seq_len),
                        generator=generator, device=generator.device)
    labels = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -1)], dim=1)
    return {"input_ids": ids, "labels": labels}
