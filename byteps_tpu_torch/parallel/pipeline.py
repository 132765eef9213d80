"""Pipeline parallelism: the GPipe schedule over a ``(dp, pp)`` layout;
port of ``byteps_tpu/parallel/pipeline.py``.

Stage ``s`` of ``S`` holds blocks ``[s * L / S, (s + 1) * L / S)`` (a
``GPT`` built with those ``layers``); the embedding and the head are whole
on every stage, as the JAX module replicates them over pp, and only stage
0 embeds and only the last stage runs the head.  The batch is sharded
over dp, and each dp shard is cut into ``M`` microbatches.

The schedule is the JAX module's ``M + S - 1`` ticks: at tick ``t`` stage
``s`` runs microbatch ``t - s`` through its blocks, then every rank of the
pp line shifts its output one stage on (``mesh_util.shift``, the wrap edge
from the last stage to stage 0 included, whose contents stage 0 never
reads).  A rank with no microbatch at a tick (a bubble) computes nothing
and shifts zeros: the port skips the bubbles' compute, which the JAX
module runs on garbage masked from the loss, so a stage runs ``M`` stage
forwards a step, not ``M + S - 1``.  Every rank runs every tick's shift,
in the same order, whether or not it computed: under gloo on the card a
shift is an all-to-all, a collective.  The head and the loss run once,
over the ``M`` microbatches, after the forward ticks.

The backward is written out rather than taken through the shifts: per
microbatch, in reverse, a stage takes dY from the next stage (the last
stage from the loss), runs ``torch.autograd.backward`` through its
blocks, and shifts dX back; the ``M + S - 1`` backward ticks mirror the
forward's, and every rank again runs every shift.

Gradients follow the JAX module's VMA derivation: the block gradients are
partial sums over dp (the loss is each rank's NLL over the count summed
over dp) and are summed over dp alone; the embedding's and the head's
come from stage 0 and the last stage only (the other stages hold zeros)
and are summed over the ``(dp, pp)`` plane, which leaves every stage's
copy equal.  The step body is :func:`make_step_body`, which the
``(dp, pp, tp)`` composite (``three_d.py``) reuses as it is.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..comm.mesh import CommContext
from ..ops.collective_ops import push_pull_tree
from .mesh_util import (Mesh, Mesh2D, check_params_on_mesh, make_2d_mesh,
                        shard_rows, shift)

__all__ = ["DP_AXIS", "PP_AXIS", "make_pp_mesh", "init_pipeline_params",
           "pipeline_params_to_gpt", "stage_layers", "shard_pipeline_params",
           "shard_pp_batch", "make_dp_pp_train_step", "make_step_body",
           "flax_tree"]

DP_AXIS = "dp"
PP_AXIS = "pp"
_EMBED = ("wte", "wpe")
_HEAD = ("ln_f", "lm_head")


def make_pp_mesh(comm: CommContext, n_pp: int) -> Mesh2D:
    """A ``(dp, pp)`` layout of ``comm``'s world, pp over consecutive
    ranks."""
    return make_2d_mesh(comm, n_pp, (DP_AXIS, PP_AXIS))


def flax_tree(model: nn.Module) -> Dict:
    """A whole model's parameters as a flax tree of tensors (``h.{i}``
    becomes scope ``h{i}``), detached."""
    tree: Dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "h":
            parts = [f"h{parts[1]}"] + parts[2:]
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = p.detach()
    return tree


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return tree if torch.is_tensor(tree) else torch.from_numpy(
        np.array(tree))


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_pipeline_params(cfg, generator: Optional[torch.Generator] = None,
                         params=None) -> Dict:
    """A GPT's parameters restacked for the pipeline: the per-layer block
    trees become one tree with a leading layer axis ``[L, ...]``;
    embedding (``wte``, ``wpe``) and head (``ln_f``, ``lm_head``) stay as
    they are.  The GPT is ``params`` (a flax tree, the JAX package's
    ``variables["params"]``), or else drawn from ``generator``.  MoE
    configs are refused: the restack needs homogeneous blocks."""
    if cfg.moe_experts:
        raise ValueError(
            "pipeline restacking needs homogeneous blocks; MoE configs "
            "(moe_experts > 0) interleave dense and switch MLPs — use the "
            "(dp, ep) path (parallel/moe_lm.py) for MoE models")
    if params is None:
        from ..models.gpt import GPT
        dev = None if generator is None else generator.device
        params = flax_tree(GPT(cfg, device=dev, generator=generator))
    p = _tensors(dict(params))
    layers = [p[f"h{i}"] for i in range(cfg.num_layers)]
    return {
        "embed": {k: p[k] for k in _EMBED},
        "blocks": _map(lambda *xs: torch.stack(xs), *layers),
        "head": {k: p[k] for k in _HEAD},
    }


def pipeline_params_to_gpt(cfg, pp_params) -> Dict:
    """Inverse of :func:`init_pipeline_params`: ``{"params": tree}``."""
    p = dict(pp_params["embed"])
    p.update(pp_params["head"])
    for i in range(cfg.num_layers):
        p[f"h{i}"] = _map(lambda x: x[i], pp_params["blocks"])
    return {"params": p}


def stage_layers(mesh: Mesh, num_layers: int) -> tuple:
    """The blocks this rank's pipeline stage holds."""
    pp = mesh.axis(PP_AXIS)
    if num_layers % pp.size:
        raise ValueError(f"{num_layers} layers not divisible by "
                         f"pp={pp.size}")
    per = num_layers // pp.size
    return tuple(range(pp.index * per, (pp.index + 1) * per))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


def num_layers(pp_params) -> int:
    """The layer count of a restacked tree (its blocks' leading axis)."""
    return next(iter(x for _, x in _flat(pp_params["blocks"]))).shape[0]


def shard_pipeline_params(mesh: Mesh, pp_params) -> Dict[str, torch.Tensor]:
    """This rank's part of a restacked tree (:func:`init_pipeline_params`)
    as a ``state_dict`` of its stage's GPT (``GPT(cfg, layers=
    stage_layers(mesh, L))``): its blocks off the layer axis (``h.{j}``
    is block ``layers[j]``), the embedding and head whole."""
    state = {}
    for part in ("embed", "head"):
        for name, x in _flat(pp_params[part]):
            state[name] = torch.as_tensor(x).clone()
    leaves = dict(_flat(pp_params["blocks"]))
    for j, i in enumerate(stage_layers(mesh, num_layers(pp_params))):
        for name, x in leaves.items():
            state[f"h.{j}.{name}"] = torch.as_tensor(x)[i].clone()
    return state


def shard_pp_batch(mesh: Mesh, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: over dp, whole over pp (and
    tp)."""
    return shard_rows(mesh, DP_AXIS, batch)


def make_dp_pp_train_step(mesh: Mesh2D, model: nn.Module,
                          optimizer: torch.optim.Optimizer,
                          num_microbatches: int) -> Callable:
    """``step(batch) -> loss`` over ``(dp, pp)``: ``model`` is this rank's
    stage, ``GPT(cfg, layers=stage_layers(mesh, cfg.num_layers))``, the
    batch this rank's rows (:func:`shard_pp_batch`, ``[B, T]`` with ``B``
    a multiple of ``num_microbatches``).  Returns the global mean NLL on
    every rank, a 0-d tensor; ``step.stage_forwards`` counts the stage
    forwards of the last step."""
    return make_step_body(mesh, model, optimizer, num_microbatches, {},
                          "GPT(cfg, layers=stage_layers(mesh, L))")


def make_step_body(mesh: Mesh, model: nn.Module,
                   optimizer: torch.optim.Optimizer, num_microbatches: int,
                   axes: Dict[str, str], hint: str) -> Callable:
    """The GPipe step (see the module docstring), for the ``(dp, pp)``
    step above and the ``(dp, pp, tp)`` composite, whose stages are built
    with a tp axis (``axes`` the layout roles the model must carry, for
    ``check_params_on_mesh``)."""
    cfg = model.cfg
    dp, pp = mesh.axis(DP_AXIS), mesh.axis(PP_AXIS)
    plane = mesh.plane((DP_AXIS, PP_AXIS))
    layers = stage_layers(mesh, cfg.num_layers)
    M, S, s = num_microbatches, pp.size, pp.index
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    ends = [(n, p) for n, p in named if n.split(".")[0] in _EMBED + _HEAD]
    blocks = [(n, p) for n, p in named if n.split(".")[0] == "h"]

    def step(batch) -> torch.Tensor:
        check_params_on_mesh(mesh, model, axes, hint, layers=layers)
        ids, labels = batch["input_ids"], batch["labels"]
        b, t = ids.shape
        if b < M or b % M:
            raise ValueError(f"per-dp-shard batch {b} must be a positive "
                             f"multiple of num_microbatches={M}")
        mb = b // M
        for _, p in named:
            p.grad = None
        ids_m, lab = ids.reshape(M, mb, t), labels.reshape(M * mb, t)
        count = (labels != -1).sum().float()
        if dp.size > 1:
            dist.all_reduce(count, group=dp.group)
        zero = torch.zeros(mb, t, cfg.hidden_size, dtype=cfg.dtype,
                           device=ids.device)
        xs, ys = [None] * M, [None] * M
        buf, forwards = zero, 0
        for tick in range(M + S - 1):
            m = tick - s
            out = zero
            if 0 <= m < M:
                x = (model.embed(ids_m[m]) if s == 0
                     else buf.detach().requires_grad_())
                ys[m], xs[m] = model.run_blocks(x), x
                out, forwards = ys[m].detach(), forwards + 1
            buf = shift([out], pp, 1)[0]
        if s == S - 1:
            held = [y.detach().requires_grad_() for y in ys]
            nll, _ = model.token_nll(model.head(torch.cat(held)), lab)
            loss_local = nll / count.clamp_min(1.0)
            loss_local.backward()
            dys = [y.grad for y in held]
        else:
            loss_local = torch.zeros((), device=ids.device)
        gbuf = zero
        for tick in range(M + S - 1):
            m = M - 1 - tick + (S - 1 - s)
            out = zero
            if 0 <= m < M:
                torch.autograd.backward(ys[m], dys[m] if s == S - 1
                                        else gbuf)
                if s > 0:
                    out = xs[m].grad
                xs[m] = ys[m] = None
            gbuf = shift([out], pp, -1)[0]
        step.stage_forwards = forwards
        for _, p in ends:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        push_pull_tree(mesh.comm, {n: p.grad for n, p in blocks
                                   if p.grad is not None},
                       op="sum", inplace=True, axis=dp)
        reduce_ends(mesh, {n: p.grad for n, p in ends}, plane)
        optimizer.step()
        loss = loss_local.detach().clone()
        if plane.size > 1:
            dist.all_reduce(loss, group=plane.group)
        return loss

    step.stage_forwards = 0
    return step


def reduce_ends(mesh: Mesh, grads: Dict[str, torch.Tensor], plane) -> None:
    """The embedding's and head's gradients summed over the ``(dp, pp)``
    plane, in place (stage 0 and the last stage hold them, the others
    zeros)."""
    push_pull_tree(mesh.comm, grads, op="sum", inplace=True, axis=plane)
