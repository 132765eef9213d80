"""3-D composite parallelism, ``(dp, pp, tp)``: data x pipeline x tensor;
port of ``byteps_tpu/parallel/three_d.py``.

The two mechanisms compose on one mesh: the GPipe schedule over
``(dp, pp)`` is ``pipeline.make_step_body`` as it is, and each stage is a
GPT laid out over ``tp`` by ``tensor_parallel.py``'s rules (column- and
row-parallel blocks; embedding and head sliced on the vocabulary over tp
and whole over pp).  The JAX module leaves tp to GSPMD inside a
partial-manual ``shard_map``; here the stage's layers state their tp
collectives, and every group's members call them in the same order (the
tp group of a stage, the pp line of a tp index, the dp line).

Axis layout: tp takes consecutive ranks (per-layer all-reduces), pp the
next (stage hops), dp the outermost (once a step).  The JAX composite
runs its CPU tests in f32 (XLA's CPU compiler aborts on a bf16 psum in a
partial-manual ``shard_map``); the port has no such limit, and its card
runs bf16.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from ..comm.mesh import CommContext
from .mesh_util import Mesh, make_mesh
from .pipeline import (DP_AXIS, PP_AXIS, init_pipeline_params,  # noqa: F401
                       make_step_body, num_layers, pipeline_params_to_gpt,
                       shard_pipeline_params, shard_pp_batch, stage_layers)
from .tensor_parallel import TP_AXIS, flax_path, gpt_layout
from .tp_layers import init_opt_state, shard_state

__all__ = ["make_3d_mesh", "init_3d_opt_state", "shard_3d_params",
           "shard_3d_batch", "make_dp_pp_tp_train_step"]

# the optimizer over this rank's slices
init_3d_opt_state = init_opt_state


def make_3d_mesh(comm: CommContext, n_pp: int, n_tp: int) -> Mesh:
    """A ``(dp, pp, tp)`` layout of ``comm``'s world, tp fastest."""
    if n_pp * n_tp <= 0 or comm.size % (n_pp * n_tp):
        raise ValueError(f"{comm.size} ranks not divisible by pp*tp = "
                         f"{n_pp}*{n_tp}")
    return make_mesh(comm, (comm.size // (n_pp * n_tp), n_pp, n_tp),
                     (DP_AXIS, PP_AXIS, TP_AXIS))


def shard_3d_params(mesh: Mesh, pp_params) -> Dict[str, torch.Tensor]:
    """This rank's part of a restacked tree: its stage's blocks
    (:func:`pipeline.shard_pipeline_params`) and of those, and of the
    embedding and head, its tp slices by the tensor-parallel rules; for
    ``load_state_dict`` into ``GPT(cfg, tp_axis=mesh.axis("tp"),
    layers=stage_layers(mesh, L))``."""
    state = shard_pipeline_params(mesh, pp_params)
    layers = stage_layers(mesh, num_layers(pp_params))
    return shard_state(state, gpt_layout(mesh.axis(TP_AXIS)),
                       lambda name: flax_path(name, layers))


def shard_3d_batch(mesh: Mesh, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """This rank's rows: over dp, whole over pp and tp."""
    return shard_pp_batch(mesh, batch)


def make_dp_pp_tp_train_step(mesh: Mesh, model: nn.Module,
                             optimizer: torch.optim.Optimizer,
                             num_microbatches: int) -> Callable:
    """``step(batch) -> loss`` over ``(dp, pp, tp)``: ``model`` is this
    rank's stage laid out over tp, ``GPT(cfg, tp_axis=mesh.axis("tp"),
    layers=stage_layers(mesh, cfg.num_layers))``; the step body is the
    pipeline's own."""
    return make_step_body(mesh, model, optimizer, num_microbatches,
                          {"tp": TP_AXIS},
                          "GPT(cfg, tp_axis=mesh.axis('tp'), "
                          "layers=stage_layers(mesh, L))")
