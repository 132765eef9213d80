"""Expert parallelism: switch-style mixture of experts with all-to-all
token dispatch; port of ``byteps_tpu/parallel/expert.py``.

A switch MLP's experts live ``E / ep`` to a rank of the ``ep`` axis: ep
rank ``e`` holds experts ``[e * E_loc, (e + 1) * E_loc)``.  Routing and
capacity are computed per token shard, the dispatched ``[E, C, h]`` block
crosses the ep axis as one all-to-all each way (``mesh_util.all_to_all``,
differentiable), and tokens past an expert's capacity are dropped, the
Switch Transformer's static-shape trade.

The JAX dispatch is a dense ``[N, E, C]`` one-hot with ``C ~ 1.25 N / E``,
which grows with the square of the token count (~84 M f32 elements a MoE
layer at 8192 tokens and 8 experts, 336 MB for each of dispatch and
combine).  :func:`switch_dispatch` computes the same function with index
ops: each token's expert, its slot (its arrival order within the expert)
and its gate; the dispatched block is an ``index_add_`` of the kept
tokens and the combine a gather, each exact (one term per element, as
the one-hot einsums).

Parity: :func:`moe_mlp` over an ep axis and :func:`moe_mlp_reference`
(the full stacks, no collective) compute the same function on a token
shard.  Routing is shard-local, so the math does not depend on the mesh
size, only the placement does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..comm.mesh import CommContext
from ..ops.collective_ops import push_pull_tree
from .mesh_util import Mesh2D, MeshAxis, all_to_all, make_2d_mesh

__all__ = ["DP_AXIS", "EP_AXIS", "make_ep_mesh", "Dispatch",
           "switch_dispatch", "capacity_of", "moe_mlp", "moe_mlp_reference",
           "init_moe_params", "moe_pspec", "shard_moe_params",
           "make_dp_ep_train_step", "reduce_expert_grads"]

DP_AXIS = "dp"
EP_AXIS = "ep"


def make_ep_mesh(comm: CommContext, n_ep: int) -> Mesh2D:
    """A ``(dp, ep)`` layout of ``comm``'s world, ep over consecutive
    ranks."""
    return make_2d_mesh(comm, n_ep, (DP_AXIS, EP_AXIS))


# ------------------------------------------------------------------ routing

@dataclasses.dataclass
class Dispatch:
    """Top-1 routing of ``N`` tokens to ``E`` experts of capacity ``C``:
    ``expert`` ``[N]`` (argmax of the router's softmax, the first index on
    ties), ``slot`` ``[N]`` (the token's arrival order within its
    expert), ``keep`` ``[N]`` (``slot < C``), ``gate`` ``[N]`` f32 (the
    max probability), ``dispatched`` ``[E, C, h]`` f32 (the kept tokens at
    their slots, zeros elsewhere) and ``aux`` (the load-balance loss ``E *
    sum_e frac_tokens_e * frac_probs_e``)."""

    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    dispatched: torch.Tensor
    aux: torch.Tensor

    def combine(self, returned: torch.Tensor) -> torch.Tensor:
        """``[N, h]`` f32: each kept token's expert output (``returned``,
        ``[E, C, h]``) at its slot, times its gate; dropped tokens 0."""
        e, c, h = returned.shape
        idx = (self.expert * c + self.slot.clamp_max(c - 1))
        rows = returned.reshape(e * c, h).index_select(0, idx)
        w = self.gate * self.keep.to(self.gate.dtype)
        return rows * w[:, None]


def capacity_of(capacity_factor: float, n: int, num_experts: int) -> int:
    return max(1, int(math.ceil(capacity_factor * n / num_experts)))


def switch_dispatch(x: torch.Tensor, router_w: torch.Tensor,
                    num_experts: int, capacity: int) -> Dispatch:
    """Top-1 (switch) routing of a token shard ``x`` ``[N, h]`` (the JAX
    function's one-hot semantics, with index ops; see the module
    docstring)."""
    n, h = x.shape
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                   # [N, E]
    gate = probs.amax(dim=-1)
    expert = torch.argmax(probs, dim=-1)                    # first on ties
    onehot = F.one_hot(expert, num_experts)                 # [N, E] int
    slot = (onehot.cumsum(0) - onehot).gather(1, expert[:, None])[:, 0]
    keep = slot < capacity
    kept = keep.nonzero()[:, 0]
    dispatched = x.new_zeros((num_experts * capacity, h), dtype=torch.float32)
    dispatched = dispatched.index_add(
        0, expert[kept] * capacity + slot[kept], x[kept].float())
    frac_tokens = onehot.float().mean(0)
    frac_probs = probs.mean(0)
    aux = num_experts * torch.sum(frac_tokens * frac_probs)
    return Dispatch(expert, slot, keep, gate,
                    dispatched.reshape(num_experts, capacity, h), aux)


def _expert_ffn(w1, b1, w2, b2, x):
    """``x`` ``[E_loc, S, h]`` through each expert's MLP (gelu, tanh
    form)."""
    y = torch.einsum("esh,ehf->esf", x, w1) + b1[:, None, :]
    y = F.gelu(y, approximate="tanh")
    return torch.einsum("esf,efh->esh", y, w2) + b2[:, None, :]


def moe_mlp(x: torch.Tensor, params: Dict[str, torch.Tensor],
            num_experts: int, capacity_factor: float,
            axis: Optional[MeshAxis] = None):
    """Switch MoE MLP over a token shard ``x`` ``[N, h]``.

    ``params``: ``router`` ``[h, E]``, ``w1`` ``[E_loc, h, f]``, ``b1``
    ``[E_loc, f]``, ``w2`` ``[E_loc, f, h]``, ``b2`` ``[E_loc, h]``: the
    expert stacks hold this rank's ``E / ep`` experts when ``axis`` is
    given, the full stacks with ``axis=None``.  The expert inputs are cast
    to the stacks' type for the products.  Returns (out ``[N, h]`` in x's
    type, aux loss)."""
    n, h = x.shape
    e_loc = params["w1"].shape[0]
    ep = 1 if axis is None else axis.size
    if e_loc * ep != num_experts:
        raise ValueError(f"expert weights carry {e_loc * ep} experts, "
                         f"config says {num_experts}")
    capacity = capacity_of(capacity_factor, n, num_experts)
    d = switch_dispatch(x, params["router"], num_experts, capacity)
    if axis is None:
        expert_in = d.dispatched                         # [E, C, h]
    else:
        # [E, C, h] = [ep, E_loc, C, h]: block j goes to ep rank j, and
        # the blocks received from each peer, for this rank's experts,
        # join the capacity axis: [E_loc, ep * C, h] in the peers' order
        expert_in = all_to_all(d.dispatched, axis, split_dim=0,
                               concat_dim=1)
    out = _expert_ffn(params["w1"], params["b1"], params["w2"], params["b2"],
                      expert_in.to(params["w1"].dtype)).float()
    if axis is not None:
        # back: each peer's capacity block to it, experts in order
        out = all_to_all(out, axis, split_dim=1, concat_dim=0)
    return d.combine(out).to(x.dtype), d.aux


def moe_mlp_reference(x: torch.Tensor, full_params: Dict[str, torch.Tensor],
                      num_experts: int, capacity_factor: float):
    """Single-device reference: the same math with the full expert
    stacks and no collective (the parity oracle for :func:`moe_mlp`)."""
    return moe_mlp(x, full_params, num_experts, capacity_factor, axis=None)


def init_moe_params(generator: torch.Generator, hidden: int, ffn: int,
                    num_experts: int, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Full (unsharded) switch-MLP parameter stacks, drawn from
    ``generator``: router and ``w1`` normal with standard deviation
    ``1/sqrt(hidden)``, ``w2`` ``1/sqrt(ffn)``, biases 0."""
    device = device or generator.device

    def normal(shape, std, dt):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(dt)

    return {
        "router": normal((hidden, num_experts), hidden ** -0.5,
                         torch.float32),
        "w1": normal((num_experts, hidden, ffn), hidden ** -0.5, dtype),
        "b1": torch.zeros((num_experts, ffn), dtype=dtype, device=device),
        "w2": normal((num_experts, ffn, hidden), ffn ** -0.5, dtype),
        "b2": torch.zeros((num_experts, hidden), dtype=dtype, device=device),
    }


def moe_pspec(name: str, leaf: torch.Tensor) -> Optional[str]:
    """The placement rule of MoE parameters (and of any state shaped like
    them): the axis a leaf is sharded over on its leading expert axis
    (``"ep"``), or None for replicated (the router, scalars)."""
    if name.split(".")[-1] == "router" or leaf.dim() == 0:
        return None
    return EP_AXIS


def _ep_slice(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    e_loc = x.shape[0] // axis.size
    return x[axis.index * e_loc:(axis.index + 1) * e_loc]


def shard_moe_params(mesh: Mesh2D, params: Dict[str, torch.Tensor],
                     pspec: Callable = moe_pspec) -> Dict[str, torch.Tensor]:
    """What this rank holds of full ``params`` (by :func:`moe_pspec`): its
    ep slice of each expert stack, the rest whole; fresh leaf tensors on
    the mesh's device."""
    ep = mesh.axis(EP_AXIS)
    out = {}
    for name, x in params.items():
        x = torch.as_tensor(x)
        if pspec(name, x) == EP_AXIS:
            x = _ep_slice(x, ep)
        out[name] = x.to(mesh.device, copy=True).detach().requires_grad_(
            x.is_floating_point())
    return out


def reduce_expert_grads(mesh: Mesh2D, named_grads, pspec: Callable) -> None:
    """The gradient rule of a ``(dp, ep)`` step, in place.  Replicated
    leaves (dense, router) hold this rank's partial sums: summed over the
    whole world.  Expert leaves are summed over ``dp`` only: the
    all-to-all's backward has already brought every ep peer's cotangent
    to the expert's owner, so a sum over ``ep`` would count each token
    ``ep`` times (the explicit form of the VMA transpose of the JAX
    step)."""
    dense, expert = {}, {}
    for name, g in named_grads.items():
        (expert if pspec(name, g) == EP_AXIS else dense)[name] = g
    if dense:
        push_pull_tree(mesh.comm, dense, op="sum", inplace=True)
    if expert:
        push_pull_tree(mesh.comm, expert, op="sum", inplace=True,
                       axis=mesh.axis(DP_AXIS))


def _world_sum(mesh: Mesh2D, x: torch.Tensor) -> torch.Tensor:
    x = x.detach().clone()
    if mesh.size > 1:
        dist.all_reduce(x)
    return x


def make_dp_ep_train_step(mesh: Mesh2D, params: Dict[str, torch.Tensor],
                          num_experts: int, capacity_factor: float,
                          optimizer: torch.optim.Optimizer,
                          loss_fn: Callable, aux_weight: float = 0.01
                          ) -> Callable:
    """``step(batch) -> loss`` for an MoE head over ``(dp, ep)``:
    ``params`` is this rank's (:func:`shard_moe_params`), ``optimizer``
    steps them, ``loss_fn(out, batch)`` is a scalar on this rank's
    tokens ``batch["x"]`` ``[..., h]`` (every rank carries distinct
    tokens, ep ranks too, as in Switch).  The objective is the mean over
    the ``dp * ep`` shards of ``main + aux_weight * aux``; the gradients
    follow :func:`reduce_expert_grads`.  Returns the objective summed over
    the world."""
    n_shards = mesh.size
    ep = mesh.axis(EP_AXIS)

    def step(batch) -> torch.Tensor:
        x = batch["x"]
        for p in params.values():
            p.grad = None
        out, aux = moe_mlp(x.reshape(-1, x.shape[-1]), params, num_experts,
                           capacity_factor, axis=ep)
        obj = (loss_fn(out.reshape(x.shape), batch)
               + aux_weight * aux) / n_shards
        obj.backward()
        reduce_expert_grads(mesh, {n: p.grad for n, p in params.items()
                                   if p.grad is not None}, moe_pspec)
        optimizer.step()
        return _world_sum(mesh, obj)

    return step
