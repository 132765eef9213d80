"""Causal transformer LM with pluggable attention; port of
``byteps_tpu/models/gpt.py`` (the long-context flagship, dense MLPs).

Parameters keep flax's names and layouts, so :func:`load_flax_gpt` is a
copy: a ``DenseGeneral`` kernel is ``(input axes..., output axes...)``
(``qkv`` is ``(C, 3, H, hd)`` with bias ``(3, H, hd)``, ``out`` is ``(H,
hd, C)``), a ``Dense`` kernel is ``(in, out)``, an ``Embed`` table is
``(vocab, C)``, and block ``i`` is ``h.{i}`` where flax says ``h{i}``.

Numerics follow flax with ``dtype=cfg.dtype`` over f32 parameters:

- ``Dense``/``DenseGeneral`` cast the input and the f32 kernel and bias to
  ``cfg.dtype`` before the product (explicitly, not through autocast, so
  gradients reach the f32 parameters);
- ``Embed`` gathers rows and casts them (the values flax's cast-then-take
  gives; the table's gradient is summed in f32);
- ``LayerNorm`` (``epsilon=1e-6``) takes its statistics in f32 with the
  fast variance ``E[x^2] - E[x]^2``, clipped at 0;
- ``gelu`` is the tanh form (``jax.nn.gelu``'s default);
- logits are returned in f32.

``remat`` (the JAX config's ``nn.remat`` of each block) wraps each block
in ``torch.utils.checkpoint`` (non-reentrant): the block's activations
are dropped after the forward and recomputed in the backward, which runs
the same ops on the same inputs, so the loss and gradients keep their
bits.

Mixture of experts (``moe_experts > 0``): every block with ``i %
moe_every == moe_every - 1`` takes a switch MLP (:class:`MoEMLP`,
``parallel/expert.py``) in place of the dense one, under flax's scope
``h{i}/moe`` (``router``, ``w1``, ``b1``, ``w2``, ``b2``).  Its
parameters are f32; the expert stacks are cast to ``cfg.dtype`` for the
products, and the router stays f32.  Built with an ``ep_axis``, a block
holds this rank's slice of the expert stacks and dispatches over that
axis.  Each block keeps the load-balance loss of its last forward
(``MoEMLP.aux``; :meth:`GPT.moe_aux_losses`), the JAX model's ``moe_aux``
collection.  A dense config keeps the dense parameter tree.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..parallel.sequence import full_attention

AttnFn = Callable  # (q, k, v, *, causal, sm_scale) -> out


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 32768
    hidden_size: int = 512
    num_layers: int = 8
    num_heads: int = 8
    intermediate_size: int = 2048
    max_position: int = 32768        # long-context by default
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False              # checkpoint each block
    # switch-MoE MLPs: 0 = dense everywhere; > 0 turns every
    # ``moe_every``-th block's MLP into a switch layer of that many experts
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity: float = 1.25

    def __post_init__(self):
        if self.moe_experts > 0 and self.moe_every < 1:
            raise ValueError(
                "moe_every must be >= 1 when moe_experts > 0 (a value "
                "of 0 would silently produce a fully dense model)")


def gpt_small() -> GPTConfig:
    return GPTConfig()


def gpt_tiny() -> GPTConfig:
    """CPU tests."""
    return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, intermediate_size=128, max_position=512)


# --- flax layers -------------------------------------------------------------

class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral``: contracts the last
    ``len(in_shape)`` axes of the input with a kernel of shape ``in_shape +
    out_shape``; input, kernel and bias are cast to ``dtype`` first."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype, bias: bool = True, device=None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(*out_shape, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = torch.matmul(x.reshape(*lead, n_in).to(self.dtype),
                         self.kernel.reshape(n_in, n_out).to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.reshape(n_out).to(self.dtype)
        return y.reshape(*lead, *self.out_shape)


class Embed(nn.Module):
    """flax ``Embed``: rows of an f32 ``(num, features)`` table, cast to
    ``dtype``."""

    def __init__(self, num: int, features: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features,
                                                  device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` (epsilon 1e-6): f32 statistics with the fast
    variance, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def run_block(block: nn.Module, remat: bool, *args) -> torch.Tensor:
    """``block(*args)``; with ``remat``, under a non-reentrant
    ``torch.utils.checkpoint`` when autograd records (the JAX models'
    ``nn.remat`` of each layer)."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(block, *args,
                                                 use_reentrant=False)
    return block(*args)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights: kernels and embedding tables normal with standard
    deviation ``1/sqrt(fan_in)``, biases 0, norm scales 1.  A switch MLP
    draws its full expert stacks and keeps its rank's slice, so every
    layout of one seed holds the same experts."""
    for m in model.modules():
        if isinstance(m, Dense):
            m.kernel.normal_(0.0, 1.0 / math.sqrt(math.prod(m.in_shape)),
                             generator=generator)
        elif isinstance(m, Embed):
            m.embedding.normal_(0.0, 1.0 / math.sqrt(m.embedding.shape[1]),
                                generator=generator)
        elif isinstance(m, MoEMLP):
            m.router.normal_(0.0, m.router.shape[0] ** -0.5,
                             generator=generator)
            for name in ("w1", "w2"):
                w = getattr(m, name)
                full = torch.empty((m.num_experts,) + tuple(w.shape[1:]),
                                   device=w.device)
                full.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
                w.copy_(m.local(full))


# --- the model ---------------------------------------------------------------

class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, attn_fn: Optional[AttnFn] = None,
                 device=None):
        super().__init__()
        c, h = cfg.hidden_size, cfg.num_heads
        self.head_dim = c // h
        self.attn_fn = attn_fn or full_attention
        self.qkv = Dense((c,), (3, h, self.head_dim), cfg.dtype,
                         device=device)
        self.out = Dense((h, self.head_dim), (c,), cfg.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        ctx = self.attn_fn(q, k, v, causal=True,
                           sm_scale=1.0 / math.sqrt(self.head_dim))
        return self.out(ctx)


class MoEMLP(nn.Module):
    """Switch-MoE MLP (``parallel/expert.py`` ``moe_mlp``) over the
    block's ``[B, T, C]`` tokens.  Without ``ep_axis`` it holds the full
    expert stacks; with one, ``E / ep`` experts (:meth:`local`) and its
    tokens cross that axis.  ``aux`` is the load-balance loss of the last
    forward."""

    def __init__(self, cfg: GPTConfig, ep_axis=None, device=None):
        super().__init__()
        h, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.moe_experts
        ep = 1 if ep_axis is None else ep_axis.size
        if e % ep:
            raise ValueError(f"{e} experts do not split over ep={ep}")
        self.cfg, self.ep_axis, self.num_experts = cfg, ep_axis, e
        e_loc = e // ep
        self.router = nn.Parameter(torch.empty(h, e, device=device))
        self.w1 = nn.Parameter(torch.empty(e_loc, h, f, device=device))
        self.b1 = nn.Parameter(torch.zeros(e_loc, f, device=device))
        self.w2 = nn.Parameter(torch.empty(e_loc, f, h, device=device))
        self.b2 = nn.Parameter(torch.zeros(e_loc, h, device=device))
        self.aux = None

    def local(self, stack: torch.Tensor) -> torch.Tensor:
        """This rank's experts of a full ``[E, ...]`` stack."""
        if self.ep_axis is None:
            return stack
        e_loc = self.w1.shape[0]
        i = self.ep_axis.index
        return stack[i * e_loc:(i + 1) * e_loc]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.expert import moe_mlp
        dt = self.cfg.dtype
        # products in cfg.dtype as the dense path; the router stays f32
        params = {"router": self.router, "w1": self.w1.to(dt),
                  "b1": self.b1.to(dt), "w2": self.w2.to(dt),
                  "b2": self.b2.to(dt)}
        b, t, h = x.shape
        out, self.aux = moe_mlp(x.reshape(b * t, h), params,
                                self.num_experts, self.cfg.moe_capacity,
                                axis=self.ep_axis)
        return out.reshape(b, t, h)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, attn_fn: Optional[AttnFn] = None,
                 device=None, moe: bool = False, ep_axis=None):
        super().__init__()
        c, dt = cfg.hidden_size, cfg.dtype
        self.ln1 = LayerNorm(c, dt, device=device)
        self.attn = CausalSelfAttention(cfg, attn_fn, device=device)
        self.ln2 = LayerNorm(c, dt, device=device)
        if moe:
            self.moe = MoEMLP(cfg, ep_axis, device=device)
        else:
            self.mlp_in = Dense((c,), (cfg.intermediate_size,), dt,
                                device=device)
            self.mlp_out = Dense((cfg.intermediate_size,), (c,), dt,
                                 device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        if hasattr(self, "moe"):
            return x + self.moe(h)
        h = F.gelu(self.mlp_in(h), approximate="tanh")
        return x + self.mlp_out(h)


class GPT(nn.Module):
    """Decoder-only LM on ``[B, T]`` token ids; ``positions`` defaults to
    ``arange(T)``.  Weights are drawn from ``generator`` (on ``device``).
    ``ep_axis`` (a ``parallel/mesh_util.MeshAxis``) shards the switch
    MLPs' experts over that axis."""

    def __init__(self, cfg: GPTConfig, attn_fn: Optional[AttnFn] = None,
                 device=None, generator: Optional[torch.Generator] = None,
                 ep_axis=None):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype
        self.wte = Embed(cfg.vocab_size, c, dt, device=device)
        self.wpe = Embed(cfg.max_position, c, dt, device=device)
        self.h = nn.ModuleList(
            Block(cfg, attn_fn, device=device, ep_axis=ep_axis,
                  moe=(cfg.moe_experts > 0
                       and i % cfg.moe_every == cfg.moe_every - 1))
            for i in range(cfg.num_layers))
        self.ln_f = LayerNorm(c, dt, device=device)
        self.lm_head = Dense((c,), (cfg.vocab_size,), dt, device=device)
        init_params(self, generator
                    or torch.Generator(device=device or "cpu").manual_seed(0))

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(input_ids.shape[1],
                                     device=input_ids.device)[None]
        x = self.wte(input_ids) + self.wpe(positions)
        for block in self.h:
            x = run_block(block, self.cfg.remat, x)
        return self.lm_head(self.ln_f(x)).float()

    def moe_aux_losses(self) -> List[torch.Tensor]:
        """The switch blocks' load-balance losses of the last forward, in
        block order (empty for a dense model)."""
        return [b.moe.aux for b in self.h if hasattr(b, "moe")]


# --- loss ------------------------------------------------------------------

def token_nll(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -1):
    """(sum of per-token NLL over valid positions, valid-token count)."""
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                          labels.reshape(-1), ignore_index=ignore,
                          reduction="sum")
    return nll, (labels != ignore).sum().float()


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -1):
    """Next-token cross-entropy; ``labels == ignore`` positions skipped.
    Callers shift: ``labels[t]`` is the target for ``logits[t]``."""
    s, c = token_nll(logits, labels, ignore)
    return s / c.clamp_min(1.0)


# --- flax weights ----------------------------------------------------------

@torch.no_grad()
def load_flax_params(model: nn.Module, params) -> nn.Module:
    """Copy a flax parameter tree (numpy arrays) into ``model`` in place.
    Scope ``h{i}`` is ``h.{i}``; every leaf must land on a parameter of
    the same shape and every parameter must get one."""
    flat = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            name = prefix + re.sub(r"^h(\d+)$", r"h.\1", key)
            if isinstance(val, Mapping):
                walk(val, name + ".")
            else:
                flat[name] = val

    walk(params, "")
    own = dict(model.named_parameters())
    if set(flat) != set(own):
        raise ValueError(
            f"flax tree and model differ: only in flax "
            f"{sorted(set(flat) - set(own))}, only in the model "
            f"{sorted(set(own) - set(flat))}")
    for name, val in flat.items():
        t = torch.from_numpy(np.array(val, dtype=np.float32))
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: flax shape {tuple(t.shape)} does not "
                             f"fit {tuple(own[name].shape)}")
        own[name].copy_(t)
    return model


def load_flax_gpt(model: GPT, params) -> GPT:
    """The JAX package's GPT parameters (``variables["params"]``) into a
    port :class:`GPT`.  Switch blocks take the full expert stacks, or,
    in a model built with an ``ep_axis``, their rank's slice of them."""
    params = dict(params)
    for i, block in enumerate(model.h):
        if hasattr(block, "moe") and f"h{i}" in params:
            scope = dict(params[f"h{i}"])
            moe = dict(scope.get("moe", {}))
            for k in ("w1", "b1", "w2", "b2"):
                if k in moe:
                    moe[k] = block.moe.local(
                        torch.from_numpy(np.array(moe[k], np.float32)))
            scope["moe"] = moe
            params[f"h{i}"] = scope
    return load_flax_params(model, params)
