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
bits.  Mixture-of-experts blocks (``moe_experts > 0``) are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping
from typing import Callable, Optional, Sequence

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
    moe_experts: int = 0             # > 0 is not ported yet
    remat: bool = False              # checkpoint each block


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
    deviation ``1/sqrt(fan_in)``, biases 0, norm scales 1."""
    for m in model.modules():
        if isinstance(m, Dense):
            m.kernel.normal_(0.0, 1.0 / math.sqrt(math.prod(m.in_shape)),
                             generator=generator)
        elif isinstance(m, Embed):
            m.embedding.normal_(0.0, 1.0 / math.sqrt(m.embedding.shape[1]),
                                generator=generator)


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


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, attn_fn: Optional[AttnFn] = None,
                 device=None):
        super().__init__()
        c, dt = cfg.hidden_size, cfg.dtype
        self.ln1 = LayerNorm(c, dt, device=device)
        self.attn = CausalSelfAttention(cfg, attn_fn, device=device)
        self.ln2 = LayerNorm(c, dt, device=device)
        self.mlp_in = Dense((c,), (cfg.intermediate_size,), dt,
                            device=device)
        self.mlp_out = Dense((cfg.intermediate_size,), (c,), dt,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class GPT(nn.Module):
    """Decoder-only LM on ``[B, T]`` token ids; ``positions`` defaults to
    ``arange(T)``.  Weights are drawn from ``generator`` (on ``device``)."""

    def __init__(self, cfg: GPTConfig, attn_fn: Optional[AttnFn] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "GPT mixture-of-experts blocks are not ported to "
                "byteps_tpu_torch yet (parallel/expert.py, ROADMAP Queue A)")
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype
        self.wte = Embed(cfg.vocab_size, c, dt, device=device)
        self.wpe = Embed(cfg.max_position, c, dt, device=device)
        self.h = nn.ModuleList(Block(cfg, attn_fn, device=device)
                               for _ in range(cfg.num_layers))
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
    port :class:`GPT`."""
    return load_flax_params(model, params)
