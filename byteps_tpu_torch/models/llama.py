"""Llama-family decoder LM: RoPE, RMSNorm, SwiGLU, grouped-query
attention; port of ``byteps_tpu/models/llama.py``.

Parameters keep flax's names and layouts (:func:`load_flax_llama` is a
copy): the q/k/v ``DenseGeneral`` kernels are ``(C, heads, hd)``, ``out``
is ``(H, hd, C)``, the MLP kernels ``(in, out)``; no biases anywhere;
untied embedding and lm head.  Numerics follow the JAX model:

- bf16 compute over f32 parameters, cast explicitly as flax does (see
  ``models/gpt.py``);
- RMSNorm statistics in f32 with an f32 scale;
- rotary embeddings in f32 with the rotate-half convention, cast back;
- GQA repeats each K/V head ``groups`` times in place
  (``repeat_interleave``, as ``jnp.repeat``), so the attention callable
  sees as many K/V heads as query heads;
- logits in f32.

Per-layer rematerialisation (the JAX config's ``remat``) is not ported
yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.sequence import full_attention
from .gpt import AttnFn, Dense, Embed, init_params, load_flax_params
from .gpt import lm_loss, token_nll  # noqa: F401 — the shared LM loss

__all__ = [
    "LlamaConfig", "Llama", "llama3_8b", "llama_tiny", "llama_tiny_f32",
    "lm_loss", "token_nll", "rope_frequencies", "apply_rope",
    "load_flax_llama",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8            # GQA group count
    intermediate_size: int = 14336   # SwiGLU width
    max_position: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads ({self.num_heads}) must be divisible by "
                f"num_kv_heads ({self.num_kv_heads})")
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must be divisible by num_heads")


def llama3_8b() -> LlamaConfig:
    """Llama-3-8B geometry."""
    return LlamaConfig()


def llama_tiny() -> LlamaConfig:
    """CPU tests; keeps GQA non-trivial (4 q heads over 2 kv heads)."""
    return LlamaConfig(vocab_size=256, hidden_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=2, intermediate_size=128,
                       max_position=512, rope_theta=10000.0)


def llama_tiny_f32() -> LlamaConfig:
    """Smaller still, f32 end to end: the parity tests' geometry."""
    return LlamaConfig(vocab_size=128, hidden_size=32, num_layers=2,
                       num_heads=4, num_kv_heads=2, intermediate_size=64,
                       max_position=64, rope_theta=10000.0,
                       dtype=torch.float32)


# --- rotary ----------------------------------------------------------------

def rope_frequencies(head_dim: int, positions: torch.Tensor, theta: float):
    """(cos, sin) tables ``[*, T, head_dim/2]`` in f32 for the given
    absolute positions."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs ``(x[i], x[i + D/2])`` (rotate-half) of ``[B, T, H,
    D]`` in f32; the tables broadcast over the head axis."""
    d2 = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :d2], xf[..., d2:]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        rms = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (xf * rms * self.scale).to(self.dtype)


# --- the model ---------------------------------------------------------------

class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, attn_fn: Optional[AttnFn] = None,
                 device=None):
        super().__init__()
        c, h, kv = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads
        self.cfg = cfg
        self.head_dim = hd = c // h
        self.groups = h // kv
        self.attn_fn = attn_fn or full_attention
        dt = cfg.dtype
        self.q = Dense((c,), (h, hd), dt, bias=False, device=device)
        self.k = Dense((c,), (kv, hd), dt, bias=False, device=device)
        self.v = Dense((c,), (kv, hd), dt, bias=False, device=device)
        self.out = Dense((h, hd), (c,), dt, bias=False, device=device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        cos, sin = rope_frequencies(self.head_dim, positions,
                                    self.cfg.rope_theta)
        q = apply_rope(self.q(x), cos, sin)
        k = apply_rope(self.k(x), cos, sin)
        v = self.v(x)
        if self.groups > 1:
            k = k.repeat_interleave(self.groups, dim=2)
            v = v.repeat_interleave(self.groups, dim=2)
        ctx = self.attn_fn(q, k, v, causal=True,
                           sm_scale=1.0 / math.sqrt(self.head_dim))
        return self.out(ctx)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        c, f, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        self.gate = Dense((c,), (f,), dt, bias=False, device=device)
        self.up = Dense((c,), (f,), dt, bias=False, device=device)
        self.down = Dense((f,), (c,), dt, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, attn_fn: Optional[AttnFn] = None,
                 device=None):
        super().__init__()
        c, dt = cfg.hidden_size, cfg.dtype
        self.attn_norm = RMSNorm(c, cfg.rms_eps, dt, device=device)
        self.attn = LlamaAttention(cfg, attn_fn, device=device)
        self.mlp_norm = RMSNorm(c, cfg.rms_eps, dt, device=device)
        self.mlp = LlamaMLP(cfg, device=device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """Decoder-only Llama on ``[B, T]`` token ids; ``positions`` (``[T]``
    or ``[B, T]``) defaults to ``arange(T)``.  Weights are drawn from
    ``generator`` (on ``device``)."""

    def __init__(self, cfg: LlamaConfig, attn_fn: Optional[AttnFn] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype,
                         device=device)
        self.h = nn.ModuleList(LlamaBlock(cfg, attn_fn, device=device)
                               for _ in range(cfg.num_layers))
        self.norm_f = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                              device=device)
        self.lm_head = Dense((cfg.hidden_size,), (cfg.vocab_size,),
                             cfg.dtype, bias=False, device=device)
        init_params(self, generator
                    or torch.Generator(device=device or "cpu").manual_seed(0))

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t = input_ids.shape
        if positions is None:
            positions = torch.arange(t, device=input_ids.device)
        if positions.dim() == 1:
            positions = positions[None]
        positions = positions.expand(b, t)
        x = self.wte(input_ids)
        for block in self.h:
            x = block(x, positions)
        return self.lm_head(self.norm_f(x)).float()


def load_flax_llama(model: Llama, params) -> Llama:
    """The JAX package's Llama parameters (``variables["params"]``) into a
    port :class:`Llama`."""
    return load_flax_params(model, params)
