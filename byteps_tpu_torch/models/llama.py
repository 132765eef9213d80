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
  (:func:`repeat_kv`, as ``jnp.repeat``), so the attention callable sees
  as many K/V heads as query heads;
- logits in f32;
- ``remat`` checkpoints each block, as ``models/gpt.py`` does.

``Llama(cfg, tp_axis=..., fsdp_axis=...)`` lays the model out by
``parallel/fsdp_tp.py``'s rules: q/k/v and gate/up column-parallel over
``tp``, out and down row-parallel, the word table and the head sliced on
the vocabulary, and the other large axis of every weight sliced over
``fsdp`` and gathered for each product (``parallel/tp_layers.py``).  When
the K/V heads do not split over ``tp`` they stay whole while the query
heads split: local query head ``j`` of tp rank ``r`` then reads K/V head
``(r * H / tp + j) // groups`` (:func:`kv_heads`), and the K/V kernels'
gradients are partial sums over ``tp`` (their ``partial_axis``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.sequence import full_attention
from ..parallel.tp_layers import at, copy_to
from .gpt import (AttnFn, Dense, Embed, head_token_nll, init_params,
                  load_flax_params, run_block)
from .gpt import lm_loss, token_nll  # noqa: F401 — the shared LM loss

__all__ = [
    "LlamaConfig", "Llama", "llama3_8b", "llama_tiny", "llama_tiny_f32",
    "lm_loss", "token_nll", "rope_frequencies", "apply_rope",
    "load_flax_llama", "kv_heads", "repeat_kv",
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
    remat: bool = False              # checkpoint each block

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

def kv_heads(tp_index: int, q_heads: int, groups: int, kv_heads_here: int,
             kv_split: bool, device=None) -> torch.Tensor:
    """The K/V head (an index into this rank's K/V heads) each of this
    rank's ``q_heads`` query heads reads: query head ``tp_index * q_heads
    + j`` reads K/V head ``(tp_index * q_heads + j) // groups``, offset to
    this rank's K/V slice when the K/V heads split too."""
    q = tp_index * q_heads + torch.arange(q_heads, device=device)
    kv = q // groups
    if kv_split:
        kv = kv - tp_index * kv_heads_here
    return kv


def repeat_kv(x: torch.Tensor, idx: torch.Tensor,
              groups: int) -> torch.Tensor:
    """``x.index_select(2, idx)`` for the K/V heads ``idx`` (on the host)
    of consecutive query heads, as :func:`kv_heads` gives them: each K/V
    head from ``idx[0]`` to ``idx[-1]`` broadcast over ``groups`` query
    heads, then the window of them ``idx`` covers.  Its backward sums each
    head's broadcast in a fixed order, where ``index_select``'s adds by
    atomics on the card and two backward passes would differ in their
    last bits."""
    lo, hi = int(idx[0]), int(idx[-1]) + 1
    start = groups - int((idx == idx[0]).sum())
    b, t, _, d = x.shape
    y = x[:, :, lo:hi, None].expand(b, t, hi - lo, groups, d)
    return y.reshape(b, t, (hi - lo) * groups, d)[:, :, start:
                                                   start + idx.numel()]


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, attn_fn: Optional[AttnFn] = None,
                 device=None, layout=None):
        super().__init__()
        c, h, kv = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads
        self.cfg = cfg
        self.head_dim = hd = c // h
        self.groups = h // kv
        self.attn_fn = attn_fn or full_attention
        dt = cfg.dtype
        self.q = Dense((c,), (h, hd), dt, bias=False, device=device,
                       layout=at(layout, "q"))
        self.k = Dense((c,), (kv, hd), dt, bias=False, device=device,
                       layout=at(layout, "k"))
        self.v = Dense((c,), (kv, hd), dt, bias=False, device=device,
                       layout=at(layout, "v"))
        self.out = Dense((h, hd), (c,), dt, bias=False, device=device,
                         layout=at(layout, "out"))
        tp = self.q.col_axis
        if self.k.col_axis is not tp:
            if tp is None:
                raise ValueError("K/V heads split where query heads do not")
            # whole K/V heads under split query heads: each rank's K/V
            # gradient covers the heads its queries read
            self.k.partial_axis = self.v.partial_axis = tp

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        tp = self.q.col_axis
        x = copy_to(x, tp)
        cos, sin = rope_frequencies(self.head_dim, positions,
                                    self.cfg.rope_theta)
        q = apply_rope(self.q(x), cos, sin)
        k = apply_rope(self.k(x), cos, sin)
        v = self.v(x)
        if self.groups > 1:
            idx = kv_heads(0 if tp is None else tp.index, q.shape[2],
                           self.groups, k.shape[2],
                           self.k.col_axis is not None)
            k, v = repeat_kv(k, idx, self.groups), repeat_kv(v, idx,
                                                             self.groups)
        ctx = self.attn_fn(q, k, v, causal=True,
                           sm_scale=1.0 / math.sqrt(self.head_dim))
        return self.out(ctx)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, layout=None):
        super().__init__()
        c, f, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        self.gate = Dense((c,), (f,), dt, bias=False, device=device,
                          layout=at(layout, "gate"))
        self.up = Dense((c,), (f,), dt, bias=False, device=device,
                        layout=at(layout, "up"))
        self.down = Dense((f,), (c,), dt, bias=False, device=device,
                          layout=at(layout, "down"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to(x, self.gate.col_axis)
        return self.down(F.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, attn_fn: Optional[AttnFn] = None,
                 device=None, layout=None):
        super().__init__()
        c, dt = cfg.hidden_size, cfg.dtype
        self.attn_norm = RMSNorm(c, cfg.rms_eps, dt, device=device)
        self.attn = LlamaAttention(cfg, attn_fn, device=device,
                                   layout=at(layout, "attn"))
        self.mlp_norm = RMSNorm(c, cfg.rms_eps, dt, device=device)
        self.mlp = LlamaMLP(cfg, device=device, layout=at(layout, "mlp"))

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """Decoder-only Llama on ``[B, T]`` token ids; ``positions`` (``[T]``
    or ``[B, T]``) defaults to ``arange(T)``.  Weights are drawn from
    ``generator`` (on ``device``), leaf by leaf, each rank keeping its
    slice where ``tp_axis`` / ``fsdp_axis`` lay the model out (see the
    module docstring); the logits are then this rank's vocabulary slice
    (:meth:`token_nll` takes them)."""

    def __init__(self, cfg: LlamaConfig, attn_fn: Optional[AttnFn] = None,
                 device=None, generator: Optional[torch.Generator] = None,
                 tp_axis=None, fsdp_axis=None):
        super().__init__()
        self.cfg = cfg
        layout = None
        if tp_axis is not None or fsdp_axis is not None:
            from ..parallel.fsdp_tp import llama_layout
            layout = llama_layout(tp_axis, fsdp_axis)
        self.mesh_axes = {"tp": tp_axis, "fsdp": fsdp_axis}
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype,
                         device=device, layout=at(layout, "wte"))
        self.h = nn.ModuleList(
            LlamaBlock(cfg, attn_fn, device=device,
                       layout=at(layout, f"h{i}"))
            for i in range(cfg.num_layers))
        self.norm_f = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype,
                              device=device)
        self.lm_head = Dense((cfg.hidden_size,), (cfg.vocab_size,),
                             cfg.dtype, bias=False, device=device,
                             layout=at(layout, "lm_head"))
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
            x = run_block(block, self.cfg.remat, x, positions)
        h = copy_to(self.norm_f(x), self.lm_head.col_axis)
        return self.lm_head(h).float()

    def token_nll(self, logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -1):
        """``token_nll`` of this model's logits: vocabulary-parallel where
        ``lm_head`` is sliced on the vocabulary."""
        return head_token_nll(self.lm_head, logits, labels, ignore)


def load_flax_llama(model: Llama, params) -> Llama:
    """The JAX package's Llama parameters (``variables["params"]``) into a
    port :class:`Llama`; a laid-out model takes its rank's slices."""
    return load_flax_params(model, params)
