"""BERT encoder and its masked-LM head, the benchmark's flagship model;
port of ``byteps_tpu/models/bert.py``.

Parameters keep flax's names and layouts, so :func:`load_flax_bert` is a
copy (``models/gpt.py``'s ``load_flax_params``): the query, key and value
kernels are ``DenseGeneral`` ``(C, heads, head_dim)`` with biases
``(heads, head_dim)``, ``out`` contracts the last two axes of its input
with a ``(heads, head_dim, C)`` kernel, ``Dense`` kernels are ``(in,
out)``, and layer ``i`` is the submodule ``encoder.layer_{i}``.

Numerics follow the JAX model with ``dtype=cfg.dtype`` (bf16) over f32
parameters, through ``models/gpt.py``'s flax-mirroring ``Dense``,
``Embed`` and ``LayerNorm``, rounding where it rounds:

- the three embeddings are cast to bf16 and added in bf16;
- ``q * scale`` in bf16, with ``scale = head_dim ** -0.5`` taken in bf16;
- the logits come out of the product in bf16, the additive mask
  (``(1 - mask) * -1e9`` cast to bf16) is added in bf16, the softmax
  runs in f32 and is cast back to bf16, and the context product is bf16;
- LayerNorm (epsilon 1e-6) takes f32 statistics and returns bf16;
- ``gelu`` is the tanh form (``jax.nn.gelu``'s default), in the MLP and
  the MLM transform;
- logits are returned in f32.

Attention is a plain product, softmax, product, as in the JAX model,
which runs no attention kernel.  ``remat`` checkpoints each encoder
layer (``torch.utils.checkpoint``, non-reentrant).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .gpt import Dense, Embed, LayerNorm, init_params, load_flax_params
from .gpt import run_block

__all__ = [
    "BertConfig", "bert_large", "bert_base", "bert_tiny", "SelfAttention",
    "EncoderLayer", "BertEncoder", "BertForMLM", "mlm_loss",
    "synthetic_batch", "load_flax_bert",
]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528          # 30522 rounded up to a multiple of 64
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position: int = 512
    type_vocab_size: int = 2
    # kept for the JAX config's shape: neither model applies dropout
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16   # compute; parameters stay f32
    remat: bool = False              # checkpoint each encoder layer


def bert_large() -> BertConfig:
    return BertConfig()


def bert_base() -> BertConfig:
    return BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                      intermediate_size=3072)


def bert_tiny() -> BertConfig:
    """CPU tests."""
    return BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                      num_heads=2, intermediate_size=256, max_position=128)


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        c, h = cfg.hidden_size, cfg.num_heads
        self.head_dim = c // h
        self.dtype = cfg.dtype
        self.query = Dense((c,), (h, self.head_dim), cfg.dtype, device=device)
        self.key = Dense((c,), (h, self.head_dim), cfg.dtype, device=device)
        self.value = Dense((c,), (h, self.head_dim), cfg.dtype, device=device)
        self.out = Dense((h, self.head_dim), (c,), cfg.dtype, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``x`` [B, T, C]; ``mask`` [B, T] additive, in the compute
        dtype."""
        q, k, v = self.query(x), self.key(x), self.value(x)   # [B, T, H, D]
        scale = torch.tensor(float(self.head_dim), dtype=self.dtype,
                             device=x.device) ** -0.5
        q = (q * scale).transpose(1, 2)                        # [B, H, T, D]
        logits = torch.matmul(q, k.permute(0, 2, 3, 1))        # [B, H, T, T]
        logits = logits + mask[:, None, None, :]
        probs = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        ctx = torch.matmul(probs, v.transpose(1, 2))           # [B, H, T, D]
        return self.out(ctx.transpose(1, 2))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        c, dt = cfg.hidden_size, cfg.dtype
        self.attention = SelfAttention(cfg, device=device)
        self.ln_att = LayerNorm(c, dt, device=device)
        self.mlp_in = Dense((c,), (cfg.intermediate_size,), dt, device=device)
        self.mlp_out = Dense((cfg.intermediate_size,), (c,), dt,
                             device=device)
        self.ln_mlp = LayerNorm(c, dt, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.ln_att(x + self.attention(x, mask))
        h = F.gelu(self.mlp_in(x), approximate="tanh")
        return self.ln_mlp(x + self.mlp_out(h))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype
        self.word_embeddings = Embed(cfg.vocab_size, c, dt, device=device)
        self.position_embeddings = Embed(cfg.max_position, c, dt,
                                         device=device)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, c, dt,
                                           device=device)
        self.ln_emb = LayerNorm(c, dt, device=device)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", EncoderLayer(cfg, device=device))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        b, t = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(b, t, dtype=torch.int32,
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(t, device=input_ids.device)[None]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        x = self.ln_emb(x)
        # additive attention mask: 0 keeps a key, -1e9 drops it
        mask = ((1.0 - attention_mask.float()) * -1e9).to(cfg.dtype)
        for i in range(cfg.num_layers):
            x = run_block(getattr(self, f"layer_{i}"), cfg.remat, x, mask)
        return x


class BertForMLM(nn.Module):
    """The masked-LM head over :class:`BertEncoder`.

    With ``masked_positions`` ([B, P] indices) the head runs only on the
    masked tokens ([B, P, V] logits, the benchmark's gathered head);
    without it, on every position ([B, T, V]).  Weights are drawn from
    ``generator`` (on ``device``)."""

    def __init__(self, cfg: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype
        self.encoder = BertEncoder(cfg, device=device)
        self.mlm_transform = Dense((c,), (c,), dt, device=device)
        self.mlm_ln = LayerNorm(c, dt, device=device)
        self.mlm_out = Dense((c,), (cfg.vocab_size,), dt, device=device)
        init_params(self, generator
                    or torch.Generator(device=device or "cpu").manual_seed(0))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                masked_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.encoder(input_ids, attention_mask)
        if masked_positions is not None:
            idx = masked_positions.long()[..., None].expand(-1, -1,
                                                            x.shape[-1])
            x = torch.gather(x, 1, idx)
        x = F.gelu(self.mlm_transform(x), approximate="tanh")
        x = self.mlm_ln(x)
        return self.mlm_out(x).float()


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy over the masked positions (labels < 0 are
    unmasked), weighted, over ``max(sum of weights, 1)``."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    w = valid.float()
    if weights is not None:
        w = w * weights
    return -(ll * w).sum() / w.sum().clamp_min(1.0)


def synthetic_batch(generator: torch.Generator, cfg: BertConfig, batch: int,
                    seq_len: int, mask_frac: float = 0.15, device=None):
    """A synthetic pretraining batch drawn from ``generator`` (the JAX
    function's structure; its values come from another generator).

    Exactly ``P = max(1, int(seq_len * mask_frac))`` positions of each
    example are masked, so the gathered head has static shapes:
    ``masked_positions`` / ``masked_labels`` ([B, P], positions sorted)
    feed ``BertForMLM(..., masked_positions=...)``, and ``labels`` ([B,
    T], -1 where unmasked) serves the full head.  Masked input ids are 0.
    Index tensors are int64 (torch's index dtype; the JAX batch's are
    int32).  The tensors are drawn on the generator's device and moved to
    ``device``."""
    gdev = generator.device
    ids = torch.randint(0, cfg.vocab_size, (batch, seq_len),
                        generator=generator, device=gdev)
    n_pred = max(1, int(seq_len * mask_frac))
    order = torch.rand(batch, seq_len, generator=generator,
                       device=gdev).argsort(dim=1)
    positions = order[:, :n_pred].sort(dim=1).values
    is_masked = torch.zeros(batch, seq_len, dtype=torch.bool, device=gdev)
    is_masked.scatter_(1, positions, True)
    out = {"input_ids": torch.where(is_masked, torch.zeros_like(ids), ids),
           "labels": torch.where(is_masked, ids, torch.full_like(ids, -1)),
           "attention_mask": torch.ones(batch, seq_len, dtype=torch.int64,
                                        device=gdev),
           "masked_positions": positions,
           "masked_labels": torch.gather(ids, 1, positions)}
    return {k: v.to(device or gdev) for k, v in out.items()}


def load_flax_bert(model: BertForMLM, params) -> BertForMLM:
    """The JAX package's ``BertForMLM`` parameters
    (``variables["params"]``, numpy arrays) into a port
    :class:`BertForMLM`."""
    return load_flax_params(model, params)
