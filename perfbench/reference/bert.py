"""BERT (Devlin et al. 2019, arXiv:1810.04805) masked-LM pretraining in
plain float32.

The encoder as the configuration states it: word, position and segment
embeddings summed and layer-normalised; in each layer multi-head
self-attention (scores scaled by ``head_dim ** -0.5``, an additive mask
of -1e9 on masked keys, softmax, context, output projection), a residual
add and LayerNorm, then the feed-forward block (dense, GELU in its tanh
form, dense), a residual add and LayerNorm (post-LN, epsilon
``layer_norm_eps``); the masked-LM head on the masked positions only
(dense, GELU, LayerNorm, the decoder to the vocabulary with a bias, its
own matrix, not tied to the word table).  Cross-entropy is the mean over
every masked position of the batch.  Parameters keep the layouts the
configuration names (``(in, out)`` kernels, query, key and value
``(hidden, heads, head_dim)``, the output ``(heads, head_dim,
hidden)``).  Departures from the paper, as the configuration states
them: LayerNorm epsilon 1e-6 (the paper's code 1e-12), GELU's tanh form,
no dropout (phase 1 runs it at 0.1), the decoder not tied to the word
table, no next-sentence head.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..data import Leaf
from .numerics import Precision


def _dense(out: List[Leaf], prefix: str, k_in, k_out, bias_shape) -> None:
    out.append((f"{prefix}.kernel", tuple(k_in) + tuple(k_out),
                ("normal", 1.0 / math.sqrt(math.prod(k_in)))))
    out.append((f"{prefix}.bias", tuple(bias_shape), ("zeros",)))


def _ln(out: List[Leaf], prefix: str, h: int) -> None:
    out.append((f"{prefix}.scale", (h,), ("ones",)))
    out.append((f"{prefix}.bias", (h,), ("zeros",)))


def leaves(config: dict) -> List[Leaf]:
    h, n = config["hidden_size"], config["num_attention_heads"]
    d, f, v = h // n, config["intermediate_size"], config["vocab_size"]
    out: List[Leaf] = []
    for name, rows in (("word_embeddings", v),
                       ("position_embeddings",
                        config["max_position_embeddings"]),
                       ("token_type_embeddings", config["type_vocab_size"])):
        out.append((f"encoder.{name}.embedding", (rows, h),
                    ("normal", 1.0 / math.sqrt(h))))
    _ln(out, "encoder.ln_emb", h)
    for i in range(config["num_hidden_layers"]):
        pre = f"encoder.layer_{i}"
        for part in ("query", "key", "value"):
            _dense(out, f"{pre}.attention.{part}", (h,), (n, d), (n, d))
        _dense(out, f"{pre}.attention.out", (n, d), (h,), (h,))
        _ln(out, f"{pre}.ln_att", h)
        _dense(out, f"{pre}.mlp_in", (h,), (f,), (f,))
        _dense(out, f"{pre}.mlp_out", (f,), (h,), (h,))
        _ln(out, f"{pre}.ln_mlp", h)
    _dense(out, "mlm_transform", (h,), (h,), (h,))
    _ln(out, "mlm_ln", h)
    _dense(out, "mlm_out", (h,), (v,), (v,))
    return out


def _layer_norm(p, prefix: str, x: torch.Tensor, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * p[f"{prefix}.scale"]
            + p[f"{prefix}.bias"])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _mm(q: Precision, eq: str, a, b):
    return q(torch.einsum(eq, q(a), q(b)))


def logits(p: Dict[str, torch.Tensor], batch: dict, config: dict,
           q: Precision) -> torch.Tensor:
    """[B, P, V] logits at the masked positions."""
    eps = config["layer_norm_eps"]
    ids = batch["input_ids"]
    b, t = ids.shape
    h, n = config["hidden_size"], config["num_attention_heads"]
    x = (p["encoder.word_embeddings.embedding"][ids]
         + p["encoder.position_embeddings.embedding"][:t][None]
         + p["encoder.token_type_embeddings.embedding"][0][None, None])
    x = _layer_norm(p, "encoder.ln_emb", x, eps)
    mask = (1.0 - batch["attention_mask"].float()) * -1e9
    for i in range(config["num_hidden_layers"]):
        pre = f"encoder.layer_{i}.attention"
        qh, kh, vh = (_mm(q, "bth,hnd->btnd", x, p[f"{pre}.{w}.kernel"])
                      + p[f"{pre}.{w}.bias"] for w in ("query", "key",
                                                       "value"))
        scores = _mm(q, "btnd,bsnd->bnts", qh * (h // n) ** -0.5, kh)
        probs = torch.softmax(scores + mask[:, None, None, :], dim=-1)
        ctx = _mm(q, "bnts,bsnd->btnd", probs, vh)
        att = _mm(q, "btnd,ndh->bth", ctx, p[f"{pre}.out.kernel"]) \
            + p[f"{pre}.out.bias"]
        pre = f"encoder.layer_{i}"
        x = _layer_norm(p, f"{pre}.ln_att", x + att, eps)
        y = _gelu(_mm(q, "bth,hf->btf", x, p[f"{pre}.mlp_in.kernel"])
                  + p[f"{pre}.mlp_in.bias"])
        y = _mm(q, "btf,fh->bth", y, p[f"{pre}.mlp_out.kernel"]) \
            + p[f"{pre}.mlp_out.bias"]
        x = _layer_norm(p, f"{pre}.ln_mlp", x + y, eps)
    pos = batch["masked_positions"]
    x = torch.gather(x, 1, pos[..., None].expand(-1, -1, h))
    x = _gelu(_mm(q, "bph,hk->bpk", x, p["mlm_transform.kernel"])
              + p["mlm_transform.bias"])
    x = _layer_norm(p, "mlm_ln", x, eps)
    return _mm(q, "bph,hv->bpv", x, p["mlm_out.kernel"]) + p["mlm_out.bias"]


def loss(p: Dict[str, torch.Tensor], batch: dict, config: dict,
         q: Precision) -> torch.Tensor:
    """Mean cross-entropy over every masked position of the batch."""
    logp = F.log_softmax(logits(p, batch, config, q), dim=-1)
    return -logp.gather(-1, batch["masked_labels"][..., None]).mean()


# every row's loss is its own: a batch's mean loss is the mean of its
# blocks' means, weighted by their rows
ROWS_SEPARABLE = True
