"""Attention kinds for the language models; port of the single-device part
of ``byteps_tpu/parallel/sequence.py``.

:func:`full_attention` is the exact oracle and the models' default
attention.  :func:`resolve_sp_attention` is the switch the training step
uses; the port has two kinds so far, ``"flash"`` (the CUDA flash kernels,
``ops/flash_attention.py``) and ``"full"`` (exact attention).  The
sequence-parallel kinds of the JAX package (ring, striped, ring_flash,
Ulysses) are not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch

from ..ops.flash_attention import flash_attention

# finite stand-in for -inf: exp(_NEG - anything real) is exactly 0 in f32
_NEG = -1e30

_NOT_PORTED = ("ring", "striped", "ring_flash", "ulysses", "ulysses_flash")


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention.  ``[B, Tq, H, D] x [B, Tk, H, D] -> [B, Tq, H,
    D]``; scores in f32, probabilities cast to V's type for the product.
    With ``causal`` the query rows are the last ``Tq`` key positions."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = (k.shape[1] - q.shape[1]) + torch.arange(q.shape[1],
                                                         device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)


def resolve_sp_attention(kind: str, *, sp: int = 1, **bound) -> Callable:
    """The attention callable of ``kind``, with ``bound`` kwargs (causal,
    sm_scale) bound onto it.  ``sp`` is the sequence-parallel degree; both
    ported kinds run local attention and need ``sp == 1``."""
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"sequence-parallel attention {kind!r} is not ported to "
            f"byteps_tpu_torch yet (ROADMAP.md, Queue A)")
    if kind == "flash":
        fn = flash_attention
    elif kind == "full":
        fn = full_attention
    else:
        raise ValueError(f"unknown attention kind: {kind!r}")
    if sp != 1:
        raise ValueError(f"attention={kind!r} runs local attention and "
                         f"needs sp=1, got sp={sp}")
    return functools.partial(fn, **bound)
