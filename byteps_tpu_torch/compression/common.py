"""Helpers shared by the codecs; port of
``byteps_tpu/compression/common.py``, with the stable top-k that the
sparsifiers need.

``lax.top_k`` is stable: among equal scores the lower index comes first,
and its output is sorted by descending score.  ``torch.topk`` promises
neither.  Gradients carry exact zeros and ``+-x`` pairs, randomk's
scores collide after rounding to 24 bits, and dithering's codes are a
handful of small integers, so ties at the k-th place are the rule, not
the exception.  :func:`stable_topk` ranks unique int64 keys
``score << 32 | (0xFFFFFFFF - index)`` instead, which gives JAX's indices
in JAX's order.
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF


def resolve_k(k, numel: int) -> int:
    """``k`` may be an absolute count (int >= 1) or a fraction
    (0 < k < 1), as the reference's HyperParamFinder accepts."""
    if isinstance(k, float) and 0 < k < 1:
        k = max(1, int(round(k * numel)))
    k = int(k)
    if not 1 <= k <= numel:
        raise ValueError(f"k={k} out of range for numel={numel}")
    return k


def stable_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """int64 indices of the ``k`` largest of the non-negative 1-D
    ``scores`` (float32 or integer), by descending score and, among equal
    scores, ascending index: ``lax.top_k``'s order.  A non-negative
    float32 orders as its bit pattern does."""
    if scores.dtype == torch.float32:
        s = scores.view(torch.int32).to(torch.int64)
    else:
        s = scores.to(torch.int64)
    idx = torch.arange(scores.numel(), dtype=torch.int64,
                       device=scores.device)
    keys = (s << 32) | (_LOW32 - idx)
    top = torch.topk(keys, k, sorted=True).values
    return _LOW32 - (top & _LOW32)
