"""Top-k sparsification; port of ``byteps_tpu/compression/topk.py``.

Keeps the ``k`` entries of largest magnitude as ``(indices int32, values
f32)``, in ``lax.top_k``'s order (descending ``|x|``, ties by lower index:
``common.stable_topk``), so the payload equals the JAX package's bit for
bit.  ``k`` is a count or a fraction of ``numel``.
"""

from __future__ import annotations

import torch

from .base import Compressor, Payload, State
from .common import resolve_k, stable_topk


def scatter(indices: torch.Tensor, values: torch.Tensor, numel: int,
            dtype: torch.dtype) -> torch.Tensor:
    """The dense chunk of a sparse payload: zeros, ``values`` set at
    ``indices`` (distinct, so the set is exact)."""
    out = torch.zeros(numel, dtype=torch.float32, device=values.device)
    out[indices.to(torch.int64)] = values.to(torch.float32)
    return out.to(dtype)


class TopkCompressor(Compressor):
    name = "topk"
    bidirectional = True

    def __init__(self, numel: int, dtype: torch.dtype = torch.float32,
                 k=0.01):
        super().__init__(numel, dtype)
        self.k = resolve_k(k, numel)

    def compress(self, x: torch.Tensor, state: State):
        xf = x.reshape(-1).to(torch.float32)
        idx = stable_topk(xf.abs(), self.k)
        return {"indices": idx.to(torch.int32), "values": xf[idx]}, state

    def decompress(self, payload: Payload) -> torch.Tensor:
        return scatter(payload["indices"], payload["values"], self.numel,
                       self.dtype)

    def payload_nbytes(self) -> int:
        return self.k * 8       # int32 index + f32 value

    def cache_key(self) -> tuple:
        return super().cache_key() + (self.k,)
