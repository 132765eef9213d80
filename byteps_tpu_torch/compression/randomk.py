"""Random-k sparsification; port of ``byteps_tpu/compression/randomk.py``.

The ``k`` indices are the top-k of the counter-based PRNG's scores
(``prng.uniform(seed, counter, numel)``), and the counter advances by
``numel`` each step, so every step draws fresh indices and every replica
with the same seed draws the same ones.  The scores are ``float32(z) /
2**32``: distinct hashes collide after rounding to 24 bits, so at a
million elements ties at the k-th place are likely, and the stable
top-k of ``common.stable_topk`` is what keeps the JAX indices.  The
counter is a 0-d int64 tensor holding the JAX package's uint32 value.
"""

from __future__ import annotations

import torch

from . import prng
from .base import Compressor, Payload, State
from .common import resolve_k, stable_topk
from .topk import scatter


class RandomkCompressor(Compressor):
    name = "randomk"
    bidirectional = True

    def __init__(self, numel: int, dtype: torch.dtype = torch.float32,
                 k=0.01, seed: int = 0):
        super().__init__(numel, dtype)
        self.k = resolve_k(k, numel)
        self.seed = int(seed)

    def init_state(self, device) -> State:
        return {"counter": torch.zeros((), dtype=torch.int64, device=device)}

    def compress(self, x: torch.Tensor, state: State):
        xf = x.reshape(-1).to(torch.float32)
        scores = prng.uniform(self.seed, state["counter"], self.numel)
        idx = stable_topk(scores, self.k)
        counter = (state["counter"] + self.numel) & prng._M32
        return ({"indices": idx.to(torch.int32), "values": xf[idx]},
                {"counter": counter})

    def decompress(self, payload: Payload) -> torch.Tensor:
        return scatter(payload["indices"], payload["values"], self.numel,
                       self.dtype)

    def payload_nbytes(self) -> int:
        return self.k * 8

    def cache_key(self) -> tuple:
        return super().cache_key() + (self.k, self.seed)
