"""Nesterov-momentum decorator; port of
``byteps_tpu/compression/momentum.py``.

``m = mu * m + g``, then the inner codec compresses ``g + mu * m``.  It
runs on the worker only (the registry skips it for the server chain) and
replaces the optimizer's own momentum: pair it with a momentum-free
optimizer.  The new momentum is returned in a fresh state dict, as every
codec here returns its state.
"""

from __future__ import annotations

import torch

from .base import Compressor, State


class NesterovMomentum(Compressor):
    name = "nesterov_momentum"

    def __init__(self, inner: Compressor, mu: float = 0.9):
        super().__init__(inner.numel, inner.dtype)
        self.inner = inner
        self.mu = float(mu)
        self.bidirectional = inner.bidirectional

    def init_state(self, device) -> State:
        return {"momentum": torch.zeros(self.numel, dtype=torch.float32,
                                        device=device),
                "inner": self.inner.init_state(device)}

    def compress(self, x: torch.Tensor, state: State):
        xf = x.reshape(-1).to(torch.float32)
        m = self.mu * state["momentum"] + xf
        boosted = xf + self.mu * m
        payload, inner = self.inner.compress(boosted, state["inner"])
        return payload, {"momentum": m, "inner": inner}

    def decompress(self, payload):
        return self.inner.decompress(payload)

    def decompress_sum(self, gathered):
        # the inner codec's fused merge runs under the decorator too
        return self.inner.decompress_sum(gathered)

    def payload_nbytes(self) -> int:
        return self.inner.payload_nbytes()

    def cache_key(self) -> tuple:
        return ("nesterov", self.mu) + self.inner.cache_key()

    # the wire format is the inner codec's: a decorator changes how state
    # is threaded, not the payload
    def wire_encode(self, payload):
        return self.inner.wire_encode(payload)

    def wire_decode(self, data):
        return self.inner.wire_decode(data)

    def wire_nbytes(self, payload) -> int:
        return self.inner.wire_nbytes(payload)
