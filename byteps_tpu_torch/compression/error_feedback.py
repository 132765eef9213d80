"""Error-feedback decorator; port of
``byteps_tpu/compression/error_feedback.py``.

``compress``: ``corrected = x + error``; compress ``corrected`` with the
inner codec; ``error = corrected - decompress(payload)``.  The residual is
kept in gradient space, as in the JAX package, and is overwritten in
place in the state dict.
"""

from __future__ import annotations

import torch

from .base import Compressor, State


class ErrorFeedback(Compressor):
    """Accumulate the compression residual into the next step."""

    name = "error_feedback"

    def __init__(self, inner: Compressor):
        super().__init__(inner.numel, inner.dtype)
        self.inner = inner
        self.bidirectional = inner.bidirectional

    def init_state(self, device: torch.device) -> State:
        return {"error": torch.zeros(self.numel, dtype=torch.float32,
                                     device=device),
                "inner": self.inner.init_state(device)}

    def compress(self, x: torch.Tensor, state: State):
        corrected = x.to(torch.float32) + state["error"]
        payload, state["inner"] = self.inner.compress(corrected,
                                                      state["inner"])
        decompressed = self.inner.decompress(payload).to(torch.float32)
        torch.sub(corrected, decompressed, out=state["error"])
        return payload, state

    def decompress(self, payload):
        return self.inner.decompress(payload)

    def decompress_sum(self, gathered):
        # the inner codec's fused merge runs under the decorator too
        return self.inner.decompress_sum(gathered)

    def wire_encode(self, payload):
        return self.inner.wire_encode(payload)

    def wire_decode(self, data):
        return self.inner.wire_decode(data)
