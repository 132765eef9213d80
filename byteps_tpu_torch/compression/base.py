"""Compressor protocol; port of ``byteps_tpu/compression/base.py``.

A compressor works on flat 1-D chunks.  ``compress(x, state)`` returns a
payload (a dict of tensors, the wire format) and the state;
``decompress(payload)`` inverts it; ``decompress_sum(gathered)`` merges R
gathered payloads (leaves stacked on axis 0) into the f32 sum of their
decompressions, the "server sum" of the compressed all-reduce.
``bidirectional`` compressors are applied again to the merged sum.

The JAX package threads state functionally.  Here a compressor **updates
its state dict in place** (an error-feedback residual is overwritten, not
replaced) and returns the same dict, so the engine keeps one state per
chunk for the life of the tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Payload = Dict[str, Any]
State = Dict[str, Any]


class Compressor:
    """Base compressor: the identity transform."""

    name: str = "identity"
    bidirectional: bool = True

    def __init__(self, numel: int, dtype: torch.dtype = torch.float32):
        self.numel = int(numel)
        self.dtype = dtype

    def init_state(self, device: torch.device) -> State:
        return {}

    def compress(self, x: torch.Tensor, state: State) -> Tuple[Payload, State]:
        return {"values": x}, state

    def decompress(self, payload: Payload) -> torch.Tensor:
        return payload["values"]

    def decompress_sum(self, gathered: Payload) -> torch.Tensor:
        """f32 sum over ranks of each gathered payload's decompression.
        Subclasses with a fused merge kernel override this."""
        R = next(iter(gathered.values())).shape[0]
        rows = [self.decompress({k: v[r] for k, v in gathered.items()})
                .to(torch.float32) for r in range(R)]
        return torch.stack(rows).sum(0)


class IdentityCompressor(Compressor):
    """No-op compressor (tensors below BYTEPS_MIN_COMPRESS_BYTES)."""

    name = "identity"
    bidirectional = False
