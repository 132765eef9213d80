"""Compressor protocol; port of ``byteps_tpu/compression/base.py``.

A compressor works on flat 1-D chunks.  ``compress(x, state)`` returns a
payload (a dict of tensors, the wire format) and the state;
``decompress(payload)`` inverts it; ``decompress_sum(gathered)`` merges R
gathered payloads (leaves stacked on axis 0) into the f32 sum of their
decompressions, the "server sum" of the compressed all-reduce.
``bidirectional`` compressors are applied again to the merged sum.

The host wire frame of a payload (``wire_encode``/``wire_decode``) is the
JAX package's generic one, an ``np.savez`` archive of the payload's
leaves; onebit and dithering have frames of their own.

State is threaded functionally, as in the JAX package: ``compress``
returns a new state and never writes into the one it was given.  The
engine commits the new state when the chunk is dispatched and restores
the old one if the chunk fails (``core/engine.py``).
"""

from __future__ import annotations

import io
from typing import Any, Dict, Tuple

import numpy as np
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

    def payload_nbytes(self) -> int:
        """Bytes one compressed chunk puts on the wire."""
        return self.numel * self.dtype.itemsize

    def decompress_sum(self, gathered: Payload) -> torch.Tensor:
        """f32 sum over ranks of each gathered payload's decompression.
        Subclasses with a fused merge kernel override this."""
        R = next(iter(gathered.values())).shape[0]
        rows = [self.decompress({k: v[r] for k, v in gathered.items()})
                .to(torch.float32) for r in range(R)]
        return torch.stack(rows).sum(0)

    def cache_key(self) -> tuple:
        """Configuration identity: codecs with equal keys compute the same
        functions."""
        return (self.name, self.numel, str(self.dtype))

    # -- host wire frame -----------------------------------------------------
    def wire_encode(self, payload: Payload) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, **{k: v.detach().cpu().numpy()
                         for k, v in payload.items()})
        return buf.getvalue()

    def wire_decode(self, data: bytes) -> Payload:
        with np.load(io.BytesIO(data)) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}

    def wire_nbytes(self, payload: Payload) -> int:
        """Measured size of the payload's frame."""
        return len(self.wire_encode(payload))


class IdentityCompressor(Compressor):
    """No-op compressor (tensors below BYTEPS_MIN_COMPRESS_BYTES)."""

    name = "identity"
    bidirectional = False
