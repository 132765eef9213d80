"""Onebit (sign) compression with L1-mean scaling; port of
``byteps_tpu/compression/onebit.py``.

Signs are packed 32 per word in the JAX package's layout
(``ops/onebit_kernels.py``); with ``scaling`` the payload carries
``mean(|x|)`` (the L1 sum over the chunk's ``numel``, not over the padded
length) and decompression returns ``sign * scale``.  Bidirectional: the
server re-compresses the merged sum.  On the card the pack, the unpack
and the merge are the CUDA kernels of ``csrc/onebit.cu``.

The host wire frame is byte-identical to the JAX package's
(``onebit.py:89-117``): little-endian ``u32 nwords | f32 scale | words``
with ``nwords = padded_lanes(numel)``, so a frame from either package
decodes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import onebit_kernels as ok
from .base import Compressor, Payload, State


class OnebitCompressor(Compressor):
    name = "onebit"
    bidirectional = True

    def __init__(self, numel: int, dtype: torch.dtype = torch.float32,
                 scaling: bool = True):
        super().__init__(numel, dtype)
        self.scaling = scaling
        self._lanes = ok.padded_lanes(numel)      # words per chunk (L)

    def compress(self, x: torch.Tensor, state: State):
        words, sums = ok.onebit_pack(
            x.reshape(-1).to(torch.float32).contiguous())
        scale = (sums[1] if self.scaling
                 else torch.ones((), dtype=torch.float32, device=x.device))
        return {"words": words, "scale": scale}, state

    def decompress(self, payload: Payload) -> torch.Tensor:
        out = ok.onebit_unpack(payload["words"], payload["scale"], self.numel)
        return out.to(self.dtype)

    def decompress_sum(self, gathered: Payload) -> torch.Tensor:
        return ok.onebit_unpack_sum(gathered["words"], gathered["scale"],
                                    self.numel)

    def payload_nbytes(self) -> int:
        return self._lanes * 4 + 4      # words and the scale

    def wire_encode(self, payload: Payload) -> bytes:
        words = payload["words"].detach().cpu().numpy().view(np.uint32)
        header = (np.uint32(len(words)).astype("<u4").tobytes()
                  + np.float32(float(payload["scale"])).astype("<f4")
                  .tobytes())
        return header + words.astype("<u4").tobytes()

    def wire_nbytes(self, payload: Payload) -> int:
        return 8 + 4 * self._lanes

    def cache_key(self) -> tuple:
        return super().cache_key() + (self.scaling,)

    def wire_decode(self, data: bytes) -> Payload:
        if len(data) < 8:
            raise ValueError("onebit wire frame shorter than its header")
        nwords = int(np.frombuffer(data[:4], "<u4")[0])
        if nwords != self._lanes:
            # untrusted input: a forged count must not dictate shapes
            raise ValueError(
                f"onebit wire frame carries {nwords} words, "
                f"expected {self._lanes}")
        if len(data) < 8 + 4 * nwords:
            raise ValueError("onebit wire frame truncated")
        scale = float(np.frombuffer(data[4:8], "<f4")[0])
        words = np.frombuffer(data[8:8 + 4 * nwords], "<u4")
        return {"words": torch.from_numpy(
                    words.astype(np.uint32).view(np.int32).copy()),
                "scale": torch.tensor(scale, dtype=torch.float32)}
