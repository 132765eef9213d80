"""PowerSGD-style low-rank compression; port of
``byteps_tpu/compression/powersgd.py``.

The chunk, viewed as a near-square matrix ``M [n, m]`` (``m`` rounded
down to a multiple of 128 once it is at least 256, zero padding at the
end), is approximated by ``P Q'^T`` from ``iters`` warm-started power
iterations: ``P = orth(M Q)`` by a reduced QR, ``Q' = M^T P``, and
``Q'`` is the next step's start.  The first start is
``RandomState(seed).standard_normal((m, rank))``, the JAX package's.
The payload is ``(P, Q')``; the server sum ``sum_i P_i Q_i^T`` is one
batched product.  ``bidirectional`` is False: re-compressing the merged
sum to rank ``r`` would drop the cross-worker components it just built,
so the compressed push_pull skips the server pass.

On the card the products and the QR are cuBLAS's and cuSOLVER's, which
sum in another order than LAPACK and the CPU's BLAS: the port on the
card agrees with the port on the CPU to a tolerance, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Compressor, Payload, State


def _matrix_shape(numel: int):
    """Near-square ``[n, m]`` view of the flat chunk, ``n >= m``."""
    m = int(np.sqrt(numel))
    if m >= 256:
        m -= m % 128
    m = max(1, m)
    n = -(-numel // m)
    return n, m


class PowerSGDCompressor(Compressor):
    name = "powersgd"
    bidirectional = False

    def __init__(self, numel: int, dtype: torch.dtype = torch.float32,
                 rank: int = 4, seed: int = 0, iters: int = 1):
        super().__init__(numel, dtype)
        self.n, self.m = _matrix_shape(self.numel)
        self.rank = max(1, min(int(rank), self.n, self.m))
        self.seed = int(seed)
        self.iters = max(1, int(iters))

    def init_state(self, device) -> State:
        q0 = np.random.RandomState(self.seed).standard_normal(
            (self.m, self.rank)).astype(np.float32)
        return {"q": torch.from_numpy(q0).to(device)}

    def _as_matrix(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.reshape(-1).to(torch.float32)
        pad = self.n * self.m - self.numel
        if pad:
            xf = torch.nn.functional.pad(xf, (0, pad))
        return xf.reshape(self.n, self.m)

    def compress(self, x: torch.Tensor, state: State):
        M = self._as_matrix(x)
        Q = state["q"]
        for _ in range(self.iters):
            P, _ = torch.linalg.qr(M @ Q)           # [n, r]
            Q = M.T @ P                             # [m, r]
        return {"p": P, "q": Q}, {"q": Q}

    def decompress(self, payload: Payload) -> torch.Tensor:
        M = payload["p"] @ payload["q"].T
        return M.reshape(-1)[:self.numel].to(self.dtype)

    def decompress_sum(self, gathered: Payload) -> torch.Tensor:
        s = torch.einsum("bnr,bmr->nm", gathered["p"], gathered["q"])
        return s.reshape(-1)[:self.numel]

    def payload_nbytes(self) -> int:
        return (self.n + self.m) * self.rank * 4

    def cache_key(self) -> tuple:
        return super().cache_key() + (self.rank, self.seed, self.iters)
