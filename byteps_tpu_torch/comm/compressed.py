"""Compressed push_pull of one chunk; port of
``byteps_tpu/comm/compressed.py``.

The reference's parameter-server cycle with compression,
``out = D_s(C_s(sum_i D_w(C_w(g_i))))``, without a server: each rank
compresses its chunk (the "push"), all-gathers only the compressed
payloads, merges every rank's payload in one pass (the "server";
onebit's merge is the ``onebit_unpack_sum`` kernel), and a bidirectional
codec re-compresses the merged sum so the "pull" is quantized too.

The JAX package compiles this into one program; here it is a plain
sequence of steps on the current stream.  Compressor state (the worker's
and the server's error-feedback residuals) is **updated in place**.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..compression.base import Compressor, State
from .mesh import CommContext


def _all_gather(comm: CommContext, t: torch.Tensor) -> torch.Tensor:
    """(*shape) on each rank -> (R, *shape), rows in rank order."""
    flat = t.reshape(-1).contiguous()
    out = flat.new_empty(comm.size * flat.numel())
    dist.all_gather_into_tensor(out, flat)
    return out.reshape((comm.size,) + tuple(t.shape))


def fused_compressed_push_pull(comm: CommContext, x: torch.Tensor,
                               worker: Compressor, server: Compressor,
                               worker_state: State,
                               server_state: State) -> torch.Tensor:
    """Reduce this rank's flat chunk ``x``: returns the merged sum (the
    caller divides for an average) in ``x.dtype``."""
    payload, _ = worker.compress(x, worker_state)
    gathered = {k: _all_gather(comm, v) for k, v in payload.items()}
    y = worker.decompress_sum(gathered).to(torch.float32)
    if worker.bidirectional:
        p2, _ = server.compress(y, server_state)
        y = server.decompress(p2).to(torch.float32)
    return y.to(x.dtype)
