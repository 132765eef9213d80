"""Compressed push_pull of one chunk; port of
``byteps_tpu/comm/compressed.py``.

The reference's parameter-server cycle with compression,
``out = D_s(C_s(sum_i D_w(C_w(g_i))))``, without a server: each rank
compresses its chunk (the "push"), all-gathers only the compressed
payloads, merges every rank's payload in one pass (the "server";
onebit's merge is the ``onebit_unpack_sum`` kernel), and a bidirectional
codec re-compresses the merged sum so the "pull" is quantized too.

Every payload leaf crosses the wire as bytes: NCCL has no 16-bit
integer type, and dithering's sparse ``idx`` is uint16 (held as int16)
at chunks of up to 65535 elements.  A codec that is not bidirectional
(PowerSGD) skips the server pass, as in the JAX package's ``body``.

The JAX package compiles this into one program; here it is a plain
sequence of steps on the current stream.  Compressor state (the worker's
and the server's error-feedback residuals) is returned anew and the
states passed in are left as they were, so the caller decides when the
step counts (the engine commits at dispatch and rolls back on failure).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..compression.base import Compressor, State
from .mesh import CommContext


def _all_gather(comm: CommContext, t: torch.Tensor) -> torch.Tensor:
    """(*shape) on each rank -> (R, *shape), rows in rank order; the
    leaf travels as its bytes, whatever its dtype (a 0-d leaf comes back
    as (R,))."""
    flat = t.reshape(-1).contiguous().view(torch.uint8)
    out = flat.new_empty(comm.size * flat.numel())
    dist.all_gather_into_tensor(out, flat)
    return out.view(t.dtype).reshape((comm.size,) + tuple(t.shape))


def fused_compressed_push_pull(comm: CommContext, x: torch.Tensor,
                               worker: Compressor, server: Compressor,
                               worker_state: State,
                               server_state: State
                               ) -> Tuple[torch.Tensor, State, State]:
    """Reduce this rank's flat chunk ``x``: returns the merged sum (the
    caller divides for an average) in ``x.dtype``, and the new worker and
    server states."""
    payload, worker_state = worker.compress(x, worker_state)
    gathered = {k: _all_gather(comm, v) for k, v in payload.items()}
    y = worker.decompress_sum(gathered).to(torch.float32)
    if worker.bidirectional:
        p2, server_state = server.compress(y, server_state)
        y = server.decompress(p2).to(torch.float32)
    return y.to(x.dtype), worker_state, server_state
