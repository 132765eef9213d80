"""Counter-based PRNG of the randomized codecs; port of
``byteps_tpu/compression/prng.py``, bit for bit.

A murmur3-style integer hash of ``(seed, counter + lane)``: every lane is
independent, so it vectorizes.  The JAX package computes it in uint32
with wraparound.  torch's uint32 has only partial kernel coverage, so
here each uint32 value lives in an int64 tensor and every product is
taken in 16-bit halves and masked to its low 32 bits, which are the
uint32 product's (no int64 product can overflow).  The final
``uint32 -> float32`` conversion rounds to nearest in both packages,
so a hash near 2**32 reads as 1.0 in both.

:func:`uniform_np` is the numpy twin (the test oracle, and the JAX
package's ``uniform_np``).
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_KNUTH = 2654435761
_M32 = 0xFFFFFFFF


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """``(z * c) mod 2**32`` for int64 ``z`` in [0, 2**32) and a uint32
    constant: ``z = hi * 2**16 + lo``, so ``z * c = lo * c + (hi * c
    mod 2**16) << 16 (mod 2**32)``, each product under 2**48."""
    lo = z & 0xFFFF
    hi = z >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix(z: torch.Tensor) -> torch.Tensor:
    z = z ^ (z >> 16)
    z = _mul32(z, _C1)
    z = z ^ (z >> 13)
    z = _mul32(z, _C2)
    return z ^ (z >> 16)


def uniform(seed: int, counter, n: int, device=None) -> torch.Tensor:
    """``n`` float32 values in [0, 1], deterministic in (seed, counter,
    lane).  ``counter`` is an int or a 0-d int64 tensor (a codec's state,
    which then gives the device)."""
    if isinstance(counter, torch.Tensor):
        device = counter.device
    idx = (torch.arange(n, dtype=torch.int64, device=device) + counter) & _M32
    z = (_mul32(idx, _KNUTH) + ((int(seed) & _M32) * _GOLDEN & _M32)) & _M32
    z = _mix(z)
    return z.to(torch.float32) / 4294967296.0     # 2**32, exact


def _mix_np(z: np.ndarray) -> np.ndarray:
    z = z ^ (z >> np.uint32(16))
    z = (z * np.uint32(_C1)).astype(np.uint32)
    z = z ^ (z >> np.uint32(13))
    z = (z * np.uint32(_C2)).astype(np.uint32)
    return z ^ (z >> np.uint32(16))


def uniform_np(seed: int, counter: int, n: int) -> np.ndarray:
    """Numpy twin of :func:`uniform`; equal bit for bit."""
    with np.errstate(over="ignore"):
        idx = np.arange(n, dtype=np.uint32) + np.uint32(counter)
        z = (idx * np.uint32(_KNUTH)
             + np.uint32(seed) * np.uint32(_GOLDEN)).astype(np.uint32)
        z = _mix_np(z)
    return z.astype(np.float32) / np.float32(2**32)
