"""Intra-worker (framework-level) gradient compression for the MXNet
adapter; port of ``byteps_tpu/mxnet/compression.py`` (the same numpy
arithmetic).

Reference surface (byteps/mxnet/compression.py): a small framework-side
``Compressor`` chain applied *before* the tensor enters the engine —
distinct from the engine's wire compressors (``compression/``).
``NagAdapter`` / ``WeightDecayMomentumAdapter`` exist because the engine's
Nesterov-momentum decorator replaces the optimizer's own momentum
(momentum.h:25-44): the framework re-applies plain NAG to tensors the
engine skips (below the size threshold).

Duck-typed to the NDArray protocol (``asnumpy``/``[:]=``), same as ops.py.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np


def _size_bytes(tensor: Any) -> int:
    a = tensor.asnumpy()
    return a.size * a.dtype.itemsize


class Compressor:
    def compress(self, tensor: Any, *args, **kwargs) -> Tuple[Any, Any]:
        raise NotImplementedError

    def decompress(self, tensor: Any, ctx: Any, *args, **kwargs) -> Any:
        raise NotImplementedError


class NoneCompressor(Compressor):
    def compress(self, tensor, *args, **kwargs):
        return tensor, None

    def decompress(self, tensor, ctx, *args, **kwargs):
        return tensor


class FP16Compressor(Compressor):
    """Cast-to-fp16 on the wire; decompress casts back (reference
    mxnet/compression.py:50-67)."""

    def compress(self, tensor, *args, **kwargs):
        a = tensor.asnumpy()
        if a.dtype == np.float32 or a.dtype == np.float64:
            tensor[:] = a.astype(np.float16).astype(a.dtype)
            return tensor, a.dtype
        return tensor, None

    def decompress(self, tensor, ctx, *args, **kwargs):
        return tensor


class NagAdapter(Compressor):
    """Nesterov momentum re-applied framework-side to tensors below the
    engine's compression threshold (reference mxnet/compression.py:70-101):
    the engine's momentum decorator replaced the optimizer's momentum for
    large tensors, so small ones must get it here to train identically."""

    def __init__(self, compressor: Compressor, mu: float, threshold: int,
                 *args, **kwargs):
        self.compressor = compressor
        self.mu = float(mu)
        self.threshold = int(threshold)
        self._mom = {}

    def compress(self, tensor, *args, **kwargs):
        if _size_bytes(tensor) < self.threshold:
            g = tensor.asnumpy().astype(np.float64)
            key = id(tensor)
            m = self._mom.get(key)
            if m is None:
                m = np.zeros_like(g)
            m = self.mu * m + g
            self._mom[key] = m
            tensor[:] = (g + self.mu * m).astype(tensor.asnumpy().dtype)
        return self.compressor.compress(tensor, *args, **kwargs)

    def decompress(self, tensor, ctx, *args, **kwargs):
        return self.compressor.decompress(tensor, ctx, *args, **kwargs)


class WeightDecayMomentumAdapter(Compressor):
    """Weight-decay momentum for onebit (reference
    mxnet/compression.py:104-148).  The engine's onebit path strips ``wd``
    from the optimizer, so decompress re-applies it to *every* tensor
    (``g += wd*x``); tensors at/above the threshold additionally get the
    weight-decay momentum ``m_t = mu*(m_{t-1} + wd*x); g += m_t`` —
    matching the reference's gating exactly."""

    def __init__(self, compressor: Compressor, mu: float, wd: float,
                 threshold: int, *args, **kwargs):
        self.compressor = compressor
        self.mu = float(mu)
        self.wd = float(wd)
        self.threshold = int(threshold)
        self._mom = {}

    def compress(self, tensor, *args, **kwargs):
        return self.compressor.compress(tensor, *args, **kwargs)

    def decompress(self, tensor, ctx, x=None, *args, **kwargs):
        if x is None:
            raise ValueError("x is missing")
        g = tensor.asnumpy().astype(np.float64)
        xv = x.asnumpy().astype(np.float64)
        cache = self.wd * xv
        if _size_bytes(tensor) >= self.threshold:
            key = id(x)
            m = self._mom.get(key)
            if m is None:
                m = np.zeros_like(xv)
            m = self.mu * (m + cache)
            self._mom[key] = m
            g = g + m
        g = g + cache
        tensor[:] = g.astype(tensor.asnumpy().dtype)
        return self.compressor.decompress(tensor, ctx, *args, **kwargs)


class Compression:
    """Namespace matching the reference's ``Compression`` holder
    (mxnet/compression.py:151-)."""

    none = NoneCompressor()
    fp16 = FP16Compressor()

    @staticmethod
    def nag(compressor: Compressor, mu: float, threshold: int) -> Compressor:
        return NagAdapter(compressor, mu, threshold)

    @staticmethod
    def wdmom(compressor: Compressor, mu: float, wd: float,
              threshold: int) -> Compressor:
        return WeightDecayMomentumAdapter(compressor, mu, wd, threshold)
