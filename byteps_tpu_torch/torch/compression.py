"""Tensor-level compression shims; port of
``byteps_tpu/torch/compression.py``.

The reference's ``bps.Compression`` enum (``none`` | ``fp16``), applied
by the caller around a push_pull.  The engine's codecs (onebit, topk,
randomk, dithering, PowerSGD) are reached instead by passing a kwargs
dict as ``compression=`` to ``push_pull`` or a wrapper.
"""

from __future__ import annotations

import torch


class NoneCompressor:
    @staticmethod
    def compress(tensor: torch.Tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        return tensor


class FP16Compressor:
    @staticmethod
    def compress(tensor: torch.Tensor):
        if tensor.dtype.is_floating_point:
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        if ctx is not None:
            return tensor.to(ctx)
        return tensor


class Compression:
    """The reference's ``bps.Compression`` namespace."""

    none = NoneCompressor
    fp16 = FP16Compressor
