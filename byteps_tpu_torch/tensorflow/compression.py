"""TF-level compression shims (reference tensorflow/compression.py); port
of ``byteps_tpu/tensorflow/compression.py``.

Tensor-level cast compression (none | fp16) applied around push_pull in the
plugin, distinct from the core compressor engine — the heavy compressors
(onebit/topk/randomk/dithering) are reached by passing a kwargs dict to
push_pull/DistributedOptimizer and run inside the engine on its device
(the card).
"""

from __future__ import annotations

import tensorflow as tf


class NoneCompressor:
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor:
    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating:
            return tf.cast(tensor, tf.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None:
            return tf.cast(tensor, ctx)
        return tensor


class Compression:
    """Namespace mirroring the reference's ``bps.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
