"""The gradient compression engine; port of ``byteps_tpu/compression``.

Codecs (onebit, topk, randomk, dithering, PowerSGD) and the
error-feedback and Nesterov-momentum decorators, each a pair of
functions over ``(tensor, state)`` with the state threaded explicitly.
The onebit pack, unpack and merge run as the CUDA kernels of
``csrc/onebit.cu`` on the card; the others are plain torch operations,
as the JAX package computes them with plain ``jnp`` operations.
"""

from .base import Compressor, IdentityCompressor  # noqa: F401
from .dithering import DitheringCompressor  # noqa: F401
from .error_feedback import ErrorFeedback  # noqa: F401
from .momentum import NesterovMomentum  # noqa: F401
from .onebit import OnebitCompressor  # noqa: F401
from .powersgd import PowerSGDCompressor  # noqa: F401
from .randomk import RandomkCompressor  # noqa: F401
from .registry import create  # noqa: F401
from .topk import TopkCompressor  # noqa: F401
