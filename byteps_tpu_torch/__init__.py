"""byteps_tpu_torch: the PyTorch/CUDA port of ``byteps_tpu``.

A second package beside the JAX one, which stays the reference.  It
imports torch and never jax, nor anything of ``byteps_tpu``.  Entry
points run on the card unless the caller passes ``device="cpu"``.

The data-parallel gradient path is ported: ``DistributedOptimizer`` ->
``push_pull_async`` -> the engine (registry keys, partitioning, priority
and credit scheduling, dispatch and sync threads) -> an all-reduce over
``torch.distributed``, or for compressed tensors the onebit compressed
push_pull whose pack, unpack and merge are CUDA kernels
(``csrc/onebit.cu``).  ``models.resnet`` carries the ResNet family.
"""

from .torch import *  # noqa: F401,F403 — the adapter is the public surface
from .torch import __all__  # noqa: F401
