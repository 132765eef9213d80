"""Collective ops on pytrees, and the port's kernels.

``collective_ops`` reduces whole pytrees of tensors in one collective per
dtype (the JAX package's in-graph ops); ``onebit_kernels`` and
``flash_attention`` hold the CUDA kernels, built at first use by
``build``.  The package exports the JAX package's names
(``byteps_tpu/ops/__init__.py``).  ``flash_attention`` is then the
function: ``importlib.import_module("byteps_tpu_torch.ops.flash_attention")``
(or ``from byteps_tpu_torch.ops.flash_attention import ...``) reaches the
module.
"""

from .collective_ops import (  # noqa: F401
    push_pull_tree,
    broadcast_tree,
    hierarchical_push_pull,
    make_onebit_pair,
    make_powersgd_pair,
)
from .flash_attention import flash_attention  # noqa: F401
