"""MNIST-class MLP, the smallest end-to-end model; port of
``byteps_tpu/models/mlp.py``.

flax infers a ``Dense`` layer's input width at its first call; a torch
module needs it up front, so :class:`MLP` takes ``in_features`` (784 for
MNIST's 28x28 images).  Layers keep flax's names and layouts
(``dense_{i}``, kernels ``(in, out)``), so :func:`load_flax_mlp` is a
copy.  Computation is in f32, as the flax layers' (no ``dtype``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .gpt import Dense, init_params, load_flax_params

__all__ = ["MLP", "mnist_mlp", "softmax_cross_entropy", "load_flax_mlp"]


class MLP(nn.Module):
    """Dense layers with ReLU between them, on inputs flattened past the
    batch axis."""

    def __init__(self, in_features: int,
                 features: Sequence[int] = (128, 64, 10), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = tuple(features)
        width = in_features
        for i, f in enumerate(self.features):
            setattr(self, f"dense_{i}", Dense((width,), (f,), torch.float32,
                                              device=device))
            width = f
        init_params(self, generator
                    or torch.Generator(device=device or "cpu").manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        last = len(self.features) - 1
        for i in range(len(self.features)):
            x = getattr(self, f"dense_{i}")(x)
            if i < last:
                x = F.relu(x)
        return x


def mnist_mlp(device=None, generator: Optional[torch.Generator] = None
              ) -> MLP:
    return MLP(784, features=(128, 64, 10), device=device,
               generator=generator)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ``-sum(onehot * log_softmax(logits))``, as
    the JAX function computes it."""
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
    return -(onehot * logp).sum(-1).mean()


def load_flax_mlp(model: MLP, params) -> MLP:
    """The JAX package's MLP parameters (``variables["params"]``, numpy
    arrays) into a port :class:`MLP`."""
    return load_flax_params(model, params)
