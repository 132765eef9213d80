"""Keras frontend (reference byteps/keras + byteps/_keras, SURVEY.md
§2.4); port of ``byteps_tpu/keras/__init__.py``.

``DistributedOptimizer`` wraps any Keras 3 optimizer so gradients are
push_pulled before apply (reference _keras/__init__.py:20-84 overrides
get_gradients/_aggregate_gradients); callbacks cover broadcast-on-start,
metric averaging, and LR schedules/warmup.  ``broadcast_global_variables``
here takes a model (TF2 has no global collection).  Keras runs on its
TensorFlow backend: this package sets ``KERAS_BACKEND`` to ``tensorflow``
where the environment names none, before Keras is first imported.
"""

from __future__ import annotations

import os

os.environ.setdefault("KERAS_BACKEND", "tensorflow")

from ..core.api import (  # noqa: E402,F401
    init, shutdown, rank, size, local_rank, local_size, declare,
)
from ..tensorflow import (  # noqa: E402,F401
    push_pull, broadcast_variables, Compression, DistributedOptimizer,
)
from . import callbacks  # noqa: E402,F401

__all__ = [
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "declare", "push_pull", "broadcast_variables", "Compression",
    "DistributedOptimizer", "callbacks", "broadcast_global_variables",
    "load_model",
]


def broadcast_global_variables(model, root_rank: int = 0):
    """Broadcast a model's (and its optimizer's) variables from root
    (reference keras/__init__.py broadcast_global_variables, adapted to
    TF2's model-scoped variables)."""
    broadcast_variables(model.variables, root_rank)
    opt = getattr(model, "optimizer", None)
    if opt is not None:
        opt_vars = getattr(opt, "variables", None)
        if callable(opt_vars):
            opt_vars = opt_vars()
        if opt_vars:
            broadcast_variables(opt_vars, root_rank)


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=Compression.none):
    """Load a Keras model, re-wrapping its optimizer in
    ``DistributedOptimizer`` (reference keras/__init__.py load_model)."""
    import keras
    from ..tensorflow import distributed_optimizer_custom_objects

    objs = distributed_optimizer_custom_objects(compression)
    if custom_objects:
        objs.update(custom_objects)
    if custom_optimizers:
        for cls in custom_optimizers:
            from ..tensorflow import _make_distributed_keras_class
            wrapped = _make_distributed_keras_class(cls, compression)
            objs[wrapped.__name__] = wrapped
    model = keras.models.load_model(filepath, custom_objects=objs)
    opt = getattr(model, "optimizer", None)
    if opt is not None and not type(opt).__name__.startswith("Distributed"):
        # class-swap instead of DistributedOptimizer(): a from_config
        # rebuild would discard the optimizer state restored from the file
        # (slot variables, iteration counter)
        from ..tensorflow import _make_distributed_keras_class
        opt.__class__ = _make_distributed_keras_class(
            opt.__class__, compression)
    return model
