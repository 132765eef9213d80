"""MXNet-style push_pull ops over the port's engine; port of
``byteps_tpu/mxnet/ops.py``.

Reference surface (byteps/mxnet/ops.py:48-101): ``byteps_push_pull`` is
*in-place* — the reduced result is written back into the tensor — and
``byteps_declare_tensor`` registers the name plus per-tensor compression
kwargs (byteps/mxnet/ops.cc:138-158).

The engine hop takes host numpy (``PushPullEngine.push_pull_local``):
the array is staged onto the engine's device (the card), reduced there,
and read back.  Tensors are duck-typed to the NDArray protocol —
``asnumpy()`` + ``tensor[:] = value`` — so the adapter works with real
``mx.nd.NDArray``s and with any array-like standing in for one.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np

from ..core import api as _api

_declared: Dict[str, Dict[str, str]] = {}
_lock = threading.Lock()


def byteps_declare_tensor(name: str, **kwargs: str) -> None:
    """Register ``name`` with the engine; ``byteps_*`` kwargs carry the
    per-tensor compression config (reference mxnet/ops.cc:138-158)."""
    with _lock:
        if name in _declared:
            # re-declaration must agree (reference re-declares freely on
            # every _do_push_pull call)
            if kwargs and _declared[name] != kwargs:
                raise ValueError(
                    f"tensor {name!r} re-declared with different kwargs")
            return
        _declared[name] = dict(kwargs)
    _api.declare(name)


def compression_kwargs(name: str) -> Optional[Dict[str, str]]:
    """Engine-facing compression dict parsed from the declared
    ``byteps_*`` attributes (None when the tensor has no compressor)."""
    attrs = _declared.get(name) or {}
    if "byteps_compressor_type" not in attrs:
        return None
    out: Dict[str, str] = {"compressor": attrs["byteps_compressor_type"]}
    mapping = {
        "byteps_ef_type": "ef",
        "byteps_error_feedback_type": "ef",  # reference C++ kwargs name
        "byteps_momentum_type": "momentum",
        "byteps_momentum_mu": "mu",
        "byteps_compressor_k": "k",
        "byteps_seed": "seed",
        "byteps_compressor_onebit_scaling": "scaling",
        "byteps_dithering_partition": "partition",
        "byteps_dithering_normalize": "normalize",
    }
    for src, dst in mapping.items():
        if src in attrs:
            out[dst] = str(attrs[src])
    return out


def byteps_push_pull(tensor: Any, version: int = 0, priority: int = 0,
                     name: Optional[str] = None,
                     is_average: bool = True) -> None:
    """In-place sum (or average) of ``tensor`` across all workers.

    ``version`` is accepted for API parity and unused (the reference also
    ignores it on the worker, mxnet/ops.cc:98-136)."""
    if name is None:
        raise ValueError("byteps_push_pull requires a tensor name")
    byteps_declare_tensor(name)
    arr = np.ascontiguousarray(tensor.asnumpy())
    out = _api._require().push_pull_local(
        arr.reshape(-1), name, op="average" if is_average else "sum",
        priority=priority, compression=compression_kwargs(name))
    tensor[:] = out.reshape(arr.shape)


def _reset_declared() -> None:
    """Test/shutdown hook: forget declared names."""
    with _lock:
        _declared.clear()
