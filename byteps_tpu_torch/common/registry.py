"""Tensor registry; port of ``byteps_tpu/common/registry.py``.

Frameworks declare tensors once, in a fixed order on every rank; the
registry assigns a monotonically increasing ``declared_key`` and carves
the 64-bit key space as ``declared_key << 16 | part``.  Declaration order
is also the priority source: frameworks pass ``priority = -declared_key``.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Dict, List, Optional

import torch

from .partitioner import chunk_bounds
from .types import TensorContext, make_key

_log = logging.getLogger("byteps_tpu_torch")


class TensorRegistry:
    """Process-wide tensor table."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_name: Dict[str, TensorContext] = {}
        self._next_key = 0

    def declare(self, name: str) -> TensorContext:
        """Idempotently declare a tensor; returns its context."""
        with self._lock:
            ctx = self._by_name.get(name)
            if ctx is None:
                ctx = TensorContext(name=name, declared_key=self._next_key)
                self._next_key += 1
                self._by_name[name] = ctx
            return ctx

    def init_tensor(self, name: str, shape, dtype: torch.dtype,
                    partition_bytes: int,
                    compression_kwargs: Optional[Dict[str, str]] = None
                    ) -> TensorContext:
        """First-call initialization: record shape/dtype, carve chunk keys.
        A name reused with another geometry raises."""
        ctx = self.declare(name)
        shape = tuple(shape)
        with ctx.lock:
            if ctx.initialized:
                if ctx.shape != shape or ctx.dtype != dtype:
                    raise ValueError(
                        f"tensor {name!r} re-initialized with "
                        f"{shape}/{dtype}, previously "
                        f"{ctx.shape}/{ctx.dtype}")
                return ctx
            num_elems = math.prod(shape)
            bounds = chunk_bounds(num_elems, dtype.itemsize, partition_bytes)
            ctx.shape = shape
            ctx.dtype = dtype
            ctx.num_elems = num_elems
            ctx.nbytes = num_elems * dtype.itemsize
            ctx.chunk_bounds = bounds
            ctx.partition_bytes = partition_bytes
            ctx.key_list = [make_key(ctx.declared_key, i)
                            for i in range(len(bounds))]
            ctx.compression_kwargs = dict(compression_kwargs or {})
            ctx.initialized = True
            _log.debug("init tensor %s: %d elems, %d chunk(s)", name,
                       num_elems, len(bounds))
        return ctx

    def get(self, name: str) -> Optional[TensorContext]:
        with self._lock:
            return self._by_name.get(name)

    def names_in_declaration_order(self) -> List[str]:
        with self._lock:
            return sorted(self._by_name,
                          key=lambda n: self._by_name[n].declared_key)
