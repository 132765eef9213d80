"""Tensor registry; port of ``byteps_tpu/common/registry.py``.

Frameworks declare tensors once, in a fixed order on every rank; the
registry assigns a monotonically increasing ``declared_key`` and carves
the 64-bit key space as ``declared_key << 16 | part``.  Declaration order
is also the priority source: frameworks pass ``priority = -declared_key``.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

import torch

from .partitioner import chunk_bounds
from .types import TensorContext, make_key
from .logging import get_logger

_log = get_logger()


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

    @staticmethod
    def repartition_locked(ctx: TensorContext, partition_bytes: int) -> bool:
        """Re-carve an initialized tensor's chunk bounds and keys under a
        new partition bound (the planner's chunk size).  The caller holds
        ``ctx.lock`` and has checked ``ctx.inflight == 0``: bounds never
        move under an outstanding push.  A compressed tensor is never
        re-carved, since its per-chunk compressor state is tied to its
        chunk geometry.  Returns True when the bounds changed."""
        if (not ctx.initialized or ctx.compressor is not None
                or ctx.compression_kwargs
                or partition_bytes == ctx.partition_bytes):
            return False
        bounds = chunk_bounds(ctx.num_elems, ctx.dtype.itemsize,
                              partition_bytes)
        ctx.partition_bytes = partition_bytes
        if bounds == ctx.chunk_bounds:
            return False
        ctx.chunk_bounds = bounds
        ctx.key_list = [make_key(ctx.declared_key, i)
                        for i in range(len(bounds))]
        ctx.scatter_layout = None   # recomputed lazily for the new bounds
        _log.debug("repartitioned tensor %s: %d chunk(s) at %d B", ctx.name,
                   len(bounds), partition_bytes)
        return True

    @staticmethod
    def retune_compression_locked(ctx: TensorContext,
                                  compression_kwargs: Optional[Dict[str,
                                                                   str]],
                                  partition_bytes: int) -> bool:
        """Swap the codec of a tensor between its pushes: the compressor
        ladder's choice for a planner-owned tensor, or the explicit kwargs
        that re-pin one.  The caller holds ``ctx.lock`` and has checked
        ``ctx.inflight == 0``.  Re-carves the bounds at the new codec's
        partition bound and drops the compressor slots, which the engine
        builds again with fresh state (switching codecs restarts the
        error feedback).  Returns True when anything changed."""
        if not ctx.initialized:
            return False
        new_kwargs = dict(compression_kwargs or {})
        if (new_kwargs == ctx.compression_kwargs
                and partition_bytes == ctx.partition_bytes):
            return False
        ctx.compression_kwargs = new_kwargs
        ctx.compressor = None
        bounds = chunk_bounds(ctx.num_elems, ctx.dtype.itemsize,
                              partition_bytes)
        ctx.partition_bytes = partition_bytes
        if bounds != ctx.chunk_bounds:
            ctx.chunk_bounds = bounds
            ctx.key_list = [make_key(ctx.declared_key, i)
                            for i in range(len(bounds))]
            ctx.scatter_layout = None
        _log.debug("retuned tensor %s codec -> %s (%d chunk(s) at %d B)",
                   ctx.name, new_kwargs.get("compressor", "none"),
                   len(bounds), partition_bytes)
        return True

    def get(self, name: str) -> Optional[TensorContext]:
        with self._lock:
            return self._by_name.get(name)

    def names_in_declaration_order(self) -> List[str]:
        with self._lock:
            return sorted(self._by_name,
                          key=lambda n: self._by_name[n].declared_key)
