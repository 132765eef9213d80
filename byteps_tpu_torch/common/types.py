"""Core types of the push_pull engine; port of ``byteps_tpu/common/types.py``.

``ChunkTask`` is one schedulable partition of a tensor and
``TensorContext`` the per-declared-tensor state.  Payloads are torch
tensors and a chunk's completion is a CUDA event (or, on the CPU, the
return of the synchronous collective) instead of a JAX async-dispatch
future.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Any, Callable, Dict, List, Optional


class StatusCode(enum.Enum):
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


@dataclasses.dataclass
class Status:
    code: StatusCode = StatusCode.OK
    reason: str = ""

    @classmethod
    def ok(cls) -> "Status":
        return cls(StatusCode.OK)

    @classmethod
    def error(cls, reason: str) -> "Status":
        return cls(StatusCode.UNKNOWN_ERROR, reason)

    def ok_or_raise(self) -> None:
        if self.code not in (StatusCode.OK, StatusCode.IN_PROGRESS):
            raise RuntimeError(
                f"byteps_tpu_torch: {self.code.name}: {self.reason}")


MAX_PARTS_PER_TENSOR = 1 << 16


def make_key(declared_key: int, part_index: int) -> int:
    """64-bit chunk key: ``declared_key << 16 | part``."""
    if not 0 <= part_index < MAX_PARTS_PER_TENSOR:
        raise ValueError(f"part_index out of range: {part_index}")
    return (declared_key << 16) | part_index


def split_key(key: int) -> tuple:
    return key >> 16, key & (MAX_PARTS_PER_TENSOR - 1)


@dataclasses.dataclass
class ChunkTask:
    """One partition of a tensor, scheduled independently."""

    name: str
    key: int                      # make_key(declared, part)
    priority: int
    offset_elems: int             # offset into the flat tensor, in elements
    num_elems: int                # chunk length in elements
    nbytes: int                   # chunk size in bytes (credit accounting)
    data: Any = None              # the flat contribution (whole tensor)
    # invoked as callback(result_chunk_or_None, status) by the sync loop
    callback: Optional[Callable[[Any, Status], None]] = None
    # the per-chunk _CompressionSlot of a compressed tensor, else None
    compression: Any = None
    # fused-scale path: the collective multiplies the sum by this before
    # any downcast, and assembly is a pure reshape
    scale: Optional[float] = None
    pending: Any = None           # the _PendingTensor this chunk belongs to
    ready: Any = None             # CUDA event recorded at enqueue, or None
    # monotonic seconds at enqueue (one stamp per push) and at dispatch:
    # the "queued" and "push_pull" spans and the queue attribution
    t_enqueue: float = 0.0
    t_dispatch: float = 0.0
    step: int = 0                 # the tensor's push count (the tracer's)
    trace_id: int = 0             # the push's captured trace, 0 = none

    # priority descending, then key ascending
    def sort_tuple(self):
        return (-self.priority, self.key)


@dataclasses.dataclass
class TensorContext:
    """Per-declared-tensor state."""

    name: str
    declared_key: int
    initialized: bool = False
    shape: Optional[tuple] = None
    dtype: Any = None             # torch.dtype
    num_elems: int = 0
    nbytes: int = 0
    # chunk boundaries in elements: list of (offset, length)
    chunk_bounds: List[tuple] = dataclasses.field(default_factory=list)
    key_list: List[int] = dataclasses.field(default_factory=list)
    # e.g. {"compressor": "onebit", "ef": "vanilla"}; emptied when the
    # tensor is below the compression size cutoff
    compression_kwargs: Dict[str, str] = dataclasses.field(
        default_factory=dict)
    compressor: Any = None        # list of _CompressionSlot, one per chunk
    # who owns the codec, decided at the first push: None (undecided),
    # True (the planner's compressor ladder), False (explicit kwargs)
    compression_tuned: Optional[bool] = None
    # explicit kwargs that re-pinned a ladder-owned tensor while pushes
    # were in flight: applied at the next push with ``inflight == 0``
    compression_pin: Optional[Dict[str, str]] = None
    partition_bytes: int = 0
    # pushes enqueued and not yet resolved; the planner re-carves chunk
    # bounds only at 0 (under ``lock``)
    inflight: int = 0
    # a sharded-update tensor's column layout for the scatter accumulator
    # (``(layout, C)``), "ineligible" once computed and refused, None
    # until computed; reset when the chunk bounds move
    scatter_layout: Any = None
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
