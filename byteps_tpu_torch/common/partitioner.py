"""Tensor partitioning; port of ``byteps_tpu/common/partitioner.py``.

A tensor larger than ``partition_bytes`` is split into chunks, each with
its own key, scheduled and reduced independently, so later chunks overlap
earlier ones.  Boundaries stay on multiples of ALIGN_ELEMS elements so the
two packages carve identical chunks (and so identical compressor state).
"""

from __future__ import annotations

from typing import List, Tuple

ALIGN_ELEMS = 512


def chunk_bounds(num_elems: int, itemsize: int, partition_bytes: int,
                 align_elems: int = ALIGN_ELEMS) -> List[Tuple[int, int]]:
    """Return [(offset_elems, length_elems)] covering [0, num_elems).

    Chunks are at most ``partition_bytes`` big; all but the last are
    aligned to ``align_elems`` elements (none where it is 0)."""
    if num_elems <= 0:
        return [(0, 0)] if num_elems == 0 else []
    max_elems = max(1, partition_bytes // itemsize)
    if num_elems <= max_elems:
        return [(0, num_elems)]
    if 0 < align_elems < max_elems:
        max_elems -= max_elems % align_elems
    bounds = []
    off = 0
    while off < num_elems:
        ln = min(max_elems, num_elems - off)
        bounds.append((off, ln))
        off += ln
    return bounds


def num_chunks(num_elems: int, itemsize: int, partition_bytes: int) -> int:
    return len(chunk_bounds(num_elems, itemsize, partition_bytes))


def flatten_array(arr):
    """A flat 1-D view of a numpy array or a tensor, a copy only where no
    view exists."""
    return arr.reshape(-1)
