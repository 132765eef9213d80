"""Maps over nested batches (dicts, lists and tuples of tensors or numpy
arrays), and a rank's rows of a global batch; shared by the input
pipeline (``utils/prefetch.py``) and the data-parallel step
(``parallel/data_parallel.py``)."""

from __future__ import annotations

from collections.abc import Mapping

__all__ = ["tree_map", "tree_leaves", "local_rows"]


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def local_rows(comm, batch):
    """This rank's rows of a global batch (tensors or numpy arrays with a
    leading batch axis), on the host: rank ``r`` of ``R`` (``comm.rank``,
    ``comm.size``) takes rows ``[r * B/R, (r + 1) * B/R)``."""
    R, r = comm.size, comm.rank

    def rows(x):
        n = x.shape[0]
        if n % R:
            raise ValueError(f"batch axis {n} not divisible by {R} ranks")
        k = n // R
        return x[r * k:(r + 1) * k]

    return tree_map(rows, batch)
