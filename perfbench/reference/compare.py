"""The numbers that decide ``correct``, and their limits.

Both sides give ``{"loss": [[rank 0, ...] per checked step],
"grad_norm": {leaf: ...}, "change_norm": {leaf: ...}}``: each rank's
loss at each checked step, each leaf's norm of the first step's gradient
as the optimizer got it, and each leaf's norm of the parameters' change
over the checked steps.  The numbers:

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over steps and
  ranks;
- ``grad_gap``: over the leaves of at least ``LEAF_MIN_ELEMS``
  elements, the largest gap between the two norms, over the reference's
  norm of that leaf or of the median such leaf, whichever is larger;
- ``change_gap``: the same for the change, over those leaves whose plain
  averaged first gradient in the reference is at least ``MOVED`` of the
  median leaf's (a leaf whose gradient is nought to rounding, as the
  key's bias under softmax, moves under Adam by round-off alone).

The leaf gaps leave out the small leaves (BatchNorm's and LayerNorm's
scales and biases, the layers' biases): their first gradient is a sum
over every position of the batch that cancels to a small part of its
terms, so a bf16 backward moves its norm by 10-50 % on every seed, and
the reference itself computed in bf16 reads the same.  Their
correctness still shows in the losses of the later checked steps.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

MOVED = 1e-3
LEAF_MIN_ELEMS = 16384      # 64 KiB of float32, the codec's threshold
NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def _finite(gap: float) -> float:
    """A gap that is not a number (a NaN loss or norm) is infinite."""
    return gap if gap == gap else float("inf")


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Tuple[float, str]:
    floor = statistics.median(ref[n] for n in leaves)
    worst, at = 0.0, ""
    for n in leaves:
        gap = _finite(abs(prog.get(n, 0.0) - ref[n])
                      / max(ref[n], floor, 1e-30))
        if gap > worst or not at:
            worst, at = gap, n
    return worst, at


def numbers(prog: dict, ref: dict) -> dict:
    """``{number: value}`` plus the leaf each leaf gap is worst at."""
    loss_gap = max(_finite(abs(a - b) / max(abs(b), 1e-30))
                   for ps, rs in zip(prog["loss"], ref["loss"])
                   for a, b in zip(ps, rs))
    if len(prog["loss"]) != len(ref["loss"]) or any(
            len(a) != len(b) for a, b in zip(prog["loss"], ref["loss"])):
        loss_gap = float("inf")
    raw = ref["raw_grad_norm"]
    floor = statistics.median(raw.values())
    big = [n for n in raw if ref["numel"][n] >= LEAF_MIN_ELEMS]
    if not big:
        raise ValueError("no leaf has LEAF_MIN_ELEMS elements")
    moved = [n for n in big if raw[n] >= MOVED * floor]
    grad_gap, grad_at = _leaf_gap(prog["grad_norm"], ref["grad_norm"], big)
    change_gap, change_at = _leaf_gap(prog["change_norm"],
                                      ref["change_norm"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_worst_leaf": grad_at,
            "change_worst_leaf": change_at,
            "left_out": sorted(set(big) - set(moved))}


def verdict(nums: dict, limits: dict) -> Tuple[bool, Dict[str, dict]]:
    """Whether every number the cell's limits name is within its limit,
    and each such number beside its limit.  A number a cell's limits do
    not name is not compared (its readings show no control or fault
    that it alone would catch)."""
    shown = {k: {"value": nums[k], "limit": limits[k]} for k in NUMBERS
             if k in limits}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
