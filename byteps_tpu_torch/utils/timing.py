"""Benchmark timing helpers; port of ``byteps_tpu/utils/timing.py``.

``block_on`` (JAX's ``block_until_ready``) becomes a wait for the card:
a ``torch.cuda.synchronize`` of the device of every CUDA tensor found in
``block_on`` (a tensor or a nested list/tuple/dict of them); CPU tensors
need no wait.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def block_until_ready(x):
    """Wait until the work producing ``x`` is done on its device(s);
    returns ``x``."""
    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u)
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u)

    walk(x)
    for d in devices:
        torch.cuda.synchronize(d)
    return x


class Timer:
    """Wall-clock span with device completion: ``block_on`` is waited
    for before the clock stops, so asynchronous launches cannot make
    steps look free."""

    def __init__(self):
        self.elapsed: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    def stop(self, block_on=None) -> float:
        if block_on is not None:
            block_until_ready(block_on)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed


def throughput(fn: Callable, steps: int, items_per_step: int,
               warmup: int = 1) -> float:
    """items/s of ``fn()`` over ``steps`` calls (after ``warmup`` calls);
    the last result is waited for before the clock stops."""
    out = None
    for _ in range(warmup):
        out = fn()
    block_until_ready(out)
    t = Timer()
    with t:
        for _ in range(steps):
            out = fn()
        t.stop(block_on=out)
    return steps * items_per_step / t.elapsed
