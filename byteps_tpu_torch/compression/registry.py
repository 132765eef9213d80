"""Compressor factory and decorator chain; port of
``byteps_tpu/compression/registry.py``.

Codecs: ``onebit``, ``topk``, ``randomk``, ``dithering`` (dense and
sparse) and ``powersgd``.  Decorators, applied in the reference's order
so that the chain is ``momentum(ef(codec))``: ``ef`` (error feedback)
and ``momentum: nesterov``, which is worker-only (the server chain skips
it).  kwargs are the per-tensor string dict the frameworks pass
(``{"compressor": "topk", "k": "0.01", "ef": "vanilla"}``).

:func:`validate_kwargs` fails at declare/enqueue, in the caller's stack,
on a bad codec; :func:`golden_error` is the codec-golden gradient error
that gates the planner's compressor ladder (``common/scheduler.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from .base import Compressor, IdentityCompressor
from .dithering import DitheringCompressor
from .error_feedback import ErrorFeedback
from .momentum import NesterovMomentum
from .onebit import OnebitCompressor
from .powersgd import PowerSGDCompressor
from .randomk import RandomkCompressor
from .topk import TopkCompressor

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def _num(v):
    if isinstance(v, str):
        return float(v) if "." in v or "e" in v.lower() else int(v)
    return v


@register("onebit")
def _make_onebit(numel, dtype, kwargs):
    scaling = str(kwargs.get("scaling", "true")).lower() in ("1", "true")
    return OnebitCompressor(numel, dtype, scaling=scaling)


@register("topk")
def _make_topk(numel, dtype, kwargs):
    return TopkCompressor(numel, dtype, k=_num(kwargs.get("k", 0.01)))


@register("powersgd")
def _make_powersgd(numel, dtype, kwargs):
    return PowerSGDCompressor(numel, dtype,
                              rank=int(kwargs.get("rank", 4)),
                              seed=int(kwargs.get("seed", 0)),
                              iters=int(kwargs.get("iters", 1)))


@register("randomk")
def _make_randomk(numel, dtype, kwargs):
    return RandomkCompressor(numel, dtype, k=_num(kwargs.get("k", 0.01)),
                             seed=int(kwargs.get("seed", 0)))


@register("dithering")
def _make_dithering(numel, dtype, kwargs):
    # 'k' is the reference's name for the level count here
    return DitheringCompressor(
        numel, dtype,
        s=int(kwargs.get("partition_num",
                         kwargs.get("s", kwargs.get("k", 16)))),
        partition=str(kwargs.get("partition", "linear")),
        normalize=str(kwargs.get("normalize", "max")),
        seed=int(kwargs.get("seed", 0)),
        sparse_ratio=float(kwargs.get("sparse_ratio", 0.0)))


# accepted decorator spellings; anything else raises, naming these
_EF_ON = ("vanilla", "true", "1")
_EF_OFF = ("", "0", "false", "none", "off")
_MOMENTUM_ON = ("nesterov",)


def registered() -> str:
    return f"compressors {sorted(_REGISTRY)}, decorators ['ef', 'momentum']"


def create(kwargs: Optional[Dict], numel: int,
           dtype: torch.dtype = torch.float32,
           for_server: bool = False) -> Compressor:
    """Build the compressor chain from a kwargs dict.  ``for_server``
    builds the chain that re-compresses the merged sum, without
    momentum."""
    if not kwargs or "compressor" not in kwargs:
        return IdentityCompressor(numel, dtype)
    ctype = str(kwargs["compressor"]).lower()
    if ctype not in _REGISTRY:
        raise ValueError(f"unknown compressor {ctype!r}; registered: "
                         f"{registered()}")
    comp = _REGISTRY[ctype](numel, dtype, kwargs)
    ef = str(kwargs.get("ef", "")).lower()
    if ef in _EF_ON:
        comp = ErrorFeedback(comp)
    elif ef not in _EF_OFF:
        raise ValueError(f"unknown ef {kwargs.get('ef')!r}: use one of "
                         f"{_EF_ON} to enable error feedback or omit the "
                         f"key")
    momentum = str(kwargs.get("momentum", "")).lower()
    if momentum in _MOMENTUM_ON:
        if not for_server:
            comp = NesterovMomentum(comp,
                                    mu=float(kwargs.get("momentum_mu", 0.9)))
    elif momentum not in _EF_OFF:
        raise ValueError(f"unknown momentum {kwargs.get('momentum')!r}: "
                         f"use {_MOMENTUM_ON} or omit the key")
    return comp


def _kwargs_key(kwargs: Dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in kwargs.items()))


_VALIDATED: set = set()
_GOLDEN: Dict[tuple, float] = {}

# the golden geometry: one fixed (numel, steps, seed), so that the error
# is a constant that the planner's gate and its tests read alike
GOLDEN_NUMEL = 16384
GOLDEN_STEPS = 8


def validate_kwargs(kwargs: Optional[Dict]) -> None:
    """Build the worker and server chains at a tiny size, so that a bad
    codec, decorator or parameter fails here, in the caller's stack
    (memoized: it runs on every push).  Raises ValueError."""
    if not kwargs:
        return
    key = _kwargs_key(kwargs)
    if key in _VALIDATED:
        return
    try:
        create(dict(kwargs), 256)
        create(dict(kwargs), 256, for_server=True)
    except ValueError as e:
        if str(e).startswith("unknown "):
            raise       # it names the bad key and the accepted values
        raise ValueError(
            f"invalid compression kwargs {dict(kwargs)!r}: {e}") from e
    except Exception as e:  # noqa: BLE001 — bad numeric parameters etc.
        raise ValueError(
            f"invalid compression kwargs {dict(kwargs)!r}: {e}") from e
    _VALIDATED.add(key)


def golden_error(kwargs: Optional[Dict], numel: int = GOLDEN_NUMEL,
                 steps: int = GOLDEN_STEPS, seed: int = 0) -> float:
    """The relative gradient mass a codec fails to deliver over ``steps``
    pushes of one seeded gradient: ``||sum(delivered) - steps * x|| /
    (steps * ||x||)``.  An error-feedback chain's residual feeds the next
    step, so the figure is the one that predicts convergence.  Computed
    on the CPU (the codecs' plain versions), memoized; ``None`` (no
    compression) is 0."""
    if not kwargs:
        return 0.0
    key = (_kwargs_key(kwargs), int(numel), int(steps), int(seed))
    cached = _GOLDEN.get(key)
    if cached is not None:
        return cached
    x = np.random.RandomState(seed).randn(numel).astype(np.float32)
    comp = create(dict(kwargs), numel)
    state = comp.init_state(torch.device("cpu"))
    acc = np.zeros(numel, np.float64)
    xt = torch.from_numpy(x)
    for _ in range(steps):
        payload, state = comp.compress(xt, state)
        acc += comp.decompress(payload).numpy().astype(np.float64)
    err = float(np.linalg.norm(acc - steps * x)
                / (steps * np.linalg.norm(x) + 1e-30))
    _GOLDEN[key] = err
    return err
