"""Compressor factory and decorator chain; port of
``byteps_tpu/compression/registry.py``.

Registered so far: the ``onebit`` codec and the ``ef`` (error feedback)
decorator.  The chain is ``ef(onebit)``, the same on the worker and the
server.  A codec or decorator that is not ported raises ``ValueError``
naming what is registered.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .base import Compressor, IdentityCompressor
from .error_feedback import ErrorFeedback
from .onebit import OnebitCompressor

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


@register("onebit")
def _make_onebit(numel, dtype, kwargs):
    scaling = str(kwargs.get("scaling", "true")).lower() in ("1", "true")
    return OnebitCompressor(numel, dtype, scaling=scaling)


_EF_ON = ("vanilla", "true", "1")
_OFF = ("", "0", "false", "none", "off")


def registered() -> str:
    return f"compressors {sorted(_REGISTRY)}, decorators ['ef']"


def create(kwargs: Optional[Dict], numel: int,
           dtype: torch.dtype = torch.float32,
           for_server: bool = False) -> Compressor:
    """Build the compressor chain from a kwargs dict such as
    ``{"compressor": "onebit", "ef": "vanilla"}``.  ``for_server`` builds
    the chain that re-compresses the merged sum (momentum, once ported,
    is worker-only)."""
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
    elif ef not in _OFF:
        raise ValueError(f"unknown ef {kwargs.get('ef')!r}: use one of "
                         f"{_EF_ON} or omit the key")
    momentum = str(kwargs.get("momentum", "")).lower()
    if momentum not in _OFF:
        raise ValueError(f"momentum {kwargs.get('momentum')!r} is not "
                         f"ported; registered: {registered()}")
    return comp


_VALIDATED: set = set()


def validate_kwargs(kwargs: Optional[Dict]) -> None:
    """Fail at declare/enqueue, in the caller's stack, on a bad codec
    (memoized: it runs on every push)."""
    if not kwargs:
        return
    key = tuple(sorted((str(k), str(v)) for k, v in kwargs.items()))
    if key not in _VALIDATED:
        create(dict(kwargs), 256)
        create(dict(kwargs), 256, for_server=True)
        _VALIDATED.add(key)
