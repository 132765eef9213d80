"""Which layer a device kernel of the trace belongs to, by its name."""

from __future__ import annotations

import re
from typing import Optional

_ONEBIT = re.compile(r"(?<![A-Za-z0-9_])(pack|unpack|unpack_sum)_kernel\b")


def is_nccl(name: str) -> bool:
    return name.lower().startswith("nccl")


def onebit_kind(name: str) -> Optional[str]:
    """``pack``, ``unpack`` or ``unpack_sum`` for a kernel of
    ``csrc/onebit.cu``, else None."""
    m = _ONEBIT.search(name)
    return m.group(1) if m else None


def per_step_ms(profile: dict, keep) -> Optional[float]:
    """Device milliseconds a profiled step of the kernels ``keep(name)``
    selects; None where the profile holds no step or no such kernel."""
    if not profile.get("steps"):
        return None
    sel = [s for n, (s, _) in profile["kernels"].items() if keep(n)]
    if not sel:
        return None
    return sum(sel) / profile["steps"] * 1e3
