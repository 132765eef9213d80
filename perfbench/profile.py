"""The profiled steps of a traced run, reduced to what the per-layer
readers take.

``summarize`` reads the Chrome trace that ``torch.profiler`` exported:
the window is the span of the ``perfbench.step`` annotations on the
host; device operations (kernels, copies, fills) are clipped to it; the
busy time is the length of their union, and each idle gap is named by
what the host's stepping thread was doing when it began (the innermost
``perfbench.*`` annotation and the innermost operator there).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP = "perfbench.step"
TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _label(host: List[dict], at: float) -> str:
    """The innermost harness annotation and innermost operator of the
    stepping thread covering time ``at``."""
    ann, op = None, None
    for e in host:
        if e["ts"] <= at < e["ts"] + e["dur"]:
            if e["name"].startswith("perfbench."):
                if ann is None or e["ts"] >= ann["ts"]:
                    ann = e
            elif op is None or e["ts"] >= op["ts"]:
                op = e
    parts = [e["name"] for e in (ann, op) if e is not None]
    return " / ".join(parts) if parts else "outside the step"


def summarize(path: str) -> dict:
    """``{"window_s", "busy_s", "steps", "kernels": {name: [seconds,
    count]}, "device_ops": [[name, seconds]] (the 10 longest in all),
    "idle_gaps": [[label, seconds]] (the 10 longest)}``, or ``{"steps":
    0}`` when the trace holds no step."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in xs if e.get("name") == STEP]
    if not steps:
        return {"steps": 0}
    lo = min(e["ts"] for e in steps)
    hi = max(e["ts"] + e["dur"] for e in steps)
    tid = steps[0].get("tid")
    pid = steps[0].get("pid")
    host = [e for e in xs if e.get("tid") == tid and e.get("pid") == pid
            and e.get("cat") in ("cpu_op", "user_annotation")]
    device, kernels = [], {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        device.append((a, b))
        if e.get("cat") == "kernel":
            k = kernels.setdefault(e["name"], [0.0, 0])
            k[0] += (b - a) * 1e-6
            k[1] += 1
    busy = _union(device)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "steps": len(steps), "kernels": kernels,
            "device_ops": [[name[:160], s] for name, (s, _) in ops],
            "idle_gaps": [[_label(host, a), (b - a) * 1e-6]
                          for a, b in gaps[:TOP]]}
