"""Shared helpers of the port's bench tools (mechanism_bench,
overlap_bench, async_bench, serve_bench, weak_scaling, fsdp_memory); port
of ``tools/_bench_util.py``: quantile stats, core pinning, the
conditions block and the diagnostics counters, one copy, so the tools
cannot drift apart in how they measure.  The JAX module's CPU-mesh
``XLA_FLAGS`` helpers have no counterpart: the port's ranks are
processes."""

from __future__ import annotations

import os
import subprocess
import sys


def quantile_stats_raw(samples):
    """(median_s, q25_s, q75_s) unrounded, in seconds, linearly
    interpolated.  Derived rates must divide by these, not by the
    display-rounded ms of :func:`quantile_stats`."""
    xs = sorted(samples)
    n = len(xs)

    def q(p):
        i = p * (n - 1)
        lo, hi = int(i), min(int(i) + 1, n - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (i - lo)

    return q(0.5), q(0.25), q(0.75)


def quantile_stats(samples, digits=1):
    """(median, [q25, q75]) in ms from samples in seconds, rounded for
    display; every artifact carries its spread."""
    med, q25, q75 = quantile_stats_raw(samples)
    return (round(med * 1e3, digits),
            [round(q25 * 1e3, digits), round(q75 * 1e3, digits)])


def _parse_cores(spec: str) -> set:
    want = set()
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        want |= set(range(int(lo), int(hi or lo) + 1))
    return want


def pin_cores():
    """Pin this process to a stable core subset when that changes
    anything; return the pinned set (or None) for the conditions block.

    Only a strict subset of the available cores is ever reported:
    pinning to everything is a no-op.  ``BYTEPS_BENCH_PIN=off`` opts
    out; ``BYTEPS_BENCH_PIN=0-3`` or ``0,2,5`` chooses the cores."""
    # bpslint: ignore[env-knob] reason=a tool's pin knob, read before any Config exists (the JAX package reads it from the root tools/, outside the linted package)
    spec = os.environ.get("BYTEPS_BENCH_PIN", "")
    if spec.lower() in ("off", "none"):
        return None
    try:
        avail = sorted(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return None
    if spec:
        try:
            want = _parse_cores(spec) & set(avail)
        except ValueError:
            return None  # malformed spec: run unpinned rather than die
        if want == set(avail):
            return None
    elif len(avail) >= 4:
        # leave core 0 (interrupt-heavy) out when there's room
        want = set(avail[1:])
    else:
        return None
    if not want:
        return None
    try:
        os.sched_setaffinity(0, want)
    except OSError:
        return None
    return sorted(want)


def card_line(device=None):
    """``nvidia-smi``'s name and power limit of the cards (one line
    each), or None off the card."""
    if device is not None and getattr(device, "type", device) != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip() or None


def conditions_block(pinned=None, note: str = "", device=None) -> dict:
    """The measurement-environment stamp every bench JSON carries; on
    CUDA it names the card and its power limit."""
    out = {
        "pinned_cores": pinned,
        "host_cores": os.cpu_count(),
        "loadavg_1m": (round(os.getloadavg()[0], 2)
                       if hasattr(os, "getloadavg") else None),
        "note": note,
    }
    if device is not None:
        out["device"] = str(device)
        card = card_line(device)
        if card is not None:
            out["card"] = card
    return out


def metrics_diag() -> dict:
    """Diagnostics counters embedded in bench artifacts, under the JAX
    tool's keys.  The port compiles no per-shape program (eager PyTorch),
    so its compile and AOT counters read 0."""
    from ..common.telemetry import counters
    return {
        "compile_cache_hit": counters.get("engine.compile_cache_hit"),
        "compile_cache_miss": counters.get("engine.compile_cache_miss"),
        "aot_compiled": counters.get("engine.aot_compiled"),
        "aot_compile_failed": counters.get("engine.aot_compile_failed"),
        "retransmits": counters.get("integrity.retransmit"),
        "crc_rejects": counters.get("integrity.crc_reject"),
    }


def print_line(text: str) -> None:
    """Print ``text`` and its newline in one write: the lines of the
    ranks that share a launcher's pipe then never interleave, even where
    Python runs unbuffered (a ``print`` writes the newline apart)."""
    sys.stdout.write(text + "\n")
    sys.stdout.flush()
