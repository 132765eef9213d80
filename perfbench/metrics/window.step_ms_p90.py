"""The 90th percentile (inclusive quantiles) of rank 0's step times in
the traced run's window: the tail a synchronous job runs at, read per
layer for the reason ``window.samples_per_s`` gives."""

import statistics


def read(ctx):
    ms = [s * 1e3 for s in ctx["ranks"][0]["window"]["step_s"]]
    if len(ms) < 2:
        return ms[0] if ms else None
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
