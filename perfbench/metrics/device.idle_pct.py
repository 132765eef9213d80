"""The share of the profiled steps in which no operation ran on the
card, on the rank where it is largest."""


def read(ctx):
    out = [100.0 * (1.0 - p["busy_s"] / p["window_s"])
           for p in (r.get("profile", {}) for r in ctx["ranks"])
           if p.get("steps") and p.get("window_s")]
    return max(out) if out else None
