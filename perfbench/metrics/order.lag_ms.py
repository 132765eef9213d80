"""The root order's cost on a follower: ``order_lag_ms`` (waiting for
an announcement while holding chunks) plus ``order_wait_ms`` (waiting
for announced chunks not enqueued yet) a step over the window, on the
follower with the most.  Nothing to read at one rank."""


def read(ctx):
    out = []
    for r in ctx["ranks"][1:]:
        w = r["window"]
        st = w["stats"]
        if w["steps"] and "order_lag_ms" in st and "order_wait_ms" in st:
            out.append((st["order_lag_ms"] + st["order_wait_ms"])
                       / w["steps"])
    return max(out) if out else None
