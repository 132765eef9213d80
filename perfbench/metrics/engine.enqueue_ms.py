"""The caller's pushes: host ms a step on rank 0 over the window that
the hooks spent in the engine's push, from the call to its tasks in the
queue
(``engine.stats["enqueue_ms"]``)."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["steps"] or "enqueue_ms" not in w["stats"]:
        return None
    return w["stats"]["enqueue_ms"] / w["steps"]
