"""Queue wait: ms a step on rank 0 over the window that each retired
unit's head chunk sat in the engine's priority queue
(``engine.stats["queue_ms"]``)."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["steps"] or "queue_ms" not in w["stats"]:
        return None
    return w["stats"]["queue_ms"] / w["steps"]
