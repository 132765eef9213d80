"""The update: host ms a step on rank 0 over the window of
``DistributedOptimizer.step()`` after its waits (the averages' copies
into the gradients and the inner optimizer's step)
(``engine.stats["update_ms"]``)."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["steps"] or "update_ms" not in w["stats"]:
        return None
    return w["stats"]["update_ms"] / w["steps"]
