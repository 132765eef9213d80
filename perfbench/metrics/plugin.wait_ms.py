"""The wait: host ms a step on rank 0 over the window that
``DistributedOptimizer`` was blocked on its push_pull handles
(``engine.stats["wait_ms"]``)."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["steps"] or "wait_ms" not in w["stats"]:
        return None
    return w["stats"]["wait_ms"] / w["steps"]
