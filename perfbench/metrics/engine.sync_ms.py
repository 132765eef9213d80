"""Sync: ms a step on rank 0 over the window that the engine's syncer
was blocked on a dispatched unit's completion
(``engine.stats["sync_ms"]``)."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["steps"] or "sync_ms" not in w["stats"]:
        return None
    return w["stats"]["sync_ms"] / w["steps"]
