"""Dispatch: host ms a step on rank 0 over the window of the engine's
dispatcher issuing its units (collectives, codec chains, a slot's step)
(``engine.stats["dispatch_ms"]``)."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["steps"] or "dispatch_ms" not in w["stats"]:
        return None
    return w["stats"]["dispatch_ms"] / w["steps"]
