"""Collectives the engine issued a step on rank 0 over the window
(``engine.stats["dispatches"]``)."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["steps"] or "dispatches" not in w["stats"]:
        return None
    return w["stats"]["dispatches"] / w["steps"]
