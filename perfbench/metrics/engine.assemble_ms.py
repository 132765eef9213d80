"""Assembly: host ms a step on rank 0 over the window of the engine's
syncer running the retired units' callbacks and assembling results
(``engine.stats["assemble_ms"]``)."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["steps"] or "assemble_ms" not in w["stats"]:
        return None
    return w["stats"]["assemble_ms"] / w["steps"]
