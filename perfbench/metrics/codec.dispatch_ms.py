"""The codecs' dispatch: the part of the dispatcher's host ms a step on
rank 0 over the window spent on compressed units (the fused compressed
push_pull: the codec chain's launches and error feedback)
(``engine.stats["codec_dispatch_ms"]``)."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["steps"] or "codec_dispatch_ms" not in w["stats"]:
        return None
    return w["stats"]["codec_dispatch_ms"] / w["steps"]
