"""The whole step's share of the cards' bf16 peak: the model FLOPs a
sample (``flops/<config>``, no recomputation counted) times the traced
run's samples a second over its window, over the peak times the
cards."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["seconds"]:
        return None
    rate = w["samples"] / w["seconds"]
    peak = ctx["peaks"]["bf16_flop_per_s"] * len(ctx["ranks"])
    return 100.0 * ctx["flops_per_sample"] * rate / peak
