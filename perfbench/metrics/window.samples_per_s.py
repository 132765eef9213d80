"""The samples of every rank in the traced run's window, over the window
from its start to the last step's end: the cell's rate, read per layer
because its runs spread too widely on the host's clock for a bound."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["seconds"]:
        return None
    return w["samples"] / w["seconds"]
