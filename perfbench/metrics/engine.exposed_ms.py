"""The communication the backward did not hide: the mean, over the
window's steps on rank 0, of the host time from the return of
``loss.backward()`` to the return of ``optimizer.step()`` (the wait on
the push_pull handles and the inner update's launch)."""


def read(ctx):
    w = ctx["ranks"][0]["window"]
    if not w["exposed_s"]:
        return None
    return sum(w["exposed_s"]) / len(w["exposed_s"]) * 1e3
