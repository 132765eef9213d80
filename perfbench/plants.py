"""Faults planted in the program, to show that the check fails them.

Only ``calibrate.py`` and the tests plant one (``--plant NAME``); a
benchmark run never does.  Each breaks the timed path underneath the
harness:

- ``unchanged_state``: ``DistributedOptimizer.step`` averages the
  gradients and returns without stepping, so the parameters and the
  optimizer's state stay as they were;
- ``half_batch``: the loss takes the first half of the batch's rows and
  their mean, leaving out the rest;
- ``no_exchange``: every push returns this rank's own gradient, the
  exchange between ranks left out;
- ``lost_answer``: the largest gradient's average comes back as zeros,
  an answer that never arrived.
"""

from __future__ import annotations

PLANTS = ("unchanged_state", "half_batch", "no_exchange", "lost_answer")


class _Done:
    def __init__(self, value):
        self.value = value

    def wait(self, timeout=None):
        return self.value


class _Altered:
    def __init__(self, handle):
        self.handle = handle

    def wait(self, timeout=None):
        return self.handle.wait(timeout).mul(0)


def plant(name: str):
    """Plant fault ``name``; returns the function that takes it out."""
    import byteps_tpu_torch.torch as bps
    from byteps_tpu_torch.models import bert, resnet

    saved = []

    def put(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "unchanged_state":
        put(bps.DistributedOptimizer, "step",
            lambda self, closure=None: self.synchronize())
    elif name == "half_batch":
        for mod, fn in ((resnet, "softmax_cross_entropy"),
                        (bert, "mlm_loss")):
            real = getattr(mod, fn)

            def half(logits, labels, *a, _real=real, **kw):
                n = max(1, logits.shape[0] // 2)
                return _real(logits[:n], labels[:n], *a, **kw)
            put(mod, fn, half)
    elif name in ("no_exchange", "lost_answer"):
        real = bps.push_pull_async
        largest = {}

        def push(tensor, *a, **kw):
            if name == "no_exchange":
                return _Done(tensor.clone())
            key = kw.get("name")
            if not largest or tensor.numel() > largest["n"]:
                largest.update(n=tensor.numel(), name=key)
            h = real(tensor, *a, **kw)
            return _Altered(h) if key == largest["name"] else h
        put(bps, "push_pull_async", push)
    else:
        raise ValueError(f"unknown plant {name!r}; there are {PLANTS}")

    def undo():
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
    return undo
