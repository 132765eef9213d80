"""SGD with momentum and weight decay, as ``torch.optim.SGD`` has it.

The program's: ``torch.optim.SGD``.  The reference's, plainly: ``d = g +
wd * p``; the momentum buffer is ``d`` at the first step and ``mu * buf
+ d`` after; ``p -= lr * buf``.  The first gradient from the program's
state after one step: ``buf - wd * p0`` with ``p0 = p + lr * buf``.
"""

import torch


def program(params, o: dict) -> torch.optim.Optimizer:
    return torch.optim.SGD(params, lr=o["lr"], momentum=o["momentum"],
                           weight_decay=o["weight_decay"])


def first_grad(state: dict, p: torch.Tensor, o: dict):
    """The gradient the program's optimizer got at its first step, or
    None where it holds no state for ``p``."""
    if "momentum_buffer" not in state:
        return None
    buf = state["momentum_buffer"]
    return buf - o["weight_decay"] * (p + o["lr"] * buf)


@torch.no_grad()
def step(p: torch.Tensor, g: torch.Tensor, state: dict, t: int,
         o: dict) -> None:
    d = g + o["weight_decay"] * p
    if "buf" in state:
        state["buf"].mul_(o["momentum"]).add_(d)
    else:
        state["buf"] = d.clone()
    p.sub_(o["lr"] * state["buf"])
