"""AdamW, as ``torch.optim.AdamW`` has it.

The program's: ``torch.optim.AdamW``.  The reference's, plainly: ``p *=
1 - lr * wd``; ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``;
``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``.  The
first gradient from the program's state after one step: ``m / (1 -
b1)``.
"""

import math

import torch


def program(params, o: dict) -> torch.optim.Optimizer:
    return torch.optim.AdamW(params, lr=o["lr"], betas=tuple(o["betas"]),
                             eps=o["eps"], weight_decay=o["weight_decay"])


def first_grad(state: dict, p: torch.Tensor, o: dict):
    if "exp_avg" not in state:
        return None
    return state["exp_avg"] / (1.0 - o["betas"][0])


@torch.no_grad()
def step(p: torch.Tensor, g: torch.Tensor, state: dict, t: int,
         o: dict) -> None:
    b1, b2 = o["betas"]
    p.mul_(1.0 - o["lr"] * o["weight_decay"])
    m = state.setdefault("m", torch.zeros_like(p))
    v = state.setdefault("v", torch.zeros_like(p))
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    denom = v.sqrt() / math.sqrt(1 - b2 ** t) + o["eps"]
    p.sub_(o["lr"] / (1 - b1 ** t) * m / denom)
