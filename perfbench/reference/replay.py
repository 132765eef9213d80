"""A cell's first steps, replayed by the reference from the seed.

Every rank's batches of the checked steps are made again from the seed
(``data.batch``), the weights too (``data.make_weights``); each rank's
loss and gradient come from the configuration's reference model in the
given precision, the ranks' gradients are averaged (through onebit with
error feedback where the traffic names it) and the traffic's optimizer
(``optimizers/<kind>.py``) steps.
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from .. import spec
from ..data import batch as make_batch
from ..data import make_weights
from .numerics import Precision, exact_f32
from .onebit import Onebit


def model(config: dict):
    return importlib.import_module(f"{__package__}.{config['reference']}")


def _loss_grad(ref, params: Dict[str, torch.Tensor], b: dict, config: dict,
               q: Precision, block_rows: int):
    """The batch's mean loss and its gradient, by blocks of rows where
    the model's loss is a mean over rows."""
    w = {n: t.detach().requires_grad_() for n, t in params.items()}
    rows = next(iter(b.values())).shape[0]
    step = block_rows if ref.ROWS_SEPARABLE and block_rows else rows
    total, grads = 0.0, None
    for lo in range(0, rows, step):
        part = {k: v[lo:lo + step] for k, v in b.items()}
        n = next(iter(part.values())).shape[0]
        loss = ref.loss(w, part, config, q) * (n / rows)
        g = torch.autograd.grad(loss, list(w.values()))
        total += float(loss)
        grads = list(g) if grads is None else [a + c for a, c in
                                               zip(grads, g)]
    return total, dict(zip(w, grads))


def _norms(ts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(ts)
    vals = torch.stack([ts[n].float().norm() for n in names]).tolist()
    return dict(zip(names, vals))


def replay(config: dict, traffic: dict, seed: int, ranks: int, device,
           precision: str = "f32") -> dict:
    """``{"loss": [[rank 0, ...] per step], "grad_norm": {leaf: the norm
    of the first step's gradient as the optimizer gets it},
    "raw_grad_norm": {leaf: that of the plain average}, "numel": {leaf:
    its elements},
    "change_norm": {leaf: the norm of the parameters' change over the
    checked steps}}``."""
    exact_f32()
    ref = model(config)
    q = Precision(precision)
    params = make_weights(ref.leaves(config), seed, device)
    params = {n: t.clone() for n, t in params.items()}
    start = {n: t.clone() for n, t in params.items()}
    o = traffic["optimizer"]
    optim = spec.load_module("optimizers", o["kind"])
    state: Dict[str, dict] = {n: {} for n in params}
    codec = (Onebit(traffic, ranks) if traffic.get("codec") else None)
    out = {"loss": [], "numel": {n: t.numel() for n, t in params.items()}}
    for step in range(traffic["checked_steps"]):
        plain: Dict[str, torch.Tensor] = {}
        packed: Dict[str, torch.Tensor] = {}
        losses = []
        for r in range(ranks):
            b = make_batch(config, traffic, seed, r, step, device)
            loss, grads = _loss_grad(ref, params, b, config, q,
                                     traffic.get("reference_block_rows", 0))
            losses.append(loss)
            for n, g in grads.items():
                plain[n] = plain[n] + g if n in plain else g
                if codec is not None and codec.compressed(g):
                    c = codec.worker_chunks(n, r, g)
                    packed[n] = packed[n] + c if n in packed else c
            del grads
        avg = {n: g / ranks for n, g in plain.items()}
        if step == 0:
            out["raw_grad_norm"] = _norms(avg)
        for n, s in packed.items():
            avg[n] = codec.merge(n, s, avg[n].shape)
        if step == 0:
            out["grad_norm"] = _norms(avg)
        out["loss"].append(losses)
        for n, p in params.items():
            optim.step(p, avg[n], state[n], step + 1, o)
        del plain, packed, avg
    out["change_norm"] = _norms({n: params[n] - start[n] for n in params})
    return out

