"""Inputs and weights made from ``--seed``: the same seed gives the same
batches and weights, on the device they are made on.

The benchmark hands the same inputs to the program and to the reference
(``reference/``): the weights of ``make_weights`` and the batches of
``batch``, made by ``inputs/<kind>.py`` as the configuration names its
``inputs``.  Imports only torch.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Sequence, Tuple

import torch

from . import spec

Leaf = Tuple[str, Tuple[int, ...], tuple]


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, a rank's batch)."""
    key = "/".join(str(t) for t in (seed,) + tags).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def make_weights(leaves: Sequence[Leaf], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``leaves`` (``(name, shape, init)``, init
    ``("normal", std)``, ``("ones",)`` or ``("zeros",)``): the normal
    leaves are views of one flat draw, scaled in one multiply."""
    normal = [(n, s, i[1]) for n, s, i in leaves if i[0] == "normal"]
    counts = [math.prod(s) for _, s, _ in normal]
    flat = torch.randn(sum(counts), generator=generator(device, seed,
                                                        "weights"),
                       device=device)
    stds = torch.tensor([std for _, _, std in normal], device=device)
    flat.mul_(torch.repeat_interleave(
        stds, torch.tensor(counts, device=device)))
    out, off = {}, 0
    for (name, shape, _), n in zip(normal, counts):
        out[name] = flat[off:off + n].view(shape)
        off += n
    for name, shape, init in leaves:
        if init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init[0] != "normal":
            raise ValueError(f"leaf {name}: unknown init {init!r}")
    return out


def batch(config: dict, traffic: dict, seed: int, rank: int, index: int,
          device) -> dict:
    """Batch ``index`` of ``rank``: distinct rows for every (rank,
    index)."""
    g = generator(device, seed, "batch", rank, index)
    maker = spec.load_module("inputs", config["inputs"])
    return maker.make(config, traffic, traffic["batch_per_rank"], g, device)
