"""Onebit compression with error feedback, as the configuration's codec
states it, over the chunks the engine's rule cuts.

A tensor of ``min_compress_bytes`` and more is cut into chunks of at
most ``partition_bytes`` (all but the last a multiple of 512 elements).
Per chunk and rank: ``c = x + e`` (``e`` the rank's residual, zero at
first), ``q = sign(c) * mean|c|`` with ``sign(0) = +1``, ``e = c - q``.
The ranks' ``q`` are summed; the sum is compressed again the same way
with a residual of its own (the server's), and the result divided by the
ranks is the average the optimizer gets.  Smaller tensors are averaged
as they are.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

ALIGN_ELEMS = 512


def chunks(numel: int, itemsize: int,
           partition_bytes: int) -> List[Tuple[int, int]]:
    most = max(1, partition_bytes // itemsize)
    if numel <= most:
        return [(0, numel)]
    if ALIGN_ELEMS < most:
        most -= most % ALIGN_ELEMS
    return [(o, min(most, numel - o)) for o in range(0, numel, most)]


def _sign_scale(c: torch.Tensor) -> torch.Tensor:
    scale = c.abs().sum() / c.numel()
    return torch.where(c >= 0, scale, -scale)


class Onebit:
    """The codec's state for one cell: each rank's residual and the
    server's, per compressed leaf."""

    def __init__(self, traffic: dict, ranks: int):
        self.min_bytes = traffic["min_compress_bytes"]
        self.partition = traffic["partition_bytes"]
        self.ranks = ranks
        self.worker: Dict[Tuple[str, int], torch.Tensor] = {}
        self.server: Dict[str, torch.Tensor] = {}

    def compressed(self, g: torch.Tensor) -> bool:
        return g.numel() * 4 >= self.min_bytes

    def worker_chunks(self, name: str, rank: int,
                      g: torch.Tensor) -> torch.Tensor:
        """Rank ``rank``'s compressed gradient (the sign times the scale
        of each chunk), its residual kept."""
        flat = g.reshape(-1).float()
        e = self.worker.get((name, rank), torch.zeros_like(flat))
        c = flat + e
        out = torch.cat([_sign_scale(c[o:o + n])
                         for o, n in chunks(flat.numel(), 4,
                                            self.partition)])
        self.worker[(name, rank)] = c - out
        return out

    def merge(self, name: str, summed: torch.Tensor,
              shape) -> torch.Tensor:
        """The server's pass over the ranks' summed compressed
        gradients, divided by the ranks."""
        e = self.server.get(name, torch.zeros_like(summed))
        c = summed + e
        out = torch.cat([_sign_scale(c[o:o + n])
                         for o, n in chunks(summed.numel(), 4,
                                            self.partition)])
        self.server[name] = c - out
        return (out / self.ranks).reshape(shape)
