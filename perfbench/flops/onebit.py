"""The bytes the onebit kernels need: each input byte read once and each
output byte written once, for a chunk of ``n`` float32 elements.

Signs take ``ceil(n / 32)`` 32-bit words; the pack writes them and two
float32 sums (``sum |x|`` and the scale), the unpack reads them and a
scale and writes ``n`` floats, the merge of ``R`` ranks reads ``R`` sets
of words and scales and writes ``n`` floats.
"""

from __future__ import annotations


def _words(n: int) -> int:
    return -(-n // 32)


def pack_bytes(n: int) -> int:
    return 4 * n + 4 * _words(n) + 8


def unpack_bytes(n: int) -> int:
    return 4 * _words(n) + 4 + 4 * n


def unpack_sum_bytes(n: int, ranks: int) -> int:
    return ranks * (4 * _words(n) + 4) + 4 * n


# a compressed chunk's kernels a step, in the engine's chain: the worker
# packs, unpacks its residual and merges the ranks' signs; the server
# packs the merged sum, unpacks its own residual and unpacks the result
PER_CHUNK = {"pack": 2, "unpack": 3, "unpack_sum": 1}


def step_bytes(chunk_numels, ranks: int) -> int:
    """The bytes of one step's onebit kernels over every chunk."""
    return sum(PER_CHUNK["pack"] * pack_bytes(n)
               + PER_CHUNK["unpack"] * unpack_bytes(n)
               + PER_CHUNK["unpack_sum"] * unpack_sum_bytes(n, ranks)
               for n in chunk_numels)
