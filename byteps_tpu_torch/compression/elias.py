"""Elias-delta wire frame of dithering codes (host-side); port of
``byteps_tpu/compression/elias.py``, byte for byte.

Per nonzero code: the gap to the previous nonzero index, a sign bit and
``|level|``, the gap and the level Elias-delta coded, LSB-first within
little-endian uint32 words.  The frame:

    word[0]   nbits  (uint32)
    word[1]   numel  (uint32)
    word[2]   norm   (float32 bits)
    word[3:]  the bitstream

The coder is the C one of ``native/core.cc`` (``bps_elias_encode`` /
``bps_elias_decode``, copied from the JAX package's).  A native library
that cannot be built raises (``native/__init__.py``): there is no quiet
fallback.  The numpy twins (:func:`elias_encode_np`,
:func:`elias_decode_np`) are the test oracle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


# ----------------------------------------------------------- numpy twins

def _bits_of(x: int, bits: list) -> None:
    """Append x's Elias-delta code (x >= 1)."""
    n = x.bit_length()
    ln = n.bit_length()
    bits.extend([0] * (ln - 1))
    bits.extend((n >> k) & 1 for k in range(ln - 1, -1, -1))
    bits.extend((x >> k) & 1 for k in range(n - 2, -1, -1))


def elias_encode_np(codes: np.ndarray) -> Tuple[np.ndarray, int]:
    """Bit-exact numpy twin of ``bps_elias_encode``: (words, nbits)."""
    codes = np.asarray(codes, dtype=np.int8)
    bits: list = []
    last = -1
    for i in np.flatnonzero(codes):
        i = int(i)
        _bits_of(i - last, bits)
        c = int(codes[i])
        bits.append(1 if c < 0 else 0)
        _bits_of(abs(c), bits)
        last = i
    nbits = len(bits)
    words = np.zeros((nbits + 31) // 32, np.uint32)
    for pos, b in enumerate(bits):
        if b:
            words[pos >> 5] |= np.uint32(1 << (pos & 31))
    return words, nbits


def elias_decode_np(words: np.ndarray, nbits: int, n: int) -> np.ndarray:
    """Bit-exact numpy twin of ``bps_elias_decode``: dense int8 codes.
    Raises on a malformed stream."""
    words = np.asarray(words, dtype=np.uint32)
    out = np.zeros(n, np.int8)
    pos = 0

    def get() -> int:
        nonlocal pos
        if pos >= nbits:
            raise ValueError("malformed elias-delta stream (truncated)")
        b = (int(words[pos >> 5]) >> (pos & 31)) & 1
        pos += 1
        return b

    def get_elias() -> int:
        zeros = 0
        while get() == 0:
            zeros += 1
            if zeros > 63:
                raise ValueError("malformed elias-delta stream")
        nlen = 1
        for _ in range(zeros):
            nlen = (nlen << 1) | get()
        x = 1
        for _ in range(nlen - 1):
            x = (x << 1) | get()
        return x

    idx = -1
    while pos < nbits:
        gap = get_elias()
        sign = get()
        mag = get_elias()
        if not 1 <= mag <= 127:
            raise ValueError("malformed elias-delta stream (level range)")
        idx += gap
        if idx >= n:
            raise ValueError("malformed elias-delta stream (index range)")
        out[idx] = -mag if sign else mag
    return out


# ------------------------------------------------------------- the coder

def elias_encode(codes: np.ndarray) -> Tuple[np.ndarray, int]:
    """(uint32 words, nbits) of signed int8 codes, by the native coder."""
    from ..native import elias_encode as native_encode
    return native_encode(codes)


def elias_decode(words: np.ndarray, nbits: int, n: int) -> np.ndarray:
    """Dense int8 codes of a bitstream, by the native coder; raises on a
    malformed stream."""
    from ..native import elias_decode as native_decode
    return native_decode(words, nbits, n)


# ------------------------------------------------------------ the frame

def encode_wire(codes: np.ndarray, norm: float) -> bytes:
    """Frame dense signed codes and their norm as wire bytes (explicit
    little-endian: the format must not depend on the producer)."""
    words, nbits = elias_encode(codes)
    header = np.empty(3, np.uint32)
    header[0] = np.uint32(nbits)
    header[1] = np.uint32(len(codes))
    header[2] = np.float32(norm).view(np.uint32)
    return header.astype("<u4").tobytes() + words.astype("<u4").tobytes()


def decode_wire(data: bytes, expected_numel: Optional[int] = None
                ) -> Tuple[np.ndarray, float]:
    """Inverse of :func:`encode_wire`: (dense int8 codes, norm).  The
    frame is checked before its bitstream reaches the decoder; pass
    ``expected_numel`` whenever the size is known, or a forged header
    dictates the allocation."""
    if len(data) < 12:
        raise ValueError("wire frame shorter than its header")
    header = np.frombuffer(data[:12], "<u4")
    nbits, numel = int(header[0]), int(header[1])
    norm = float(header[2:3].astype(np.uint32).view(np.float32)[0])
    if expected_numel is not None and numel != expected_numel:
        raise ValueError(
            f"wire payload numel {numel} != expected {expected_numel}")
    nwords = (nbits + 31) // 32
    if len(data) < 12 + 4 * nwords:
        raise ValueError(
            f"wire frame truncated: header claims {nbits} bits "
            f"({nwords} words) but carries {len(data) - 12} bytes")
    words = np.frombuffer(data[12:12 + 4 * nwords], "<u4").astype(np.uint32)
    return elias_decode(words, nbits, numel), norm


def wire_nbytes(codes: np.ndarray) -> int:
    """Measured size of a payload's frame (header and bitstream)."""
    words, _ = elias_encode(codes)
    return 12 + 4 * len(words)
