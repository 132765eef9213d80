"""Stochastic (dithered) quantization; port of
``byteps_tpu/compression/dithering.py``.

Magnitudes are normalized by the chunk's max or L2 norm and rounded
stochastically onto ``s`` levels, linear (``i / s``) or natural
(``2**-j``), with the counter-based PRNG (``prng.py``) drawing the
rounding; the counter advances by ``numel`` each step.  Two layouts, as
in the JAX package:

- dense (default): a signed int8 code per element, and the norm;
- sparse (``sparse_ratio > 0``): the ``k = ceil(ratio * numel)`` entries
  of largest ``|code|`` as ``(idx, codes, norm)``.  Nearly all codes tie,
  so the top-k must be ``lax.top_k``'s stable one
  (``common.stable_topk``).  ``idx`` keeps the JAX wire width: uint16
  when ``numel <= 0xFFFF``, held here as an int16 view (the way onebit's
  uint32 words are held as int32; widen with ``& 0xFFFF``), else int32.

The host wire frame (``wire_encode``/``wire_decode``) is the Elias-delta
coding of ``elias.py``, byte-identical to the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import prng
from .base import Compressor, Payload, State
from .common import stable_topk


def _levels(scheme: str, s: int) -> np.ndarray:
    if scheme == "linear":
        return (np.arange(s + 1) / s).astype(np.float32)
    if scheme == "natural":
        lv = [0.0] + [2.0 ** -(s - 1 - i) for i in range(s)]
        return np.asarray(lv, dtype=np.float32)
    raise ValueError(f"unknown partition scheme: {scheme}")


def _to_u16(idx: torch.Tensor) -> torch.Tensor:
    """int64 indices in [0, 0xFFFF] as the int16 bit patterns of uint16."""
    return torch.where(idx >= 0x8000, idx - 0x10000, idx).to(torch.int16)


def widen_idx(idx: torch.Tensor) -> torch.Tensor:
    """A payload's ``idx`` (int16-held uint16, or int32) as int64."""
    if idx.dtype == torch.int16:
        return idx.to(torch.int64) & 0xFFFF
    return idx.to(torch.int64)


class DitheringCompressor(Compressor):
    name = "dithering"
    bidirectional = True

    def __init__(self, numel: int, dtype: torch.dtype = torch.float32,
                 s: int = 16, partition: str = "linear",
                 normalize: str = "max", seed: int = 0,
                 sparse_ratio: float = 0.0):
        super().__init__(numel, dtype)
        if not 1 <= s <= 127:
            raise ValueError("s must be in [1, 127] for int8 codes")
        if normalize not in ("max", "l2"):
            raise ValueError(f"unknown normalization: {normalize}")
        if not 0.0 <= sparse_ratio <= 1.0:
            raise ValueError("sparse_ratio must be in [0, 1]")
        self.s = s
        self.partition = partition
        self.normalize = normalize
        self.seed = int(seed)
        self.level_table = _levels(partition, s)
        self.sparse_k = (max(1, math.ceil(sparse_ratio * numel))
                         if sparse_ratio > 0 else 0)
        # the narrowest index that addresses the chunk (JAX: uint16/uint32)
        self.idx_bytes = 2 if numel <= 0xFFFF else 4
        self._lv = {}           # device -> the level table there

    def _levels_on(self, device) -> torch.Tensor:
        key = str(device)
        lv = self._lv.get(key)
        if lv is None:
            lv = self._lv[key] = torch.from_numpy(self.level_table).to(device)
        return lv

    def init_state(self, device) -> State:
        return {"counter": torch.zeros((), dtype=torch.int64, device=device)}

    def quantize(self, xf: torch.Tensor, norm: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
        """int8 signed codes of the f32 ``xf`` under ``norm``, rounded up
        where the uniform draw ``r`` (one per element) falls below the
        remainder.  The sharded update's parameter leg calls it on one
        block of a vector with the vector's norm and the block's draws."""
        mag = xf.abs()
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        u = torch.clamp(mag / safe, 0.0, 1.0)
        lv = self._levels_on(xf.device)
        # L[i] <= u < L[i+1]
        i = torch.clamp(torch.searchsorted(lv, u, right=True) - 1,
                        0, self.s - 1)
        lo, hi = lv[i], lv[i + 1]
        p = (u - lo) / (hi - lo)
        code = i + (r < p)
        return torch.where(xf < 0, -code, code).to(torch.int8)

    def compress(self, x: torch.Tensor, state: State):
        xf = x.reshape(-1).to(torch.float32)
        mag = xf.abs()
        norm = (mag.max() if self.normalize == "max"
                else torch.sqrt(torch.sum(mag * mag)))
        r = prng.uniform(self.seed, state["counter"], self.numel)
        signed = self.quantize(xf, norm, r)
        new_state = {"counter": (state["counter"] + self.numel) & prng._M32}
        if self.sparse_k:
            idx = stable_topk(signed.abs(), self.sparse_k)
            held = (_to_u16(idx) if self.idx_bytes == 2
                    else idx.to(torch.int32))
            return {"idx": held, "codes": signed[idx],
                    "norm": norm}, new_state
        return {"codes": signed, "norm": norm}, new_state

    def _decode_values(self, codes: torch.Tensor,
                       norm: torch.Tensor) -> torch.Tensor:
        mags = self._levels_on(codes.device)[codes.abs()] * norm
        return torch.sign(codes).to(torch.float32) * mags

    def decompress(self, payload: Payload) -> torch.Tensor:
        codes = payload["codes"].to(torch.int64)
        vals = self._decode_values(codes, payload["norm"])
        if "idx" in payload:
            dense = torch.zeros(self.numel, dtype=torch.float32,
                                device=vals.device)
            dense[widen_idx(payload["idx"])] = vals
            vals = dense
        return vals.to(self.dtype)

    def payload_nbytes(self) -> int:
        if self.sparse_k:
            return self.sparse_k * (self.idx_bytes + 1) + 4
        return self.numel + 4   # an int8 code per element, and the norm

    def cache_key(self) -> tuple:
        return super().cache_key() + (self.s, self.partition,
                                      self.normalize, self.seed,
                                      self.sparse_k)

    # -- the host wire frame: Elias-delta codes (elias.py) --------------------
    def _dense_codes(self, payload: Payload) -> np.ndarray:
        codes = payload["codes"].detach().cpu().numpy().astype(np.int8)
        if "idx" in payload:
            dense = np.zeros(self.numel, np.int8)
            dense[widen_idx(payload["idx"]).cpu().numpy()] = codes
            return dense
        return codes

    def wire_encode(self, payload: Payload) -> bytes:
        """The reference's Elias-delta gap/sign/level frame of the
        payload (host-side; ``elias.encode_wire``)."""
        from .elias import encode_wire
        return encode_wire(self._dense_codes(payload),
                           float(payload["norm"]))

    def wire_decode(self, data: bytes) -> Payload:
        """Inverse of :meth:`wire_encode`, in this codec's layout.  The
        frame's numel must be this codec's: wire bytes are untrusted, and
        a forged header must not dictate an allocation."""
        from .elias import decode_wire
        codes, norm = decode_wire(data, expected_numel=self.numel)
        codes = torch.from_numpy(codes)
        payload: Payload = {"codes": codes,
                            "norm": torch.tensor(norm, dtype=torch.float32)}
        if self.sparse_k:
            idx = stable_topk(codes.abs(), self.sparse_k)
            payload = {"idx": (_to_u16(idx) if self.idx_bytes == 2
                               else idx.to(torch.int32)),
                       "codes": codes[idx], "norm": payload["norm"]}
        return payload

    def wire_nbytes(self, payload: Payload) -> int:
        """Measured size of this payload's Elias-delta frame."""
        from .elias import wire_nbytes
        return wire_nbytes(self._dense_codes(payload))
