"""Onebit pack / unpack / merge: CUDA kernels and their plain versions.

Counterpart of ``byteps_tpu/ops/pallas_kernels.py``.  The wire layout is
the JAX package's: a chunk of ``numel`` floats, zero-padded to ``32 * L``
with ``L = padded_lanes(numel)`` (words rounded up to a multiple of
``LANES = 128``, which ``wire_decode`` checks, so the padding is part of
the wire format), is viewed as a ``(32, L)`` matrix and bit ``i`` of word
``j`` is ``x[i * L + j] >= 0``.  Padding packs as 1 bits, ``-0.0`` as 1
and NaN as 0.

Words are carried as ``torch.int32`` tensors holding the uint32 bit
pattern (collectives and indexing are the same for both); ``.view`` them
as unsigned in numpy.

Each kernel has a wrapper and a plain PyTorch version.  The wrapper runs
the plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel of ``csrc/onebit.cu`` on the current stream or
raises.  ``launches`` counts kernel launches per wrapper.

Which TPU kernel each replaces, and what bounds it on an H100 (device
memory bytes, for a chunk of n floats):

- ``onebit_pack``: ``byteps_tpu/ops/pallas_kernels.py:77`` onebit_pack
  (``_pack_kernel``); reads 4n bytes, writes n/8.
- ``onebit_unpack``: ``pallas_kernels.py:113`` onebit_unpack
  (``_unpack_kernel``); reads n/8 bytes, writes 4n.
- ``onebit_unpack_sum``: ``pallas_kernels.py:142`` onebit_unpack_sum
  (``_unpack_sum_kernel``); reads R*n/8 bytes, writes 4n.

The source (``csrc/onebit.cu``) says what holds them back at the main
path's chunk sizes and what the design does about it.  pack, unpack and
unpack_sum take tiles of ``4 * vw`` words by 32 rows, one block of 256
threads each, 16 bytes per access; :func:`launch_geometry` picks ``vw``
from the chunk's words, and an input that is not 16-byte aligned takes
the kernels' scalar-access instance (:func:`_aligned`).  Each is one
launch.  pack's last block adds the blocks' L1 partials in index order,
which it knows are all there by the tag each carries, kept in a
workspace per device and stream (:func:`_workspace`); unpack_sum adds
the ranks in the order r = 0..R-1 from +0.0, as the reference does.  No
atomics: the scale and the merge have the same bits from run to run.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import build as _build

LANES = 128
SOURCE = "onebit.cu"

# pack, unpack and unpack_sum take tiles of 4 * vw words by 32 rows, one
# block each.  pack: the widest tile that still gives PACK_MIN_BLOCKS
# blocks (about half the SMs of an H100), else the narrowest; unpack and
# unpack_sum: UNPACK_VW.  Each was the fastest over the ResNet-50 slice's
# chunk sizes on an H100 (python -m byteps_tpu_torch.tools.onebit_widths).
VECTOR_WIDTHS = (32, 16, 8)
PACK_MIN_BLOCKS = 64
UNPACK_VW = 16
# int32 slots of a pack workspace before its partials (the last pack's
# tag, then padding to 128 bytes); each partial takes two (8 bytes)
WS_HEAD = 32

# kernel launches per wrapper since the last reset_launches()
launches: Dict[str, int] = {"onebit_pack": 0, "onebit_unpack": 0,
                            "onebit_unpack_sum": 0}
# onebit_unpack_sum's launches by the ranks R it merged
merge_ranks: Dict[int, int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    merge_ranks.clear()


def padded_lanes(numel: int) -> int:
    """uint32 words for ``numel`` floats, rounded up to LANES."""
    words = -(-numel // 32)
    return -(-words // LANES) * LANES


# --- plain versions ----------------------------------------------------------

def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)[:, None]


def onebit_pack_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 chunk -> ((L,) int32 words, (2,) f32 [sum|x|, sum|x|/numel])."""
    numel = x.numel()
    L = padded_lanes(numel)
    xf = x.reshape(-1).to(torch.float32)
    x2d = F.pad(xf, (0, 32 * L - numel)).view(32, L)
    w = ((x2d >= 0).to(torch.int64) << _shifts(x.device)).sum(0)
    words = (w - ((w >> 31) << 32)).to(torch.int32)   # uint32 bit pattern
    abs_sum = x2d.abs().sum()
    return words, torch.stack([abs_sum, abs_sum / numel])


def _expand_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., L) int32 words -> (..., 32, L) f32 of +-1."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w.unsqueeze(-2) >> _shifts(words.device)) & 1
    return bits.to(torch.float32) * 2.0 - 1.0


def onebit_unpack_plain(words: torch.Tensor, scale: torch.Tensor,
                        numel: int) -> torch.Tensor:
    """((L,) words, scalar scale) -> (numel,) f32 of ``sign * scale``."""
    return (_expand_bits(words) * scale).reshape(-1)[:numel]


def onebit_unpack_sum_plain(words: torch.Tensor, scales: torch.Tensor,
                            numel: int) -> torch.Tensor:
    """((R, L) words, (R,) scales) -> (numel,) f32 of
    ``sum_r sign_r * scale_r``, added in rank order r = 0..R-1."""
    acc = torch.zeros((32, words.shape[1]), dtype=torch.float32,
                      device=words.device)
    for r in range(words.shape[0]):
        acc = acc + _expand_bits(words[r]) * scales[r]
    return acc.reshape(-1)[:numel]


# --- CUDA wrappers ----------------------------------------------------------

def launch_geometry(L: int, kernel: str) -> Tuple[int, int]:
    """(vw, blocks) of ``kernel`` ("onebit_pack", "onebit_unpack" or
    "onebit_unpack_sum") for ``L`` words: tiles of ``4 * vw`` words, one
    block each, ``blocks * 4 * vw == L`` (L is a multiple of LANES, so of
    every tile width)."""
    if kernel in ("onebit_unpack", "onebit_unpack_sum"):
        vw = UNPACK_VW
    else:
        vw = next((w for w in VECTOR_WIDTHS
                   if L // (4 * w) >= PACK_MIN_BLOCKS), VECTOR_WIDTHS[-1])
    return vw, L // (4 * vw)


def _aligned(*ts: torch.Tensor) -> bool:
    """Whether every tensor starts 16-byte aligned: the kernels' 16-byte
    instance, else their scalar-access one."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


_workspaces: Dict[Tuple[str, int, int], torch.Tensor] = {}
_ws_lock = threading.Lock()


def _workspace(device: torch.device, stream: int,
               blocks: int) -> torch.Tensor:
    """The pack's int32 workspace on ``device`` for ``stream``: the last
    pack's tag (slot 0) and room for ``blocks`` tagged partials of 8 bytes
    from slot WS_HEAD on.  Zeroed once when made, on ``stream``; each pack
    tags its partials one above the last pack's tag, so the packs of one
    stream share it in stream order, and two streams never share one."""
    key = (device.type, device.index, stream)
    with _ws_lock:
        ws = _workspaces.get(key)
        if ws is None or ws.numel() < WS_HEAD + 2 * blocks:
            have = 0 if ws is None else ws.numel() - WS_HEAD
            ws = torch.zeros(WS_HEAD + max(2 * blocks, 2 * have, 2048),
                             dtype=torch.int32, device=device)
            _workspaces[key] = ws
        return ws


_c_fns = None


def _lib():
    """The kernels' C entry points, built and typed on first use."""
    global _c_fns
    if _c_fns is None:
        lib = _build.load(SOURCE)
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bps_onebit_error_string.argtypes = [i]
        lib.bps_onebit_error_string.restype = ctypes.c_char_p
        lib.bps_onebit_pack.argtypes = [p, ll, i, i, i, p, p, p, p]
        lib.bps_onebit_unpack.argtypes = [p, p, i, i, i, ll, p, p]
        lib.bps_onebit_unpack_sum.argtypes = [p, p, i, i, i, i, ll, p, p]
        for fn in (lib.bps_onebit_pack, lib.bps_onebit_unpack,
                   lib.bps_onebit_unpack_sum):
            fn.restype = i
        _c_fns = lib
    return _c_fns


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA or CPU tensor, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().bps_onebit_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def onebit_pack(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 chunk -> ((L,) int32 words, (2,) f32 [sum|x|, sum|x|/numel])."""
    if x.device.type == "cpu":
        return onebit_pack_plain(x)
    _check(x, torch.float32, "onebit_pack input")
    numel = x.numel()
    L = padded_lanes(numel)
    vw, blocks = launch_geometry(L, "onebit_pack")
    with torch.cuda.device(x.device):
        stream = _stream(x)
        words = torch.empty(L, dtype=torch.int32, device=x.device)
        sums = torch.empty(2, dtype=torch.float32, device=x.device)
        ws = _workspace(x.device, stream, blocks)   # held over the launch
        rc = _lib().bps_onebit_pack(x.data_ptr(), numel, L, vw,
                                    int(_aligned(x)), words.data_ptr(),
                                    ws.data_ptr(), sums.data_ptr(), stream)
    _raise_on(rc, "onebit_pack")
    launches["onebit_pack"] += 1
    return words, sums


def onebit_unpack(words: torch.Tensor, scale: torch.Tensor,
                  numel: int) -> torch.Tensor:
    """((L,) int32 words, scalar f32 scale) -> (numel,) f32 sign * scale."""
    if words.device.type == "cpu":
        return onebit_unpack_plain(words, scale, numel)
    _check(words, torch.int32, "onebit_unpack words")
    _check(scale, torch.float32, "onebit_unpack scale")
    L = words.numel()
    if words.dim() != 1 or L != padded_lanes(numel) or scale.numel() != 1:
        raise ValueError(f"onebit_unpack: {L} words / {scale.numel()} "
                         f"scale(s) do not describe {numel} elements")
    vw, _ = launch_geometry(L, "onebit_unpack")
    with torch.cuda.device(words.device):
        out = torch.empty(numel, dtype=torch.float32, device=words.device)
        rc = _lib().bps_onebit_unpack(words.data_ptr(), scale.data_ptr(), L,
                                      vw, int(_aligned(words, out)), numel,
                                      out.data_ptr(), _stream(words))
    _raise_on(rc, "onebit_unpack")
    launches["onebit_unpack"] += 1
    return out


def onebit_unpack_sum(words: torch.Tensor, scales: torch.Tensor,
                      numel: int) -> torch.Tensor:
    """((R, L) int32 words, (R,) f32 scales) -> (numel,) f32 merge."""
    if words.device.type == "cpu":
        return onebit_unpack_sum_plain(words, scales, numel)
    _check(words, torch.int32, "onebit_unpack_sum words")
    _check(scales, torch.float32, "onebit_unpack_sum scales")
    if (words.dim() != 2 or words.shape[1] != padded_lanes(numel)
            or scales.numel() != words.shape[0]):
        raise ValueError(f"onebit_unpack_sum: words {tuple(words.shape)} / "
                         f"{scales.numel()} scales do not describe "
                         f"{numel} elements")
    R, L = words.shape
    vw, _ = launch_geometry(L, "onebit_unpack_sum")
    with torch.cuda.device(words.device):
        out = torch.empty(numel, dtype=torch.float32, device=words.device)
        rc = _lib().bps_onebit_unpack_sum(words.data_ptr(), scales.data_ptr(),
                                          R, L, vw, int(_aligned(words, out)),
                                          numel, out.data_ptr(),
                                          _stream(words))
    _raise_on(rc, "onebit_unpack_sum")
    launches["onebit_unpack_sum"] += 1
    merge_ranks[R] = merge_ranks.get(R, 0) + 1
    return out
