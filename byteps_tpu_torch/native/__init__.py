"""ctypes bindings for the native core (``core.cc``); port of the
scheduler, Elias-delta, host-reducer and CRC32C parts of
``byteps_tpu/native/__init__.py``.

:func:`load` compiles ``core.cc`` with ``g++`` at first use into
``byteps_tpu_torch/_build/``, under a file name that carries a hash of
the source and the flags, and loads it.  Nothing runs at import.

Unlike the JAX package, which logs and falls back to the Python heap
and the numpy Elias twin, a failed build or load raises: the engine asks
for this scheduler only when ``Config.use_native`` is set, and a run that
silently took the other queue, or the other coder, would measure
something else than it says.  ``BYTEPS_NATIVE=0`` (``use_native=False``)
selects the Python heap explicitly; the Elias coder and the CRC32C have
no other implementation outside the tests.  :func:`inplace_add` adds
with the native reducer for the dtypes it has (f32, f64, i32, i64,
bf16) and with a plain ``add`` otherwise, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

SOURCE = Path(__file__).resolve().with_name("core.cc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
ABI_VERSION = 3

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libbps_native_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("byteps_tpu_torch: g++ not found; the native "
                           "scheduler is built from native/core.cc at first "
                           "use (BYTEPS_NATIVE=0 selects the Python one)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, target)     # atomic: concurrent builds agree


def load() -> ctypes.CDLL:
    """The native library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _compile(target)
            lib = ctypes.CDLL(str(target))
            _declare_signatures(lib)
            if lib.bps_native_abi_version() != ABI_VERSION:
                raise RuntimeError(f"{target.name}: native ABI mismatch")
            _lib = lib
        return _lib


def _declare_signatures(lib: ctypes.CDLL) -> None:
    i64, u64, p = ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p
    lib.bps_sched_create.restype = p
    lib.bps_sched_create.argtypes = [i64]
    lib.bps_sched_destroy.restype = None
    lib.bps_sched_destroy.argtypes = [p]
    lib.bps_sched_add.restype = None
    lib.bps_sched_add.argtypes = [p, i64, i64, u64, i64]
    lib.bps_sched_get.restype = i64
    lib.bps_sched_get.argtypes = [p, ctypes.c_int, ctypes.c_double,
                                  ctypes.POINTER(i64)]
    for name in ("bps_sched_report_finish", "bps_sched_set_credit"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [p, i64]
    for name in ("bps_sched_wake", "bps_sched_interrupt"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [p]
    for name in ("bps_sched_get_credit", "bps_sched_pending",
                 "bps_sched_in_flight"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [p]
    lib.bps_sched_drain.restype = i64
    lib.bps_sched_drain.argtypes = [p, ctypes.POINTER(i64), i64]
    lib.bps_elias_encode.restype = i64
    lib.bps_elias_encode.argtypes = [ctypes.POINTER(ctypes.c_int8), i64,
                                     ctypes.POINTER(ctypes.c_uint32), i64]
    lib.bps_elias_decode.restype = i64
    lib.bps_elias_decode.argtypes = [ctypes.POINTER(ctypes.c_uint32), i64,
                                     ctypes.POINTER(ctypes.c_int8), i64]
    lib.bps_native_abi_version.restype = ctypes.c_int
    lib.bps_native_abi_version.argtypes = []
    for name in _REDUCE_FNS.values():
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [p, p, i64, ctypes.c_int]
    lib.bps_crc32c.restype = ctypes.c_uint32
    lib.bps_crc32c.argtypes = [p, i64, ctypes.c_uint32]


# ------------------------------------------------------------- cpu reducer

_REDUCE_FNS = {
    torch.float32: "bps_reduce_sum_f32",
    torch.float64: "bps_reduce_sum_f64",
    torch.int32: "bps_reduce_sum_i32",
    torch.int64: "bps_reduce_sum_i64",
    torch.bfloat16: "bps_reduce_sum_bf16",
}
_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}

HostArray = Union[torch.Tensor, np.ndarray]


def _describe(x: HostArray):
    """(address, dtype as torch's, C-contiguous, shape) of a host array."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"inplace_add takes host arrays, got a tensor "
                             f"on {x.device}")
        return x.data_ptr(), x.dtype, x.is_contiguous(), tuple(x.shape)
    return (x.ctypes.data, _NP_TO_TORCH.get(x.dtype), x.flags.c_contiguous,
            x.shape)


def inplace_add(dst: HostArray, src: HostArray,
                nthreads: int = 0) -> HostArray:
    """``dst += src`` with the native multithreaded reducer; either
    argument is a CPU tensor or a numpy array.  Other dtypes and layouts
    take a plain add, as in the JAX package.  Returns ``dst``."""
    lib = load()
    dp, dt, dc, dshape = _describe(dst)
    sp, st, sc, sshape = _describe(src)
    if dt is None or dt != st or not (dc and sc) or dshape != sshape \
            or dt not in _REDUCE_FNS:
        if isinstance(dst, torch.Tensor):
            if isinstance(src, np.ndarray):   # may be a read-only view
                src = torch.from_numpy(np.array(src))
            dst.add_(src.reshape(dshape))
        else:
            np.add(dst, np.asarray(src), out=dst)
        return dst
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    n = int(np.prod(dshape, dtype=np.int64))
    getattr(lib, _REDUCE_FNS[dt])(dp, sp, n, nthreads)
    return dst


# ------------------------------------------------------------------ crc32c

def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of a buffer (bytes or a C-contiguous
    memoryview), continuing ``crc``; no copy of the buffer."""
    lib = load()
    mv = memoryview(data)
    if not mv.c_contiguous:
        mv = memoryview(bytes(mv))
    # np.frombuffer exposes the address of a read-only buffer, which
    # ctypes' from_buffer refuses
    view = np.frombuffer(mv.cast("B") if mv.ndim != 1 or mv.format != "B"
                         else mv, dtype=np.uint8)
    return int(lib.bps_crc32c(view.ctypes.data, view.nbytes,
                              crc & 0xFFFFFFFF))


def elias_encode(codes: np.ndarray) -> Tuple[np.ndarray, int]:
    """Elias-delta code signed int8 level codes: (uint32 words, nbits)."""
    lib = load()
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    cap = max(4, codes.size + 64)
    while True:
        out = np.zeros(cap, np.uint32)
        nbits = lib.bps_elias_encode(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), codes.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), cap)
        if nbits == -2:         # the buffer was too small
            cap *= 2
            continue
        return out[:(int(nbits) + 31) // 32].copy(), int(nbits)


def elias_decode(words: np.ndarray, nbits: int, n: int) -> np.ndarray:
    """Dense int8 codes of ``n`` elements from an Elias-delta bitstream;
    raises on a malformed one."""
    lib = load()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if 32 * words.size < nbits:
        raise ValueError("elias-delta stream shorter than its bit count")
    out = np.zeros(n, np.int8)
    rc = lib.bps_elias_decode(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), int(nbits),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), n)
    if rc != 0:
        raise ValueError("malformed elias-delta stream")
    return out


class NativeChunkScheduler:
    """``common.scheduler.ChunkScheduler`` backed by the C++ queue: the
    same interface and pop order.  Python keeps the task objects; the
    priority, key, bytes and the credit window live native."""

    def __init__(self, credit_bytes: int = 0):
        self._lib = load()
        self._h = self._lib.bps_sched_create(int(credit_bytes))
        self._tasks = {}
        self._next_id = 0
        self._mu = threading.Lock()

    def add_task(self, task) -> None:
        with self._mu:
            tid = self._next_id
            self._next_id += 1
            self._tasks[tid] = task
        self._lib.bps_sched_add(self._h, tid, task.priority, task.key,
                                task.nbytes)

    def get_task(self, block: bool = False,
                 timeout: Optional[float] = None):
        tid = self._lib.bps_sched_get(
            self._h, 1 if block else 0,
            -1.0 if timeout is None else float(timeout), None)
        if tid < 0:
            return None
        with self._mu:
            return self._tasks.pop(tid)

    def report_finish(self, nbytes: int) -> None:
        self._lib.bps_sched_report_finish(self._h, int(nbytes))

    def interrupt(self) -> None:
        """One-shot wakeup of a blocked get_task (pause handshake)."""
        self._lib.bps_sched_interrupt(self._h)

    def wake(self) -> None:
        """Latched wakeup: every blocked and future get_task returns."""
        self._lib.bps_sched_wake(self._h)

    def set_credit_bytes(self, credit_bytes: int) -> None:
        self._lib.bps_sched_set_credit(self._h, int(credit_bytes))

    @property
    def credit_bytes(self) -> int:
        return int(self._lib.bps_sched_get_credit(self._h))

    @property
    def pending(self) -> int:
        return int(self._lib.bps_sched_pending(self._h))

    @property
    def bytes_in_flight(self) -> int:
        return int(self._lib.bps_sched_in_flight(self._h))

    def drain(self) -> list:
        cap = max(1, self.pending)
        ids = (ctypes.c_int64 * cap)()
        n = self._lib.bps_sched_drain(self._h, ids, cap)
        with self._mu:
            return [self._tasks.pop(ids[i]) for i in range(n)]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.bps_sched_destroy(h)
            self._h = None
