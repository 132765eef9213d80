"""Build and load the port's CUDA sources (``byteps_tpu_torch/csrc``).

Each source is a plain C interface over its kernels, compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under
``byteps_tpu_torch/_build/`` and loaded with ``ctypes``.  The library's
file name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one is reused.  :func:`build` starts one
``nvcc`` per source, all at once, and waits for them together.

Nothing here runs at import: the first kernel launch builds its library.
A missing ``nvcc`` or a failed compile raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# compiler output of each source built by this process (ptxas register,
# shared-memory and spill report)
build_logs: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError(
        "byteps_tpu_torch: nvcc not found (PATH, /usr/local/cuda/bin); the "
        "CUDA kernels are built from csrc/ at first use and need the CUDA "
        "toolkit")


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str]) -> Dict[str, Path]:
    """Compile every source not built yet, all ``nvcc`` runs at once."""
    sources = list(sources)
    nvcc = nvcc_path() if any(not library_path(s).exists()
                              for s in sources) else None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for s in sources:
        target = library_path(s)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / s)]
        running.append((s, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for s, target, tmp, proc in running:
        log, _ = proc.communicate()
        build_logs[s] = log
        if proc.returncode != 0:
            failed.append(f"{s} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {s: library_path(s) for s in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(build([source])[source]))
        return lib
