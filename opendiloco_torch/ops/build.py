"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers: such a build takes seconds, where
``torch.utils.cpp_extension.load`` takes minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o csrc/build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source rebuilds and a stale library is never loaded. Only sources in
the repository are built. Builds happen at first use (or all at once,
in parallel, through :func:`build`), never at import.

Every exported C function returns the ``cudaError_t`` of its launch; the
kernel wrappers (``ops/decode_kernels.py``) raise on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on the card's machine")
    return path


def _source(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    if not os.path.isfile(src):
        raise FileNotFoundError(f"no CUDA source {src}")
    return src


def library_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def _start(name: str) -> tuple[subprocess.Popen, str, str]:
    out = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: str, out: str) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            + log.decode(errors="replace")
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build(names: Iterable[str]) -> float:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Returns the wall seconds."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [(n, *_start(n)) for n in names if not os.path.exists(library_path(n))]
        for name, proc, tmp, out in jobs:
            _finish(name, proc, tmp, out)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not os.path.exists(out):
            _finish(name, *_start(name))
        lib = _loaded[name] = ctypes.CDLL(out)
        return lib
