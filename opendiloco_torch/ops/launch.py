"""Launching the hand-written CUDA kernels, and counting their launches.

Every kernel wrapper of the port (``ops/decode_kernels.py``,
``ops/flash_attention.py``) goes through :func:`launch`: it loads the
kernel's library (built at first use by :mod:`~opendiloco_torch.ops.build`),
calls the exported C function on the current stream, raises on any
``cudaError_t`` other than 0, and adds one to the kernel's entry in
:data:`LAUNCHES`. Only a launch on the card counts.

:data:`LAUNCHES` is one counter for all kernels, safe under threads: two
DiLoCo workers in one process launch kernels concurrently (ctypes releases
the GIL during a call), and a run's counts must stay exact. It also keeps
the launches of each thread (:meth:`LaunchCounter.by_thread`): the ranks
of a loopback group, one thread each, are counted apart.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from opendiloco_torch.ops import build

SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
# the 16-bit types that the tensor-core designs take (the sm90 kernels'
# route rules); f32 takes the first designs
HALF_DTYPES = (torch.bfloat16, torch.float16)
P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class LaunchCounter(dict):
    """Launches by kernel name. Reads are plain dict reads; every change
    goes through :meth:`add` or :meth:`reset`, which hold one lock."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._threads: dict = {}  # thread ident -> {name: launches}

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self[name] = self.get(name, 0) + n
            mine = self._threads.setdefault(threading.get_ident(), {})
            mine[name] = mine.get(name, 0) + n

    def reset(self) -> None:
        with self._lock:
            for name in self:
                self[name] = 0
            self._threads.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self)

    def by_thread(self) -> dict:
        """{thread ident: {name: launches}} since the last reset."""
        with self._lock:
            return {t: dict(c) for t, c in self._threads.items()}


LAUNCHES = LaunchCounter()
_fns: dict = {}
_fns_lock = threading.Lock()
_bound = threading.local()  # the device indices this thread has a CUDA context bound for


def register(*names: str) -> None:
    """Give each kernel name its entry (0), so a run that never launched
    it still reports it."""
    for name in names:
        LAUNCHES.setdefault(name, 0)


def _entry(source: str, symbol: str, argtypes):
    with _fns_lock:
        fn = _fns.get(symbol)
        if fn is None:
            lib = build.load(source)
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            fn = _fns[symbol] = (fn, lib)
        return fn


def launch(name: str, source: str, symbol: str, argtypes, device: torch.device, *args) -> None:
    """Call ``symbol`` of ``csrc/<source>.cu`` on the current stream of
    ``device``, with ``device`` the thread's current CUDA device (the C
    side's per-device set-up reads ``cudaGetDevice``), and count it under
    ``name``. Pointers are passed as ints (``data_ptr``); the caller keeps
    every tensor alive, and PyTorch reuses freed memory only in stream
    order, after the kernel."""
    fn, lib = _entry(source, symbol, argtypes)
    _bind_context(device.index if device.index is not None else torch.cuda.current_device())
    # the raw stream, not torch.cuda.current_stream(device).cuda_stream: that
    # builds a torch.cuda.Stream object, microseconds of host time a launch on
    # a host-bound decode step; and a device switch only where the device is
    # not already current (the switch costs more host time than the launch)
    index = torch.cuda.current_device()
    if device.index is None or device.index == index:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA launch failed: {lib.cuda_error_string(err).decode()} ({err})"
        )
    LAUNCHES.add(name)


def _bind_context(index: int) -> None:
    """Bind the device's CUDA context to this thread once: a thread that
    has run no PyTorch op on the card has none current, and a kernel
    launched from it fails ("invalid argument") though the same launch
    from the main thread succeeds (the ring's loopback ranks, one thread
    each, launch before any op of their own). One small PyTorch op binds
    it; afterwards the check is one attribute read."""
    done = getattr(_bound, "indices", None)
    if done is None:
        done = _bound.indices = set()
    if index not in done:
        torch.zeros(1, device=torch.device("cuda", index)).add_(1)
        done.add(index)


def on_card(*tensors: torch.Tensor) -> bool:
    """True when all tensors lie on one CUDA device, False when all lie on
    the CPU; anything else raises."""
    index = tensors[0].get_device()  # the fast test first: all on one card
    if index >= 0 and all(t.is_cuda and t.get_device() == index for t in tensors):
        return True
    dev = tensors[0].device
    if all(t.device == dev for t in tensors) and dev.type in ("cpu", "cuda"):
        return dev.type == "cuda"
    raise ValueError(
        f"tensors must all be on the CPU or all on one CUDA device, got {[str(t.device) for t in tensors]}"
    )
