"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device. A
request for ``cuda`` on a machine without one raises: nothing carries on
silently on the CPU.
"""
from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU"
        )
    return dev


def pin_cpu_gemm_bits() -> None:
    """Make MKL's CPU gemm give the same bits at any thread count.

    MKL splits a gemm's work by the number of threads it runs on, and with
    ``MKL_DYNAMIC`` (on by default) it may run a call on fewer threads than
    its maximum; so a process could compute one step's matmuls in another
    order than the process it is compared with. ``MKL_CBWR=AUTO,STRICT``
    (MKL's strict conditional numerical reproducibility) fixes the order
    for any thread count. MKL reads the variable once, at its first call:
    call this before the process computes anything. A value the caller
    set is kept."""
    os.environ.setdefault("MKL_CBWR", "AUTO,STRICT")


def pin_cpu_threads(device: torch.device) -> None:
    """Run every CPU op of the process on one thread when ``device`` is
    the CPU, so its bits depend on no thread setting.

    PyTorch takes its intra-op thread count from ``MKL_NUM_THREADS`` when
    ``OMP_NUM_THREADS`` is unset, and ATen's reductions fold their input
    in another order on one thread than on several (a 2m run's
    ``grad_norm`` moves at one thread against two or more), as do the MKL
    calls that strict reproducible mode does not cover. With
    ``MKL_DYNAMIC`` (on by default) MKL may run a call on fewer threads
    than its maximum, so two processes could split the same step
    differently. One thread (ATen, OpenMP and MKL:
    ``torch.set_num_threads`` sets all three) gives one order for any
    environment. A card run is unaffected."""
    if device.type == "cpu":
        torch.set_num_threads(1)
