"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device. A
request for ``cuda`` on a machine without one raises: nothing carries on
silently on the CPU.
"""
from __future__ import annotations

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
