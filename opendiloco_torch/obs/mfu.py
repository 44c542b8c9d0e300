"""Achieved-MFU estimation from the model's shapes and the card's peak.

The port's one obs module that is not a copy of the JAX package's: that
module reads a TPU roofline file and defaults to a TPU peak, and neither
belongs on a GPU. Here the model FLOPs per token are the standard
``6 * n_params`` training estimate (the JAX module's own fallback, source
``analytic_6n``) and the peak comes from :data:`PEAK_FLOPS`, keyed by
``torch.cuda.get_device_name()``. A device not in the table, or the CPU,
has no peak: the source is ``unavailable``, the FLOPs are ``None`` and a
metric row carries no ``mfu``, as the JAX package's rows do when it has
no FLOPs. Everything is computed once at startup; the per-step cost of
the gauge is one multiply.
"""
from __future__ import annotations

from typing import Optional

# dense (no sparsity) bf16 tensor-core peak of one card, FLOP/s
PEAK_FLOPS = {
    # H100 SXM5 at its 700 W power limit: 989 TFLOP/s bf16 dense (NVIDIA
    # H100 Tensor Core GPU datasheet; 1,979 with sparsity)
    "NVIDIA H100 80GB HBM3": 989e12,
}


def device_name() -> Optional[str]:
    """The first CUDA device's name, or None without one."""
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else None


def flops_per_token(
    path_model: str, n_params: Optional[int] = None, device: Optional[str] = None
) -> "tuple[Optional[float], Optional[float], str]":
    """-> (total model flops per token or None, per-device peak or None,
    source). ``device`` is the card's name (None: this process's first
    CUDA device, if any). ``path_model`` names the model as the JAX
    signature does; the estimate reads only ``n_params``."""
    peak = PEAK_FLOPS.get(device if device is not None else device_name())
    if peak is None or not n_params:
        return None, peak, "unavailable"
    return 6.0 * float(n_params), peak, "analytic_6n"


def mfu(
    tokens_per_second: float,
    model_flops_per_token: float,
    n_devices: int,
    peak_flops_per_device: float,
) -> float:
    """Model FLOPs utilization in [0, ~1] across ``n_devices`` cards."""
    achieved = model_flops_per_token * tokens_per_second
    return achieved / (peak_flops_per_device * max(1, n_devices))
