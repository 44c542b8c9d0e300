"""Carry weights between the JAX package and the port.

The two packages share one parameter layout (a nested dict of stacked
[L, ...] leaves, linear weights [in, out]), so conversion is a walk over
the dict: numpy arrays (as ``jax.device_get`` returns them) become
tensors and back, bit for bit when the dtype is kept.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def params_from_numpy(
    tree, device=None, dtype: Optional[torch.dtype] = None, requires_grad: bool = False
):
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``,
    cast to ``dtype`` when given (default: keep each array's dtype).
    ``requires_grad`` marks every leaf as a trainable leaf (the f32
    masters of a training state)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype, requires_grad) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True))  # writable, never aliased
    t = t.to(device=device, dtype=dtype if dtype is not None else t.dtype)
    return t.requires_grad_(True) if requires_grad else t


def params_to_numpy(tree):
    """Nested dict of tensors -> the same dict of numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
