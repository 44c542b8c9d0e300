"""Host-side outer optimizer: Nesterov-momentum SGD on the master leaves.

The port's copy of ``opendiloco_tpu/diloco/outer_optimizer.py``
``OuterSGD``. Numerically torch.optim.SGD(lr=0.7, momentum=0.9,
nesterov=True), the reference's outer optimizer:

    buf   = momentum * buf + grad
    d     = grad + momentum * buf        (nesterov)  |  d = buf (plain)
    param = param - lr * d

It runs in numpy on host RAM: the master copy never touches the card. The
JAX package fuses this body into a native OpenMP kernel when its library
is built; the port runs the numpy body as written.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class OuterSGD:
    def __init__(self, lr: float = 0.7, momentum: float = 0.9, nesterov: bool = True):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.bufs: Optional[list[np.ndarray]] = None

    def step(self, params: list[np.ndarray], grads: list[np.ndarray]) -> None:
        """In-place update of ``params`` given pseudo-gradients ``grads``."""
        self.step_indices(params, grads, range(len(params)))

    def step_indices(self, params: list[np.ndarray], grads: list[np.ndarray], idxs) -> None:
        """In-place update of ``params[i] for i in idxs`` given
        pseudo-gradients aligned to ``idxs``: the one copy of the update
        rule."""
        if self.momentum == 0.0:
            for j, i in enumerate(idxs):
                params[i] -= self.lr * grads[j]
            return
        if self.bufs is None:
            self.bufs = [np.zeros_like(p) for p in params]
        for j, i in enumerate(idxs):
            p, g, buf = params[i], grads[j], self.bufs[i]
            np.multiply(buf, self.momentum, out=buf)
            buf += g
            if self.nesterov:
                d = g + self.momentum * buf
            else:
                d = buf
            p -= self.lr * d

    def clone(self) -> "OuterSGD":
        """Deep copy, for the step-the-clone-then-rebind discipline that
        keeps published buf arrays bit-stable."""
        new = OuterSGD(lr=self.lr, momentum=self.momentum, nesterov=self.nesterov)
        new.bufs = None if self.bufs is None else [b.copy() for b in self.bufs]
        return new

    def state_dict_refs(self) -> dict:
        """state_dict without the buf copies: arrays are shared with the
        live optimizer (safe while every mutation rebinds)."""
        return {"lr": self.lr, "momentum": self.momentum, "nesterov": self.nesterov, "bufs": self.bufs}

    def state_dict(self) -> dict:
        sd = self.state_dict_refs()
        sd["bufs"] = None if self.bufs is None else [b.copy() for b in self.bufs]
        return sd

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.momentum = state["momentum"]
        self.nesterov = state["nesterov"]
        bufs = state["bufs"]
        self.bufs = None if bufs is None else [np.asarray(b).copy() for b in bufs]
