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

Gossip (NoLoCo, arXiv 2506.10911) adds :meth:`OuterSGD.step_mixed_indices`
and :func:`noloco_step`, the Nesterov rule on pair-mixed state, and the
async mix weights :func:`staleness_weight` and :func:`staleness_mix`.
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

    def step_mixed_indices(self, params: list[np.ndarray], mix_m: list[np.ndarray],
                           mix_b: Optional[list[np.ndarray]], grads: list[np.ndarray], idxs) -> None:
        """NoLoCo's modified Nesterov step on a fragment: adopt the
        pair-mixed master and momentum for ``idxs``, then run the unchanged
        rule with the pair-averaged pseudo-gradient."""
        for j, i in enumerate(idxs):
            params[i] = np.asarray(mix_m[j], np.float32)
        if self.momentum != 0.0:
            if self.bufs is None:
                self.bufs = [np.zeros_like(p) for p in params]
            if mix_b is not None:
                for j, i in enumerate(idxs):
                    self.bufs[i] = np.asarray(mix_b[j], np.float32)
        self.step_indices(params, grads, idxs)

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


def staleness_weight(distance: int, decay: float = 0.5) -> float:
    """The partner's mixing weight under async gossip, ``0.5 * decay**d``
    at epoch distance ``d``: the symmetric pair average at distance 0.
    Both sides of a match compute the same ``d``, so the mix keeps the
    pair's sum."""
    return 0.5 * float(decay) ** max(0, int(distance))


def staleness_mix(mine: list[np.ndarray], theirs: list[np.ndarray], weight: float) -> list[np.ndarray]:
    """``(1-w)*mine + w*theirs`` per leaf, fresh f32 arrays. Distance 0
    goes through gossip's sorted-pair average instead, so it stays bit for
    bit the lockstep mix."""
    w = np.float32(weight)
    one_m_w = np.float32(1.0) - w
    return [np.asarray(a, np.float32) * one_m_w + np.asarray(b, np.float32) * w for a, b in zip(mine, theirs)]


def noloco_step(mix_m: list[np.ndarray], mix_b: Optional[list[np.ndarray]], avg_g: list[np.ndarray], *,
                lr: float, momentum: float, nesterov: bool) -> tuple[list[np.ndarray], Optional[list[np.ndarray]]]:
    """The NoLoCo outer step as a function: the Nesterov rule on pair-mixed
    (master, momentum) with the pair-averaged pseudo-gradient, returning
    fresh ``(new_masters, new_bufs)``; the inputs are not touched. The
    streaming and device-placement gossip paths land through this."""
    opt = OuterSGD(lr=lr, momentum=momentum, nesterov=nesterov)
    params = [np.array(m, np.float32) for m in mix_m]
    if momentum != 0.0:
        if mix_b is None:
            opt.bufs = [np.zeros_like(p) for p in params]
        else:
            opt.bufs = [np.array(b, np.float32) for b in mix_b]
    grads = [np.ascontiguousarray(np.asarray(g, np.float32)) for g in avg_g]
    opt.step(params, grads)
    return params, opt.bufs
