"""Pipeline parallelism over the "pp" axis: the GPipe schedule.

The counterpart of ``opendiloco_tpu/parallel/pipeline.py``. The stacked
layer leaves [L, ...] are cut over pp, so stage ``r`` of ``n`` owns layers
[r L/n, (r + 1) L/n); the batch of B rows is cut into M micro-batches of
B/M rows. Where the JAX package runs the fill-drain schedule as one
differentiable scan of ``M + n - 1`` ticks with ``ppermute`` (autodiff
gives the reverse pipeline, the fill and drain ticks compute masked-out
garbage), eager PyTorch runs it as a schedule of point-to-point
exchanges over the pp comm (:mod:`~opendiloco_torch.parallel.comm`):

- forward (:func:`pipeline_hidden`): for m = 0 .. M-1 stage r takes
  micro-batch m (stage 0 from the embedded batch, later stages from stage
  r - 1), runs its layers (each block under the remat policy) and hands
  the activation to stage r + 1; the last stage joins its M outputs into
  the final hidden states [B, T, D] that the loss reads;
- backward (:meth:`Pipeline.backward`): for m = M-1 .. 0 stage r takes
  the gradient of micro-batch m's output (the last stage from the loss,
  the others from stage r + 1), backpropagates it through its layers into
  its leaves, and hands the input gradient to stage r - 1.

Every exchange is issued outside the autograd engine, in that fixed order
on both sides, and each micro-batch's graph is its own, so no backward
node waits on another stage (collectives of tp, sp, ep and fsdp inside a
stage run in one order on the stage's peers, which run the same
schedule). Memory is GPipe's: a stage keeps its M micro-batches' saved
activations until their backward.

The MoE aux is summed over each stage's layers and micro-batches and
averaged over L x M (:meth:`Pipeline.aux_total`): with M 1 the
unpipelined value; with M > 1 every router statistic (capacity, drops, the
aux) is per micro-batch, the GPipe semantics of the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class Pipeline:
    """One pass of the schedule on this stage. ``hidden`` is the final
    hidden states [B, T, D] on the last stage (None elsewhere); ``auxs`` the
    stage's MoE aux of each micro-batch (summed over its layers; empty for
    a dense stack) and ``norms`` its attn-output norms of each micro-batch
    (a list a layer)."""

    def __init__(self, comm, microbatches: int, shape: tuple, dtype: torch.dtype, device):
        self.comm, self.M = comm, microbatches
        self.shape, self.dtype, self.device = shape, dtype, device
        self.xs: list = []
        self.ys: list = []
        self.auxs: list = []
        self.norms: list = []
        self.hidden: Optional[torch.Tensor] = None

    @property
    def first(self) -> bool:
        return self.comm.rank == 0

    @property
    def last(self) -> bool:
        return self.comm.rank == self.comm.size - 1

    def backward(self, leaves: list, dys: Optional[list], aux_grad: Optional[float]) -> tuple[list, Optional[torch.Tensor]]:
        """The reverse schedule: ``dys`` are the gradients of the last
        stage's M outputs (None on the other stages, which receive theirs);
        ``aux_grad`` the gradient of each micro-batch's aux (None for a
        dense stack). Returns (the gradients of ``leaves`` summed over the
        micro-batches, None where a leaf is not used on this stage; on stage
        0 the gradient of the embedded batch [B, T, D], else None)."""
        comm, r = self.comm, self.comm.rank
        self.hidden = None  # the joined outputs' graph is spent (the loss's backward)
        grads: list = [None] * len(leaves)
        dxs: list = [None] * self.M
        for m in reversed(range(self.M)):
            dy = dys[m] if self.last else comm.recv(self.shape, self.dtype, self.device, r + 1)
            outs, gouts = [self.ys[m]], [dy]
            if aux_grad is not None:
                outs.append(self.auxs[m])
                gouts.append(torch.full_like(self.auxs[m], aux_grad))
            got = torch.autograd.grad(outs, [*leaves, self.xs[m]], gouts, allow_unused=True)
            for i, g in enumerate(got[:-1]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            self.ys[m] = self.xs[m] = None  # the micro-batch's graph goes with them
            if self.first:
                dxs[m] = got[-1]
            else:
                comm.send(got[-1], r - 1)
        return grads, (torch.cat(dxs) if self.first else None)

    def aux_total(self, num_layers: int) -> torch.Tensor:
        """The MoE aux of the whole model (detached): every stage's sum over
        its layers and micro-batches, summed over pp, over L x M."""
        local = torch.stack([a.detach() for a in self.auxs]).sum()
        return self.comm.all_reduce(local) / (num_layers * self.M)


def pipeline_hidden(stage: Callable, h0: Optional[torch.Tensor], positions: torch.Tensor, comm, *,
                    microbatches: int, grad: bool = True, width: Optional[int] = None,
                    dtype: Optional[torch.dtype] = None) -> Pipeline:
    """Run the forward schedule. ``stage(x, positions) -> (y, aux or None,
    norms)`` runs this stage's layers (``llama.stage_fn``); ``h0`` is the
    embedded batch [B, T, D] on stage 0 (ignored elsewhere: pass None with
    ``width`` and ``dtype``, the activation's D and dtype); ``positions``
    [B, T] this rank's. With ``grad`` each micro-batch's input is a fresh
    leaf, so its graph ends there and :meth:`Pipeline.backward` can take
    the input gradient."""
    B, T = positions.shape
    M = microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    b = B // M
    if h0 is not None:
        width, dtype, device = h0.shape[-1], h0.dtype, h0.device
    else:
        device = positions.device
    run = Pipeline(comm, M, (b, T, width), dtype, device)
    r = comm.rank
    for m in range(M):
        rows = slice(m * b, (m + 1) * b)
        x = h0[rows] if run.first else comm.recv(run.shape, dtype, device, r - 1)
        if grad:
            x = x.detach().requires_grad_(True)
        y, aux, norms = stage(x, positions[rows])
        if not run.last:
            comm.send(y.detach(), r + 1)
        run.xs.append(x)
        run.ys.append(y)
        if aux is not None:
            run.auxs.append(aux)
        run.norms.append(norms)
    if run.last:
        run.hidden = torch.cat(run.ys) if M > 1 else run.ys[0]
    if not grad:
        run.xs, run.ys = [], []
    return run
