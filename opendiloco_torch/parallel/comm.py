"""Collectives on blocks of a leaf, over one process group.

A leaf cut along ``dim`` into equal contiguous blocks, block ``r`` on
rank ``r`` of the group: :func:`all_gather_dim` joins them, and
:func:`reduce_scatter_dim` sums a full tensor over the group and leaves
each rank its block. :class:`GatherLayer` is the per-layer gather of a
FULL_SHARD forward: all of a layer's cut leaves in one call, moving the
compute dtype; its backward reduce-scatters the f32 gradients into the
blocks, in one call too. :func:`sum_over` is an
all-reduce whose backward is the identity (each rank's gradient is its own
share of a loss that is summed over the ranks). :func:`all_gather_dim`,
:func:`all_reduce_` and :func:`sum_over` also take a rank-thread comm in
place of the group: the data group of
:func:`~opendiloco_torch.parallel.mesh.loopback_plans`.

The tensor, pipeline and sequence axes go through one small interface, a
*comm*: ``rank``, ``size``, ``all_reduce``, ``all_gather``,
``reduce_scatter``, ``broadcast``, ``send`` and ``recv``; a rank
thread's comm is also a ring (``exchange``,
:mod:`~opendiloco_torch.ops.ring_attention`). :class:`DistComm` runs it over a
``torch.distributed`` group (NCCL on the card, gloo on the CPU);
:class:`LoopbackGroup` runs ``n`` ranks in one process, one thread each,
for one card (NCCL refuses two ranks on one GPU) and for the tests.
Neither falls back to the other. On it sit the Megatron tensor-parallel
operations (:class:`TensorParallel`):

- :meth:`~TensorParallel.copy`: identity forward, all-reduce backward, at
  the entry of a region whose ranks each use the input partially (a
  column-parallel product);
- :meth:`~TensorParallel.reduce`: all-reduce forward, identity backward,
  at the exit of a row-parallel product;
- :meth:`~TensorParallel.embed`: the vocab-parallel lookup (mask, look up
  the rank's rows, reduce);
- :meth:`~TensorParallel.gather`: the blocks joined; its backward takes
  the rank's block of the gradient where every rank consumes the whole
  tensor identically (``partial=False``: the head of the loss), and
  reduce-scatters it where each rank consumes it partially
  (``partial=True``: k and v for the rank's heads).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

# all_gather_single / reduce_scatter_single where torch has them (the
# *_tensor names are deprecated there), else the older names
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if isinstance(group, _LoopbackComm):
        return group.all_gather(x, dim)
    n = dist.get_world_size(group)
    # the collectives take blocks joined along dim 0 (gloo checks the shape)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous(), group=group)
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= n
    return out.unflatten(0, (n, x.shape[0])).movedim(0, dim).reshape(shape)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    _reduce_scatter(out, parts.flatten(0, 1), group=group)
    return out


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    if isinstance(group, _LoopbackComm):
        return x.copy_(group.all_reduce(x))  # every rank has read x when the result is back
    dist.all_reduce(x, group=group)
    return x


class GatherLayer(torch.autograd.Function):
    """Cut blocks (f32) -> the whole leaves in ``dtype``, with one
    all-gather of the blocks laid end to end (a layer's flat parameter, as
    FSDP keeps one per wrapped module) instead of one call a leaf; the
    backward reduce-scatters the gradients, in the blocks' dtype, the same
    way. ``dims[i]``: the dim block ``i`` is cut along."""

    @staticmethod
    def forward(ctx, dims: tuple, group, dtype: torch.dtype, *blocks: torch.Tensor):
        n = dist.get_world_size(group)
        shapes = [b.shape for b in blocks]
        ctx.dims, ctx.group, ctx.shapes, ctx.block_dtype = dims, group, shapes, blocks[0].dtype
        flat = torch.cat([b.to(dtype).reshape(-1) for b in blocks])
        out = torch.empty(n * flat.numel(), dtype=dtype, device=flat.device)
        _all_gather(out, flat, group=group)
        out = out.view(n, -1)
        fulls, off = [], 0
        for shape, dim in zip(shapes, dims):
            k = math.prod(shape)
            full = list(shape)
            full[dim] *= n
            fulls.append(out[:, off:off + k].reshape(n, *shape).movedim(0, dim).reshape(full))
            off += k
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        n = dist.get_world_size(ctx.group)
        parts = []
        for g, shape, dim in zip(grads, ctx.shapes, ctx.dims):
            if g is None:
                parts.append(torch.zeros(n, math.prod(shape), dtype=ctx.block_dtype, device=grads[0].device))
                continue
            # [.., n * b, ..] -> [n, *block] -> [n, numel]
            parts.append(g.to(ctx.block_dtype).unflatten(dim, (n, shape[dim])).movedim(dim, 0).reshape(n, -1))
        flat = torch.cat(parts, dim=1)
        out = torch.empty(flat.shape[1], dtype=flat.dtype, device=flat.device)
        _reduce_scatter(out, flat.reshape(-1), group=ctx.group)
        blocks, off = [], 0
        for shape in ctx.shapes:
            k = math.prod(shape)
            blocks.append(out[off:off + k].view(shape))
            off += k
        return (None, None, None, *blocks)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group; the backward hands each rank the
    incoming gradient unchanged."""
    return _SumOver.apply(x, group)


# ---------------------------------------------------------------------------
# the comm interface: a process group, or rank threads of one process
# ---------------------------------------------------------------------------


class DistComm:
    """The comm over a ``torch.distributed`` group; ``send``/``recv`` peers
    are ranks of the group. Every rank of the group calls the collectives
    in one order; a send and its receive are issued in one order on both
    sides."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_(x.contiguous().clone(), self.group)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather_dim(x, dim, self.group)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return reduce_scatter_dim(x, dim, self.group)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        x = x.contiguous().clone()
        dist.broadcast(x, dist.get_global_rank(self.group, src), group=self.group)
        return x

    def send(self, x: torch.Tensor, dst: int) -> None:
        dist.send(x.contiguous(), dist.get_global_rank(self.group, dst), group=self.group)

    def recv(self, shape: tuple, dtype: torch.dtype, device, src: int) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(out, dist.get_global_rank(self.group, src), group=self.group)
        return out


class LoopbackGroup:
    """``n`` ranks of a group in one process, each driven by its own thread
    (``group.rank(r)`` is rank ``r``'s comm). A collective posts the rank's
    tensor, waits for every rank to post, and computes its result from the
    posts in rank order, so every rank's result is the same bits; a second
    wait keeps the posts until every rank has read them. A received tensor
    is new memory, as over a wire. On the card every thread enqueues on the
    device's current stream, so a posted tensor is written before it is
    read. A rank thread that waits inside a backward node must run its
    backward on its own thread: ``torch.autograd.set_multithreading_enabled(False)``
    (CUDA backward otherwise runs on one engine thread for all ranks)."""

    def __init__(self, n: int, timeout: float = 600.0):
        import queue
        import threading

        self.size = n
        self._barrier = threading.Barrier(n, timeout=timeout)
        self._slots: list = [None] * n
        self._boxes = {(a, b): queue.Queue() for a in range(n) for b in range(n) if a != b}
        self.timeout = timeout
        self.aborted = False

    def rank(self, r: int) -> "_LoopbackComm":
        return _LoopbackComm(self, r)

    def abort(self) -> None:
        """Fail every rank's pending and later exchange (a rank thread
        raised: the others must not wait for it)."""
        self.aborted = True
        self._barrier.abort()


class _LoopbackComm:
    def __init__(self, group: LoopbackGroup, rank: int):
        self.g, self.rank, self.size = group, rank, group.size

    def _posted(self, x: torch.Tensor, fn):
        g = self.g
        g._slots[self.rank] = x
        g._barrier.wait()
        try:
            return fn(g._slots)
        finally:
            g._barrier.wait()  # every rank has read the posts before the next one

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        def total(posts):
            out = posts[0].clone()
            for p in posts[1:]:
                out += p
            return out

        return self._posted(x, total)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return self._posted(x, lambda posts: torch.cat([p.clone() for p in posts], dim=dim))

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        def block(posts):
            parts = [p.chunk(self.size, dim=dim)[self.rank] for p in posts]
            out = parts[0].clone()
            for p in parts[1:]:
                out += p
            return out

        return self._posted(x, block)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        return self._posted(x, lambda posts: posts[src].clone())

    def exchange(self, tensors: list) -> list:
        """The ring step: copies of rank ``r - 1``'s ``tensors`` (this
        rank's go to ``r + 1``)."""
        return self._posted(list(tensors), lambda posts: [t.clone() for t in posts[(self.rank - 1) % self.size]])

    def send(self, x: torch.Tensor, dst: int) -> None:
        self.g._boxes[(self.rank, dst)].put(x.clone())

    def recv(self, shape: tuple, dtype: torch.dtype, device, src: int) -> torch.Tensor:
        import queue
        import time

        box, deadline = self.g._boxes[(src, self.rank)], time.monotonic() + self.g.timeout
        while True:
            try:
                out = box.get(timeout=0.5)
                break
            except queue.Empty:
                if self.g.aborted or time.monotonic() > deadline:
                    raise RuntimeError(f"loopback rank {self.rank}: nothing from rank {src}"
                                       + (" (the group was aborted)" if self.g.aborted else ""))
        if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
            raise RuntimeError(f"rank {self.rank} expected {tuple(shape)} {dtype} from {src}, got "
                               f"{tuple(out.shape)} {out.dtype}")
        return out


# ---------------------------------------------------------------------------
# Megatron tensor parallelism over a comm
# ---------------------------------------------------------------------------


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim: int, partial: bool):
        ctx.comm, ctx.dim, ctx.partial, ctx.n = comm, dim, partial, x.shape[dim]
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        if ctx.partial:
            return comm.reduce_scatter(g.contiguous(), ctx.dim), None, None, None
        return g.narrow(ctx.dim, comm.rank * ctx.n, ctx.n).contiguous(), None, None, None


class TensorParallel:
    """The tensor-parallel operations of this rank over ``comm`` (see the
    module docstring)."""

    def __init__(self, comm):
        self.comm = comm
        self.rank, self.size = comm.rank, comm.size

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.comm)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.comm)

    def gather(self, x: torch.Tensor, dim: int, *, partial: bool) -> torch.Tensor:
        return _Gather.apply(x, self.comm, dim % x.dim(), partial)

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of a table cut over the ranks along the vocab: this
        rank looks up the ids in its block, zeros the others' rows, and the
        ranks' rows are summed (one nonzero each: exact)."""
        v = table.shape[0]
        local = ids - self.rank * v
        mask = (local >= 0) & (local < v)
        rows = table[torch.where(mask, local, torch.zeros_like(local))] * mask[..., None].to(table.dtype)
        return self.reduce(rows)
