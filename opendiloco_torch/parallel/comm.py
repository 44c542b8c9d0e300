"""Collectives on blocks of a leaf, over one process group.

A leaf cut along ``dim`` into equal contiguous blocks, block ``r`` on
rank ``r`` of the group: :func:`all_gather_dim` joins them, and
:func:`reduce_scatter_dim` sums a full tensor over the group and leaves
each rank its block. :class:`GatherLayer` is the per-layer gather of a
FULL_SHARD forward: all of a layer's cut leaves in one call, moving the
compute dtype; its backward reduce-scatters the f32 gradients into the
blocks, in one call too. :func:`sum_over` is an
all-reduce whose backward is the identity (each rank's gradient is its own
share of a loss that is summed over the ranks).
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
