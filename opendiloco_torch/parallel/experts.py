"""The collectives of the routed-expert FFN over a process group.

In the JAX package ``_switch_ffn`` sees the global [B, T, D] activations
under GSPMD: the capacity comes from the global token count, the cumsum
that assigns capacity slots runs over the global (batch, then sequence)
order, the load-balance means are global, and the expert dim of the FFN
leaves is cut over the "ep" axis. :class:`ExpertPlan` gives the port's
FFN the same semantics on this rank's tokens ([B/(dp*fsdp), T/sp] rows and
positions) and this rank's ``E/ep`` experts:

- :meth:`global_expert_ids` gathers the per-token expert ids (small ints)
  over the data group (the ranks that hold distinct tokens: dp, fsdp and
  sp) and lays them out in the global order, so each rank takes its slots
  from the global prefix;
- :meth:`sum_data` sums a load-balance statistic over the data group (its
  backward hands each rank its own share);
- :meth:`to_experts` and :meth:`from_experts` bracket this rank's experts:
  the FFN input and gate are replicated over ep, so their gradients from
  the rank's experts are summed over ep on the way back; each rank's
  partial combine is summed over ep on the way out.

The ranks of the data group are in global rank order, which on the
``("pp", "dp", "fsdp", "ep", "sp", "tp")`` mesh is (batch block, then
sequence chunk): entry ``j`` holds batch block ``j // sp`` and chunk
``j % sp``.

Under pp x sp the JAX pipeline binds sp manual (its
``parallel/pipeline.py`` :91-95), so each sequence chunk routes on its own
there: the slots and the load-balance means are over the batch blocks of
one chunk (the plan's ``block_group``) and the aux is the mean of the
chunks' values (:meth:`mean_chunks`). Without pp they stay over the whole
sequence, as the JAX package's GSPMD forward takes them.
"""
from __future__ import annotations

import torch

from opendiloco_torch.parallel.comm import all_gather_dim, all_reduce_, sum_over


class _ToExperts(torch.autograd.Function):
    """Identity forward; the backward sums each gradient over the group."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(all_reduce_(g.contiguous().clone(), ctx.group) for g in grads))


class ExpertPlan:
    """This rank's place among the expert and data groups of a
    :class:`~opendiloco_torch.parallel.mesh.MeshPlan`."""

    def __init__(self, plan):
        self.ep_size, self.ep_rank = plan.shape["ep"], plan.coord("ep")
        self.ep_group = plan.group("ep") if self.ep_size > 1 else None
        self.sp_size, self.sp_rank = plan.shape["sp"], plan.coord("sp")
        self.batch_blocks, self.batch_index = plan.data_parallel_size, plan.batch_index
        # the ranks the routing statistics are taken over (None: this rank
        # alone): under pp x sp the batch blocks of this rank's sequence
        # chunk, whose aux is then averaged over the chunks; else every
        # rank that holds distinct tokens
        self.chunk_local = plan.shape["pp"] > 1 and self.sp_size > 1
        self.route_group = plan.block_group if self.chunk_local else plan.batch_group()
        self.sp_group = plan.group("sp") if self.chunk_local else None

    def local_experts(self, num_experts: int) -> tuple[int, int]:
        """(first expert, count) of this rank's block of the expert dim."""
        n = num_experts // self.ep_size
        return self.ep_rank * n, n

    def global_expert_ids(self, ids: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        """This rank's [B, T] expert ids -> (the routed [B * blocks, T * sp]
        ids, [B * blocks, T] under pp x sp; this rank's first row, first
        position)."""
        B, T = ids.shape
        if self.route_group is None:
            return ids, 0, 0
        parts = all_gather_dim(ids[None].contiguous(), 0, self.route_group)
        if self.chunk_local:
            return parts.reshape(self.batch_blocks * B, T), self.batch_index * B, 0
        glob = parts.reshape(self.batch_blocks, self.sp_size, B, T).transpose(1, 2)
        return glob.reshape(self.batch_blocks * B, self.sp_size * T), self.batch_index * B, self.sp_rank * T

    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.route_group is None else sum_over(x, self.route_group)

    def mean_chunks(self, aux: torch.Tensor) -> torch.Tensor:
        """Under pp x sp the chunks' mean of a chunk-local aux (each rank's
        gradient its chunk's share); else ``aux`` itself."""
        return sum_over(aux, self.sp_group) / self.sp_size if self.chunk_local else aux

    def to_experts(self, *xs: torch.Tensor) -> tuple:
        return xs if self.ep_group is None else _ToExperts.apply(self.ep_group, *xs)

    def from_experts(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.ep_group is None else sum_over(y, self.ep_group)
