"""Ring attention: causal attention over a sequence cut into chunks, one a
rank of a ring.

The counterpart of ``opendiloco_tpu/ops/ring_attention.py``. Rank ``r`` of
``n`` holds the ``r``-th contiguous chunk of q, k and v ([B, T/n, H|Hkv,
D]); K/V chunks travel once around the ring while each rank folds them
into its queries' softmax. Two bodies, as in the JAX package:

- :func:`ring_attention`, the einsum ring (``ring_attention`` with its
  custom VJP): grouped-query einsums with f32 online-softmax statistics at
  every rotation, causality from global position masks; its backward
  re-rotates K/V with the dK/dV accumulators travelling along.
- :func:`ring_flash_attention`, the flash-chunk ring (B5,
  ``ring_flash_attention``): each chunk goes through the flash-attention
  kernels (B1 forward; delta, B2a and B2b backward). The diagonal chunk is
  causal, earlier chunks are full, later chunks are skipped. Per-chunk
  (out, lse) pairs merge by log-sum-exp in f32 (elementwise torch, as XLA
  runs it outside Pallas in the reference). The forward saves q, k, v, out
  and the merged lse; the backward runs B2a/B2b per chunk under that
  global lse with f32 gradients (``grad_dtype=torch.float32``), the f32
  dK/dV accumulators rotating with their chunks, plus one rotation home.
  On the card the kernels run; on the CPU their plain versions.

The rotation goes through one small interface, a ring: ``rank``, ``size``
and ``exchange(tensors)``, which sends the list to the next rank and
returns the previous rank's. :class:`DistRing` runs it over a
``torch.distributed`` group (``batch_isend_irecv``); a rank of a
:class:`~opendiloco_torch.parallel.comm.LoopbackGroup` runs ``n`` ranks
in one process, one thread each, for the tests and for one card (NCCL
refuses two ranks on one GPU). Neither falls back to the other. A ring of one rank (:data:`SOLO`) is one causal chunk: the flash
ring there computes what ``flash_attention`` does.
"""
from __future__ import annotations

import torch

from opendiloco_torch.ops.flash_attention import (
    FLASH_FWD_OP,
    attention_delta,
    flash_attention_dkv,
    flash_attention_dq,
)

_NEG_INF = -1e30


class SoloRing:
    """A ring of one rank: nothing ever rotates."""

    rank, size = 0, 1

    def exchange(self, tensors: list) -> list:
        raise RuntimeError("a ring of one rank has no neighbour to exchange with")


SOLO = SoloRing()


class DistRing:
    """The ring over a ``torch.distributed`` group: rank ``r`` of the group
    sends to ``r + 1`` and receives from ``r - 1`` (mod its size), one
    point-to-point pair a tensor, all in one ``batch_isend_irecv``."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self._prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def exchange(self, tensors: list) -> list:
        import torch.distributed as dist

        outs = [torch.empty_like(t) for t in tensors]
        ops = []
        for i, (t, o) in enumerate(zip(tensors, outs)):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self._next, self.group, tag=i))
            ops.append(dist.P2POp(dist.irecv, o, self._prev, self.group, tag=i))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return outs


# ---------------------------------------------------------------------------
# the einsum ring
# ---------------------------------------------------------------------------


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, T, Hq, D] -> [B, T, Hkv, G, D] (grouped-query view)."""
    b, t, hq, d = x.shape
    return x.reshape(b, t, hkv, hq // hkv, d)


def _chunk_pos(src: int, tl: int, device) -> torch.Tensor:
    return src * tl + torch.arange(tl, device=device)


def _ein_scores(qg, k, q_pos, k_pos, causal: bool) -> torch.Tensor:
    """Masked logits [B, Hkv, G, Tq, Tk] in f32 (operands in their dtype,
    products summed in f32, as ``preferred_element_type=float32``)."""
    d = qg.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (d**-0.5)
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return s


def ring_attention_fwd(q, k, v, ring, causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The einsum ring's forward on this rank's chunks: (out [B, Tl, Hq, D]
    in q's dtype, lse [B, Hkv, G, Tl, 1] f32)."""
    b, tl, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = _grouped(q, hkv)
    idx, n = ring.rank, ring.size
    q_pos = _chunk_pos(idx, tl, q.device)
    m = torch.full((b, hkv, g, tl, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, tl, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        if i:
            k_cur, v_cur = ring.exchange([k_cur, v_cur])
        s = _ein_scores(qg, k_cur, q_pos, _chunk_pos((idx - i) % n, tl, q.device), causal)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v_cur.float())
        m = m_new
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    lse = m + torch.log(l_safe)
    out = (acc / l_safe).permute(0, 3, 1, 2, 4).reshape(b, tl, hq, d).to(q.dtype)
    return out, lse


def ring_attention_bwd(q, k, v, out, lse, dout, ring, causal: bool = True) -> tuple:
    """The einsum ring's backward: (dq, dk, dv) in their inputs' dtypes.
    The dK/dV accumulators (f32) rotate with their chunks and are home
    after ``n`` rotations."""
    b, tl, hq, d = q.shape
    hkv = k.shape[2]
    scale = d**-0.5
    qg, dog = _grouped(q, hkv), _grouped(dout, hkv)
    D = (_grouped(dout.float(), hkv) * _grouped(out.float(), hkv)).sum(dim=-1).permute(0, 2, 3, 1)[..., None]
    idx, n = ring.rank, ring.size
    q_pos = _chunk_pos(idx, tl, q.device)
    k_cur, v_cur = k, v
    dk = torch.zeros((b, tl, hkv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq = torch.zeros((b, tl, hkv, hq // hkv, d), dtype=torch.float32, device=q.device)
    for i in range(n):
        s = _ein_scores(qg, k_cur, q_pos, _chunk_pos((idx - i) % n, tl, q.device), causal)
        p = torch.exp(s - lse)
        dv = dv + torch.einsum("bhgqk,bqhgd->bkhd", p.to(dout.dtype).float(), dog.float())
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog.float(), v_cur.float())
        ds = p * (dp - D)
        dq = dq + scale * torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k_cur.float())
        dk = dk + scale * torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(), qg.float())
        if n > 1:
            k_cur, v_cur, dk, dv = ring.exchange([k_cur, v_cur, dk, dv])
    return dq.reshape(b, tl, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """The einsum ring with its hand-written backward; saves q, k, v, out
    and lse."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal: bool):
        out, lse = ring_attention_fwd(q, k, v, ring, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal = ring, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*ring_attention_bwd(q, k, v, out, lse, dout, ctx.ring, ctx.causal), None, None)


def ring_attention(q, k, v, ring=SOLO, *, causal: bool = True) -> torch.Tensor:
    """This rank's chunk of attention over the ring's sequence, by einsums."""
    return RingAttention.apply(q, k, v, ring, causal)


# ---------------------------------------------------------------------------
# the flash-chunk ring (B5)
# ---------------------------------------------------------------------------


def _bhT_to_bTh(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T] -> [B, T, H, 1], to weight [B, T, H, D] outputs."""
    return x.transpose(1, 2)[..., None]


def ring_flash_fwd(q, k, v, ring) -> tuple[torch.Tensor, torch.Tensor]:
    """The flash ring's forward on this rank's chunks: (out [B, Tl, H, D]
    in q's dtype, the merged lse [B, H, Tl] f32). B1 runs once causal on
    the own chunk and once full on each earlier chunk; a later chunk is
    skipped (the reference merges it as lse -inf, which changes nothing)."""
    idx, n = ring.rank, ring.size
    o, lse = FLASH_FWD_OP(q, k, v, True)
    o = o.float()
    k_c, v_c = k, v
    for i in range(1, n):
        k_c, v_c = ring.exchange([k_c, v_c])
        if (idx - i) % n >= idx:
            continue
        oi, lsei = FLASH_FWD_OP(q, k_c, v_c, False)
        lse_new = torch.logaddexp(lse, lsei)
        o = o * _bhT_to_bTh(torch.exp(lse - lse_new)) + oi.float() * _bhT_to_bTh(torch.exp(lsei - lse_new))
        lse = lse_new
    return o.to(q.dtype), lse


def ring_flash_bwd(q, k, v, out, lse, dout, ring) -> tuple:
    """The flash ring's backward: delta once, then B2a and B2b a live chunk
    under the global ``lse`` with f32 outputs; (dq, dk, dv) in their
    inputs' dtypes."""
    idx, n = ring.rank, ring.size
    f32 = torch.float32
    delta = attention_delta(dout, out)
    dq = flash_attention_dq(q, k, v, dout, lse, delta, True, f32)
    dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta, True, f32)
    k_c, v_c = k, v
    for i in range(1, n):
        k_c, v_c, dk, dv = ring.exchange([k_c, v_c, dk, dv])
        if (idx - i) % n >= idx:
            continue
        dki, dvi = flash_attention_dkv(q, k_c, v_c, dout, lse, delta, False, f32)
        dk, dv = dk + dki, dv + dvi
        dq = dq + flash_attention_dq(q, k_c, v_c, dout, lse, delta, False, f32)
    if n > 1:
        # n - 1 rotations in the loop and this one: a full revolution
        dk, dv = ring.exchange([dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingFlashAttention(torch.autograd.Function):
    """B5: the flash-chunk ring, saving only q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, ring):
        out, lse = ring_flash_fwd(q, k, v, ring)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*ring_flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.ring), None)


def ring_flash_attention(q, k, v, ring=SOLO) -> torch.Tensor:
    """This rank's chunk of causal attention over the ring's sequence,
    through the flash kernels (their plain versions on the CPU)."""
    return RingFlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), ring)
