"""Plain attention in PyTorch: the counterparts of
``opendiloco_tpu/ops/attention.py`` ``xla_attention``,
``decode_attention`` and ``spec_tail_attention``.

Prefill attention stays plain PyTorch here, as the JAX package leaves it
to XLA; it does not call ``scaled_dot_product_attention``. Layouts are
the JAX package's: [batch, seq, heads, head_dim] for prefill and the
slot-paged ring cache [S, T, Kh, D] for decode. Scores and softmax are
float32 whatever the input dtype; probabilities are cast back to
``q.dtype`` before the product with V.
"""
from __future__ import annotations

import torch

_F32_MIN = torch.finfo(torch.float32).min


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Broadcast KV heads up to the query head count (GQA): [B, T, Kh, D]
    -> [B, T, H, D], kv head ``i`` serving query heads ``i*rep .. i*rep+rep-1``.
    Also the JAX package's ``_repeat_kv_slots``: the slot-major ring
    layout [S, T, Kh, D] has the same shape."""
    b, t, nkv, d = k.shape
    if nkv == num_q_heads:
        return k
    if num_q_heads % nkv:
        raise ValueError(f"{num_q_heads} query heads over {nkv} kv heads")
    rep = num_q_heads // nkv
    return k[:, :, :, None, :].expand(b, t, nkv, rep, d).reshape(b, t, num_q_heads, d)


def xla_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """[B, T, H, D] -> [B, T, H, D]; f32 scores, probabilities in q.dtype."""
    b, tq, h, d = q.shape
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    tk = k.shape[1]
    # f32 inputs make the products and sums f32, as the JAX package's
    # preferred_element_type=float32 does
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
    if causal:
        q_pos = torch.arange(tq, device=q.device)[:, None]
        k_pos = torch.arange(tk, device=q.device)[None, :]
        # when tq < tk (decode), align the query block to the suffix
        mask = q_pos + (tk - tq) >= k_pos
        scores = scores.masked_fill(~mask, _F32_MIN)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor
) -> torch.Tensor:
    """Single-token decode attention over a slot-paged ring KV cache.

    q [S, H, D] is the current token per slot; k/v [S, T, Kh, D] are the
    ring pages; lens [S] int is each slot's token count BEFORE this step
    (its K/V already written at ring index ``lens % T``). Valid entries are
    indices <= lens until the sequence outgrows the page, after which the
    whole ring is live (sliding-window attention over the last T tokens)."""
    s, t, nkv, d = k.shape
    h = q.shape[1]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    scores = torch.einsum("shd,sthd->sht", q.float(), k.float()) * d**-0.5
    idx = torch.arange(t, device=q.device)[None, :]
    lens_ = lens.to(device=q.device, dtype=torch.int64)[:, None]
    valid = (idx <= lens_) | (lens_ >= t)
    scores = scores.masked_fill(~valid[:, None, :], _F32_MIN)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("sht,sthd->shd", probs, v)


def spec_tail_valid(
    lens: torch.Tensor, t: int, kq: int, kt: int, q_start: int, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """The live entries of :func:`spec_tail_attention`: ring [S, Kq, T]
    and tail [1, Kq, Kt] booleans for queries at tail positions
    ``q_start + i``."""
    idx = torch.arange(t, device=device)[None, :]
    lens_ = lens.to(device=device, dtype=torch.int64)[:, None]
    base = (idx < lens_) | (lens_ >= t)  # live pre-tail rows [S, T]
    disp = torch.remainder(idx - lens_, t)  # the tail token whose ring write lands here
    j = q_start + torch.arange(kq, device=device)[None, :, None]  # [1, Kq, 1]
    evicted = (disp[:, None, :] <= j) & ((lens_[:, None, :] + disp[:, None, :]) >= t)
    ring_valid = base[:, None, :] & ~evicted
    ki = torch.arange(kt, device=device)[None, None, :]
    return ring_valid, ki <= j


def spec_tail_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    tail_k: torch.Tensor,
    tail_v: torch.Tensor,
    lens: torch.Tensor,
    *,
    q_start: int = 0,
) -> torch.Tensor:
    """Multi-token tail attention over a ring KV cache plus the tail's own
    K/V: the verify and draft primitive of speculative decode, and the
    continued prefill of prefix reuse.

    q [S, Kq, H, D] are unverified tail tokens at absolute positions
    ``lens + q_start + i``; cache_{k,v} [S, T, Kh, D] hold the ring as of
    before the tail (positions <= lens - 1); tail_{k,v} [S, Kt, Kh, D]
    are the tail's K/V, kept out of the ring until acceptance. Query i
    attends tail rows <= q_start + i, and the ring rows the one-token loop
    would still hold at its step: a ring row is live iff its index is
    < lens (or lens >= T), and query j has evicted it once the write of
    tail token i <= j lands on it, i.e. when ``disp = (idx - lens) mod T``
    satisfies ``disp <= j`` and ``lens + disp >= T``. Masked entries get
    the f32 minimum, so their softmax terms are exact zeros."""
    s, t, nkv, d = cache_k.shape
    kq, h = q.shape[1], q.shape[2]
    kt = tail_k.shape[1]
    ck, cv = _repeat_kv(cache_k, h), _repeat_kv(cache_v, h)
    tk, tv = _repeat_kv(tail_k, h), _repeat_kv(tail_v, h)
    scale = d**-0.5

    ring_valid, tail_valid = spec_tail_valid(lens, t, kq, kt, q_start, q.device)
    ring_scores = torch.einsum("sqhd,sthd->shqt", q.float(), ck.float()) * scale
    ring_scores = ring_scores.masked_fill(~ring_valid[:, None], _F32_MIN)
    tail_scores = torch.einsum("sqhd,skhd->shqk", q.float(), tk.float()) * scale
    tail_scores = tail_scores.masked_fill(~tail_valid[:, None], _F32_MIN)

    scores = torch.cat([ring_scores, tail_scores], dim=-1)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("shqt,sthd->sqhd", probs[..., :t], cv)
    return out + torch.einsum("shqk,skhd->sqhd", probs[..., t:], tv)
