"""Plain attention in PyTorch: the counterparts of
``opendiloco_tpu/ops/attention.py`` ``xla_attention`` and
``decode_attention``.

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
    -> [B, T, H, D], kv head ``i`` serving query heads ``i*rep .. i*rep+rep-1``."""
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
