"""Blockwise-4-bit weight packing for ``weight_format="w4"`` serving.

The port's own copy of the JAX package's packer
(``opendiloco_tpu/diloco/compression.py`` ``pack_blockwise4_stacked``,
with the quantize math of ``opendiloco_tpu/native`` ``quantize_blockwise4``)
and of its unpacker (``models/llama.py`` ``dequant_w4``), written in torch
ops so it runs on the card at full model size as well as on the CPU:

- one scale per ``W4_BLOCK`` flat elements: the block's absmax (1 for an
  all-zero block), clamped to [6.1035156e-05, 65504] and rounded to fp16;
- q = clip(round(x * (7 / s16)), -7, 7) + 8, rounding half to even;
- element 2i in the low nibble of byte i; an odd tail leaves the last
  high nibble 0 (not quantized zero, which would be 8).

Scales are kept as int16 holding the fp16 bits (the JAX package keeps the
same bits as uint16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

W4_BLOCK = 4096  # the codec's block (diloco.compression._BLOCK)

_F16_MIN_NORMAL = 6.1035156e-05
_F16_MAX = 65504.0


def _pack_one(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One flat f32 leaf -> (packed [ceil(n/2)] uint8, scales [nblocks] int16)."""
    n = a.numel()
    pad = (-n) % W4_BLOCK
    blocks = F.pad(a, (0, pad)).reshape(-1, W4_BLOCK)
    amax = blocks.abs().amax(dim=1)
    s = torch.where(amax > 0, amax, torch.ones_like(amax))
    s16 = s.clamp(_F16_MIN_NORMAL, _F16_MAX).to(torch.float16)
    sf = s16.float()
    # tensor / tensor: torch turns `7.0 / t` into reciprocal-then-multiply,
    # and on CUDA `t / 7.0` into a multiply by 1/7; both round differently
    inv = torch.full_like(sf, 7.0) / sf
    qv = torch.clamp(torch.round(blocks * inv[:, None]), -7, 7)
    nib = (qv.reshape(-1)[:n] + 8).to(torch.uint8)
    if n % 2:
        nib = torch.cat([nib, nib.new_zeros(1)])
    packed = nib[0::2] | (nib[1::2] << 4)
    return packed, s16.view(torch.int16)


def pack_blockwise4_stacked(arr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack a stacked [L, ...] weight per layer: returns (q [L, ceil(n/2)]
    uint8, s [L, nblocks] int16) on ``arr``'s device, n = per-layer size.
    Layer by layer, so the working memory is one layer's, not the stack's."""
    a = arr.detach().float()
    L = a.shape[0]
    n = a[0].numel()
    nb = (n + W4_BLOCK - 1) // W4_BLOCK
    q = torch.empty((L, (n + 1) // 2), dtype=torch.uint8, device=a.device)
    s = torch.empty((L, nb), dtype=torch.int16, device=a.device)
    for i in range(L):
        q[i], s[i] = _pack_one(a[i].reshape(-1))
    return q, s


def dequant_w4(q: torch.Tensor, s: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    """Unpack one layer's 4-bit weight to ``shape`` in ``dtype``: element 2i
    is the low nibble of byte i, value = (nibble - 8) * (fp16(scale) / 7),
    in f32, then cast."""
    n = 1
    for d in shape:
        n *= int(d)
    nib = torch.stack([q & 0x0F, q >> 4], dim=-1).reshape(-1)[:n]
    qv = nib.float() - 8.0
    sf = s.view(torch.float16).float()
    sf = sf / torch.full_like(sf, 7.0)  # a true division (see _pack_one)
    pad = (-n) % W4_BLOCK
    qp = F.pad(qv, (0, pad)).reshape(-1, W4_BLOCK)
    out = (qp * sf[: qp.shape[0], None]).reshape(-1)[:n].reshape(tuple(shape))
    return out.to(dtype)
