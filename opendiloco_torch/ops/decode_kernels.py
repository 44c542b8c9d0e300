"""Serving kernels: paged decode attention and the fused W4 dequant-matmul.

The counterparts of ``opendiloco_tpu/ops/decode_kernels.py``
``paged_decode_attention`` and ``w4_matmul``, written by hand in CUDA C++
for Hopper (``csrc/paged_decode_attention.cu``, ``csrc/w4_matmul.cu``;
each source notes the TPU kernel it replaces, its bound and its design).

Each wrapper sits beside its plain PyTorch version, which repeats the
kernel's arithmetic in one pass:

- a tensor on the CPU goes to the plain version (that is how the CPU tests
  reach the arithmetic);
- a tensor on the card goes to the kernel, or the wrapper raises. Nothing
  falls back, and a launch error is never swallowed.

``LAUNCHES`` (the port's one launch counter, ``ops/launch.py``) counts
kernel launches by name, so a run can show that its main path went
through the kernels. Only a launch on the card counts.
"""
from __future__ import annotations

import torch

# LAUNCHES is re-exported: callers read the one shared counter from here
from opendiloco_torch.ops.launch import LAUNCHES, SUFFIX as _SUFFIX, F as _F, I as _I, P as _P
from opendiloco_torch.ops.launch import launch, on_card as _on_card, register
from opendiloco_torch.quant import W4_BLOCK, dequant_w4

register("paged_decode_attention", "w4_matmul")
_ARGTYPES = {
    "paged_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "w4_matmul": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    launch(name, name, f"{name}_{_SUFFIX[dtype]}", _ARGTYPES[name], device, *args)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def paged_decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 scores over the live
    ring rows, p = exp(s - max) rounded to the cache dtype before p.v, and
    acc / l in q's dtype. q [S, H, D], k/v [S, T, Kh, D], lens [S]."""
    S, T, Kh, D = k.shape
    H = q.shape[1]
    qg = q.float().reshape(S, Kh, H // Kh, D)
    s = torch.einsum("sgrd,stgd->sgrt", qg, k.float()) * D**-0.5
    idx = torch.arange(T, device=k.device)[None, :]
    lens_ = lens.to(device=k.device, dtype=torch.int64)[:, None]
    valid = (idx <= lens_) | (lens_ >= T)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("sgrt,stgd->sgrd", p.to(v.dtype).float(), v.float())
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(S, H, D).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor
) -> torch.Tensor:
    """Drop-in :func:`~opendiloco_torch.ops.attention.decode_attention`:
    q [S, H, D] over ring pages k/v [S, T, Kh, D] with per-slot ``lens``
    [S] int32. Takes f32 or bf16, any D that is a multiple of 8 up to 256
    and any H divisible by Kh; anything else raises."""
    if not _on_card(q, k, v, lens):
        return paged_decode_attention_plain(q, k, v, lens)
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    S, T, Kh, D = k.shape
    H = q.shape[1]
    if q.shape != (S, H, D):
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype}: need one of f32/bf16")
    if D % 8 or not 0 < D <= 256:
        raise ValueError(f"head_dim {D} must be a multiple of 8 up to 256")
    if Kh < 1 or H % Kh:
        raise ValueError(f"{H} query heads over {Kh} kv heads")
    if lens.dtype != torch.int32 or lens.shape != (S,):
        raise ValueError(f"lens must be int32 [{S}], got {lens.dtype} {tuple(lens.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous() and lens.is_contiguous()):
        raise ValueError("q, k, v and lens must be contiguous")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    _launch(
        "paged_decode_attention", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        S, T, H, Kh, D, D**-0.5,
    )
    return out


# ---------------------------------------------------------------------------
# fused W4 dequant-matmul
# ---------------------------------------------------------------------------


def w4_matmul_supported(shape) -> bool:
    """Shapes the fused kernel takes: a 2-D weight with an even, positive
    column count (a column pair shares one packed byte)."""
    return len(shape) == 2 and int(shape[1]) % 2 == 0 and int(shape[1]) > 0


def w4_matmul_plain(
    x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, shape, dtype: torch.dtype
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the weight dequantized and
    rounded to ``dtype``, products summed in f32, the result in ``dtype``."""
    w = dequant_w4(q, s, shape, dtype).float()
    return (x.to(dtype).float() @ w).to(dtype)


def w4_matmul(
    x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, shape, dtype: torch.dtype
) -> torch.Tensor:
    """``x [M, K] @ dequant(q, s, (K, N))`` in ``dtype`` (f32 or bf16),
    without materializing the weight. ``q`` is one layer's packed stream
    ([K*N/2] uint8) and ``s`` its [ceil(K*N/4096)] fp16 scale bits
    (int16), the :class:`~opendiloco_torch.models.llama.PackedW4` layout.
    On the card a shape :func:`w4_matmul_supported` refuses raises."""
    if not _on_card(x, q, s):
        return w4_matmul_plain(x, q, s, shape, dtype)
    if not w4_matmul_supported(shape):
        raise ValueError(f"w4_matmul cannot take weight shape {tuple(shape)}")
    K, N = (int(d) for d in shape)
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match weight {shape}")
    if dtype not in _SUFFIX:
        raise ValueError(f"dtype {dtype}: need one of f32/bf16")
    if q.dtype != torch.uint8 or q.numel() != K * N // 2 or not q.is_contiguous():
        raise ValueError(f"q must be contiguous uint8 [{K * N // 2}]")
    nb = (K * N + W4_BLOCK - 1) // W4_BLOCK
    if s.dtype != torch.int16 or s.numel() != nb or not s.is_contiguous():
        raise ValueError(f"s must be contiguous int16 [{nb}]")
    x2 = x.to(dtype).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=dtype, device=x.device)
    if M == 0:
        return out
    _launch("w4_matmul", dtype, x.device, x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, K, N)
    return out
