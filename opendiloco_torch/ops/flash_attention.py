"""Flash attention for training: forward and backward, causal or full, GQA.

The counterpart of ``opendiloco_tpu/ops/flash_attention.py``. Its three
Pallas kernels are written by hand in CUDA C++ for Hopper (each source
notes what it replaces, its bound and its design):

- B1 ``flash_attention_fwd``: out and lse (``_fwd`` / ``_fwd_kernel``);
- B2a ``flash_attention_dq``: dq by recompute (``_dq_kernel``);
- B2b ``flash_attention_dkv``: dk and dv per kv head (``_dkv_kernel``).

Each direction takes one of two routes, chosen from the dtype and head
dim alone by :func:`_fwd_route` and :func:`_bwd_route`, which share one
rule (:func:`_on_sm90`): bf16 and f16 at D 32, 64 or 128 go to the wgmma
and TMA kernels of ``csrc/flash_attention_fwd_sm90.cu`` and
``csrc/flash_attention_bwd_sm90.cu``, counted as
``flash_attention_fwd_sm90``, ``flash_attention_dq_sm90`` and
``flash_attention_dkv_sm90``; f32 and any other head dim to the first
design's ``mma.sync`` kernels in ``csrc/flash_attention.cu``, counted as
``flash_attention_fwd``, ``flash_attention_dq`` and
``flash_attention_dkv``. A launch error raises on either route.

Between the forward and the backward, :func:`attention_delta` computes
delta = rowsum(dO * O) (the JAX package's ``_delta``, which XLA computes
outside Pallas) through its own kernel, ``csrc/flash_attention_delta.cu``,
counted as ``flash_attention_delta``, on both routes.

Each wrapper sits beside its plain version (``*_plain``), which repeats
the kernel's arithmetic and roundings in a few einsums: scores, softmax
statistics and accumulators in f32, p rounded to v's dtype before p.v, ds
rounded to k's (q's) dtype before the dq (dk) product, outputs in the input
dtype or ``grad_dtype``. A CPU tensor goes to the plain version; a CUDA
tensor goes to the kernel, or the wrapper raises (f32, bf16 and f16 only,
D a multiple of 8 up to 128, any rep and any T). Nothing falls back.
Every kernel has an instance for each of the three (``SUFFIX``).
:class:`FlashAttention` is the ``torch.autograd.Function`` that replaces
``_flash``'s ``custom_vjp``: it saves q, k, v, out and lse as
``_flash_fwd`` does.

Autograd Functions call B1 through the dispatcher, as the custom op
``odtp::flash_fwd`` (:data:`FLASH_FWD_OP`, its implementation
:func:`flash_attention_fwd` on any device, a fake one for shapes): the
kernel is loaded through ctypes, out of the dispatcher's sight, and the op
is what a selective-checkpoint policy names to keep B1's out and lse
instead of rerunning B1 on recompute (``models/llama.py _maybe_remat``
"dots", the JAX package's ``checkpoint_name(out, "attn_out")`` and
``"attn_lse"``).

Layouts are the port's model layout, read in place by the kernels:
q, out [B, T, H, D]; k, v [B, T, Hkv, D]; lse, delta [B, H, T] f32 (the
JAX kernels take [B, H, T, D] and lse [B, H, 1, T]).
"""
from __future__ import annotations

from typing import Optional

import torch

# LAUNCHES is re-exported: callers read the one shared counter from here
from opendiloco_torch.ops.launch import HALF_DTYPES, LAUNCHES, F, I, P, SUFFIX, launch, on_card, register

NEG_INF = -1e30  # the TPU kernel's finite stand-in for -inf
SOURCE = "flash_attention"
SM90_SOURCE = "flash_attention_bwd_sm90"
SM90_FWD_SOURCE = "flash_attention_fwd_sm90"
DELTA_SOURCE = "flash_attention_delta"
SM90_HEAD_DIMS = (32, 64, 128)
register("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv", "flash_attention_fwd_sm90",
         "flash_attention_dq_sm90", "flash_attention_dkv_sm90", "flash_attention_delta")
_ARGTYPES = {
    "flash_attention_fwd": [P, P, P, P, P, I, I, I, I, I, I, F, P],
    "flash_attention_dq": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P],
    "flash_attention_dkv": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P],
    "flash_attention_delta": [P, P, P, I, I, I, I, P],
}


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args, source: str = SOURCE) -> None:
    kernel = name if source == SOURCE else f"{name}_sm90"
    launch(kernel, source, f"{kernel}_{SUFFIX[dtype]}", _ARGTYPES[name], device, *args)


def _on_sm90(dtype: torch.dtype, D: int) -> bool:
    """The route rule of both directions: the wgmma kernels take bf16 and
    f16 at D 32, 64 or 128; everything else takes the first design."""
    return dtype in HALF_DTYPES and D in SM90_HEAD_DIMS


def _fwd_route(dtype: torch.dtype, D: int) -> str:
    """The source of the forward kernel for (dtype, head dim)."""
    return SM90_FWD_SOURCE if _on_sm90(dtype, D) else SOURCE


def _bwd_route(dtype: torch.dtype, D: int) -> str:
    """The source of the backward kernels for (dtype, head dim)."""
    return SM90_SOURCE if _on_sm90(dtype, D) else SOURCE


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *rest: torch.Tensor) -> tuple:
    """The shapes, dtypes and layouts the kernels take; anything else
    raises. Returns (B, T, H, Hkv, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype} differ")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} kv heads")
    _check_operands(q.dtype, D, q, k, v, *rest)
    return B, T, H, Hkv, D


def _check_operands(dtype: torch.dtype, D: int, *tensors: torch.Tensor) -> None:
    if dtype not in SUFFIX:
        raise ValueError(f"dtype {dtype}: need one of f32/bf16/f16")
    if D % 8 or not 0 < D <= 128:
        raise ValueError(f"head_dim {D} must be a multiple of 8 up to 128")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("flash attention operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash attention operands must be 16-byte aligned")


def _check_stats(lse: torch.Tensor, delta: torch.Tensor, B: int, H: int, T: int) -> None:
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (B, H, T):
            raise ValueError(f"{name} must be f32 [{B}, {H}, {T}], got {t.dtype} {tuple(t.shape)}")


def _grad_dtype(dtype: torch.dtype, grad_dtype: Optional[torch.dtype]) -> torch.dtype:
    out = grad_dtype or dtype
    if out not in (dtype, torch.float32):
        raise ValueError(f"grad_dtype {out}: the kernels write {dtype} or f32")
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _expand(x: torch.Tensor, H: int) -> torch.Tensor:
    """[B, T, Hkv, D] -> [B, T, H, D]: q-head h reads kv-head h // rep."""
    return x.repeat_interleave(H // x.shape[2], dim=2)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """scale * q.k^T in f32, [B, H, Tq, Tk], masked to NEG_INF above the
    diagonal when causal."""
    D = q.shape[-1]
    s = D**-0.5 * torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand(k, q.shape[2]).float())
    if causal:
        T = q.shape[1]
        pos = torch.arange(T, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """B1's arithmetic in one pass: (out [B, T, H, D] in q's dtype, lse
    [B, H, T] f32). p is rounded to v's dtype at the row's global maximum
    (the kernel rounds it at each tile's running maximum)."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), _expand(v, q.shape[2]).float())
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_safe).transpose(1, 2).to(q.dtype)
    return out.contiguous(), (m + torch.log(l_safe))[..., 0]


def _probs_and_ds(q, k, v, dout, lse, delta, causal):
    s = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), _expand(v, q.shape[2]).float())
    return p, p * (dp - delta[..., None])


def flash_attention_dq_plain(
    q, k, v, dout, lse, delta, causal: bool = True, grad_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """B2a's arithmetic: dq = scale * ds.k with ds rounded to k's dtype;
    [B, T, H, D] in ``grad_dtype`` (default q's dtype)."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), _expand(k, q.shape[2]).float())
    return (q.shape[-1] ** -0.5 * dq).to(grad_dtype or q.dtype)


def flash_attention_dkv_plain(
    q, k, v, dout, lse, delta, causal: bool = True, grad_dtype: Optional[torch.dtype] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """B2b's arithmetic: dv = p^T.dO with p rounded to dO's dtype, dk =
    scale * ds^T.q with ds rounded to q's dtype, each summed over the rep
    q-heads of its kv head; [B, T, Hkv, D] in ``grad_dtype``."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal)
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = dv.reshape(B, T, Hkv, H // Hkv, D).sum(dim=3)
    dk = D**-0.5 * dk.reshape(B, T, Hkv, H // Hkv, D).sum(dim=3)
    out = grad_dtype or k.dtype
    return dk.to(out), dv.to(out)


def attention_delta_plain(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32: [B, T, H, D] -> [B, H, T]."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """B1: (out [B, T, H, D], lse [B, H, T] f32)."""
    if not on_card(q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal)
    return _fwd_kernel(q, k, v, causal)


def _fwd_kernel(q, k, v, causal, route: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """B1 on the card through ``route`` (default :func:`_fwd_route`'s)."""
    B, T, H, Hkv, D = _check(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch(
        "flash_attention_fwd", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, T, H, Hkv, D, int(causal), D**-0.5,
        source=route or _fwd_route(q.dtype, D),
    )
    return out, lse


def attention_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32: [B, T, H, D] -> [B, H, T], the
    backward's preprocess (the JAX package's ``_delta``)."""
    if not on_card(dout, out):
        return attention_delta_plain(dout, out)
    if out.dim() != 4 or dout.shape != out.shape or dout.dtype != out.dtype:
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} does not match out {out.dtype} {tuple(out.shape)}")
    B, T, H, D = out.shape
    _check_operands(out.dtype, D, dout, out)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=out.device)
    launch(DELTA_SOURCE, DELTA_SOURCE, f"{DELTA_SOURCE}_{SUFFIX[out.dtype]}", _ARGTYPES[DELTA_SOURCE],
           out.device, dout.data_ptr(), out.data_ptr(), delta.data_ptr(), B, T, H, D)
    return delta


def flash_attention_dq(
    q, k, v, dout, lse, delta, causal: bool = True, grad_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """B2a: dq [B, T, H, D] in ``grad_dtype`` (q's dtype or f32)."""
    if not on_card(q, k, v, dout, lse, delta):
        return flash_attention_dq_plain(q, k, v, dout, lse, delta, causal, grad_dtype)
    return _dq_kernel(q, k, v, dout, lse, delta, causal, grad_dtype)


def flash_attention_dkv(
    q, k, v, dout, lse, delta, causal: bool = True, grad_dtype: Optional[torch.dtype] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """B2b: (dk, dv) [B, T, Hkv, D] in ``grad_dtype`` (k's dtype or f32)."""
    if not on_card(q, k, v, dout, lse, delta):
        return flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal, grad_dtype)
    return _dkv_kernel(q, k, v, dout, lse, delta, causal, grad_dtype)


def _check_bwd(q, k, v, dout, lse, delta) -> tuple:
    B, T, H, Hkv, D = _check(q, k, v, dout, lse, delta)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} does not match q")
    _check_stats(lse, delta, B, H, T)
    return B, T, H, Hkv, D


def _dq_kernel(q, k, v, dout, lse, delta, causal, grad_dtype, route: Optional[str] = None) -> torch.Tensor:
    """B2a on the card through ``route`` (default :func:`_bwd_route`'s)."""
    B, T, H, Hkv, D = _check_bwd(q, k, v, dout, lse, delta)
    gd = _grad_dtype(q.dtype, grad_dtype)
    dq = torch.empty(q.shape, dtype=gd, device=q.device)
    _launch(
        "flash_attention_dq", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(),
        B, T, H, Hkv, D, int(causal), D**-0.5, int(gd == torch.float32 and q.dtype != gd),
        source=route or _bwd_route(q.dtype, D),
    )
    return dq


def _dkv_kernel(q, k, v, dout, lse, delta, causal, grad_dtype,
                route: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """B2b on the card through ``route`` (default :func:`_bwd_route`'s)."""
    B, T, H, Hkv, D = _check_bwd(q, k, v, dout, lse, delta)
    gd = _grad_dtype(k.dtype, grad_dtype)
    dk = torch.empty(k.shape, dtype=gd, device=k.device)
    dv = torch.empty(k.shape, dtype=gd, device=k.device)
    _launch(
        "flash_attention_dkv", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, H, Hkv, D, int(causal), D**-0.5, int(gd == torch.float32 and k.dtype != gd),
        source=route or _bwd_route(q.dtype, D),
    )
    return dk, dv


@torch.library.custom_op("odtp::flash_fwd", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, bool causal) -> (Tensor, Tensor)")
def _flash_fwd_op(q, k, v, causal):
    return flash_attention_fwd(q, k, v, causal)


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal):
    B, T, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, T), dtype=torch.float32)


# B1 as the dispatcher sees it: (out, lse) = FLASH_FWD_OP(q, k, v, causal)
FLASH_FWD_OP = torch.ops.odtp.flash_fwd.default


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v): B1 forward, B2a and B2b backward with
    delta computed in between by its own kernel. Saves (q, k, v, out, lse) for the backward,
    as ``_flash_fwd`` does. Under activation checkpointing the forward
    reruns, and with it B1, unless the policy keeps :data:`FLASH_FWD_OP`'s
    outputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = FLASH_FWD_OP(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(dout, out)
        dq = flash_attention_dq(q, k, v, dout, lse, delta, ctx.causal)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """[B, T, H, D] attention through the kernels (on the CPU, their plain
    versions), differentiable in q, k and v."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), causal)
