"""Fused lm-head + cross-entropy: the mean next-token loss of h . w without
the logits in device memory.

The counterpart of ``opendiloco_tpu/ops/fused_xent.py``. Its three Pallas
kernels are written by hand in CUDA C++ for Hopper in
``csrc/fused_xent_sm90.cu`` (bf16 and f16) and ``csrc/fused_xent.cu`` (the
first design; the sources note what each replaces, its bound and its design):

- B3 ``fused_xent_fwd``: per-token nll and lse by an online log-sum-exp
  over vocab tiles (``_fwd`` / ``_fwd_kernel``);
- B4, the backward (``_bwd_impl``), over chunks of :data:`CHUNK_ROWS`
  rows: ``fused_xent_dlog`` recomputes the logits of the chunk and writes
  dlog = g * (softmax - onehot) in h's dtype (``_recompute_dlog``), then
  B4a ``fused_xent_dh`` gives the chunk's dh = dlog . w^T (``_dh_kernel``)
  and B4b ``fused_xent_dw`` adds its hT . dlog to the f32 dw (``_dw_kernel``).

Every kernel takes one of two routes, chosen from the dtype alone by
:func:`_route` (:func:`_on_sm90`): bf16 and f16 go to the wgmma and TMA
kernels of ``csrc/fused_xent_sm90.cu``, counted as ``fused_xent_fwd_sm90``,
``fused_xent_dlog_sm90``, ``fused_xent_dh_sm90`` and
``fused_xent_dw_sm90``; f32 to the first design's ``mma.sync`` kernels in
``csrc/fused_xent.cu``, counted as ``fused_xent_fwd``,
``fused_xent_dlog``, ``fused_xent_dh`` and ``fused_xent_dw``. ``route=``
launches a given route (the smoke times the first design in bf16 that
way). B3 splits the vocab across blocks on both routes and merges the
splits' (m, l, target) in split order; :func:`fwd_sm90_splits` is the
sm90 route's split rule.

Each wrapper sits beside its plain version (``*_plain``), which repeats
the kernel's arithmetic and roundings on materialized f32 logits: s from
the operands in their own dtype with f32 sums, statistics in f32, dlog
rounded to h's dtype before both products, dh written in h's dtype, dw in
f32. A CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the wrapper raises (f32, bf16 and f16, D and V multiples of 8,
contiguous operands, one device). Nothing falls back.

:class:`FusedLinearCrossEntropy` is the ``torch.autograd.Function`` that
replaces ``_fused_nll``'s ``custom_vjp``: it saves h, w, labels and lse,
masks the upstream gradient by ``labels != IGNORE``, and returns dh in
h's dtype and dw in w's dtype (at bf16-mixed and fp16-mixed, dw is rounded
to bf16 or f16 before autograd carries it to the f32 master: at f16 a dw
past 65504 becomes inf there, as in the JAX package, and the loss scaler
skips the step).

Where the JAX package pads rows to a multiple of 128 with ignored labels
and pads the vocab to wide tiles, the kernels take any N and mask columns
past V. The JAX package's materializing branch for ``D % 128 != 0`` (a
constraint of its TPU compiler) stays on the CPU, so CPU results agree
with it at any width; on the card the kernels take every D they support.
"""
from __future__ import annotations

import functools

import torch

# LAUNCHES is re-exported: callers read the one shared counter from here
from opendiloco_torch.ops.launch import HALF_DTYPES, LAUNCHES, I, P, SUFFIX, launch, on_card, register

IGNORE = -100
# rows of one backward chunk: its dlog is CHUNK_ROWS x V in h's dtype (131 MB
# at V 32000 in bf16), and dw is read and written once per chunk
CHUNK_ROWS = 2048
_TILE = 128  # rows and vocab columns of a kernel's output tile
SOURCE = "fused_xent"
SM90_SOURCE = "fused_xent_sm90"
NAMES = ("fused_xent_fwd", "fused_xent_dlog", "fused_xent_dh", "fused_xent_dw")
SM90_NAMES = ("fused_xent_fwd_sm90", "fused_xent_dlog_sm90", "fused_xent_dh_sm90", "fused_xent_dw_sm90")
_SM90_TILE = (128, 256)  # rows and vocab columns of a B3 sm90 tile
register(*NAMES, *SM90_NAMES)
_ARGTYPES = {  # the last pointer is the stream
    "fused_xent_fwd": [P, P, P, P, P, P, I, I, I, I, P],
    "fused_xent_dlog": [P, P, P, P, P, P, I, I, I, P],
    "fused_xent_dh": [P, P, P, I, I, I, P],
    "fused_xent_dw": [P, P, P, I, I, I, I, P],
    "fused_xent_fwd_sm90": [P, P, P, P, P, P, I, I, I, I, P],
    "fused_xent_dlog_sm90": [P, P, P, P, P, P, I, I, I, P],
    "fused_xent_dh_sm90": [P, P, P, I, I, I, P],
    "fused_xent_dw_sm90": [P, P, P, I, I, I, I, P],
}


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args, source: str = SOURCE) -> None:
    kernel = name if source == SOURCE else f"{name}_sm90"
    launch(kernel, source, f"{kernel}_{SUFFIX[dtype]}", _ARGTYPES[kernel], device, *args)


def _on_sm90(dtype: torch.dtype) -> bool:
    """The route rule of every kernel here: the wgmma kernels take bf16 and
    f16 (at every D and V that :func:`_check` lets through: multiples of 8,
    the 16-byte rows TMA needs); f32 takes the first design."""
    return dtype in HALF_DTYPES


def _route(dtype: torch.dtype, route: str | None = None) -> str:
    """The source of the kernels for ``dtype``: ``route`` when given
    (SOURCE, or SM90_SOURCE where :func:`_on_sm90` allows it, else
    ValueError), else the rule's."""
    if route is None:
        return SM90_SOURCE if _on_sm90(dtype) else SOURCE
    if route == SOURCE or (route == SM90_SOURCE and _on_sm90(dtype)):
        return route
    raise ValueError(f"route {route!r} does not take {dtype}")


def _check(N: int, D: int, V: int, *operands: torch.Tensor) -> None:
    """The sizes, dtypes and layouts the kernels take; anything else
    raises. The operands share one dtype, f32, bf16 or f16."""
    dtype = operands[0].dtype
    if dtype not in SUFFIX or any(t.dtype != dtype for t in operands):
        raise ValueError(f"dtypes {[t.dtype for t in operands]}: need all f32/bf16/f16, all the same")
    if N < 1 or D < 8 or V < 8 or D % 8 or V % 8:
        raise ValueError(f"N {N}, D {D}, V {V}: the kernels take N >= 1 and D, V multiples of 8")
    for t in operands:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fused cross-entropy operands must be contiguous and 16-byte aligned")


def _check_rows(N: int, labels: torch.Tensor, *stats: torch.Tensor) -> None:
    if labels.shape != (N,) or labels.dtype != torch.int64 or not labels.is_contiguous():
        raise ValueError(f"labels must be contiguous int64 [{N}], got {labels.dtype} {tuple(labels.shape)}")
    for t in stats:
        if t.shape != (N,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"per-row statistics must be contiguous f32 [{N}], got {t.dtype} {tuple(t.shape)}")


def _dims(a: torch.Tensor, b: torch.Tensor, shared: tuple, what: str) -> tuple:
    """Sizes of two 2-D operands whose dimensions ``shared`` (a's, b's)
    must agree."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[shared[0]] != b.shape[shared[1]]:
        raise ValueError(f"bad shapes for {what}: {tuple(a.shape)} and {tuple(b.shape)}")
    return tuple(a.shape), tuple(b.shape)


def _check_out(out: torch.Tensor, shape: tuple, dtype: torch.dtype) -> None:
    if out.shape != shape or out.dtype != dtype or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError(f"out must be a contiguous {dtype} {list(shape)}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """s = h . w in f32 from the operands in their own dtype (a bf16 x
    bf16 product is exact in f32, so only the order of the sums differs
    from the kernels')."""
    return h.float() @ w.float()


def fused_xent_fwd_plain(h, w, labels) -> tuple[torch.Tensor, torch.Tensor]:
    """B3's arithmetic: (nll [N], lse [N]) in f32; nll is 0 where the
    label is IGNORE."""
    s = _logits(h, w)
    lse = torch.logsumexp(s, dim=1)
    mask = labels != IGNORE
    tgt = s.gather(1, torch.where(mask, labels, 0)[:, None].long())[:, 0]
    return (lse - tgt) * mask, lse


def fused_xent_dlog_plain(h, w, labels, lse, g) -> torch.Tensor:
    """dlog = g * (exp(s - lse) - onehot) rounded to h's dtype, [N, V]."""
    s = _logits(h, w)
    onehot = torch.arange(w.shape[1], device=h.device)[None, :] == labels[:, None]
    return (g[:, None] * (torch.exp(s - lse[:, None]) - onehot.float())).to(h.dtype)


def fused_xent_dh_plain(dlog, w, out=None) -> torch.Tensor:
    """B4a's arithmetic: dh = dlog . w^T in f32, written in dlog's (h's)
    dtype, into ``out`` when given."""
    dh = (dlog.float() @ w.float().T).to(dlog.dtype)
    return dh if out is None else out.copy_(dh)


def fused_xent_dw_plain(h, dlog, out=None) -> torch.Tensor:
    """B4b's arithmetic: h^T . dlog in f32, added to ``out`` (f32 [D, V])
    in place when given."""
    dw = h.float().T @ dlog.float()
    return dw if out is None else out.add_(dw)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fwd_splits(N: int, V: int, device: torch.device) -> int:
    """Vocab splits of the first design's B3: enough 128-row blocks to cover
    the SMs once. A function of N, V and the card only, so results repeat
    on one card."""
    return max(1, min(_sm_count(device) // -(-N // _TILE), -(-V // _TILE)))


@functools.lru_cache(maxsize=256)
def fwd_sm90_splits(N: int, V: int, sms: int) -> int:
    """Vocab splits of the sm90 B3: a unit of work is (split, 128-row tile),
    a CTA an SM takes units in turn, and a unit walks its split's 256-column
    vocab tiles. The count is the smallest that minimises the vocab tiles
    the busiest CTA walks, ceil(units / sms) * ceil(tiles / splits), so it
    depends on N, V and the SM count alone and results repeat on one card
    (125, one vocab tile a split, at N 8184, V 32000 on 132
    SMs)."""
    mt, nvt = -(-N // _SM90_TILE[0]), -(-V // _SM90_TILE[1])
    return min(range(1, nvt + 1), key=lambda s: (-(-mt * s // sms) * -(-nvt // s), s))


def fused_xent_fwd(h, w, labels, *, route: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """B3: (nll [N], lse [N]) in f32, on :func:`_route`'s kernel, the vocab
    split across blocks and the splits merged in order."""
    if not on_card(h, w, labels):
        return fused_xent_fwd_plain(h, w, labels)
    (N, D), (_, V) = _dims(h, w, (1, 0), "h [N, D] and w [D, V]")
    _check(N, D, V, h, w)
    _check_rows(N, labels)
    source = _route(h.dtype, route)
    nll = torch.empty(N, dtype=torch.float32, device=h.device)
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    if source == SM90_SOURCE:
        splits = fwd_sm90_splits(N, V, _sm_count(h.device))
    else:
        splits = _fwd_splits(N, V, h.device)
    part = torch.empty((3, splits, N) if splits > 1 else (1,), dtype=torch.float32, device=h.device)
    _launch(
        "fused_xent_fwd", h.dtype, h.device,
        h.data_ptr(), w.data_ptr(), labels.data_ptr(), nll.data_ptr(), lse.data_ptr(), part.data_ptr(),
        N, D, V, splits, source=source,
    )
    return nll, lse


def fused_xent_dlog(h, w, labels, lse, g, *, route: str | None = None) -> torch.Tensor:
    """The logits' gradient of one chunk of rows, [N, V] in h's dtype, on
    :func:`_route`'s kernel."""
    if not on_card(h, w, labels, lse, g):
        return fused_xent_dlog_plain(h, w, labels, lse, g)
    (N, D), (_, V) = _dims(h, w, (1, 0), "h [N, D] and w [D, V]")
    _check(N, D, V, h, w)
    _check_rows(N, labels, lse, g)
    source = _route(h.dtype, route)
    dlog = torch.empty((N, V), dtype=h.dtype, device=h.device)
    _launch(
        "fused_xent_dlog", h.dtype, h.device,
        h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), dlog.data_ptr(),
        N, D, V, source=source,
    )
    return dlog


def fused_xent_dh(dlog, w, out=None, *, route: str | None = None) -> torch.Tensor:
    """B4a: dh = dlog . w^T, [N, D] in dlog's dtype, into ``out`` when
    given, on :func:`_route`'s kernel."""
    if not on_card(dlog, w, *([] if out is None else [out])):
        return fused_xent_dh_plain(dlog, w, out)
    (N, V), (D, _) = _dims(dlog, w, (1, 1), "dlog [N, V] and w [D, V]")
    _check(N, D, V, dlog, w)
    source = _route(dlog.dtype, route)
    if out is None:
        out = torch.empty((N, D), dtype=dlog.dtype, device=dlog.device)
    _check_out(out, (N, D), dlog.dtype)
    _launch("fused_xent_dh", dlog.dtype, dlog.device, dlog.data_ptr(), w.data_ptr(), out.data_ptr(), N, D, V,
            source=source)
    return out


def fused_xent_dw(h, dlog, out=None, *, route: str | None = None) -> torch.Tensor:
    """B4b: h^T . dlog in f32 [D, V], added in place to ``out`` when given,
    else written to a new tensor, on :func:`_route`'s kernel."""
    if not on_card(h, dlog, *([] if out is None else [out])):
        return fused_xent_dw_plain(h, dlog, out)
    (N, D), (_, V) = _dims(h, dlog, (0, 0), "h [N, D] and dlog [N, V]")
    _check(N, D, V, h, dlog)
    source = _route(h.dtype, route)
    accumulate = out is not None
    if out is None:
        out = torch.empty((D, V), dtype=torch.float32, device=h.device)
    _check_out(out, (D, V), torch.float32)
    _launch("fused_xent_dw", h.dtype, h.device, h.data_ptr(), dlog.data_ptr(), out.data_ptr(), N, D, V,
            int(accumulate), source=source)
    return out


def fused_xent_bwd(h, w, labels, lse, g) -> tuple[torch.Tensor, torch.Tensor]:
    """(dh [N, D] in h's dtype, dw [D, V] f32) for the masked upstream
    gradient ``g`` [N] f32, over chunks of CHUNK_ROWS rows in order: one
    dlog, one dh and one dw launch per chunk, on the route :func:`_route`
    picks (the first chunk writes dw, later ones add to it)."""
    N = h.shape[0]
    dh = torch.empty_like(h)
    dw = None
    for c0 in range(0, N, CHUNK_ROWS):
        rows = slice(c0, min(N, c0 + CHUNK_ROWS))
        dlog = fused_xent_dlog(h[rows], w, labels[rows], lse[rows], g[rows])
        fused_xent_dh(dlog, w, out=dh[rows])
        dw = fused_xent_dw(h[rows], dlog, dw)
        del dlog
    return dh, dw


class FusedLinearCrossEntropy(torch.autograd.Function):
    """nll [N] f32 = B3(h, w, labels); the backward is B4 over chunks."""

    @staticmethod
    def forward(ctx, h, w, labels):
        nll, lse = fused_xent_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        g = (g.float() * (labels != IGNORE)).contiguous()
        dh, dw = fused_xent_bwd(h, w, labels, lse, g)
        return dh, dw.to(w.dtype), None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _nll_sum_count(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of nll over non-ignored labels, their count): the core of the
    mean entry point, as ``_nll_sum_count`` in the JAX package."""
    labels = labels.long()
    mask = labels != IGNORE
    count = mask.sum()
    if h.shape[1] % 128 and not on_card(h, w, labels):
        # the JAX package's materializing branch, differentiated by autograd
        lp = torch.log_softmax(h.float() @ w.float(), dim=-1)
        nll = -lp.gather(1, torch.where(mask, labels, 0)[:, None])[:, 0] * mask
        return nll.sum(), count
    nll = FusedLinearCrossEntropy.apply(h.contiguous(), w, labels.contiguous())
    return nll.sum(), count


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean nll over non-ignored labels; h [N, D], w [D, V], labels [N]."""
    s, c = _nll_sum_count(h, w, labels)
    return s / torch.clamp(c, min=1)


def fused_linear_cross_entropy_sharded(
    h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *, mesh=None, batch_axes: tuple = (), tp_axis=None
) -> torch.Tensor:
    """The SPMD entry. ``mesh`` is the trainer's
    :class:`~opendiloco_torch.parallel.mesh.MeshPlan`: without one, on one
    process, or with no batch axes, the unsharded entry. Otherwise the rows
    of ``h``/``labels`` are this rank's share of the batch: the kernels run
    on them, and the local (nll sum, count) are summed over the batch group
    before the division, as the JAX entry's psum does. The returned mean is
    the whole batch's; each rank's gradient is its rows' share, and the
    head's (``w``, whole on every rank) is summed by the trainer's gradient
    reduction like any other leaf's.

    ``tp_axis``: ``w`` is this rank's block of a head cut over tp along the
    vocab. It is gathered whole (the softmax needs the full vocab: the JAX
    entry replicates a tp-cut head into its region), every tp rank runs
    the kernels on the same rows, (sum, count) are summed over the batch
    group only, and the backward hands each rank its block of the head's
    gradient (every rank computed the same whole gradient)."""
    if tp_axis is not None and mesh is not None and mesh.shape[tp_axis] > 1:
        from opendiloco_torch.parallel.comm import TensorParallel

        w = TensorParallel(mesh.comm(tp_axis)).gather(w, 1, partial=False)
    group = None
    if mesh is not None and getattr(mesh, "size", 1) > 1 and batch_axes:
        group = mesh.batch_group()
    if group is None:
        return fused_linear_cross_entropy(h, w, labels)
    from opendiloco_torch.parallel.comm import all_reduce_, sum_over

    s, c = _nll_sum_count(h, w, labels)
    return sum_over(s, group) / torch.clamp(all_reduce_(c, group), min=1)
