"""Serving kernels: paged decode attention, speculative tail attention and
the fused W4 dequant-matmul.

The counterparts of ``opendiloco_tpu/ops/decode_kernels.py``
``paged_decode_attention``, ``spec_tail_attention_fused`` and
``w4_matmul``, written by hand in CUDA C++ for Hopper
(``csrc/spec_tail_attention.cu``, ``csrc/w4_matmul_sm90.cu``, and
``csrc/paged_decode_attention.cu`` and ``csrc/w4_matmul.cu`` for B6's and
B8's first designs; each source notes the TPU kernel it replaces, its
bound and its design).

B8 has two routes (:func:`w4_route`): bf16 goes to the tensor-core kernel
with K split across blocks (:func:`w4_splits`), counted as
``w4_matmul_sm90``; f32 and shapes it does not take to the first design,
counted as ``w4_matmul``.

B7 cuts the ring into splits across blocks (:func:`spec_tail_splits`)
and, with more than one, merges the splits' partials in a second kernel
(``spec_tail_attention_merge``).
:func:`spec_tail_attention_split_plain` repeats that split-and-merge
arithmetic for the tests. B6 is the same split kernel with a prefix-live
ring and no tail (its ``kPrefix`` instance), with the same split rule and
merge kernel, counted as ``paged_decode_attention`` and
``paged_decode_attention_merge``; :func:`paged_decode_attention_split_plain`
repeats its arithmetic. Head dims above 128 take B6's first design
(:func:`_decode_route`), counted as ``paged_decode_attention_first``.

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

import functools

import torch

# LAUNCHES is re-exported: callers read the one shared counter from here
from opendiloco_torch.ops.launch import LAUNCHES, SUFFIX as _SUFFIX, F as _F, I as _I, P as _P
from opendiloco_torch.ops.attention import spec_tail_valid
from opendiloco_torch.ops.launch import launch, on_card as _on_card, register
from opendiloco_torch.quant import W4_BLOCK, dequant_w4

SPLIT_SOURCE = "spec_tail_attention"  # B7, and B6 up to SPLIT_MAX_D
FIRST_SOURCE = "paged_decode_attention"  # B6's first design
SPLIT_MAX_D = 128
W4_FIRST_SOURCE = "w4_matmul"  # B8's first design: f32, and shapes the sm90 kernel does not take
W4_SM90_SOURCE = "w4_matmul_sm90"  # B8 on the tensor cores, K split across blocks: bf16
_MERGE = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
# launch counter: (source, exported C function less its dtype suffix, argtypes)
_KERNELS = {
    "paged_decode_attention": (SPLIT_SOURCE, "paged_decode_split", [_P] * 7 + [_I] * 8 + [_F, _P]),
    "paged_decode_attention_merge": (SPLIT_SOURCE, "spec_tail_attention_merge", _MERGE),
    "paged_decode_attention_first": (FIRST_SOURCE, "paged_decode_attention",
                                     [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "spec_tail_attention": (SPLIT_SOURCE, "spec_tail_attention", [_P] * 9 + [_I] * 11 + [_F, _P]),
    "spec_tail_attention_merge": (SPLIT_SOURCE, "spec_tail_attention_merge", _MERGE),
    "w4_matmul": (W4_FIRST_SOURCE, "w4_matmul", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "w4_matmul_sm90": (W4_SM90_SOURCE, "w4_matmul_sm90", [_P] * 6 + [_I] * 5 + [_P]),
}
register(*_KERNELS)


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    source, symbol, argtypes = _KERNELS[name]
    launch(name, source, f"{symbol}_{_SUFFIX[dtype]}", argtypes, device, *args)


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


def paged_decode_attention_split_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor, *, splits: int = 1
) -> torch.Tensor:
    """The split kernel's arithmetic for B6 in plain PyTorch, for the
    tests: the ring cut as :func:`spec_tail_split_chunk` cuts it, each
    split's partial (m, l, unnormalised acc) in f32 over its live rows,
    p = exp(s - m) rounded to v's dtype before p.v, then
    :func:`spec_tail_merge_plain` at Kq 1. A split with no live row has
    m = -inf, l = 0 and acc = 0."""
    S, T, Kh, D = k.shape
    H = q.shape[1]
    rep = H // Kh
    splits, chunk = spec_tail_split_chunk(T, splits)
    qg = q.float().reshape(S, Kh, rep, D)
    sc = torch.einsum("sgrd,stgd->sgrt", qg, k.float()) * D**-0.5
    idx = torch.arange(T, device=k.device)
    lens_ = lens.to(device=k.device, dtype=torch.int64)[:, None, None, None]
    sc = sc.masked_fill(~((idx <= lens_) | (lens_ >= T)), float("-inf"))
    mls, accs = [], []
    for p in range(splits):
        mine = (idx >= p * chunk) & (idx < (p + 1) * chunk)
        sp = sc.masked_fill(~mine, float("-inf"))
        m = sp.amax(dim=-1, keepdim=True)
        pr = torch.exp(sp - torch.where(m == float("-inf"), torch.zeros_like(m), m))
        accs.append(torch.einsum("sgrt,stgd->sgrd", pr.to(v.dtype).float(), v.float()))
        mls.append(torch.stack([m[..., 0], pr.sum(dim=-1)], dim=-1))
    out = spec_tail_merge_plain(torch.stack(mls, dim=2), torch.stack(accs, dim=2), 1, q.dtype)
    return out.reshape(S, H, D)


def _decode_route(D: int) -> str:
    """The source of B6's kernel at head dim ``D``: the split kernel up to
    SPLIT_MAX_D, the first design above."""
    return SPLIT_SOURCE if D <= SPLIT_MAX_D else FIRST_SOURCE


def _check_decode(q, k, v, lens) -> None:
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


def _decode_split(q, k, v, lens, *, splits: int, chunk: int) -> tuple[torch.Tensor, int, int]:
    """Launch B6's split kernel alone on checked operands, ``splits`` > 1
    of ``chunk`` rows, into one new f32 buffer: ml [S, Kh, splits, rep, 2]
    first, then acc [S, Kh, splits, rep, D] from the next 16-byte
    boundary. Returns the buffer and the two addresses (one allocation
    and no views: the host time of a decode step is the serving path's
    bottleneck)."""
    S, T, Kh, D = k.shape
    H = q.shape[1]
    n_ml = S * H * splits * 2
    n_ml += -n_ml % 4
    buf = torch.empty(n_ml + S * H * splits * D, dtype=torch.float32, device=q.device)
    ml = buf.data_ptr()
    acc = ml + 4 * n_ml
    _launch(
        "paged_decode_attention", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), 0, ml, acc,
        S, T, H, Kh, D, splits, chunk, spec_tail_rows_per_block(H // Kh), D**-0.5,
    )
    return buf, ml, acc


def _paged_decode_partials(q, k, v, lens, *, splits: int, chunk: int):
    """B6's split kernel alone (:func:`_decode_split`) with its partials as
    tensors, for the tests: ml [S, Kh, splits, rep, 2] and acc [S, Kh,
    splits, rep, D] f32, which :func:`paged_decode_merge` combines."""
    S, T, Kh, D = k.shape
    rep = q.shape[1] // Kh
    buf, ml, acc = _decode_split(q, k, v, lens, splits=splits, chunk=chunk)
    n = S * Kh * splits * rep
    return buf[: 2 * n].view(S, Kh, splits, rep, 2), buf[(acc - ml) // 4:].view(S, Kh, splits, rep, D)


def paged_decode_merge(ml: torch.Tensor, acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """B6's merge: B7's merge kernel at Kq 1 on B6's partials, counted as
    ``paged_decode_attention_merge``; out [S, H, D] in ``dtype``."""
    if not _on_card(ml, acc):
        out = spec_tail_merge_plain(ml, acc, 1, dtype)
    else:
        out = _merge("paged_decode_attention_merge", ml, acc, 1, dtype)
    return out.reshape(out.shape[0], out.shape[2], out.shape[3])


@functools.lru_cache(maxsize=None)
def _decode_grid(S: int, T: int, Kh: int, rep: int, index: int, splits: int | None) -> tuple[int, int]:
    """(splits, chunk) of B6's split kernel: :func:`spec_tail_splits` (rows
    = rep) unless ``splits`` is given, cut by :func:`spec_tail_split_chunk`;
    one answer per shape, kept."""
    if splits is None:
        splits = spec_tail_splits(S, T, Kh, rep, _sm_count(index))
    elif not 1 <= splits <= T:
        raise ValueError(f"splits {splits} must lie in 1 .. T = {T}")
    return spec_tail_split_chunk(T, splits)


def paged_decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lens: torch.Tensor, *, splits: int | None = None
) -> torch.Tensor:
    """Drop-in :func:`~opendiloco_torch.ops.attention.decode_attention`:
    q [S, H, D] over ring pages k/v [S, T, Kh, D] with per-slot ``lens``
    [S] int32. Takes f32 or bf16, any D that is a multiple of 8 up to 256
    and any H divisible by Kh; anything else raises. On :func:`_decode_route`'s
    split kernel the ring is cut into :func:`spec_tail_splits` splits
    (one query token: rows = rep) unless ``splits`` is given; with more
    than one, the merge kernel combines them (one more launch, counted as
    ``paged_decode_attention_merge``)."""
    if not _on_card(q, k, v, lens):
        return paged_decode_attention_plain(q, k, v, lens)
    _check_decode(q, k, v, lens)
    S, T, Kh, D = k.shape
    H = q.shape[1]
    out = torch.empty_like(q)
    if _decode_route(D) == FIRST_SOURCE:
        _launch(
            "paged_decode_attention_first", q.dtype, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            S, T, H, Kh, D, D**-0.5,
        )
        return out
    splits, chunk = _decode_grid(S, T, Kh, H // Kh, q.device.index or 0, splits)
    if splits > 1:
        # out [S, H, D] is the merge's [S, Kq = 1, H, D]; buf keeps the
        # partials alive until both launches are queued
        buf, ml, acc = _decode_split(q, k, v, lens, splits=splits, chunk=chunk)
        _launch("paged_decode_attention_merge", q.dtype, q.device, ml, acc, out.data_ptr(), S, 1, H, Kh, D, splits)
        return out
    _launch(
        "paged_decode_attention", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(), 0, 0,
        S, T, H, Kh, D, 1, chunk, spec_tail_rows_per_block(H // Kh), D**-0.5,
    )
    return out


# ---------------------------------------------------------------------------
# speculative tail attention
# ---------------------------------------------------------------------------


def spec_tail_attention_plain(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    tail_k: torch.Tensor,
    tail_v: torch.Tensor,
    lens: torch.Tensor,
    *,
    q_start: int = 0,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in one pass over
    concat(ring, tail): f32 scores, masked entries exactly 0, p = exp(s -
    max) rounded to v's dtype before p.v, l the sum of the f32 p, and
    acc / l in q's dtype. Shapes as :func:`spec_tail_attention_fused`."""
    S, T, Kh, D = cache_k.shape
    Kq, H = q.shape[1], q.shape[2]
    ring_valid, tail_valid = spec_tail_valid(lens, T, Kq, tail_k.shape[1], q_start, cache_k.device)
    valid = torch.cat([ring_valid, tail_valid.expand(S, -1, -1)], dim=-1)  # [S, Kq, T + Kt]
    qg = q.float().reshape(S, Kq, Kh, H // Kh, D)
    keys = torch.cat([cache_k, tail_k], dim=1).float()
    s = torch.einsum("sqgrd,stgd->sgrqt", qg, keys) * D**-0.5
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))  # every query sees its own tail row
    l = p.sum(dim=-1)
    values = torch.cat([cache_v, tail_v], dim=1)
    acc = torch.einsum("sgrqt,stgd->sqgrd", p.to(values.dtype).float(), values.float())
    l = l.permute(0, 3, 1, 2)[..., None]  # [S, Kq, Kh, rep, 1]
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(S, Kq, H, D).to(q.dtype)


# ring rows a split holds at the least: two of the kernel's 64-row tiles
SPLIT_ROWS = 128


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The card's SM count, read once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def spec_tail_rows_per_block(rows: int) -> int:
    """Query rows a B7 block owns for ``rows`` = Kq * rep per (slot, kv
    head): 16 or 32 when they fit (the block's 4 warps then share one or two
    16-row slices and split the key tiles), else 64. The one place this is
    decided: the wrapper passes it to the kernel, which launches the
    packing it names, and :func:`spec_tail_splits` sizes the grid by it."""
    return 16 if rows <= 16 else 32 if rows <= 32 else 64


def spec_tail_split_chunk(T: int, splits: int) -> tuple[int, int]:
    """(splits, chunk): ``splits`` cut T ring rows into chunks of ``chunk``
    rows, the last possibly shorter; splits shrinks until none is empty."""
    chunk = -(-T // max(1, min(splits, T)))
    return -(-T // chunk), chunk


def spec_tail_splits(S: int, T: int, Kh: int, rows: int, sms: int) -> int:
    """Ring splits of B7 from the static shape alone (lens stays on the
    device): one when the query tiles already give at least half a wave
    of the card's ``sms`` SMs (the suffix shapes), else enough splits of
    at least :data:`SPLIT_ROWS` rows for about two blocks per SM (the
    draft and verify shapes at config_1b: 8 splits of 128 rows)."""
    blocks = -(-rows // spec_tail_rows_per_block(rows)) * Kh * S
    if 2 * blocks >= sms:
        return 1
    return max(1, min(-(-T // SPLIT_ROWS), -(-2 * sms // blocks)))


def spec_tail_merge_plain(ml: torch.Tensor, acc: torch.Tensor, Kq: int, dtype: torch.dtype) -> torch.Tensor:
    """The merge kernel's arithmetic: split partials ``ml`` [S, Kh, P, R, 2]
    (m, l) and ``acc`` [S, Kh, P, R, D], f32, rows R = Kq * rep
    token-major, merged in split order into out [S, Kq, Kh * rep, D] in
    ``dtype``. A split with m = -inf adds exactly 0."""
    S, Kh, P, R, D = acc.shape
    m, l = ml[..., 0], ml[..., 1]
    M = m.amax(dim=2)
    L = torch.zeros_like(M)
    A = torch.zeros(S, Kh, R, D, dtype=torch.float32, device=acc.device)
    for p in range(P):
        mp = m[:, :, p]
        w = torch.where(mp == float("-inf"), torch.zeros_like(mp), torch.exp(mp - M))
        L = L + l[:, :, p] * w
        A = A + acc[:, :, p] * w[..., None]
    out = A / torch.where(L == 0, torch.ones_like(L), L)[..., None]
    rep = R // Kq
    return out.reshape(S, Kh, Kq, rep, D).permute(0, 2, 1, 3, 4).reshape(S, Kq, Kh * rep, D).to(dtype)


def spec_tail_attention_split_plain(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    tail_k: torch.Tensor,
    tail_v: torch.Tensor,
    lens: torch.Tensor,
    *,
    q_start: int = 0,
    splits: int = 1,
) -> torch.Tensor:
    """The split kernel's arithmetic in plain PyTorch, for the tests: the
    ring cut as :func:`spec_tail_split_chunk` cuts it, each split's partial
    (m, l, unnormalised acc) in f32 over its live ring rows (the last split
    also over the tail), p = exp(s - m) rounded to v's dtype before p.v,
    then :func:`spec_tail_merge_plain`. A split with no live entry has
    m = -inf, l = 0 and acc = 0."""
    S, T, Kh, D = cache_k.shape
    Kq, H = q.shape[1], q.shape[2]
    Kt, rep = tail_k.shape[1], H // Kh
    splits, chunk = spec_tail_split_chunk(T, splits)
    ring_valid, tail_valid = spec_tail_valid(lens, T, Kq, Kt, q_start, cache_k.device)
    qg = q.float().reshape(S, Kq, Kh, rep, D)
    scale = D**-0.5
    s_ring = torch.einsum("sqgrd,stgd->sgqrt", qg, cache_k.float()) * scale
    s_tail = torch.einsum("sqgrd,stgd->sgqrt", qg, tail_k.float()) * scale
    s_ring = s_ring.masked_fill(~ring_valid[:, None, :, None], float("-inf"))
    s_tail = s_tail.masked_fill(~tail_valid[:, None, :, None], float("-inf"))
    idx = torch.arange(T, device=cache_k.device)
    mls, accs = [], []
    for p in range(splits):
        mine = (idx >= p * chunk) & (idx < (p + 1) * chunk)
        sc = s_ring.masked_fill(~mine, float("-inf"))
        values = cache_v
        if p == splits - 1:
            sc = torch.cat([sc, s_tail], dim=-1)
            values = torch.cat([cache_v, tail_v], dim=1)
        m = sc.amax(dim=-1, keepdim=True)
        pr = torch.exp(sc - torch.where(m == float("-inf"), torch.zeros_like(m), m))
        acc = torch.einsum("sgqrt,stgd->sgqrd", pr.to(values.dtype).float(), values.float())
        mls.append(torch.stack([m[..., 0], pr.sum(dim=-1)], dim=-1).reshape(S, Kh, Kq * rep, 2))
        accs.append(acc.reshape(S, Kh, Kq * rep, D))
    return spec_tail_merge_plain(torch.stack(mls, dim=2), torch.stack(accs, dim=2), Kq, q.dtype)


def _check_spec_tail(q, cache_k, cache_v, tail_k, tail_v, lens, q_start) -> None:
    if q.dim() != 4 or cache_k.dim() != 4 or tail_k.dim() != 4:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} cache {tuple(cache_k.shape)} tail {tuple(tail_k.shape)}"
        )
    S, T, Kh, D = cache_k.shape
    Kq, H = q.shape[1], q.shape[2]
    Kt = tail_k.shape[1]
    if (
        cache_v.shape != cache_k.shape
        or tail_v.shape != tail_k.shape
        or q.shape != (S, Kq, H, D)
        or tail_k.shape != (S, Kt, Kh, D)
        or min(Kq, Kt, T) < 1
    ):
        raise ValueError(
            f"q {tuple(q.shape)}, cache {tuple(cache_k.shape)}/{tuple(cache_v.shape)} and "
            f"tail {tuple(tail_k.shape)}/{tuple(tail_v.shape)} do not match"
        )
    ops = (q, cache_k, cache_v, tail_k, tail_v)
    if q.dtype not in _SUFFIX or any(t.dtype != q.dtype for t in ops):
        raise ValueError(f"dtypes {[t.dtype for t in ops]}: need one of f32/bf16, all the same")
    if D % 8 or not 0 < D <= 128:
        raise ValueError(f"head_dim {D} must be a multiple of 8 up to 128")
    if Kh < 1 or H % Kh:
        raise ValueError(f"{H} query heads over {Kh} kv heads")
    if lens.dtype != torch.int32 or lens.shape != (S,):
        raise ValueError(f"lens must be int32 [{S}], got {lens.dtype} {tuple(lens.shape)}")
    if q_start < 0:
        raise ValueError(f"q_start {q_start} must be >= 0")
    if not all(t.is_contiguous() for t in (*ops, lens)):
        raise ValueError("q, the caches, the tail and lens must be contiguous")
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("q, the caches and the tail must be 16-byte aligned")


def _spec_tail_partials(q, cache_k, cache_v, tail_k, tail_v, lens, *, q_start: int, splits: int, chunk: int):
    """Launch the split kernel alone on operands the caller has checked
    (:func:`_check_spec_tail`), ``splits`` > 1 of ``chunk`` rows: the
    partials (ml [S, Kh, splits, R, 2], acc [S, Kh, splits, R, D]) f32
    that :func:`spec_tail_merge` combines."""
    S, T, Kh, D = cache_k.shape
    Kq, H, Kt = q.shape[1], q.shape[2], tail_k.shape[1]
    R = Kq * (H // Kh)
    ml = torch.empty((S, Kh, splits, R, 2), dtype=torch.float32, device=q.device)
    acc = torch.empty((S, Kh, splits, R, D), dtype=torch.float32, device=q.device)
    _launch(
        "spec_tail_attention", q.dtype, q.device,
        *(t.data_ptr() for t in (q, cache_k, cache_v, tail_k, tail_v, lens)), 0, ml.data_ptr(), acc.data_ptr(),
        S, T, Kq, Kt, H, Kh, D, int(q_start), splits, chunk, spec_tail_rows_per_block(R), D**-0.5,
    )
    return ml, acc


def spec_tail_merge(ml: torch.Tensor, acc: torch.Tensor, Kq: int, dtype: torch.dtype) -> torch.Tensor:
    """The merge kernel: :func:`spec_tail_merge_plain`'s function on the
    card, out [S, Kq, H, D] in ``dtype``."""
    if not _on_card(ml, acc):
        return spec_tail_merge_plain(ml, acc, Kq, dtype)
    return _merge("spec_tail_attention_merge", ml, acc, Kq, dtype)


def _merge(name: str, ml: torch.Tensor, acc: torch.Tensor, Kq: int, dtype: torch.dtype) -> torch.Tensor:
    """Launch the merge kernel on card partials, counted under ``name``."""
    S, Kh, P, R, D = acc.shape
    if (ml.shape != (S, Kh, P, R, 2) or R % Kq or ml.dtype != torch.float32 or acc.dtype != torch.float32
            or dtype not in _SUFFIX):
        raise ValueError(f"partials ml {tuple(ml.shape)} {ml.dtype}, acc {tuple(acc.shape)} {acc.dtype} "
                         f"for Kq {Kq} and {dtype}")
    if not (ml.is_contiguous() and acc.is_contiguous()):
        raise ValueError("the partials must be contiguous")
    H = Kh * (R // Kq)
    out = torch.empty((S, Kq, H, D), dtype=dtype, device=acc.device)
    _launch(name, dtype, acc.device, ml.data_ptr(), acc.data_ptr(), out.data_ptr(), S, Kq, H, Kh, D, P)
    return out


def spec_tail_attention_fused(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    tail_k: torch.Tensor,
    tail_v: torch.Tensor,
    lens: torch.Tensor,
    *,
    q_start: int = 0,
    splits: int | None = None,
) -> torch.Tensor:
    """Drop-in :func:`~opendiloco_torch.ops.attention.spec_tail_attention`:
    q [S, Kq, H, D] over ring pages cache_{k,v} [S, T, Kh, D] and the
    tail's own K/V [S, Kt, Kh, D], one softmax, the exact ring-wrap
    eviction mask, with ``lens`` [S] int32 and queries at tail positions
    ``q_start + i``. Takes f32 or bf16, D a multiple of 8 up to 128 and H
    divisible by Kh; anything else raises on the card. The ring is cut
    into :func:`spec_tail_splits` splits unless ``splits`` is given; with
    more than one, the merge kernel combines them (one more launch)."""
    if not _on_card(q, cache_k, cache_v, tail_k, tail_v, lens):
        return spec_tail_attention_plain(q, cache_k, cache_v, tail_k, tail_v, lens, q_start=q_start)
    _check_spec_tail(q, cache_k, cache_v, tail_k, tail_v, lens, q_start)
    S, T, Kh, D = cache_k.shape
    Kq, H, Kt = q.shape[1], q.shape[2], tail_k.shape[1]
    if splits is None:
        splits = spec_tail_splits(S, T, Kh, Kq * (H // Kh), _sm_count(q.device.index or 0))
    elif not 1 <= splits <= T:
        raise ValueError(f"splits {splits} must lie in 1 .. T = {T}")
    splits, chunk = spec_tail_split_chunk(T, splits)
    if splits > 1:
        ml, acc = _spec_tail_partials(q, cache_k, cache_v, tail_k, tail_v, lens, q_start=q_start, splits=splits,
                                     chunk=chunk)
        return spec_tail_merge(ml, acc, Kq, q.dtype)
    out = torch.empty_like(q)
    _launch(
        "spec_tail_attention", q.dtype, q.device,
        *(t.data_ptr() for t in (q, cache_k, cache_v, tail_k, tail_v, lens)), out.data_ptr(), 0, 0,
        S, T, Kq, Kt, H, Kh, D, int(q_start), 1, chunk, spec_tail_rows_per_block(Kq * (H // Kh)), D**-0.5,
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


W4_TILE_N = 64  # columns of a sm90 block's tile


def w4_sm90_dequant_plain(nib: torch.Tensor, scale_bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The sm90 kernel's dequant of nibbles ``nib`` (0..15, any integer
    dtype) under fp16 scale bits ``scale_bits`` (int16, broadcast against
    ``nib``), in torch, for the tests: the factor half2float(s) / 7 by an
    IEEE divide, the exact float nib - 8 as the float of bits 0x4B000000 |
    nib (2^23 + nib) less 2^23 + 8, one f32 multiply, one rounding to
    ``dtype``."""
    f = scale_bits.view(torch.float16).float()
    f = f / torch.full_like(f, 7.0)
    v = (torch.bitwise_or(nib.to(torch.int32), 0x4B000000).view(torch.float32) - 8388616.0)
    return (v * f).to(dtype)


def w4_on_sm90(dtype: torch.dtype, K: int, N: int) -> bool:
    """The route rule of B8: the sm90 kernel takes bf16 where K is a multiple
    of 8 (16-byte rows of x) and N of 64 (whole column tiles, each row's
    64 columns in one scale block); everything else, f32 above all (the
    identity probe's bits), takes the first design."""
    return dtype == torch.bfloat16 and K % 8 == 0 and N % W4_TILE_N == 0


def w4_route(dtype: torch.dtype, K: int, N: int, route: str | None = None) -> str:
    """B8's source for these operands: ``route`` when given
    (W4_FIRST_SOURCE, or W4_SM90_SOURCE where :func:`w4_on_sm90` allows it,
    else ValueError), else the rule's."""
    if route is None:
        return W4_SM90_SOURCE if w4_on_sm90(dtype, K, N) else W4_FIRST_SOURCE
    if route == W4_FIRST_SOURCE or (route == W4_SM90_SOURCE and w4_on_sm90(dtype, K, N)):
        return route
    raise ValueError(f"route {route!r} does not take {dtype} at K {K}, N {N}")


def w4_slices(M: int) -> int:
    """16-row slices of x that one sm90 block owns: enough for M up to 64,
    so decode (M 8) and the spec verify (M 40) take one row tile."""
    return min(4, max(1, -(-M // 16)))


# floats of f32 split partials a SM that the sm90 B8's scratch holds: with
# more than one split the (row tile, column tile) blocks number fewer than
# twice the SMs, a tile spans at most 64 x 64 outputs, and splits < 2 SMs /
# tiles + 1, so splits * M * N < (2 SMs + tiles) * 4096 < 4 * 4096 SMs
W4_PART_FLOATS_PER_SM = 16384


# the most splits of K the sm90 B8 takes: past 8, the splits' partial
# stores and the last block's ordered sum of them cost more than the added
# blocks gain (chip_smoke.py phase 3's sweep; PERF.md, B8)
W4_MAX_SPLITS = 8


def w4_splits(M: int, K: int, N: int, sms: int) -> int:
    """Splits of K for the sm90 B8: 1 where the (row tile, column tile)
    blocks already number twice the SMs, else as many as bring the blocks
    to twice the SMs, at most W4_MAX_SPLITS and one 16-row step of K a
    split. A function of M, K, N and the SM count alone (at M 8 on 132
    SMs: 8 for the 2048 x 2048, 2048 x 256 and 5632 x 2048 weights, 3 for
    2048 x 5632)."""
    tiles = max(1, -(-M // (16 * w4_slices(M))) * (N // W4_TILE_N))
    if tiles >= 2 * sms:
        return 1
    return max(1, min(-(-K // 16), -(-2 * sms // tiles), W4_MAX_SPLITS))


def _w4_plan(M: int, K: int, N: int, dtype: torch.dtype, route: str | None, index: int) -> tuple:
    """(source, slices, splits) of one call's shape; the sm90 kernel's
    splits always fit :func:`_w4_scratch` (W4_PART_FLOATS_PER_SM)."""
    if dtype not in _SUFFIX:
        raise ValueError(f"dtype {dtype}: need one of f32/bf16")
    source = w4_route(dtype, K, N, route)
    if source == W4_FIRST_SOURCE or M == 0:
        return source, 0, 1
    mi, sms = w4_slices(M), _sm_count(index)
    splits = w4_splits(M, K, N, sms)
    tiles = -(-M // (16 * mi)) * (N // W4_TILE_N)
    if splits > 1 and (tiles >= 2 * sms or splits * M * N > W4_PART_FLOATS_PER_SM * sms):
        raise RuntimeError(f"w4_splits {splits} at {(M, K, N)} overflows the sm90 scratch")
    return source, mi, splits


_w4_scratch_bufs: dict = {}


def _w4_scratch(index: int, stream: int) -> tuple:
    """The sm90 B8's scratch for launches on one stream of device ``index``:
    (partials pointer, tickets pointer, partials, tickets). The tickets, one
    int32 a tile (2 x SMs), start at 0 and the last block of a tile puts its
    ticket back; the f32 partials hold W4_PART_FLOATS_PER_SM floats a SM,
    which :func:`w4_splits` never exceeds. So the scratch is made once, at
    the stream's first split launch, outside CUDA-graph capture, and never
    grown or freed: a graph captured on the stream keeps valid pointers
    (replay it in order with that stream's own B8 launches), and launches
    on two streams never share a ticket or a partial."""
    bufs = _w4_scratch_bufs.get((index, stream))
    if bufs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("w4_matmul: call it once on the capturing stream before the capture "
                               "(its scratch is made then)")
        sms, dev = _sm_count(index), torch.device("cuda", index)
        part = torch.empty(W4_PART_FLOATS_PER_SM * sms, dtype=torch.float32, device=dev)
        tickets = torch.zeros(2 * sms, dtype=torch.int32, device=dev)
        bufs = _w4_scratch_bufs.setdefault((index, stream), (part.data_ptr(), tickets.data_ptr(), part, tickets))
    return bufs


_w4_calls: dict = {}


def _w4_call(M: int, K: int, N: int, dtype: torch.dtype, route: str | None, index: int) -> tuple:
    """(source, the launch's arguments after x, q, s and out) of one call's
    shape on the current stream, made once (the serving loop makes the
    same few calls every step)."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    key = (M, K, N, dtype, route, index, stream)
    call = _w4_calls.get(key)
    if call is None:
        source, mi, splits = _w4_plan(M, K, N, dtype, route, index)
        if source == W4_FIRST_SOURCE:
            call = (source, (M, K, N))
        else:
            part, tickets = _w4_scratch(index, stream)[:2] if splits > 1 else (0, 0)
            call = (source, (part, tickets, M, K, N, mi, splits))
        call = _w4_calls.setdefault(key, call)
    return call


def w4_matmul(
    x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, shape, dtype: torch.dtype, *, route: str | None = None
) -> torch.Tensor:
    """``x [M, K] @ dequant(q, s, (K, N))`` in ``dtype`` (f32 or bf16),
    without materializing the weight. ``q`` is one layer's packed stream
    ([K*N/2] uint8) and ``s`` its [ceil(K*N/4096)] fp16 scale bits
    (int16), the :class:`~opendiloco_torch.models.llama.PackedW4` layout.
    On the card it launches :func:`w4_route`'s kernel (``route`` forces
    one), counted as ``w4_matmul_sm90`` or ``w4_matmul``; the sm90 kernel
    splits K as :func:`w4_splits` says. A shape :func:`w4_matmul_supported`
    refuses raises."""
    if not _on_card(x, q, s):
        return w4_matmul_plain(x, q, s, shape, dtype)
    if not w4_matmul_supported(shape):
        raise ValueError(f"w4_matmul cannot take weight shape {tuple(shape)}")
    K, N = (int(d) for d in shape)
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match weight {shape}")
    if q.dtype != torch.uint8 or q.numel() != K * N // 2 or not q.is_contiguous():
        raise ValueError(f"q must be contiguous uint8 [{K * N // 2}]")
    nb = (K * N + W4_BLOCK - 1) // W4_BLOCK
    if s.dtype != torch.int16 or s.numel() != nb or not s.is_contiguous():
        raise ValueError(f"s must be contiguous int16 [{nb}]")
    M, dev = x.shape[0], x.device
    source, tail = _w4_call(M, K, N, dtype, route, dev.index)
    out = torch.empty((M, N), dtype=dtype, device=dev)
    if M:
        x2 = x if x.dtype == dtype and x.is_contiguous() else x.to(dtype).contiguous()
        _launch(source, dtype, dev, x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), *tail)
    return out
