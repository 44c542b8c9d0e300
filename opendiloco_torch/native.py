"""Host bodies of the wire codecs: fp16, scaled fp16, 8- and 4-bit
blockwise, uniform 8-bit and the quantile codebook, in numpy.

The port's copy of the numpy versions in ``opendiloco_tpu/native``
(its fallback when ``libodtp.so`` is not loaded), function for function
and expression for expression, so an encode here gives the bytes the JAX
package's fallback gives and a decode its bits. The port loads no native
library: every body below is the numpy one. Its codecs
(:mod:`opendiloco_torch.diloco.compression`) call these.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _check_out(out: np.ndarray, n: int) -> None:
    """Decode destinations must be 1-D contiguous float32 of exactly n
    elements (a reshape of a strided view would copy and drop the result)."""
    if out.dtype != np.float32 or out.ndim != 1 or not out.flags.c_contiguous:
        raise ValueError(
            "out must be a contiguous 1-D float32 array, got "
            f"dtype={out.dtype} ndim={out.ndim} contiguous={out.flags.c_contiguous}"
        )
    if out.size != n:
        raise ValueError(f"out holds {out.size} elements, need exactly {n}")


def _check_len(have: int, need: int, what: str) -> None:
    """A short payload (a truncated transfer) fails loudly."""
    if have < need:
        raise ValueError(f"{what}: payload holds {have} elements, need {need}")


def add_inplace(dst: np.ndarray, src: np.ndarray) -> None:
    """dst += src over float32 buffers."""
    np.add(dst, src, out=dst)


# -- fp16 --------------------------------------------------------------------


def f32_to_f16_bytes(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a, np.float32).astype(np.float16).tobytes()


def f16_bytes_to_f32(payload: bytes, n: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    _check_len(len(payload) // 2, n, "f16_bytes_to_f32")
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    out[:] = np.frombuffer(payload, np.float16)[:n]
    return out


def f16_accumulate(payload: bytes, dst: np.ndarray) -> None:
    """dst += decode_f16(payload)."""
    _check_len(len(payload) // 2, dst.size, "f16_accumulate")
    dst += np.frombuffer(payload, np.float16).astype(np.float32).reshape(dst.shape)


# -- scaled fp16 -------------------------------------------------------------


def absmax(a: np.ndarray) -> float:
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    return float(np.max(np.abs(a))) if a.size else 0.0


def f32_to_f16_scaled_bytes(a: np.ndarray, scale: float) -> bytes:
    """f16(a / scale)."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    return (a / np.float32(scale)).astype(np.float16).tobytes()


def f16_bytes_to_f32_scaled(
    payload: bytes, scale: float, n: int, out: Optional[np.ndarray] = None
) -> np.ndarray:
    """decode_f16(payload) * scale."""
    _check_len(len(payload) // 2, n, "f16_bytes_to_f32_scaled")
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    np.multiply(np.frombuffer(payload, np.float16)[:n].astype(np.float32), np.float32(scale), out=out)
    return out


def f16_accumulate_scaled(payload: bytes, scale: float, dst: np.ndarray) -> None:
    """dst += decode_f16(payload) * scale."""
    _check_len(len(payload) // 2, dst.size, "f16_accumulate_scaled")
    dst += (
        np.frombuffer(payload, np.float16)[: dst.size].astype(np.float32).reshape(dst.shape)
        * np.float32(scale)
    )


# -- 8-bit blockwise -----------------------------------------------------------


def quantize_blockwise(a: np.ndarray, block: int) -> tuple[bytes, bytes]:
    """-> (int8 payload, float32 scales payload): per-block absmax, q =
    clip(round(x / s * 127), -127, 127)."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    pad = (-a.size) % block
    padded = np.pad(a, (0, pad)).reshape(-1, block)
    scales = np.max(np.abs(padded), axis=1)
    scales[scales == 0] = 1.0
    q = np.clip(np.round(padded / scales[:, None] * 127.0), -127, 127).astype(np.int8)
    return q.reshape(-1)[: a.size].tobytes(), scales.astype(np.float32).tobytes()


def dequantize_blockwise(
    payload: bytes, scales_payload: bytes, n: int, block: int, out: Optional[np.ndarray] = None
) -> np.ndarray:
    q = np.frombuffer(payload, np.int8)
    scales = np.frombuffer(scales_payload, np.float32)
    _check_len(q.size, n, "dequantize_blockwise")
    _check_len(scales.size, (n + block - 1) // block, "dequantize_blockwise scales")
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    pad = (-n) % block
    qp = np.pad(q[:n].astype(np.float32), (0, pad)).reshape(-1, block)
    dec = qp * (scales[: qp.shape[0], None] / 127.0)
    out[:] = dec.reshape(-1)[:n]
    return out


def dequant8_accumulate(payload: bytes, scales_payload: bytes, dst: np.ndarray, block: int) -> None:
    """dst += dequantize_blockwise(payload)."""
    _check_len(len(payload), dst.size, "dequant8_accumulate")
    _check_len(len(scales_payload) // 4, (dst.size + block - 1) // block, "dequant8_accumulate scales")
    dst += dequantize_blockwise(payload, scales_payload, dst.size, block).reshape(dst.shape)


# -- 4-bit blockwise -----------------------------------------------------------


def quantize_blockwise4(a: np.ndarray, block: int) -> tuple[bytes, bytes]:
    """-> (packed nibbles, fp16 scales as u16 bytes). Element 2i is the
    low nibble of byte i, element 2i+1 the high one; an odd tail leaves
    the last high nibble 0 (not quantized zero, which is 8). The scale is
    the block's absmax (1 for an all-zero block) clamped into the fp16
    normal range and rounded to fp16, and q = clip(round(x * (7 / s16)),
    -7, 7) + 8 against that rounded scale."""
    if block % 2:
        raise ValueError(f"block must be even for nibble packing, got {block}")
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    nblocks = (a.size + block - 1) // block
    pad = (-a.size) % block
    padded = np.pad(a, (0, pad)).reshape(-1, block)
    amax = np.max(np.abs(padded), axis=1) if nblocks else np.zeros(0, np.float32)
    s = np.where(amax > 0, amax, np.float32(1.0)).astype(np.float32)
    np.clip(s, np.float32(6.1035156e-05), np.float32(65504.0), out=s)
    s16 = s.astype(np.float16)
    inv = np.float32(7.0) / s16.astype(np.float32)
    q = np.clip(np.round(padded * inv[:, None]), -7, 7)
    nib = (q.reshape(-1)[: a.size] + 8).astype(np.uint8)
    if a.size % 2:
        nib = np.append(nib, np.uint8(0))
    packed = nib[0::2] | (nib[1::2] << 4)
    return packed.tobytes(), s16.view(np.uint16).tobytes()


def _dequant4(packed: np.ndarray, scales: np.ndarray, n: int, block: int) -> np.ndarray:
    nib = np.empty(2 * packed.size, np.uint8)
    nib[0::2] = packed & 0x0F
    nib[1::2] = packed >> 4
    q = nib[:n].astype(np.float32) - np.float32(8.0)
    s = scales[: (n + block - 1) // block].view(np.float16).astype(np.float32) / np.float32(7.0)
    qp = np.pad(q, (0, (-n) % block)).reshape(-1, block)
    return (qp * s[:, None]).reshape(-1)[:n]


def dequantize_blockwise4(
    payload: bytes, scales_payload: bytes, n: int, block: int, out: Optional[np.ndarray] = None
) -> np.ndarray:
    if block % 2:
        raise ValueError(f"block must be even for nibble packing, got {block}")
    packed = np.frombuffer(payload, np.uint8)
    scales = np.frombuffer(scales_payload, np.uint16)
    _check_len(packed.size, (n + 1) // 2, "dequantize_blockwise4")
    _check_len(scales.size, (n + block - 1) // block, "dequantize_blockwise4 scales")
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    out[:] = _dequant4(packed, scales, n, block)
    return out


def dequant4_accumulate(payload: bytes, scales_payload: bytes, dst: np.ndarray, block: int) -> None:
    """dst += dequantize_blockwise4(payload)."""
    packed = np.frombuffer(payload, np.uint8)
    scales = np.frombuffer(scales_payload, np.uint16)
    _check_len(packed.size, (dst.size + 1) // 2, "dequant4_accumulate")
    _check_len(scales.size, (dst.size + block - 1) // block, "dequant4_accumulate scales")
    dst += _dequant4(packed, scales, dst.size, block).reshape(dst.shape)


# -- uniform 8-bit -------------------------------------------------------------


def minmax_span(a: np.ndarray) -> tuple[float, float]:
    """(lo, span) over ``a``; a zero span becomes 1."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    lo = float(a.min()) if a.size else 0.0
    hi = float(a.max()) if a.size else 0.0
    span = (hi - lo) or 1.0
    return lo, span


def quantize_uniform8_given(a: np.ndarray, lo: float, span: float) -> bytes:
    """q = clip(round((x - lo) * (255 / span)), 0, 255), in f32 and in
    that order."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    inv = np.float32(255.0) / np.float32(span)
    return np.clip(np.round((a - np.float32(lo)) * inv), 0, 255).astype(np.uint8).tobytes()


def quantize_uniform8(a: np.ndarray) -> tuple[bytes, float, float]:
    """Linear lo/span uint8 quantization -> (payload, lo, span)."""
    lo, span = minmax_span(a)
    return quantize_uniform8_given(a, lo, span), lo, span


def dequantize_uniform8(
    payload: bytes, lo: float, span: float, n: int, out: Optional[np.ndarray] = None
) -> np.ndarray:
    q = np.frombuffer(payload, np.uint8)
    _check_len(q.size, n, "dequantize_uniform8")
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    np.multiply(q[:n].astype(np.float32), span / 255.0, out=out)
    out += lo
    return out


def dequant_uniform8_accumulate(payload: bytes, lo: float, span: float, dst: np.ndarray) -> None:
    """dst += uniform8_decode(payload)."""
    _check_len(len(payload), dst.size, "dequant_uniform8_accumulate")
    q = np.frombuffer(payload, np.uint8)
    dst += (q.astype(np.float32) * (span / 255.0) + lo).reshape(dst.shape)


# -- quantile codebook ---------------------------------------------------------


def lut256_gather(idx_payload: bytes, lut: np.ndarray, n: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """out = lut[idx]."""
    idx = np.frombuffer(idx_payload, np.uint8)
    _check_len(idx.size, n, "lut256_gather")
    lut = np.ascontiguousarray(lut, np.float32)
    _check_len(lut.size, 256, "lut256_gather codebook")
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    np.take(lut, idx[:n], out=out)
    return out


def lut256_accumulate(idx_payload: bytes, lut: np.ndarray, dst: np.ndarray) -> None:
    """dst += lut[idx]."""
    idx = np.frombuffer(idx_payload, np.uint8)
    _check_len(idx.size, dst.size, "lut256_accumulate")
    lut = np.ascontiguousarray(lut, np.float32)
    _check_len(lut.size, 256, "lut256_accumulate codebook")
    dst += lut[idx].reshape(dst.shape)


def quantile_assign(flat: np.ndarray, inner_edges: np.ndarray) -> np.ndarray:
    """Bucket of each value among the 256 split by 255 sorted inner edges
    (searchsorted side='right')."""
    flat = np.ascontiguousarray(flat, np.float32)
    inner_edges = np.ascontiguousarray(inner_edges, np.float32)
    return np.clip(np.searchsorted(inner_edges, flat, side="right"), 0, 255).astype(np.uint8)


def quantile_edges(flat: np.ndarray) -> np.ndarray:
    """257 quantile edges, float32, of a strided sample of at most 100k
    values of ``flat``."""
    flat = np.ascontiguousarray(flat, np.float32).reshape(-1)
    cap = 100_000
    if flat.size <= cap:
        sample = flat
    else:
        stride = flat.size / cap
        sample = flat[(np.arange(cap) * stride).astype(np.int64)]
    return np.quantile(sample, np.linspace(0, 1, 257)).astype(np.float32)
