"""Host kernels of the outer loop: the wire codecs (fp16, scaled fp16, 8-
and 4-bit blockwise, uniform 8-bit, the quantile codebook), the
butterfly's add and scale, and the bulk plane's socket pump.

The port's copy of ``opendiloco_tpu/native``: ``csrc/odtp_host.cpp`` (a
copy of the JAX package's ``native/odtp_kernels.cpp``, its codecs,
add/scale and socket pump) is built at first use with the system ``g++``
and the JAX package's Makefile flags into ``csrc/build/`` and bound here
with ctypes. So an encode gives the bytes the JAX package gives on its
native path and a decode its bits, and a galaxy of JAX and port workers
adopts one decoded value of every part. A library that does not build
raises; nothing falls back quietly.

Each function keeps its numpy body, expression for expression the JAX
package's fallback, as its plain version. It runs only where ``_plain``
is set (the tests set it to hold the bodies against the JAX fallback),
or where the reference's wrapper takes it for its argument (a
destination that is not contiguous float32). The codecs
(:mod:`opendiloco_torch.diloco.compression`), the TCP backend and the
bulk plane call these.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SOURCE = os.path.join(_CSRC, "odtp_host.cpp")
_BUILD_DIR = os.path.join(_CSRC, "build")
# native/Makefile's SOFLAGS
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17", "-Wall") + (
    ("-mf16c", "-mavx2") if platform.machine() == "x86_64" else ()
)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_plain = False  # the numpy bodies in place of the library (a test seam)


def _library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libodtp_host-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's host kernels (csrc/odtp_host.cpp) build with the system g++")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SOURCE], capture_output=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed for {_SOURCE} (exit {proc.returncode}):\n" + proc.stderr.decode(errors="replace")
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32 = ctypes.c_float
    st = ctypes.c_size_t
    lib.odtp_add_f32.argtypes = [f32p, f32p, st]
    lib.odtp_scale_f32.argtypes = [f32p, f32, st]
    lib.odtp_f32_to_f16.argtypes = [f32p, u16p, st]
    lib.odtp_f16_to_f32.argtypes = [u16p, f32p, st]
    lib.odtp_f16_accumulate_f32.argtypes = [u16p, f32p, st]
    lib.odtp_absmax_f32.argtypes = [f32p, st]
    lib.odtp_absmax_f32.restype = f32
    lib.odtp_f32_to_f16_scaled.argtypes = [f32p, f32, u16p, st]
    lib.odtp_f16_to_f32_scaled.argtypes = [u16p, f32, f32p, st]
    lib.odtp_f16_accumulate_scaled_f32.argtypes = [u16p, f32, f32p, st]
    lib.odtp_quantize_blockwise_i8.argtypes = [f32p, i8p, f32p, st, st]
    lib.odtp_dequantize_blockwise_i8.argtypes = [i8p, f32p, f32p, st, st]
    lib.odtp_dequantize_blockwise_i8_accumulate.argtypes = [i8p, f32p, f32p, st, st]
    lib.odtp_quantize_blockwise4.argtypes = [f32p, u8p, u16p, st, st]
    lib.odtp_dequantize_blockwise4.argtypes = [u8p, u16p, f32p, st, st]
    lib.odtp_dequantize_blockwise4_accumulate.argtypes = [u8p, u16p, f32p, st, st]
    lib.odtp_quantize_uniform8.argtypes = [f32p, u8p, st, f32p, f32p]
    lib.odtp_minmax_f32.argtypes = [f32p, st, f32p, f32p]
    lib.odtp_quantize_uniform8_given.argtypes = [f32p, u8p, st, f32, f32]
    lib.odtp_dequantize_uniform8.argtypes = [u8p, f32, f32, f32p, st]
    lib.odtp_dequantize_uniform8_accumulate.argtypes = [u8p, f32, f32, f32p, st]
    lib.odtp_lut256_gather.argtypes = [u8p, f32p, f32p, st]
    lib.odtp_lut256_accumulate.argtypes = [u8p, f32p, f32p, st]
    lib.odtp_quantile_assign.argtypes = [f32p, f32p, u8p, st]
    lib.odtp_quantile_edges.argtypes = [f32p, st, f32p]
    for fn in (lib.odtp_sendall, lib.odtp_recvall):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, st]
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The loaded host library, built first if needed. Raises when it
    does not build or load."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            out = _library_path()
            if not os.path.exists(out):
                _build(out)
            _lib = _bind(ctypes.CDLL(out))
    return _lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The host library, or None where ``_plain`` is set."""
    return None if _plain else load()


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def _i8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check_out(out: np.ndarray, n: int) -> None:
    """Decode destinations must be 1-D contiguous float32 of exactly n
    elements: the C kernels write n floats through a raw pointer, and the
    plain bodies' reshape(-1) of a strided view would copy and drop the
    result."""
    if out.dtype != np.float32 or out.ndim != 1 or not out.flags.c_contiguous:
        raise ValueError(
            "out must be a contiguous 1-D float32 array, got "
            f"dtype={out.dtype} ndim={out.ndim} contiguous={out.flags.c_contiguous}"
        )
    if out.size != n:
        raise ValueError(f"out holds {out.size} elements, need exactly {n}")


def _check_len(have: int, need: int, what: str) -> None:
    """The C kernels read exactly `need` elements: a short payload (a
    truncated transfer) fails loudly."""
    if have < need:
        raise ValueError(f"{what}: payload holds {have} elements, need {need}")


def add_inplace(dst: np.ndarray, src: np.ndarray) -> None:
    """dst += src over float32 buffers."""
    lib = get_lib()
    if lib is None or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        np.add(dst, src, out=dst)
        return
    src = np.ascontiguousarray(src, np.float32)
    lib.odtp_add_f32(_f32p(dst), _f32p(src), dst.size)


def scale_inplace(dst: np.ndarray, s: float) -> None:
    """dst *= s (the butterfly's mean)."""
    lib = get_lib()
    if lib is None or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        np.multiply(dst, s, out=dst)
        return
    lib.odtp_scale_f32(_f32p(dst), ctypes.c_float(s), dst.size)


def sqnorm(a: np.ndarray) -> float:
    """sum(a * a) in f64 (the pseudo_grad_norm and ef_residual_norm
    gauges' per-leaf term), a bounded slice at a time."""
    flat = np.ascontiguousarray(a, np.float32).reshape(-1)
    sq = 0.0
    for i in range(0, flat.size, 1 << 22):
        v = flat[i:i + (1 << 22)].astype(np.float64)
        sq += float(np.dot(v, v))
    return sq


# -- fp16 --------------------------------------------------------------------


def f32_to_f16_bytes(a: np.ndarray) -> bytes:
    lib = get_lib()
    a = np.ascontiguousarray(a, np.float32)
    if lib is None:
        return a.astype(np.float16).tobytes()
    out = np.empty(a.size, np.uint16)
    lib.odtp_f32_to_f16(_f32p(a.reshape(-1)), _u16p(out), a.size)
    return out.tobytes()


def f16_bytes_to_f32(payload: bytes, n: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    lib = get_lib()
    src = np.frombuffer(payload, np.uint16)
    _check_len(src.size, n, "f16_bytes_to_f32")
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    if lib is None:
        out[:] = np.frombuffer(payload, np.float16)[:n]
        return out
    lib.odtp_f16_to_f32(_u16p(src), _f32p(out), n)
    return out


def f16_accumulate(payload: bytes, dst: np.ndarray) -> None:
    """dst += decode_f16(payload)."""
    lib = get_lib()
    _check_len(len(payload) // 2, dst.size, "f16_accumulate")
    if lib is None or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        dst += np.frombuffer(payload, np.float16).astype(np.float32).reshape(dst.shape)
        return
    src = np.frombuffer(payload, np.uint16)
    lib.odtp_f16_accumulate_f32(_u16p(src), _f32p(dst), dst.size)


# -- scaled fp16 -------------------------------------------------------------


def absmax(a: np.ndarray) -> float:
    lib = get_lib()
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    if lib is None:
        return float(np.max(np.abs(a))) if a.size else 0.0
    return float(lib.odtp_absmax_f32(_f32p(a), a.size))


def f32_to_f16_scaled_bytes(a: np.ndarray, scale: float) -> bytes:
    """f16(a / scale)."""
    lib = get_lib()
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    if lib is None:
        return (a / np.float32(scale)).astype(np.float16).tobytes()
    out = np.empty(a.size, np.uint16)
    lib.odtp_f32_to_f16_scaled(_f32p(a), ctypes.c_float(scale), _u16p(out), a.size)
    return out.tobytes()


def f16_bytes_to_f32_scaled(
    payload: bytes, scale: float, n: int, out: Optional[np.ndarray] = None
) -> np.ndarray:
    """decode_f16(payload) * scale."""
    lib = get_lib()
    src = np.frombuffer(payload, np.uint16)
    _check_len(src.size, n, "f16_bytes_to_f32_scaled")
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    if lib is None:
        np.multiply(np.frombuffer(payload, np.float16)[:n].astype(np.float32), np.float32(scale), out=out)
        return out
    lib.odtp_f16_to_f32_scaled(_u16p(src), ctypes.c_float(scale), _f32p(out), n)
    return out


def f16_accumulate_scaled(payload: bytes, scale: float, dst: np.ndarray) -> None:
    """dst += decode_f16(payload) * scale."""
    lib = get_lib()
    _check_len(len(payload) // 2, dst.size, "f16_accumulate_scaled")
    if lib is None or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        dst += (
            np.frombuffer(payload, np.float16)[: dst.size].astype(np.float32).reshape(dst.shape)
            * np.float32(scale)
        )
        return
    src = np.frombuffer(payload, np.uint16)
    lib.odtp_f16_accumulate_scaled_f32(_u16p(src), ctypes.c_float(scale), _f32p(dst), dst.size)


# -- 8-bit blockwise -----------------------------------------------------------


def quantize_blockwise(a: np.ndarray, block: int) -> tuple[bytes, bytes]:
    """-> (int8 payload, float32 scales payload): per-block absmax, q =
    clip(round(x / s * 127), -127, 127)."""
    lib = get_lib()
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    nblocks = (a.size + block - 1) // block
    if lib is None:
        pad = (-a.size) % block
        padded = np.pad(a, (0, pad)).reshape(-1, block)
        scales = np.max(np.abs(padded), axis=1)
        scales[scales == 0] = 1.0
        q = np.clip(np.round(padded / scales[:, None] * 127.0), -127, 127).astype(np.int8)
        return q.reshape(-1)[: a.size].tobytes(), scales.astype(np.float32).tobytes()
    q = np.empty(a.size, np.int8)
    scales = np.empty(nblocks, np.float32)
    lib.odtp_quantize_blockwise_i8(_f32p(a), _i8p(q), _f32p(scales), a.size, block)
    return q.tobytes(), scales.tobytes()


def dequantize_blockwise(
    payload: bytes, scales_payload: bytes, n: int, block: int, out: Optional[np.ndarray] = None
) -> np.ndarray:
    lib = get_lib()
    q = np.frombuffer(payload, np.int8)
    scales = np.frombuffer(scales_payload, np.float32)
    _check_len(q.size, n, "dequantize_blockwise")
    _check_len(scales.size, (n + block - 1) // block, "dequantize_blockwise scales")
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    if lib is None:
        pad = (-n) % block
        qp = np.pad(q[:n].astype(np.float32), (0, pad)).reshape(-1, block)
        dec = qp * (scales[: qp.shape[0], None] / 127.0)
        out[:] = dec.reshape(-1)[:n]
        return out
    lib.odtp_dequantize_blockwise_i8(_i8p(q), _f32p(scales), _f32p(out), n, block)
    return out


def dequant8_accumulate(payload: bytes, scales_payload: bytes, dst: np.ndarray, block: int) -> None:
    """dst += dequantize_blockwise(payload)."""
    lib = get_lib()
    _check_len(len(payload), dst.size, "dequant8_accumulate")
    _check_len(len(scales_payload) // 4, (dst.size + block - 1) // block, "dequant8_accumulate scales")
    if lib is None or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        dst += dequantize_blockwise(payload, scales_payload, dst.size, block).reshape(dst.shape)
        return
    q = np.frombuffer(payload, np.int8)
    scales = np.frombuffer(scales_payload, np.float32)
    lib.odtp_dequantize_blockwise_i8_accumulate(_i8p(q), _f32p(scales), _f32p(dst), dst.size, block)


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
    lib = get_lib()
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    nblocks = (a.size + block - 1) // block
    if lib is None:
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
    packed = np.empty((a.size + 1) // 2, np.uint8)
    scales = np.empty(nblocks, np.uint16)
    lib.odtp_quantize_blockwise4(_f32p(a), _u8p(packed), _u16p(scales), a.size, block)
    return packed.tobytes(), scales.tobytes()


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
    lib = get_lib()
    packed = np.frombuffer(payload, np.uint8)
    scales = np.frombuffer(scales_payload, np.uint16)
    _check_len(packed.size, (n + 1) // 2, "dequantize_blockwise4")
    _check_len(scales.size, (n + block - 1) // block, "dequantize_blockwise4 scales")
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    if lib is None:
        out[:] = _dequant4(packed, scales, n, block)
        return out
    lib.odtp_dequantize_blockwise4(_u8p(packed), _u16p(scales), _f32p(out), n, block)
    return out


def dequant4_accumulate(payload: bytes, scales_payload: bytes, dst: np.ndarray, block: int) -> None:
    """dst += dequantize_blockwise4(payload)."""
    lib = get_lib()
    packed = np.frombuffer(payload, np.uint8)
    scales = np.frombuffer(scales_payload, np.uint16)
    _check_len(packed.size, (dst.size + 1) // 2, "dequant4_accumulate")
    _check_len(scales.size, (dst.size + block - 1) // block, "dequant4_accumulate scales")
    if lib is None or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        dst += _dequant4(packed, scales, dst.size, block).reshape(dst.shape)
        return
    lib.odtp_dequantize_blockwise4_accumulate(_u8p(packed), _u16p(scales), _f32p(dst), dst.size, block)


# -- uniform 8-bit -------------------------------------------------------------


def quantize_uniform8(a: np.ndarray) -> tuple[bytes, float, float]:
    """Linear lo/span uint8 quantization -> (payload, lo, span). The
    library returns span as the f32 difference hi - lo, the plain body as
    the double one (the JAX package's two paths do the same)."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    lib = get_lib()
    if lib is None:
        lo, span = minmax_span(a)
        return quantize_uniform8_given(a, lo, span), lo, span
    q = np.empty(a.size, np.uint8)
    lo_out = np.empty(1, np.float32)
    span_out = np.empty(1, np.float32)
    lib.odtp_quantize_uniform8(_f32p(a), _u8p(q), a.size, _f32p(lo_out), _f32p(span_out))
    return q.tobytes(), float(lo_out[0]), float(span_out[0])


def minmax_span(a: np.ndarray) -> tuple[float, float]:
    """(lo, span) over ``a`` with the reduction, precision and zero-span
    fix-up of :func:`quantize_uniform8` on the same path, so a chunked
    encode fed by it equals the whole-tensor encode bit for bit."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    lib = get_lib()
    if lib is None:
        lo = float(a.min()) if a.size else 0.0
        hi = float(a.max()) if a.size else 0.0
        span = (hi - lo) or 1.0
        return lo, span
    lo_out = np.empty(1, np.float32)
    hi_out = np.empty(1, np.float32)
    lib.odtp_minmax_f32(_f32p(a), a.size, _f32p(lo_out), _f32p(hi_out))
    span = np.float32(hi_out[0]) - np.float32(lo_out[0])
    if not (span > 0):
        span = np.float32(1.0)
    return float(lo_out[0]), float(span)


def quantize_uniform8_given(a: np.ndarray, lo: float, span: float) -> bytes:
    """q = clip(round((x - lo) * (255 / span)), 0, 255), in f32 and in
    that order."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1)
    lib = get_lib()
    if lib is None:
        inv = np.float32(255.0) / np.float32(span)
        return np.clip(np.round((a - np.float32(lo)) * inv), 0, 255).astype(np.uint8).tobytes()
    q = np.empty(a.size, np.uint8)
    lib.odtp_quantize_uniform8_given(_f32p(a), _u8p(q), a.size, ctypes.c_float(lo), ctypes.c_float(span))
    return q.tobytes()


def dequantize_uniform8(
    payload: bytes, lo: float, span: float, n: int, out: Optional[np.ndarray] = None
) -> np.ndarray:
    q = np.frombuffer(payload, np.uint8)
    _check_len(q.size, n, "dequantize_uniform8")
    lib = get_lib()
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    if lib is None:
        np.multiply(q[:n].astype(np.float32), span / 255.0, out=out)
        out += lo
        return out
    lib.odtp_dequantize_uniform8(_u8p(q), ctypes.c_float(lo), ctypes.c_float(span), _f32p(out), n)
    return out


def dequant_uniform8_accumulate(payload: bytes, lo: float, span: float, dst: np.ndarray) -> None:
    """dst += uniform8_decode(payload)."""
    lib = get_lib()
    _check_len(len(payload), dst.size, "dequant_uniform8_accumulate")
    if lib is None or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        q = np.frombuffer(payload, np.uint8)
        dst += (q.astype(np.float32) * (span / 255.0) + lo).reshape(dst.shape)
        return
    lib.odtp_dequantize_uniform8_accumulate(
        _u8p(np.frombuffer(payload, np.uint8)), ctypes.c_float(lo), ctypes.c_float(span), _f32p(dst), dst.size
    )


# -- quantile codebook ---------------------------------------------------------


def lut256_gather(idx_payload: bytes, lut: np.ndarray, n: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """out = lut[idx]."""
    idx = np.frombuffer(idx_payload, np.uint8)
    _check_len(idx.size, n, "lut256_gather")
    lut = np.ascontiguousarray(lut, np.float32)
    _check_len(lut.size, 256, "lut256_gather codebook")
    lib = get_lib()
    if out is None:
        out = np.empty(n, np.float32)
    else:
        _check_out(out, n)
    if lib is None:
        np.take(lut, idx[:n], out=out)
        return out
    lib.odtp_lut256_gather(_u8p(idx), _f32p(lut), _f32p(out), n)
    return out


def lut256_accumulate(idx_payload: bytes, lut: np.ndarray, dst: np.ndarray) -> None:
    """dst += lut[idx]."""
    idx = np.frombuffer(idx_payload, np.uint8)
    _check_len(idx.size, dst.size, "lut256_accumulate")
    lut = np.ascontiguousarray(lut, np.float32)
    _check_len(lut.size, 256, "lut256_accumulate codebook")
    lib = get_lib()
    if lib is None or dst.dtype != np.float32 or not dst.flags.c_contiguous:
        dst += lut[idx].reshape(dst.shape)
        return
    lib.odtp_lut256_accumulate(_u8p(idx), _f32p(lut), _f32p(dst), dst.size)


def quantile_assign(flat: np.ndarray, inner_edges: np.ndarray) -> np.ndarray:
    """Bucket of each value among the 256 split by 255 sorted inner edges
    (searchsorted side='right')."""
    lib = get_lib()
    flat = np.ascontiguousarray(flat, np.float32)
    inner_edges = np.ascontiguousarray(inner_edges, np.float32)
    if lib is None:
        return np.clip(np.searchsorted(inner_edges, flat, side="right"), 0, 255).astype(np.uint8)
    out = np.empty(flat.size, np.uint8)
    lib.odtp_quantile_assign(_f32p(flat), _f32p(inner_edges), _u8p(out), flat.size)
    return out


def quantile_edges(flat: np.ndarray) -> np.ndarray:
    """257 quantile edges, float32, of a strided sample of at most 100k
    values of ``flat``. The library interpolates in double, the plain body
    through ``np.quantile`` (the JAX package's two paths do the same)."""
    lib = get_lib()
    flat = np.ascontiguousarray(flat, np.float32).reshape(-1)
    if lib is None:
        cap = 100_000
        if flat.size <= cap:
            sample = flat
        else:
            stride = flat.size / cap
            sample = flat[(np.arange(cap) * stride).astype(np.int64)]
        return np.quantile(sample, np.linspace(0, 1, 257)).astype(np.float32)
    out = np.empty(257, np.float32)
    lib.odtp_quantile_edges(_f32p(flat), flat.size, _f32p(out))
    return out


# -- socket pump (the bulk plane) ----------------------------------------------


def sock_sendall(sock, buf) -> None:
    """Send a whole contiguous buffer on a connected socket; the library
    pumps the bytes with the GIL released."""
    lib = get_lib()
    if lib is None:
        sock.sendall(buf if isinstance(buf, (bytes, memoryview)) else memoryview(buf))
        return
    a = np.frombuffer(buf, np.uint8)  # zero-copy view, works read-only
    rc = lib.odtp_sendall(sock.fileno(), ctypes.c_void_p(a.ctypes.data), a.size)
    if rc != 0:
        raise OSError(-rc, f"odtp_sendall failed (rc={rc})")


def sock_recvall(sock, buf: np.ndarray) -> None:
    """Receive exactly len(buf) bytes into a writable contiguous buffer."""
    lib = get_lib()
    if lib is None:
        view = memoryview(buf).cast("B")
        got = 0
        while got < len(view):
            r = sock.recv_into(view[got:])
            if r == 0:
                raise ConnectionResetError("peer closed mid-transfer")
            got += r
        return
    a = np.frombuffer(buf, np.uint8)
    rc = lib.odtp_recvall(sock.fileno(), ctypes.c_void_p(a.ctypes.data), a.size)
    if rc == -1:
        raise ConnectionResetError("peer closed mid-transfer")
    if rc != 0:
        raise OSError(-rc, f"odtp_recvall failed (rc={rc})")
