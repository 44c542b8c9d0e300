"""Wire codecs: none, fp16, scaled-fp16, uniform8bit, quantile8bit,
blockwise8bit, blockwise4bit and topk.

The port's copy of ``opendiloco_tpu/diloco/compression.py``, codec for
codec, over the numpy bodies of :mod:`opendiloco_torch.native`: an
encode gives the JAX package's payload and meta byte for byte, and a
decode its bits, so a payload made by either package decodes in the
other.

- ``meta`` is JSON-serializable; binary side data (block scales, the
  quantile codebook) leads the payload.
- ``decode_accumulate`` adds a decode into a buffer in one call, and
  ``decode_into`` writes it into one.
- Chunked encode (``chunk_state`` + ``encode_chunk``) splits a part into
  chunk payloads that decode independently. Tensor-wide state
  (scaled-fp16's abs-max, uniform8bit's lo/span, quantile8bit's codebook,
  topk's selection) is computed once over the whole part by
  ``chunk_state``, so the concatenated chunk decodes equal the
  whole-tensor decode bit for bit.

The 4-bit packing of served weights is :mod:`opendiloco_torch.quant`'s
(in torch, on the card); :func:`split_blockwise4_stacked` re-slices a
``blockwise4bit`` payload into that layout.
"""

from __future__ import annotations

import os

import numpy as np

from opendiloco_torch import native

_BLOCK = 4096
_TOPK_DENSITY_ENV = "ODTP_TOPK_DENSITY"
_TOPK_DEFAULT_DENSITY = 0.03125  # 1/32 kept -> 0.25 B/elem on the wire


def chunk_bounds(n: int, chunk_elems: int, align: int = 1) -> list[int]:
    """Element offsets splitting an n-element part into pipeline chunks.

    Returns ``[0, c1, ..., n]``; always at least one chunk (an empty part
    yields a single empty chunk so the receiver's chunk loop still runs).
    ``align`` rounds the chunk size down to a codec's block granularity
    (blockwise8bit) so chunk payloads stay bit-identical to the whole-tensor
    encode."""
    ce = max(1, int(chunk_elems))
    if align > 1:
        ce = max(align, ce - (ce % align))
    if n <= 0:
        return [0, 0]
    return list(range(0, n, ce)) + [n]


class Codec:
    name: str = "none"
    # chunk offsets must be multiples of this many elements (blockwise8bit)
    chunk_align: int = 1
    # bulk stripe boundaries round to this many BYTES so a stripe never
    # splits one encoded wire record (f32 element here; fp16 = 2, u8 = 1,
    # topk's u32/f32 records = 4; packed nibbles are byte-granular already)
    wire_align_bytes: int = 4

    def chunk_state(self, arr: np.ndarray) -> dict:
        """Tensor-global encode state, computed once per part before the
        per-chunk ``encode_chunk`` calls. Stateless codecs return {}."""
        return {}

    def encode_chunk(self, arr: np.ndarray, state: dict) -> tuple[bytes, dict]:
        """Encode one contiguous slice of a part using the shared ``state``.

        The returned (payload, meta) must decode through the whole-tensor
        ``decode_accumulate`` / ``decode_into`` on the matching destination
        slice, and the concatenation of chunk decodes must be bit-identical
        to decoding one whole-tensor encode."""
        return self.encode(arr)

    def encode(self, arr: np.ndarray) -> tuple[bytes, dict]:
        # zero-copy when already contiguous f32: a memoryview over the array
        # buffer goes straight to the socket (the array outlives the send)
        return memoryview(np.ascontiguousarray(arr, np.float32)).cast("B"), {}

    def decode(self, payload: bytes, shape: tuple[int, ...], meta: dict) -> np.ndarray:
        # read-only view over the received payload -- every consumer either
        # reduces it into an accumulator or copies it during reassembly
        return np.frombuffer(payload, dtype=np.float32).reshape(shape)

    def decode_accumulate(
        self, payload: bytes, meta: dict, dst: np.ndarray
    ) -> None:
        """dst += decode(payload); dst is float32, shape defines layout.

        The base routes through ``self.decode``; subclasses add their
        decode straight into ``dst``."""
        native.add_inplace(dst, self.decode(payload, dst.shape, meta))

    def decode_into(self, payload: bytes, meta: dict, dst: np.ndarray) -> None:
        """dst[:] = decode(payload); dst is a contiguous float32 1-D view.

        A gathered part decodes straight into its slice of the output
        buffer. The base routes through ``self.decode``; subclasses write
        into dst directly."""
        np.copyto(dst, self.decode(payload, dst.shape, meta))


class Float16Codec(Codec):
    name = "fp16"
    wire_align_bytes = 2

    def encode(self, arr):
        return native.f32_to_f16_bytes(arr), {}

    def decode(self, payload, shape, meta):
        return native.f16_bytes_to_f32(payload, int(np.prod(shape))).reshape(shape)

    def decode_accumulate(self, payload, meta, dst):
        native.f16_accumulate(payload, dst)

    def decode_into(self, payload, meta, dst):
        native.f16_bytes_to_f32(payload, dst.size, out=dst)


class ScaledFloat16Codec(Codec):
    """fp16 after normalizing by the tensor's abs-max (keeps outliers finite;
    hivemind ScaledFloat16Compression equivalent)."""

    name = "scaled-fp16"
    wire_align_bytes = 2

    def encode(self, arr):
        arr = np.asarray(arr, np.float32)
        scale = native.absmax(arr) if arr.size else 0.0
        scale = scale if scale > 0 else 1.0
        return native.f32_to_f16_scaled_bytes(arr, scale), {"scale": scale}

    def chunk_state(self, arr):
        arr = np.asarray(arr, np.float32)
        scale = native.absmax(arr) if arr.size else 0.0
        return {"scale": scale if scale > 0 else 1.0}

    def encode_chunk(self, arr, state):
        scale = state["scale"]
        return (
            native.f32_to_f16_scaled_bytes(np.asarray(arr, np.float32), scale),
            {"scale": scale},
        )

    def decode(self, payload, shape, meta):
        return native.f16_bytes_to_f32_scaled(
            payload, float(meta["scale"]), int(np.prod(shape))
        ).reshape(shape)

    def decode_accumulate(self, payload, meta, dst):
        native.f16_accumulate_scaled(payload, float(meta["scale"]), dst)

    def decode_into(self, payload, meta, dst):
        native.f16_bytes_to_f32_scaled(
            payload, float(meta["scale"]), dst.size, out=dst
        )


class Uniform8BitCodec(Codec):
    """Linear min/max quantization to uint8: lo and span in the meta."""

    name = "uniform8bit"
    wire_align_bytes = 1

    def encode(self, arr):
        payload, lo, span = native.quantize_uniform8(arr)
        return payload, {"lo": lo, "span": span}

    def chunk_state(self, arr):
        lo, span = native.minmax_span(arr)
        return {"lo": lo, "span": span}

    def encode_chunk(self, arr, state):
        payload = native.quantize_uniform8_given(arr, state["lo"], state["span"])
        return payload, {"lo": state["lo"], "span": state["span"]}

    def decode(self, payload, shape, meta):
        return native.dequantize_uniform8(
            payload, meta["lo"], meta["span"], int(np.prod(shape))
        ).reshape(shape)

    def decode_accumulate(self, payload, meta, dst):
        native.dequant_uniform8_accumulate(
            payload, meta["lo"], meta["span"], dst
        )

    def decode_into(self, payload, meta, dst):
        native.dequantize_uniform8(
            payload, meta["lo"], meta["span"], dst.size, out=dst
        )


class Quantile8BitCodec(Codec):
    """256-bucket quantile codebook quantization (hivemind
    Quantile8BitQuantization equivalent): robust to heavy-tailed grads.
    Payload layout: [256 x f32 codebook][n x u8 indices]."""

    name = "quantile8bit"
    wire_align_bytes = 1

    def encode(self, arr):
        flat = np.asarray(arr, np.float32).reshape(-1)
        if flat.size == 0:
            return np.zeros(256, np.float32).tobytes(), {}
        # strided sample, sort, interpolated quantiles, then bucket assignment
        edges = native.quantile_edges(flat)
        codebook = ((edges[:-1] + edges[1:]) * 0.5).astype(np.float32)
        idx = native.quantile_assign(flat, edges[1:-1])
        return codebook.tobytes() + idx.tobytes(), {}

    def chunk_state(self, arr):
        # codebook is built over the whole part; each chunk payload carries
        # it (1 KB) so chunks stay independently decodable
        flat = np.asarray(arr, np.float32).reshape(-1)
        if flat.size == 0:
            return {
                "codebook": np.zeros(256, np.float32).tobytes(),
                "inner": np.zeros(255, np.float32),
            }
        edges = native.quantile_edges(flat)
        codebook = ((edges[:-1] + edges[1:]) * 0.5).astype(np.float32)
        return {"codebook": codebook.tobytes(), "inner": edges[1:-1]}

    def encode_chunk(self, arr, state):
        flat = np.asarray(arr, np.float32).reshape(-1)
        if flat.size == 0:
            return state["codebook"], {}
        idx = native.quantile_assign(flat, state["inner"])
        return state["codebook"] + idx.tobytes(), {}

    def decode(self, payload, shape, meta):
        codebook = np.frombuffer(payload[: 256 * 4], dtype=np.float32)
        return native.lut256_gather(
            payload[256 * 4 :], codebook, int(np.prod(shape))
        ).reshape(shape)

    def decode_accumulate(self, payload, meta, dst):
        codebook = np.frombuffer(payload[: 256 * 4], dtype=np.float32)
        native.lut256_accumulate(payload[256 * 4 :], codebook, dst)

    def decode_into(self, payload, meta, dst):
        codebook = np.frombuffer(payload[: 256 * 4], dtype=np.float32)
        native.lut256_gather(payload[256 * 4 :], codebook, dst.size, out=dst)


class Blockwise8BitCodec(Codec):
    """Per-block absmax int8 (bitsandbytes/hivemind BlockwiseQuantization
    style): one fp32 scale per 4096 values.
    Payload layout: [nblocks x f32 scales][n x i8]."""

    name = "blockwise8bit"
    wire_align_bytes = 1
    # chunk boundaries on block multiples keep chunk-local blocks (and their
    # scales) identical to the whole-tensor block grid
    chunk_align = _BLOCK

    def encode(self, arr):
        arr = np.asarray(arr, np.float32).reshape(-1)
        q, scales = native.quantize_blockwise(arr, _BLOCK)
        return scales + q, {"nblocks": (arr.size + _BLOCK - 1) // _BLOCK}

    def _split(self, payload, meta):
        nb = int(meta["nblocks"])
        return payload[: nb * 4], payload[nb * 4 :]

    def decode(self, payload, shape, meta):
        scales, q = self._split(payload, meta)
        n = int(np.prod(shape))
        return native.dequantize_blockwise(q, scales, n, _BLOCK).reshape(shape)

    def decode_accumulate(self, payload, meta, dst):
        scales, q = self._split(payload, meta)
        native.dequant8_accumulate(q, scales, dst, _BLOCK)

    def decode_into(self, payload, meta, dst):
        scales, q = self._split(payload, meta)
        native.dequantize_blockwise(q, scales, dst.size, _BLOCK, out=dst)


class Blockwise4BitCodec(Codec):
    """Per-block absmax 4-bit quantization: packed nibbles with one fp16
    scale per 4096 values (0.504 B/elem, ~2x below the 8-bit codecs).
    Element 2i rides the low nibble of byte i, element 2i+1 the high
    nibble; quantization uses the fp16-ROUNDED scale so encode and decode
    agree exactly. Payload layout: [nblocks x u16 fp16-scales][ceil(n/2) x
    packed u8]."""

    name = "blockwise4bit"
    wire_align_bytes = 1
    # _BLOCK is even, so block-aligned chunk boundaries are also nibble
    # (byte) boundaries: every non-final chunk packs an even element count
    chunk_align = _BLOCK

    def encode(self, arr):
        arr = np.asarray(arr, np.float32).reshape(-1)
        q, scales = native.quantize_blockwise4(arr, _BLOCK)
        return scales + q, {"nblocks": (arr.size + _BLOCK - 1) // _BLOCK}

    def _split(self, payload, meta):
        nb = int(meta["nblocks"])
        return payload[: nb * 2], payload[nb * 2 :]

    def decode(self, payload, shape, meta):
        scales, q = self._split(payload, meta)
        n = int(np.prod(shape))
        return native.dequantize_blockwise4(q, scales, n, _BLOCK).reshape(shape)

    def decode_accumulate(self, payload, meta, dst):
        scales, q = self._split(payload, meta)
        native.dequant4_accumulate(q, scales, dst, _BLOCK)

    def decode_into(self, payload, meta, dst):
        scales, q = self._split(payload, meta)
        native.dequantize_blockwise4(q, scales, dst.size, _BLOCK, out=dst)


def topk_density() -> float:
    """Kept fraction for the topk codec, from ``ODTP_TOPK_DENSITY``
    (read lazily so tests and launch scripts can flip it)."""
    try:
        d = float(os.environ.get(_TOPK_DENSITY_ENV, _TOPK_DEFAULT_DENSITY))
    except ValueError:
        d = _TOPK_DEFAULT_DENSITY
    return min(1.0, max(d, 0.0))


class TopKCodec(Codec):
    """Per-tensor top-k magnitude sparsification: keep the k largest-|x|
    entries (k = max(1, n*density)), ship [k x u32 indices][k x f32
    values]. At the default 1/32 density that is 0.25 B/elem. Selection is
    deterministic: ties at the magnitude threshold resolve to the lowest
    indices, and the index payload is sorted ascending. Dropped mass is the
    error-feedback residual's job (config ``error_feedback``)."""

    name = "topk"
    # one wire record is (u32 index, f32 value) = 8 bytes; stripe
    # boundaries must not split a record (schema.CODEC_WIRE_GEOMETRY)
    wire_align_bytes = 8

    def _select(self, flat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        n = flat.size
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        k = min(n, max(1, int(n * topk_density())))
        mag = np.abs(flat)
        thr = np.partition(mag, n - k)[n - k]
        idx = np.nonzero(mag > thr)[0]  # provably <= k-1 elements
        need = k - idx.size
        if need > 0:
            idx = np.concatenate([idx, np.nonzero(mag == thr)[0][:need]])
        idx.sort()
        return idx, flat[idx]

    def encode(self, arr):
        flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
        idx, vals = self._select(flat)
        return (
            idx.astype(np.uint32).tobytes() + vals.tobytes(),
            {"k": int(idx.size)},
        )

    def chunk_state(self, arr):
        # top-k is a whole-tensor property: prescan selects globally, then
        # each chunk ships its slice of the selection (chunk-relative
        # indices), so the concatenated chunk decodes match the
        # whole-tensor encode exactly
        flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
        idx, vals = self._select(flat)
        return {"base": flat, "idx": idx, "vals": vals}

    def encode_chunk(self, arr, state):
        chunk = np.asarray(arr)
        base = state["base"]
        off = chunk.ctypes.data - base.ctypes.data
        if (
            chunk.dtype != np.float32
            or not chunk.flags.c_contiguous
            or off < 0
            or off % 4
            or off // 4 + chunk.size > base.size
        ):
            raise ValueError(
                "topk encode_chunk needs a contiguous float32 view into the "
                "part passed to chunk_state"
            )
        lo = off // 4
        a = np.searchsorted(state["idx"], lo, side="left")
        b = np.searchsorted(state["idx"], lo + chunk.size, side="left")
        idx = (state["idx"][a:b] - lo).astype(np.uint32)
        vals = state["vals"][a:b]
        return idx.tobytes() + vals.tobytes(), {"k": int(idx.size)}

    def _split(self, payload, meta):
        k = int(meta["k"])
        return (
            np.frombuffer(payload[: k * 4], np.uint32).astype(np.int64),
            np.frombuffer(payload[k * 4 : k * 8], np.float32),
        )

    def decode(self, payload, shape, meta):
        idx, vals = self._split(payload, meta)
        out = np.zeros(int(np.prod(shape)), np.float32)
        out[idx] = vals
        return out.reshape(shape)

    def decode_accumulate(self, payload, meta, dst):
        if not dst.flags.c_contiguous or dst.dtype != np.float32:
            native.add_inplace(dst, self.decode(payload, dst.shape, meta))
            return
        idx, vals = self._split(payload, meta)
        # selected indices are unique, so fancy-index += is accumulate-safe
        dst.reshape(-1)[idx] += vals

    def decode_into(self, payload, meta, dst):
        idx, vals = self._split(payload, meta)
        dst[:] = 0.0
        dst[idx] = vals


_CODECS = {
    c.name: c
    for c in [
        Codec(),
        Float16Codec(),
        ScaledFloat16Codec(),
        Uniform8BitCodec(),
        Quantile8BitCodec(),
        Blockwise8BitCodec(),
        Blockwise4BitCodec(),
        TopKCodec(),
    ]
}

# running per-codec (raw, wire) byte totals: the obs counters' source and
# what a bench reads to measure each codec's wire savings
_WIRE_TOTALS: dict[str, list[float]] = {}


def record_wire(name: str, raw_nbytes: int, wire_nbytes: int) -> None:
    """Account one encoded payload: the per-codec raw and wire byte
    counters and a running compression-ratio gauge (obs armed)."""
    tot = _WIRE_TOTALS.setdefault(name, [0.0, 0.0])
    tot[0] += raw_nbytes
    tot[1] += wire_nbytes
    from opendiloco_torch import obs  # deferred: obs is an optional plane

    tr = obs.tracer()
    if tr is None:
        return
    tr.count("outer_raw_bytes", raw_nbytes, codec=name)
    tr.count("outer_wire_bytes", wire_nbytes, codec=name)
    if tot[1] > 0:
        tr.gauge("outer_compression_ratio", tot[0] / tot[1], codec=name)


def get_codec(name: str) -> Codec:
    if name not in _CODECS:
        raise ValueError(f"unknown compression {name!r}; have {sorted(_CODECS)}")
    return _CODECS[name]


def compress_roundtrip(arr: np.ndarray, codec: Codec) -> np.ndarray:
    payload, meta = codec.encode(arr)
    return codec.decode(payload, arr.shape, meta)


def split_blockwise4_stacked(
    payload: bytes, meta: dict, L: int, n_layer: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Re-slice a whole-leaf ``blockwise4bit`` wire payload into the
    per-layer stacked layout of :func:`opendiloco_torch.quant.pack_blockwise4_stacked`
    (q [L, n_layer / 2] uint8, scales [L, n_layer / _BLOCK] uint16, the
    fp16 bits) with no dequantize/requantize round trip: the cheap
    hot-swap install for w4-resident serving. Only exact when the
    codec's block grid lands on layer boundaries (n_layer % _BLOCK == 0,
    which also makes the nibble packing byte-aligned per layer); returns
    None otherwise, and the caller decodes and repacks."""
    if n_layer <= 0 or n_layer % _BLOCK:
        return None
    nb_total = int(meta["nblocks"])
    scales, q = payload[: nb_total * 2], payload[nb_total * 2 :]
    if len(q) != (L * n_layer + 1) // 2 or nb_total != L * (n_layer // _BLOCK):
        return None
    qa = np.frombuffer(q, np.uint8).reshape(L, n_layer // 2)
    sa = np.frombuffer(scales, np.uint16).reshape(L, n_layer // _BLOCK)
    return qa.copy(), sa.copy()


def device_wire_dtype(name: str) -> str | None:
    """The dtype the device outer plane may cast a pseudo-gradient to on
    the card before its D2H copy, or None (full-width f32).

    Only a codec whose host encode is idempotent under the cast
    qualifies: plain fp16 encodes f16(x), and f16(f32(f16(x))) == f16(x)
    bit for bit, so the wire bytes are the host placement's. scaled-fp16
    divides by a host abs-max before its cast and the 8-bit codecs bucket
    full-precision values, so a cast on the card would change their
    bytes."""
    return "float16" if name == "fp16" else None
