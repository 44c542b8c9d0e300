"""State-tree packing: raw numpy bytes plus a JSON meta, no pickle.

The port's copy of ``opendiloco_tpu/diloco/tcp.py`` ``serialize_state``,
``deserialize_state`` and ``state_codec`` with the
``_encode_obj``/``_decode_obj`` walk they use: the bytes and the meta
equal the JAX package's for the same tree and codec, so a checkpoint's
DiLoCo sidecar (``diloco_state.bin`` / ``.json``) and an encoded state
payload read in either package. With a codec, float32 arrays ride
codec-encoded and every other array raw; the per-array codec metas go in
the meta's ``enc`` list.
"""
from __future__ import annotations

import os
from typing import Any, BinaryIO, Optional

import numpy as np

from opendiloco_torch.diloco.compression import Codec, get_codec


def state_codec(configured: Codec) -> Codec:
    """Codec for state payloads (onboarding, serving snapshots): the
    configured codec when it is of the fp16 family, else plain fp16 (the
    8-bit codecs are tuned for pseudo-gradient magnitudes, not weights).
    ``ODTP_STATE_CODEC``, read at call time under the JAX package's name,
    overrides ("none" keeps raw float32)."""
    name = os.environ.get("ODTP_STATE_CODEC")
    if name:
        return get_codec(name)
    if configured.name in ("fp16", "scaled-fp16"):
        return configured
    return get_codec("fp16")


def pack_state(state: dict[str, Any], codec: Optional[Codec] = None) -> tuple[dict, list[np.ndarray]]:
    """(JSON meta, contiguous arrays) of a state tree of numpy arrays and
    JSON scalars: the meta holds the tree with ``{"__arr__": i}`` in place
    of array i and the list of (offset, nbytes, dtype, shape); the payload
    is the arrays' bytes in that order. With ``codec`` (other than
    "none"), each float32 array is encoded and its entry in the list is
    the payload's bytes as uint8."""
    if codec is not None and codec.name == "none":
        codec = None
    arrays: list[np.ndarray] = []
    meta = _encode_obj(state, arrays)
    blobs, offsets, encs, off = [], [], [], 0
    for a in arrays:
        # ascontiguousarray makes a 0-d array 1-d: the meta keeps its shape
        ac = np.ascontiguousarray(a)
        if codec is not None and ac.dtype == np.float32:
            payload, cmeta = codec.encode(ac.reshape(-1))
            ac = np.frombuffer(bytes(payload), np.uint8)
            encs.append({"codec": codec.name, "meta": cmeta})
        else:
            encs.append(None)
        offsets.append((off, ac.nbytes, str(a.dtype), list(a.shape)))
        off += ac.nbytes
        blobs.append(ac)
    out = {"tree": meta, "arrays": offsets}
    if any(e is not None for e in encs):
        out["enc"] = encs
    return out, blobs


def serialize_state(state: dict[str, Any], codec: Optional[Codec] = None) -> tuple[dict, bytes]:
    """(JSON meta, payload bytes) of :func:`pack_state`."""
    meta, arrays = pack_state(state, codec)
    return meta, b"".join(a.tobytes() for a in arrays)


def _decoded(raw, shape, enc: dict) -> np.ndarray:
    size = int(np.prod(shape)) if shape else 1
    c = get_codec(enc["codec"])
    return np.asarray(c.decode(raw, (size,), enc["meta"]), dtype=np.float32).reshape(shape).copy()


def deserialize_state(meta: dict, payload: bytes) -> dict[str, Any]:
    encs = meta.get("enc") or [None] * len(meta["arrays"])
    arrays = []
    for (o, n, dt, shape), enc in zip(meta["arrays"], encs):
        raw = payload[o : o + n]
        if enc is not None:
            arrays.append(_decoded(raw, shape, enc))
        else:
            arrays.append(np.frombuffer(raw, dtype=dt).reshape(shape).copy())
    return _decode_obj(meta["tree"], arrays)


def read_state(meta: dict, f: BinaryIO) -> dict[str, Any]:
    """:func:`deserialize_state` of a payload read array by array from the
    open binary file ``f`` (no second copy of a raw payload in memory)."""
    encs = meta.get("enc") or [None] * len(meta["arrays"])
    arrays = []
    for (o, n, dt, shape), enc in zip(meta["arrays"], encs):
        f.seek(o)
        if enc is not None:
            raw = f.read(n)
            if len(raw) != n:
                raise ValueError("state payload ends inside an array")
            arrays.append(_decoded(raw, shape, enc))
            continue
        a = np.empty(shape, dtype=dt)
        if a.nbytes != n:
            raise ValueError(f"state array of {n} bytes for shape {shape} of {dt}")
        if n and f.readinto(memoryview(a.reshape(-1)).cast("B")) != n:
            raise ValueError("state payload ends inside an array")
        arrays.append(a)
    return _decode_obj(meta["tree"], arrays)


def _encode_obj(obj: Any, arrays: list[np.ndarray]) -> Any:
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return {"__arr__": len(arrays) - 1}
    if isinstance(obj, dict):
        return {k: _encode_obj(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode_obj(v, arrays) for v in obj]
    return obj


def _decode_obj(obj: Any, arrays: list[np.ndarray]) -> Any:
    if isinstance(obj, dict):
        if "__arr__" in obj:
            return arrays[obj["__arr__"]]
        return {k: _decode_obj(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode_obj(v, arrays) for v in obj]
    return obj
