"""State-tree packing: raw numpy bytes plus a JSON meta, no pickle.

The port's copy of ``opendiloco_tpu/diloco/tcp.py`` ``serialize_state``
and ``deserialize_state`` with the ``_encode_obj``/``_decode_obj`` walk
they use, for the uncompressed form only: the bytes and the meta equal
the JAX package's for the same tree, so a checkpoint's DiLoCo sidecar
(``diloco_state.bin`` / ``.json``) reads in either package. Codecs on the
payload wait for the port's copy of the codecs (ROADMAP.md A3).
"""
from __future__ import annotations

from typing import Any, BinaryIO, Optional

import numpy as np


def _check_codec(codec: Optional[Any]) -> None:
    name = getattr(codec, "name", codec)
    if name not in (None, "none"):
        raise NotImplementedError(
            f"state payload codec {name!r} is not ported yet (ROADMAP.md A3); only 'none' is"
        )


def pack_state(state: dict[str, Any], codec: Optional[Any] = None) -> tuple[dict, list[np.ndarray]]:
    """(JSON meta, contiguous arrays) of a state tree of numpy arrays and
    JSON scalars: the meta holds the tree with ``{"__arr__": i}`` in place
    of array i and the list of (offset, nbytes, dtype, shape); the payload
    is the arrays' raw bytes in that order."""
    _check_codec(codec)
    arrays: list[np.ndarray] = []
    meta = _encode_obj(state, arrays)
    offsets, off = [], 0
    for a in arrays:
        offsets.append((off, a.nbytes, str(a.dtype), list(a.shape)))
        off += a.nbytes
    # ascontiguousarray makes a 0-d array 1-d: the meta keeps its shape
    return {"tree": meta, "arrays": offsets}, [np.ascontiguousarray(a) for a in arrays]


def serialize_state(state: dict[str, Any], codec: Optional[Any] = None) -> tuple[dict, bytes]:
    """(JSON meta, payload bytes) of :func:`pack_state`."""
    meta, arrays = pack_state(state, codec)
    return meta, b"".join(a.tobytes() for a in arrays)


def _unpacked(meta: dict, arrays: list) -> dict[str, Any]:
    if any(e is not None for e in meta.get("enc") or ()):
        _check_codec(next(e for e in meta["enc"] if e is not None)["codec"])
    return _decode_obj(meta["tree"], arrays)


def deserialize_state(meta: dict, payload: bytes) -> dict[str, Any]:
    arrays = [
        np.frombuffer(payload[o : o + n], dtype=dt).reshape(shape).copy()
        for o, n, dt, shape in meta["arrays"]
    ]
    return _unpacked(meta, arrays)


def read_state(meta: dict, f: BinaryIO) -> dict[str, Any]:
    """:func:`deserialize_state` of a payload read array by array from the
    open binary file ``f`` (no second copy of the payload in memory)."""
    arrays = []
    for o, n, dt, shape in meta["arrays"]:
        a = np.empty(shape, dtype=dt)
        if a.nbytes != n:
            raise ValueError(f"state array of {n} bytes for shape {shape} of {dt}")
        f.seek(o)
        if n and f.readinto(memoryview(a.reshape(-1)).cast("B")) != n:
            raise ValueError("state payload ends inside an array")
        arrays.append(a)
    return _unpacked(meta, arrays)


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
