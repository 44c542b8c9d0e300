"""Reader and writer for the safetensors file format, without the
``safetensors`` package.

A file is an 8-byte little-endian header length N, then N bytes of JSON,
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` map of strings, padded with spaces to a
multiple of 8, then the tensors' raw little-endian bytes, offsets counted
from the end of the header. Nothing is pickled.

Tensors are numpy arrays or torch tensors (any device; they are copied to
the host to be written). numpy has no bfloat16, so a bf16 tensor is
carried as its raw 16-bit words: written from a ``torch.bfloat16`` tensor,
and read back as ``torch.bfloat16`` (``load_torch``) or as uint16 words
(``load``).
"""
from __future__ import annotations

import json
import math
import struct
from typing import Any, BinaryIO, Optional

import numpy as np
import torch

# safetensors dtype name <-> numpy dtype (little-endian); BF16 rides as uint16
_NP = {
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"),
    "I32": np.dtype("<i4"),
    "I64": np.dtype("<i8"),
}
_FROM_NP = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16", np.dtype(np.int32): "I32",
            np.dtype(np.int64): "I64"}
_FROM_TORCH = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.int32: "I32",
               torch.int64: "I64"}
# a header larger than this is not a safetensors file (the format's own cap)
_MAX_HEADER = 100 * 2**20


def _entry(name: str, t: Any) -> tuple[str, tuple, int]:
    """(dtype name, shape, element size) of a tensor, without copying it."""
    if isinstance(t, torch.Tensor):
        dtype = _FROM_TORCH.get(t.dtype)
        if dtype is None:
            raise TypeError(f"{name}: dtype {t.dtype} is not one of {sorted(_FROM_TORCH)}")
        return dtype, tuple(t.shape), t.element_size()
    arr = np.asarray(t)
    dtype = _FROM_NP.get(arr.dtype.newbyteorder("="))
    if dtype is None:
        raise TypeError(f"{name}: dtype {arr.dtype} is not one of {sorted(_FROM_NP.values())}")
    return dtype, arr.shape, arr.dtype.itemsize


def _host_bytes(t: Any, dtype: str) -> memoryview:
    """The raw little-endian bytes of a tensor, copied to the host."""
    if isinstance(t, torch.Tensor):
        t = t.detach().contiguous().cpu()
        arr = t.view(torch.int16).numpy() if dtype == "BF16" else t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(t), dtype=_NP[dtype])
    return memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B")


def write(f: BinaryIO, tensors: dict, metadata: Optional[dict] = None) -> int:
    """Write ``tensors`` ({name: array or tensor}) to the open binary file
    ``f``; returns the bytes written. Tensors are laid out widest element
    first, then by name, so every tensor starts aligned to its element;
    each is copied to the host only as its turn comes."""
    entries = {name: _entry(name, t) for name, t in tensors.items()}
    order = sorted(entries, key=lambda n: (-entries[n][2], n))
    header: dict = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise TypeError("safetensors __metadata__ maps strings to strings")
        header["__metadata__"] = dict(metadata)
    off = 0
    for name in order:
        dtype, shape, size = entries[name]
        nbytes = size * math.prod(shape)
        header[name] = {"dtype": dtype, "shape": list(shape), "data_offsets": [off, off + nbytes]}
        off += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    f.write(struct.pack("<Q", len(blob)))
    f.write(blob)
    for name in order:
        if header[name]["data_offsets"][1] > header[name]["data_offsets"][0]:
            f.write(_host_bytes(tensors[name], entries[name][0]))
    return 8 + len(blob) + off


def read_header(f: BinaryIO) -> tuple[dict, dict, int]:
    """(tensor entries, metadata, offset of the data) of the open file."""
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError("not a safetensors file: shorter than its header length")
    (n,) = struct.unpack("<Q", raw)
    if n > _MAX_HEADER:
        raise ValueError(f"not a safetensors file: header of {n} bytes")
    header = json.loads(f.read(n).decode())
    metadata = header.pop("__metadata__", None) or {}
    for name, e in header.items():
        if e["dtype"] not in _NP:
            raise TypeError(f"{name}: safetensors dtype {e['dtype']} is not one of {sorted(_NP)}")
    return header, metadata, 8 + n


def read_entry(f: BinaryIO, base: int, name: str, e: dict) -> np.ndarray:
    """Tensor ``name`` (header entry ``e``; data from ``base``) of the open
    file, read into a fresh host array."""
    begin, end = e["data_offsets"]
    dt = _NP[e["dtype"]]
    arr = np.empty(e["shape"], dtype=dt)
    if arr.nbytes != end - begin:
        raise ValueError(f"{name}: {end - begin} bytes for shape {e['shape']} of {e['dtype']}")
    f.seek(base + begin)
    if arr.nbytes and f.readinto(memoryview(arr.reshape(-1)).cast("B")) != arr.nbytes:
        raise ValueError(f"{name}: file ends inside the tensor")
    return arr.astype(dt.newbyteorder("="), copy=False)


def load(f: BinaryIO) -> tuple[dict, dict]:
    """({name: numpy array}, metadata) of the open file; BF16 tensors come
    back as their uint16 words."""
    header, metadata, base = read_header(f)
    return {name: read_entry(f, base, name, e) for name, e in header.items()}, metadata


def load_torch(f: BinaryIO) -> tuple[dict, dict]:
    """({name: CPU tensor}, metadata) of the open file; BF16 tensors come
    back as ``torch.bfloat16``."""
    header, metadata, base = read_header(f)
    out = {}
    for name, e in header.items():
        t = torch.from_numpy(read_entry(f, base, name, e))
        out[name] = t.view(torch.bfloat16) if e["dtype"] == "BF16" else t
    return out, metadata


def save_file(tensors: dict, path: str, metadata: Optional[dict] = None) -> int:
    with open(path, "wb") as f:
        return write(f, tensors, metadata)


def load_file(path: str) -> dict:
    """{name: numpy array} of the file at ``path`` (metadata dropped)."""
    with open(path, "rb") as f:
        return load(f)[0]
