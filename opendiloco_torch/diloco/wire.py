"""Framed-message wire protocol for the DCN control/data plane.

The reference's equivalent layer is hivemind's protobuf RPC through the Go
libp2p daemon (SURVEY.md §2.3: p2pd + *_pb2 schemas). Here the control plane
is a minimal length-prefixed frame: an 8-byte big-endian header length, a
JSON header, then a raw binary payload (tensor bytes travel untouched --
JSON never sees them).

Frame layout:  [4B magic "ODTP"][4B header_len][header JSON][payload bytes]
The header carries {"type": ..., "meta": {...}, "payload_len": N}; meta
values must be JSON-serializable (bytes fields are hex-encoded by codecs
that need them).

The port's copy of ``opendiloco_tpu/diloco/wire.py``: the same bytes on
the wire, so port and JAX workers share one galaxy.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Optional

from opendiloco_torch.diloco.schema import (  # single layout declaration
    FRAME_HDR as _HDR,
    MAGIC,
    MAX_HEADER,
)
# StreamReader buffer: the 64KB default throttles multi-hundred-MB tensor
# frames to well under 1 GB/s; 16MB keeps the read loop off the hot path
STREAM_LIMIT = 16 * 1024 * 1024


class WireError(RuntimeError):
    pass


def encode_frame(msg_type: str, meta: dict[str, Any], payload: bytes = b"") -> bytes:
    header = json.dumps(
        {"type": msg_type, "meta": meta, "payload_len": len(payload)}
    ).encode()
    return _HDR.pack(MAGIC, len(header)) + header + payload


def _tune_socket(writer: asyncio.StreamWriter) -> None:
    sock = writer.get_extra_info("socket")
    if sock is not None:
        import socket as _socket

        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_SNDBUF, 4 * 1024 * 1024)
            sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVBUF, 4 * 1024 * 1024)
        except OSError:
            pass


async def read_frame(
    reader: asyncio.StreamReader, *, timeout: Optional[float] = None
) -> tuple[str, dict[str, Any], bytes]:
    async def _read() -> tuple[str, dict[str, Any], bytes]:
        hdr = await reader.readexactly(_HDR.size)
        magic, hlen = _HDR.unpack(hdr)
        if magic != MAGIC or hlen > MAX_HEADER:
            raise WireError(f"bad frame header: magic={magic!r} hlen={hlen}")
        header = json.loads(await reader.readexactly(hlen))
        payload = b""
        n = header.get("payload_len", 0)
        if n:
            payload = await reader.readexactly(n)
        return header["type"], header.get("meta", {}), payload

    if timeout is None:
        return await _read()
    return await asyncio.wait_for(_read(), timeout)


async def send_frame(
    writer: asyncio.StreamWriter, msg_type: str, meta: dict[str, Any], payload: bytes = b""
) -> None:
    # header and payload written separately: no multi-hundred-MB concat copy
    header = json.dumps(
        {"type": msg_type, "meta": meta, "payload_len": len(payload)}
    ).encode()
    writer.write(_HDR.pack(MAGIC, len(header)) + header)
    if payload:
        writer.write(payload)
    await writer.drain()


async def request(
    host: str,
    port: int,
    msg_type: str,
    meta: dict[str, Any],
    payload: bytes = b"",
    *,
    timeout: float = 30.0,
) -> tuple[str, dict[str, Any], bytes]:
    """One-shot RPC: connect, send one frame, read one frame, close."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port, limit=STREAM_LIMIT), timeout
    )
    _tune_socket(writer)
    try:
        await send_frame(writer, msg_type, meta, payload)
        return await read_frame(reader, timeout=timeout)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass


# -- chunk framing (pipelined outer data plane) ------------------------------
#
# A pipelined part travels as `nchunks` independent frames; each frame's meta
# gains the fields below so the receiver can route the payload to the right
# element slice without waiting for the rest of the part. Frames without a
# "chunk" field are whole-part (serial path) and keep their original keys.


def chunk_fields(k: int, nchunks: int, coff: int, clen: int) -> dict[str, int]:
    """Meta fields marking one chunk of a pipelined part: chunk index,
    chunk count, and the element offset/length within the part."""
    return {
        "chunk": int(k),
        "nchunks": int(nchunks),
        "coff": int(coff),
        "clen": int(clen),
    }


def chunk_span(meta: dict[str, Any], part_size: int) -> tuple[int, int]:
    """Validated (offset, length) of a chunk frame within its part."""
    coff = int(meta.get("coff", 0))
    clen = int(meta.get("clen", part_size))
    if coff < 0 or clen < 0 or coff + clen > part_size:
        raise WireError(
            f"chunk [{coff}:{coff + clen}] outside part of {part_size} elements"
        )
    return coff, clen


def check_plan(meta: dict[str, Any], expected: Any) -> None:
    """Fail a frame whose sender planned a different butterfly partition.

    Adaptive-transport frames (diloco/linkstate.py) carry a ``plan`` hash
    of the part-bounds vector. Both sides adaptive -> hashes must match or
    the parts would silently misalign. A side not carrying/expecting a plan
    skips the check: a mixed swarm always plans uniform (the planner
    requires link vectors from EVERY member), so frame shapes still agree
    and the existing shape/size validation covers the rest."""
    got = meta.get("plan")
    if got is not None and expected is not None and got != expected:
        raise WireError(
            f"partition plan mismatch: peer planned {got}, local {expected}"
        )


# -- multi-tensor payload packing -------------------------------------------


def pack_arrays(payloads: list[bytes], metas: list[dict]) -> tuple[bytes, list[dict]]:
    """Concatenate per-tensor payloads; meta gains offset/length fields."""
    out_meta = []
    offset = 0
    for p, m in zip(payloads, metas):
        m = dict(m)
        m["_off"] = offset
        m["_len"] = len(p)
        offset += len(p)
        out_meta.append(m)
    return b"".join(payloads), out_meta


def unpack_arrays(blob: bytes, metas: list[dict]) -> list[tuple[bytes, dict]]:
    out = []
    for m in metas:
        m = dict(m)
        off, ln = m.pop("_off"), m.pop("_len")
        out.append((blob[off : off + ln], m))
    return out
