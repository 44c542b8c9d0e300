"""Blocking ODTP framing for the fleet's push channel.

The port's copy of ``opendiloco_tpu/fleet/wire.py``: the bytes of the
asyncio control plane's frames (``diloco/wire.py``),
``[4B magic "ODTP"][4B BE header_len][header JSON][payload]`` with the
header ``{"type", "meta", "payload_len"}``, over a plain blocking socket
per (publisher, replica) pair. The layout constants come from
``diloco/schema.py``, so a port publisher feeds a JAX replica and back.
"""
from __future__ import annotations

import json
import socket
from typing import Any, Optional

from opendiloco_torch.diloco.schema import FRAME_HDR as _HDR
from opendiloco_torch.diloco.schema import MAGIC, MAX_HEADER


class FleetWireError(RuntimeError):
    pass


def send_frame(sock: socket.socket, msg_type: str, meta: dict[str, Any], payload: bytes = b"") -> None:
    header = json.dumps({"type": msg_type, "meta": meta, "payload_len": len(payload)}).encode()
    # header and payload written separately: no large concatenated copy
    sock.sendall(_HDR.pack(MAGIC, len(header)) + header)
    if payload:
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise FleetWireError("connection closed mid-frame")
        got += k
    return bytes(buf)


def recv_frame(sock: socket.socket, *, timeout: Optional[float] = None) -> tuple[str, dict[str, Any], bytes]:
    if timeout is not None:
        sock.settimeout(timeout)
    hdr = _recv_exact(sock, _HDR.size)
    magic, hlen = _HDR.unpack(hdr)
    if magic != MAGIC or hlen > MAX_HEADER:
        raise FleetWireError(f"bad frame header: magic={magic!r} hlen={hlen}")
    header = json.loads(_recv_exact(sock, hlen))
    payload = b""
    n = int(header.get("payload_len", 0))
    if n:
        payload = _recv_exact(sock, n)
    return header["type"], header.get("meta", {}), payload
