"""Socket front end of the serving plane: HTTP and JSONL on one port.

The port's copy of ``opendiloco_tpu/serve/server.py``: a daemon accept
loop, one handler thread per connection, no framework. Both protocols
carry the same JSON request::

    {"prompt": [1, 2, 3], "max_new_tokens": 16, "eos_id": null}

- HTTP: ``POST /generate`` with that body; ``GET /healthz`` and
  ``GET /stats`` return the batcher's and the engine's status.
- JSONL: a connection whose first bytes are not an HTTP verb is a stream
  of JSON lines; each line gets a response line, in order. An ``"id"``
  field is echoed back.

A request the server rejects for load ("queue full", "deadline
exceeded") gets a structured 503 with ``Retry-After`` from the batcher's
wait estimate. A port in use falls back to an ephemeral one with a
warning, so a training run is never taken down by a port clash; the
bound port is ``ServeServer.port``. ``identity`` (a dict, or a callable
read at each request) says who the server is, a fleet replica's id and
staleness for instance, on ``/healthz`` and ``/stats``. With the obs
plane armed (``ODTP_OBS``) the edge adopts a request's ``"trace"``
context (``schema.TRACE_CTX_KEY``) or mints one, and the batcher records
the request's stages under it (:mod:`~opendiloco_torch.obs.reqtrace`).
"""
from __future__ import annotations

import json
import logging
import select
import socket
import threading
import time
from typing import Callable, Optional, Union

from opendiloco_torch.obs import reqtrace
from opendiloco_torch.serve.scheduler import ContinuousBatcher

log = logging.getLogger(__name__)

_HTTP_VERBS = (b"GET ", b"POST", b"PUT ", b"HEAD", b"DELE", b"OPTI", b"PATC")

# scheduler rejects that are the server's load, not the request's fault:
# answered as structured 503 + Retry-After so clients back off cleanly
_OVERLOAD_ERRORS = ("queue full", "deadline exceeded")

# seconds a connection may idle, and a generation may take, before the
# request is given up
_REQUEST_TIMEOUT_S = 300.0


def bind_with_fallback(host: str, port: int, what: str, retry_s: float = 0.0) -> socket.socket:
    """Bind (host, port), falling back to an ephemeral port when the
    requested one is taken — a shared-process serving plane must never
    take down training over a port clash.

    ``retry_s`` keeps retrying an explicit port, with a bounded backoff,
    before the fallback: a replica respawned at its old address races its
    predecessor's listener teardown, and the router and the manager dial
    the address they know."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    deadline = time.monotonic() + max(0.0, retry_s)
    pause = 0.05
    while True:
        try:
            sock.bind((host, port))
            return sock
        except OSError as e:
            if port == 0:
                sock.close()
                raise
            if time.monotonic() + pause <= deadline:
                time.sleep(pause)
                pause = min(pause * 2, 0.5)
                continue
            log.warning("%s port %d unavailable (%s); falling back to an ephemeral port", what, port, e)
            sock.bind((host, 0))
            return sock


class ServeServer:
    def __init__(
        self,
        batcher: ContinuousBatcher,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        identity: Optional[Union[dict, Callable[[], dict]]] = None,
        bind_retry_s: float = 0.0,
    ):
        self.batcher = batcher
        self.rejected_total = 0  # structured 503 rejects served
        self._identity = identity
        self._sock = bind_with_fallback(host, port, "serve", bind_retry_s)
        self._sock.listen(32)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, name="odt-serve-http", daemon=True
        )
        self._thread.start()

    def identity(self) -> dict:
        ident = self._identity
        if ident is None:
            return {}
        return dict(ident() if callable(ident) else ident)

    # -- accept / dispatch -------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            ).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(_REQUEST_TIMEOUT_S)
            head = conn.recv(4096)
            if not head:
                return
            if head[:4].ljust(4) in _HTTP_VERBS or head[:5] == b"PATCH":
                self._handle_http(conn, head)
            else:
                self._handle_jsonl(conn, head)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- one generation ----------------------------------------------------

    @staticmethod
    def _disconnected(conn: socket.socket) -> bool:
        """True when the peer closed the connection (EOF is readable)."""
        try:
            readable, _, _ = select.select([conn], [], [], 0)
            if not readable:
                return False
            return conn.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _retry_after_s(self) -> float:
        """Backpressure hint for structured 503 rejects: the scheduler's
        current queue-drain estimate, clamped to something a client can
        reasonably sleep on."""
        return round(min(30.0, max(0.1, self.batcher.estimate_wait_s())), 3)

    def _generate(
        self, payload: dict, conn: Optional[socket.socket] = None
    ) -> Optional[dict]:
        deadline_ms = payload.get("deadline_ms")
        # trace context: adopt one a router propagated, else mint one at
        # this edge; an absent field is an untraced request
        trace_ctx = None
        rt = reqtrace.ring()
        if rt is not None:
            trace_ctx = reqtrace.ctx_of(payload)
            if trace_ctx is None:
                trace_ctx = rt.mint(at="server", req_id=payload.get("id"))
        req = self.batcher.submit(
            payload.get("prompt") or [],
            max_new_tokens=int(payload.get("max_new_tokens", 16)),
            eos_id=payload.get("eos_id"),
            priority=int(payload.get("priority", 0)),
            deadline_ms=None if deadline_ms is None else float(deadline_ms),
            trace=trace_ctx,
        )
        # wait in slices, watching the client socket: a disconnect
        # mid-generation retires the slot immediately instead of decoding
        # the remaining tokens into a dead socket (None = nobody to answer)
        deadline = time.monotonic() + _REQUEST_TIMEOUT_S
        while not req.wait(0.05):
            if conn is not None and self._disconnected(conn):
                req.cancel()
                return None
            if time.monotonic() >= deadline:
                req.cancel()
                return {"error": "timeout", "id": payload.get("id")}
        out = {
            "tokens": req.tokens,
            "epoch": req.epoch,
            "latency_ms": None
            if req.latency_s is None
            else round(req.latency_s * 1e3, 3),
        }
        if req.error is not None:
            out["error"] = req.error
            if req.error in _OVERLOAD_ERRORS:
                # structured backpressure: the client learns when to come
                # back instead of watching its connection error out
                out["retry_after_s"] = self._retry_after_s()
                self.rejected_total += 1
        if payload.get("id") is not None:
            out["id"] = payload["id"]
        return out

    # -- HTTP --------------------------------------------------------------

    def _handle_http(self, conn: socket.socket, head: bytes) -> None:
        while b"\r\n\r\n" not in head and len(head) < 65536:
            chunk = conn.recv(4096)
            if not chunk:
                break
            head += chunk
        header, _, body = head.partition(b"\r\n\r\n")
        lines = header.split(b"\r\n")
        method, path = (lines[0].split(b" ") + [b"", b""])[:2]
        clen = 0
        for ln in lines[1:]:
            if ln.lower().startswith(b"content-length:"):
                clen = int(ln.split(b":", 1)[1].strip() or 0)
        while len(body) < clen:
            chunk = conn.recv(65536)
            if not chunk:
                break
            body += chunk

        if method == b"POST" and path.startswith(b"/generate"):
            try:
                payload = json.loads(body.decode() or "{}")
            except (ValueError, UnicodeDecodeError):
                self._respond(conn, 400, {"error": "malformed JSON body"})
                return
            out = self._generate(payload, conn)
            if out is not None:
                if out.get("error") in _OVERLOAD_ERRORS:
                    self._respond(
                        conn,
                        503,
                        out,
                        headers={"Retry-After": str(out["retry_after_s"])},
                    )
                else:
                    self._respond(conn, 400 if "error" in out else 200, out)
        elif method == b"GET" and path.startswith(b"/healthz"):
            self._respond(
                conn,
                200,
                {
                    "ok": self.batcher.loop_error is None,
                    "weights_epoch": self.batcher.engine.weights_epoch,
                    "staleness": self.batcher.engine.staleness(),
                    "free_slots": self.batcher.slots.num_free,
                    # the tier's load, so a poller sees paging pressure
                    **(
                        {
                            "tier_occupancy": round(self.batcher.kv_tier.occupancy(), 4),
                            "tier_paused": self.batcher.kv_tier.paused_count,
                        }
                        if self.batcher.kv_tier is not None
                        else {}
                    ),
                    **self.identity(),
                },
            )
        elif method == b"GET" and path.startswith(b"/stats"):
            stats = self.batcher.stats()
            stats["rejected_total"] = self.rejected_total
            ident = self.identity()
            if ident:
                stats["identity"] = ident
            self._respond(conn, 200, stats)
        else:
            self._respond(conn, 404, {"error": "unknown route"})

    def _respond(
        self,
        conn: socket.socket,
        status: int,
        obj: dict,
        headers: Optional[dict] = None,
    ) -> None:
        body = (json.dumps(obj) + "\n").encode()
        reason = {
            200: "OK",
            400: "Bad Request",
            404: "Not Found",
            503: "Service Unavailable",
        }.get(status, "Error")
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        head = (
            f"HTTP/1.0 {status} {reason}\r\n"
            "Content-Type: application/json\r\n"
            f"{extra}"
            f"Content-Length: {len(body)}\r\n\r\n"
        ).encode()
        conn.sendall(head + body)

    # -- JSONL -------------------------------------------------------------

    def _handle_jsonl(self, conn: socket.socket, buf: bytes) -> None:
        while True:
            while b"\n" in buf:
                line, _, buf = buf.partition(b"\n")
                line = line.strip()
                if not line:
                    continue
                try:
                    payload = json.loads(line.decode())
                except (ValueError, UnicodeDecodeError):
                    out = {"error": "malformed JSON line"}
                else:
                    out = self._generate(payload, conn)
                    if out is None:  # client disconnected mid-generation
                        return
                conn.sendall((json.dumps(out) + "\n").encode())
            chunk = conn.recv(65536)
            if not chunk:
                return
            buf += chunk

    def stop(self) -> None:
        """End the accept loop: shutting the listening socket down wakes a
        blocked ``accept``, so the loop ends at once."""
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)
