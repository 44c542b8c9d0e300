"""Minimal pull-based Prometheus text endpoint.

A daemon thread accepts plain HTTP GETs and answers with the current
tracer snapshot rendered by :func:`export.prometheus_text`. Started
only from ``Tracer.__init__`` when both ``ODTP_OBS`` and
``ODTP_OBS_PROM_PORT`` are set — with the plane disarmed no socket is
ever bound.

One registry per process: the tracer is process-wide, so trainer metrics
and the serve plane's gauges (serve_p50_ms, serve_tokens_per_s, ...)
come out of the SAME snapshot on the SAME endpoint — the serve plane
calls :func:`get_or_start` rather than binding a second port. A
requested port that is already taken (e.g. serve.port colliding with
``ODTP_OBS_PROM_PORT`` when both are enabled) downgrades to an ephemeral
port with a warning instead of killing the process; the bound port is
always ``PromServer.port``.
"""
from __future__ import annotations

import logging
import socket
import threading

log = logging.getLogger(__name__)


class PromServer:
    def __init__(self, port: int, tracer) -> None:
        self._tracer = tracer
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind(("0.0.0.0", port))
        except OSError as e:
            if port == 0:
                raise
            log.warning(
                "prometheus port %d unavailable (%s); "
                "falling back to an ephemeral port",
                port,
                e,
            )
            self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name="odtp-obs-prom", daemon=True
        )
        self._thread.start()

    def _serve(self) -> None:
        from opendiloco_torch.obs.export import prometheus_text

        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                conn.settimeout(2.0)
                try:
                    conn.recv(4096)  # drain the request; any GET is /metrics
                except OSError:
                    pass
                body = prometheus_text(self._tracer).encode()
                head = (
                    "HTTP/1.0 200 OK\r\n"
                    "Content-Type: text/plain; version=0.0.4\r\n"
                    f"Content-Length: {len(body)}\r\n\r\n"
                ).encode()
                conn.sendall(head + body)
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


def start(port: int, tracer) -> PromServer:
    return PromServer(port, tracer)


def get_or_start(port: int, tracer) -> PromServer:
    """The process's single metrics endpoint: reuse the tracer's already-
    bound server when there is one (its snapshot covers every subsystem's
    gauges — one registry), else bind now and attach it to the tracer so
    later callers converge on the same instance."""
    if tracer.prom is not None:
        return tracer.prom
    tracer.prom = start(port, tracer)
    return tracer.prom
