"""Threaded bulk data plane for large tensor transfers.

The asyncio control plane (diloco/tcp.py) is right for matchmaking, gossip
and small frames, but for multi-hundred-MB butterfly parts it pays an
allocation and a copy per read and runs every byte through the event loop.
This module is the native data plane the reference delegates to hivemind's
libp2p daemon (SURVEY §2.3): plain blocking sockets on dedicated threads,
``sendall`` straight from the tensor buffer and ``recv`` straight into a
preallocated numpy buffer -- zero application-side copies. The byte pumping
itself runs in C (native/odtp_kernels.cpp ``odtp_sendall``/``odtp_recvall``)
with the GIL released when the native library is built.

Wire format: identical ODTP frames (diloco/wire.py), persistent connections
across rounds; each frame is acknowledged with a single byte so senders get
backpressure parity with the RPC path.

Large frames stripe over several parallel TCP streams (``ODTP_BULK_STREAMS``,
payloads >= ``ODTP_BULK_STRIPE_MIN`` bytes): a single TCP stream tops out
well below the path capacity (kernel-measured ~2.1 GB/s loopback here; WAN
paths are window/BBR-limited the same way), while k streams pump k slices
concurrently with the GIL released in the native sendall/recvall. The main
connection carries the frame header (with the stripe table and a session
id) plus slice 0 and the ack; sibling connections carry ``_stripe``
sub-frames that land via recv_into directly into their slice of the one
preallocated buffer -- reassembly is zero-copy.

The port's copy of ``opendiloco_tpu/diloco/bulk.py``, minus its obs
counters (ROADMAP.md A17), over the port's own host library
(:mod:`opendiloco_torch.native`). ``BulkServer.stop`` also shuts the
listening socket down, so its accept thread ends (in the JAX package it
stays blocked, holding its ``TcpBackend``).
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import struct
import threading
import time
import uuid
from typing import Callable, Optional

import numpy as np

from opendiloco_torch import native
from opendiloco_torch.diloco import chaos, linkstate
from opendiloco_torch.diloco.schema import (
    BULK_ACK as _ACK,
    FRAME_HDR as _HDR,
    MAGIC,
    MAX_HEADER,
    SO_TIMEVAL_FMT,
)
from opendiloco_torch.diloco.wire import WireError
from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)
def _stripe_wait_s() -> float:
    """Stripe channels must land within the transfer budget; tunable so a
    deployment with a known round budget can fail a lost stripe faster than
    the 5-minute default (the retry path then re-forms the group)."""
    try:
        return float(os.environ.get("ODTP_BULK_STRIPE_WAIT_S", "300"))
    except ValueError:
        return 300.0


_TOMBSTONE_S = 60.0  # how long finished session ids stay known-dead

# test seam: called with every received frame's type ("push", "result",
# "_stripe", ...) from BulkServer handler threads
_frame_observer: Optional[Callable[[str], None]] = None


class _BufferPool:
    """Pre-touched receive buffers, keyed by exact size.

    Receiving into a fresh ``np.empty`` pays a soft page fault per 4KB --
    ~100k faults on a 430MB frame, measured at 1.2 vs 2.1 GB/s loopback
    (the whole single-stream gap). Consumers hand buffers back through
    ``release_buffer`` once the payload is decoded; steady-state rounds
    then allocate nothing. Unreturned buffers are simply garbage-collected
    (the pool holds no reference to handed-out buffers).
    """

    def __init__(self, max_per_size: int = 4):
        self._free: dict[int, list[np.ndarray]] = {}
        self._lock = threading.Lock()
        self._max = max_per_size

    def get(self, n: int) -> np.ndarray:
        with self._lock:
            lst = self._free.get(n)
            if lst:
                return lst.pop()
        buf = np.empty(n, np.uint8)
        buf.fill(0)  # touch every page outside the receive path
        return buf

    def release(self, buf) -> None:
        # only whole pool-shaped buffers come back; views (codec "none"
        # decode output aliases the payload) and foreign types are ignored
        if (
            not isinstance(buf, np.ndarray)
            or buf.dtype != np.uint8
            or buf.base is not None
            or buf.ndim != 1
        ):
            return
        with self._lock:
            lst = self._free.setdefault(buf.size, [])
            if len(lst) < self._max:
                lst.append(buf)


_pool = _BufferPool()


def release_buffer(buf) -> None:
    """Return a bulk-received payload to the receive pool (no-op for
    payloads that did not come from it)."""
    _pool.release(buf)


class _TokenBucket:
    """Global egress rate cap emulating a constrained WAN link.

    ``ODTP_BULK_BANDWIDTH_BPS`` (bytes/second; unset or 0 = unlimited) caps
    the aggregate payload egress of this process across all bulk streams —
    the bench's stand-in for tc/netem where traffic shaping isn't
    permitted. Tokens are taken in chunks so concurrent stripes interleave
    fairly instead of one stream draining the bucket."""

    def __init__(self, rate_bps: float):
        self.rate = float(rate_bps)
        # ~50ms of burst, floor 1MB: small enough to shape the flow, large
        # enough not to turn every chunk into a sleep
        self.burst = max(self.rate * 0.05, float(1 << 20))
        self.tokens = self.burst
        self.t = time.monotonic()
        self.lock = threading.Lock()

    def acquire(self, n: int) -> None:
        remaining = float(n)
        while remaining > 0:
            take = min(remaining, self.burst)
            with self.lock:
                now = time.monotonic()
                self.tokens = min(
                    self.burst, self.tokens + (now - self.t) * self.rate
                )
                self.t = now
                if self.tokens >= take:
                    self.tokens -= take
                    remaining -= take
                    continue
                wait = (take - self.tokens) / self.rate
            time.sleep(min(wait, 0.25))


_rate_lock = threading.Lock()
_rate_bucket: Optional[_TokenBucket] = None
_rate_bps: float = -1.0


def egress_bucket() -> Optional[_TokenBucket]:
    """The process-wide egress bucket, rebuilt when the env knob changes
    (the bench sweeps several caps in one parent process). Shared with the
    asyncio RPC path: bytes that bypass the bulk plane (small frames, bulk
    fallback) must drain the same budget or capped bench rows lie.

    The chaos plane's ``egress_bps`` folds into the same bucket (the lower
    of the two caps binds): that is how a bench emulates a bandwidth-skewed
    galaxy — every worker shares ODTP_BULK_BANDWIDTH_BPS, one worker's
    ODTP_CHAOS tightens its own link."""
    global _rate_bucket, _rate_bps
    try:
        bps = float(os.environ.get("ODTP_BULK_BANDWIDTH_BPS", "0") or 0.0)
    except ValueError:
        bps = 0.0
    cp = chaos.plane()
    if cp is not None:
        cbps = cp.egress_bps()
        if cbps > 0:
            bps = min(bps, cbps) if bps > 0 else cbps
    with _rate_lock:
        if bps != _rate_bps:
            _rate_bps = bps
            _rate_bucket = _TokenBucket(bps) if bps > 0 else None
        return _rate_bucket


_wan_bucket: Optional[_TokenBucket] = None
_wan_bps: float = -1.0


def wan_bucket() -> Optional[_TokenBucket]:
    """The process-wide WAN-uplink bucket, armed only by the chaos plane's
    ``wan_bps``. Separate from :func:`egress_bucket` by design: frames to
    WAN-classified destinations (``chaos wan_peers`` globs, consulted by
    the tcp layer) drain BOTH buckets — a worker's NIC and its site's
    shared uplink are distinct constraints, and the hierarchical bench
    relies on intra-site traffic paying only the first."""
    global _wan_bucket, _wan_bps
    cp = chaos.plane()
    bps = cp.wan_bps() if cp is not None else 0.0
    with _rate_lock:
        if bps != _wan_bps:
            _wan_bps = bps
            _wan_bucket = _TokenBucket(bps) if bps > 0 else None
        return _wan_bucket


_THROTTLE_CHUNK = 1 << 20


def _send_payload(sock: socket.socket, data) -> None:
    """Payload sendall with the optional egress cap applied per-chunk."""
    bucket = egress_bucket()
    if bucket is None:
        native.sock_sendall(sock, data)
        return
    view = data if isinstance(data, memoryview) else memoryview(data)
    view = view.cast("B")
    for off in range(0, len(view), _THROTTLE_CHUNK):
        chunk = view[off : off + _THROTTLE_CHUNK]
        bucket.acquire(len(chunk))
        native.sock_sendall(sock, chunk)


def _num_streams() -> int:
    try:
        return max(1, int(os.environ.get("ODTP_BULK_STREAMS", "4")))
    except ValueError:
        return 1


def _stripe_min() -> int:
    try:
        return int(os.environ.get("ODTP_BULK_STRIPE_MIN", str(64 << 20)))
    except ValueError:
        return 64 << 20


def _tune(sock: socket.socket) -> None:
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 * 1024 * 1024)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 * 1024 * 1024)
    except OSError:
        pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = np.empty(n, np.uint8)
    native.sock_recvall(sock, buf)
    return buf.tobytes()


def send_frame_sync(
    sock: socket.socket, msg_type: str, meta: dict, payload=b""
) -> None:
    nbytes = (
        payload.nbytes if isinstance(payload, np.ndarray) else len(payload)
    )
    header = json.dumps(
        {"type": msg_type, "meta": meta, "payload_len": nbytes}
    ).encode()
    cp = chaos.plane()
    if cp is not None and nbytes and cp.truncate("bulk_send"):
        # mid-transfer truncation: the header promises nbytes but only half
        # go out before the "link" dies. The receiver wedges in recvall
        # until the dropped connection resets it; the sender's retry /
        # RPC-fallback machinery owns recovery.
        native.sock_sendall(sock, _HDR.pack(MAGIC, len(header)) + header)
        view = memoryview(payload).cast("B")
        native.sock_sendall(sock, view[: nbytes // 2])
        raise ConnectionResetError("chaos: bulk payload truncated mid-transfer")
    native.sock_sendall(sock, _HDR.pack(MAGIC, len(header)) + header)
    if nbytes:
        _send_payload(sock, payload)


def read_frame_sync(sock: socket.socket) -> tuple[str, dict, np.ndarray]:
    """Read one frame; the payload lands in a fresh numpy uint8 buffer
    (single allocation, received in place)."""
    hdr = _recv_exact(sock, _HDR.size)
    magic, hlen = _HDR.unpack(hdr)
    if magic != MAGIC or hlen > MAX_HEADER:
        raise WireError(f"bad bulk frame header: magic={magic!r} hlen={hlen}")
    header = json.loads(_recv_exact(sock, hlen))
    n = header.get("payload_len", 0)
    payload = np.empty(n, np.uint8)
    if n:
        native.sock_recvall(sock, payload)
    return header["type"], header.get("meta", {}), payload


class _Session:
    """Reassembly state for one striped frame.

    ``done`` / ``inflight`` exist for hedged transfers: a stripe may arrive
    twice (original + hedge copy, byte-identical), so completion is counted
    per stripe index, and the buffer is only handed to the consumer once no
    writer still holds a view into it."""

    __slots__ = ("views", "remaining", "failed", "done", "inflight", "hedged")

    def __init__(self, views: list, remaining: int, hedged: bool = False):
        self.views = views
        self.remaining = remaining
        self.failed = False
        self.done: set[int] = set()
        self.inflight = 0
        self.hedged = hedged


class BulkServer:
    """Accepts persistent bulk connections; one handler thread each.

    ``deliver(msg, meta, payload)`` is called from handler threads for every
    received frame (payload is a numpy uint8 buffer).
    """

    def __init__(self, deliver: Callable[[str, dict, np.ndarray], None], host: str):
        self._deliver = deliver
        self._sock = socket.create_server((host, 0))
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        self._sessions: dict[str, _Session] = {}
        # sid -> expiry: sessions that already completed or failed. A stripe
        # arriving after its session finished (sender retry, slow socket)
        # must fail fast instead of blocking its connection for the full
        # stripe wait while the sender's next round needs it.
        self._dead_sessions: dict[str, float] = {}
        self._sess_cond = threading.Condition()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="odtp-bulk-accept", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            _tune(conn)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._handle, args=(conn,), name="odtp-bulk-conn", daemon=True
            ).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    hdr = _recv_exact(conn, _HDR.size)
                    magic, hlen = _HDR.unpack(hdr)
                    if magic != MAGIC or hlen > MAX_HEADER:
                        raise WireError(f"bad bulk frame: magic={magic!r}")
                    header = json.loads(_recv_exact(conn, hlen))
                except ConnectionResetError:
                    return  # peer dropped the pooled connection: normal
                except (ConnectionError, OSError, WireError) as e:
                    # anything but a clean close means stream desync or a
                    # socket fault -- make it visible, the sender will see
                    # an unexplained EOF on its next ack read
                    log.warning("bulk conn dropped (%r)", e)
                    return
                if _frame_observer is not None:
                    _frame_observer(header["type"])
                if header["type"] == "_stripe":
                    # stripe channel: bytes land straight in the session
                    # buffer; no ack (the main connection acks the frame)
                    self._read_stripe(conn, header)
                    continue
                n = header.get("payload_len", 0)
                if header.get("stripe_lens"):
                    payload = self._assemble(conn, header)
                else:
                    payload = _pool.get(n)
                    if n:
                        native.sock_recvall(conn, payload)
                self._deliver(header["type"], header.get("meta", {}), payload)
                native.sock_sendall(conn, _ACK)
        except Exception:
            if not self._stop.is_set():
                log.exception("bulk handler error")
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _read_stripe(self, conn: socket.socket, header: dict) -> None:
        sid, j = header["session"], header["stripe"]
        deadline = time.monotonic() + _stripe_wait_s()
        with self._sess_cond:
            while sid not in self._sessions:
                if sid in self._dead_sessions:  # tombstoned
                    if header.get("hedge") and header.get("len") is not None:
                        # late copy of a stripe whose sibling already
                        # completed the session: the bytes are in flight on
                        # this connection, so drain them to keep the stream
                        # in sync instead of killing the pooled connection
                        break
                    raise WireError(f"stripe {j} for finished session {sid}")
                left = deadline - time.monotonic()
                if left <= 0 or self._stop.is_set():
                    raise WireError(f"stripe {j} for unknown session {sid}")
                self._sess_cond.wait(timeout=min(left, 1.0))
            sess = self._sessions.get(sid)
            if sess is not None:
                sess.inflight += 1
        if sess is None:
            n = int(header["len"])
            scratch = _pool.get(n)
            try:
                if n:
                    native.sock_recvall(conn, scratch)
            finally:
                _pool.release(scratch)
            return
        try:
            # duplicate arrivals (hedge + original) carry identical bytes,
            # so receiving into the view unconditionally is benign; only
            # the first arrival advances ``remaining``
            native.sock_recvall(conn, sess.views[j])
        except Exception:
            with self._sess_cond:
                sess.inflight -= 1
                if not sess.hedged:
                    # a hedged sender may still deliver this stripe via its
                    # hedge copy; don't poison the session on one bad leg
                    sess.failed = True
                self._sess_cond.notify_all()
            raise
        with self._sess_cond:
            sess.inflight -= 1
            if j not in sess.done:
                sess.done.add(j)
                sess.remaining -= 1
            self._sess_cond.notify_all()

    def _assemble(self, conn: socket.socket, header: dict) -> np.ndarray:
        """Main-connection side of a striped frame: allocate the full
        buffer, register the session, receive slice 0, wait for siblings."""
        lens = header["stripe_lens"]
        sid = header["session"]
        payload = _pool.get(header["payload_len"])
        offs = [0]
        for ln in lens:
            offs.append(offs[-1] + ln)
        views = [payload[offs[i] : offs[i + 1]] for i in range(len(lens))]
        sess = _Session(
            views, remaining=len(lens) - 1, hedged=bool(header.get("hedged"))
        )
        with self._sess_cond:
            self._sessions[sid] = sess
            self._sess_cond.notify_all()
        try:
            native.sock_recvall(conn, views[0])
            deadline = time.monotonic() + _stripe_wait_s()
            with self._sess_cond:
                # wait for every stripe AND for every writer to let go of
                # its view: a slow duplicate writer must not scribble into
                # the buffer after it is handed out (and pooled/reused)
                while (
                    sess.remaining > 0 or sess.inflight > 0
                ) and not sess.failed:
                    left = deadline - time.monotonic()
                    if left <= 0 or self._stop.is_set():
                        raise WireError(f"striped frame {sid} timed out")
                    self._sess_cond.wait(timeout=min(left, 1.0))
                if sess.failed:
                    raise WireError(f"striped frame {sid} lost a stripe")
        finally:
            with self._sess_cond:
                self._sessions.pop(sid, None)
                now = time.monotonic()
                self._dead_sessions[sid] = now + _TOMBSTONE_S
                for k in [
                    k for k, t in self._dead_sessions.items() if t < now
                ]:
                    del self._dead_sessions[k]
                self._sess_cond.notify_all()
        return payload

    def stop(self) -> None:
        self._stop.set()
        try:
            # on Linux close() alone leaves a thread blocked in accept()
            # there, holding the server (and its deliver callback's owner)
            # for the life of the process; shutdown() wakes it
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            for c in list(self._conns):
                try:
                    c.close()
                except OSError:
                    pass


class BulkSender:
    """Persistent outgoing bulk connections (a stream group per
    destination), with a per-destination lock serializing frames."""

    _session_counter = itertools.count()

    def __init__(self, connect_timeout: float = 10.0):
        self._timeout = connect_timeout
        self._conns: dict[tuple, list[socket.socket]] = {}
        self._locks: dict[tuple, threading.Lock] = {}
        self._meta_lock = threading.Lock()
        self._id = uuid.uuid4().hex[:12]
        # per-destination link estimates (bps, rtt_s) fed by the adaptive
        # layer (tcp.py) and a multiplicative stripe-count backoff applied
        # on top of the BDP plan when a striped send fails
        self._links: dict[tuple, tuple[float, float]] = {}
        self._stripe_scale: dict[tuple, float] = {}

    def set_link(self, host: str, port: int, bps: float, rtt_s: float) -> None:
        """Record the current link estimate toward one destination; used to
        derive stripe counts from bandwidth-delay product when
        ODTP_LINK_ADAPT is on."""
        with self._meta_lock:
            self._links[(host, port)] = (float(bps), float(rtt_s))

    def _plan_streams(self, key: tuple, nbytes: int) -> int:
        # a hint only exists when the owning backend runs adaptive (config
        # kwarg or ODTP_LINK_ADAPT) — its presence is the gate
        with self._meta_lock:
            hint = self._links.get(key)
            scale = self._stripe_scale.get(key, 1.0)
        if hint is not None and hint[0] > 0:
            streams = linkstate.stripes_for(nbytes, hint[0], hint[1])
        else:
            streams = _num_streams()
        return max(1, int(streams * scale))

    def _scale_stripes(self, key: tuple, ok: bool) -> None:
        """Multiplicative backoff on striped-send failure, slow recovery on
        success (halve / grow 25%, clamped to [1/8, 1])."""
        with self._meta_lock:
            s = self._stripe_scale.get(key, 1.0)
            s = min(1.0, s * 1.25) if ok else max(0.125, s * 0.5)
            self._stripe_scale[key] = s

    def _connect(self, host: str, port: int) -> socket.socket:
        sock = socket.create_connection((host, port), timeout=self._timeout)
        # keep the socket BLOCKING (settimeout would flip it to
        # non-blocking and break the native C recv/send path);
        # bound hangs with kernel-level timeouts instead
        sock.settimeout(None)
        tv = struct.pack(SO_TIMEVAL_FMT, 300, 0)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
        _tune(sock)
        return sock

    def _get_conns(self, key: tuple, n: int) -> list[socket.socket]:
        conns = self._conns.setdefault(key, [])
        while len(conns) < n:
            conns.append(self._connect(*key))
        return conns

    def send(
        self,
        host: str,
        port: int,
        msg: str,
        meta: dict,
        payload,
        *,
        lock_timeout: float = 30.0,
        align: int = 1,
    ) -> None:
        key = (host, port)
        with self._meta_lock:
            lock = self._locks.setdefault(key, threading.Lock())
        # bounded wait: a zombie transfer from a timed-out round must not
        # wedge the retry forever (the caller falls back / re-forms the group)
        if not lock.acquire(timeout=lock_timeout):
            raise TimeoutError(f"bulk destination {key} busy")
        try:
            nbytes = (
                payload.nbytes if isinstance(payload, np.ndarray) else len(payload)
            )
            streams = self._plan_streams(key, nbytes)
            striped = streams > 1 and nbytes >= max(_stripe_min(), streams)
            cp = chaos.plane()
            for attempt in (0, 1):
                if cp is not None:
                    d = cp.delay_s("bulk_send") + cp.straggle_s()
                    if d:
                        time.sleep(d)
                    if cp.drop_conn("bulk_send"):
                        self._drop(key)
                        if attempt == 1:
                            raise ConnectionResetError(
                                "chaos: bulk connection dropped"
                            )
                        continue
                try:
                    if striped:
                        self._send_striped(
                            key, msg, meta, payload, streams, align
                        )
                        self._scale_stripes(key, ok=True)
                    else:
                        sock = self._get_conns(key, 1)[0]
                        send_frame_sync(sock, msg, meta, payload)
                        self._await_ack(sock)
                    return
                except (ConnectionError, OSError, WireError):
                    # stale pooled connections: reconnect once, then give up
                    self._drop(key)
                    if striped:
                        self._scale_stripes(key, ok=False)
                    if attempt == 1:
                        raise
        finally:
            lock.release()

    def _await_ack(self, sock: socket.socket) -> None:
        ack = np.empty(1, np.uint8)
        native.sock_recvall(sock, ack)
        if ack[0] != _ACK[0]:
            raise WireError(f"bad bulk ack {ack[0]!r}")

    def stream(
        self, host: str, port: int, *, lock_timeout: float = 30.0
    ) -> "BulkStream":
        """Open a pipelined chunk stream to one destination.

        The destination lock is held for the stream's whole lifetime (chunk
        frames from two rounds must not interleave on one connection);
        ``BulkStream.close`` releases it. On connect failure the lock is
        released here and the caller falls back to the RPC path."""
        key = (host, port)
        with self._meta_lock:
            lock = self._locks.setdefault(key, threading.Lock())
        if not lock.acquire(timeout=lock_timeout):
            raise TimeoutError(f"bulk destination {key} busy")
        try:
            sock = self._get_conns(key, 1)[0]
        except BaseException:
            self._drop(key)
            lock.release()
            raise
        return BulkStream(self, key, lock, sock)

    def _send_striped(
        self, key: tuple, msg: str, meta: dict, payload, streams: int,
        align: int = 1,
    ) -> None:
        """Pump ~equal contiguous slices over ``streams`` connections; the
        header (with the stripe table + session id) and slice 0 go on
        connection 0, which also carries the single ack.

        ``align`` (bytes) rounds the stripe step up so every boundary lands
        on a wire-record multiple of the payload's codec (f32/f16 element
        width, topk's u32+f32 records; packed-nibble payloads are already
        byte-granular) — stripe boundaries then never split an encoded
        record, whatever order the receiver lands them in.

        With a link estimate and ODTP_LINK_ADAPT on, the send is *hedged*:
        a stripe still in flight past a deadline derived from the estimated
        bandwidth/RTT is re-dispatched over an idle connection, first
        arrival wins (the receiver dedups per stripe index)."""
        data = memoryview(payload).cast("B")
        n = len(data)
        conns = self._get_conns(key, streams)
        sid = f"{self._id}-{next(self._session_counter)}"
        step = -(-n // streams)
        if align > 1:
            step += (-step) % align
        offs = [min(i * step, n) for i in range(streams + 1)]
        lens = [offs[i + 1] - offs[i] for i in range(streams)]

        hedge_s = 0.0
        with self._meta_lock:
            hint = self._links.get(key)
        if hint is not None and hint[0] > 0:
            hedge_s = linkstate.hedge_deadline_s(
                max(lens), hint[0], hint[1], streams
            )
        hedged = hedge_s > 0.0 and streams > 1

        header = json.dumps(
            {
                "type": msg,
                "meta": meta,
                "payload_len": n,
                "stripe_lens": lens,
                "session": sid,
                **({"hedged": 1} if hedged else {}),
            }
        ).encode()
        errors: list[BaseException] = []
        done = [threading.Event() for _ in range(streams)]

        def pump(j: int) -> None:
            try:
                sub = json.dumps(
                    {"type": "_stripe", "session": sid, "stripe": j,
                     "len": lens[j]}
                ).encode()
                native.sock_sendall(conns[j], _HDR.pack(MAGIC, len(sub)) + sub)
                if lens[j]:
                    _send_payload(conns[j], data[offs[j] : offs[j + 1]])
                done[j].set()
            except BaseException as e:  # surfaced on the main thread
                errors.append((j, e))

        threads = [
            threading.Thread(target=pump, args=(j,), daemon=True)
            for j in range(1, streams)
        ]
        for t in threads:
            t.start()
        native.sock_sendall(conns[0], _HDR.pack(MAGIC, len(header)) + header)
        if lens[0]:
            _send_payload(conns[0], data[offs[0] : offs[1]])
        done[0].set()
        if not hedged:
            for t in threads:
                t.join()
            if errors:
                raise errors[0][1]
            self._await_ack(conns[0])
            return
        # hedged path: give laggards until the deadline, then re-send any
        # stripe that has not completed (slow OR failed leg) over an idle
        # pooled connection / a fresh dial. The ack still rides conn 0 and
        # is the single source of truth for delivery.
        deadline = time.monotonic() + hedge_s
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        laggards = [j for j in range(1, streams) if not done[j].is_set()]
        hedged_ok: set[int] = set()
        for hedge_idx, j in enumerate(laggards):
            try:
                self._hedge_stripe(
                    key, sid, j, data[offs[j] : offs[j + 1]],
                    conns, streams + hedge_idx,
                )
                hedged_ok.add(j)
            except Exception as e:
                log.warning("stripe %d hedge to %s failed (%s)", j, key, e)
        # a stripe whose original leg already errored AND whose hedge failed
        # can never arrive -- fail fast instead of blocking on the ack
        dead = [e for j, e in list(errors) if j not in hedged_ok]
        if dead:
            raise dead[0]
        self._await_ack(conns[0])
        # bounded cleanup: original legs usually finish right behind the
        # hedge; a leg wedged past that is a dead socket — drop the pool so
        # the zombie writer errors out instead of corrupting a later frame
        for t in threads:
            t.join(5.0)
        if any(t.is_alive() for t in threads):
            log.warning("bulk stripes to %s wedged after hedge; dropping", key)
            self._drop(key)
        elif errors:
            # ack arrived, so delivery completed via the hedge copies; the
            # sockets behind the failed legs are still suspect for reuse
            log.warning(
                "bulk send to %s recovered via hedging (%d failed leg(s))",
                key, len(errors),
            )
            self._drop(key)

    def _hedge_stripe(
        self,
        key: tuple,
        sid: str,
        j: int,
        view,
        conns: list,
        idle_idx: int,
    ) -> None:
        """Re-dispatch stripe ``j`` over the fastest idle connection: a
        pooled connection beyond the active stripe set (already-warm TCP
        window) when one exists, else a fresh dial that joins the pool."""
        if idle_idx < len(conns):
            sock = conns[idle_idx]
        else:
            sock = self._connect(*key)
            conns.append(sock)
        sub = json.dumps(
            {"type": "_stripe", "session": sid, "stripe": j,
             "len": len(view), "hedge": 1}
        ).encode()
        native.sock_sendall(sock, _HDR.pack(MAGIC, len(sub)) + sub)
        if len(view):
            _send_payload(sock, view)

    def _drop(self, key: tuple) -> None:
        for sock in self._conns.pop(key, []):
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._meta_lock:
            for key in list(self._conns):
                self._drop(key)


class BulkStream:
    """One destination's bulk connection held across a part's chunk frames.

    Frames are pipelined with a bounded ack window: chunk k's ack is only
    collected once k+`window` frames are on the wire, so the socket never
    idles between chunks while the server's per-frame ack still provides
    end-of-stream backpressure (``close`` drains the remainder). Any
    send/ack error poisons the stream and drops the pooled connection; the
    caller re-sends outstanding chunks through the RPC path."""

    def __init__(
        self,
        sender: BulkSender,
        key: tuple,
        lock: threading.Lock,
        sock: socket.socket,
        window: int = 2,
    ):
        self._sender = sender
        self._key = key
        self._lock = lock
        self._sock = sock
        self._window = max(1, window)
        self._pending = 0
        self._broken = False
        self._released = False

    def send(self, msg: str, meta: dict, payload) -> None:
        if self._broken:
            raise WireError(f"bulk stream to {self._key} is broken")
        cp = chaos.plane()
        if cp is not None:
            d = cp.delay_s("bulk_stream") + cp.straggle_s()
            if d:  # write-side latency on the pipelined chunk path
                time.sleep(d)
        try:
            send_frame_sync(self._sock, msg, meta, payload)
            self._pending += 1
            while self._pending >= self._window:
                self._sender._await_ack(self._sock)
                self._pending -= 1
        except BaseException:
            self._broken = True
            self._sender._drop(self._key)
            raise

    def close(self) -> None:
        """Drain outstanding acks and release the destination lock.

        A drain failure drops the pooled connection but does NOT raise:
        every frame was already written (send() errors are fatal and
        re-routed by the caller), and the acks are backpressure, not a
        delivery guarantee — delivery is enforced end-to-end by the
        receiver's mailbox timeout and the round retry machinery. Failing
        the sender's round here over a lost trailing ack was observed to
        desync an otherwise-complete 8-worker round: every receiver had the
        data, only this peer re-formed, and the swarm phase-shifted."""
        try:
            if not self._broken:
                try:
                    while self._pending:
                        self._sender._await_ack(self._sock)
                        self._pending -= 1
                except Exception as e:
                    self._broken = True
                    self._sender._drop(self._key)
                    log.warning(
                        "bulk stream to %s: %d trailing ack(s) lost at "
                        "close (%s); connection dropped",
                        self._key, self._pending, e,
                    )
        finally:
            if not self._released:
                self._released = True
                self._lock.release()
