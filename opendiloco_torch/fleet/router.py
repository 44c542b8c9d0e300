"""Front-end router: one ingress over a galaxy of serving replicas.

The port's copy of ``opendiloco_tpu/fleet/router.py``. It speaks the two
protocols of ``serve/server.py`` (HTTP ``POST /generate`` and JSONL), so
a client cannot tell a fleet from one replica, and it fronts replicas of
either package. Dispatch is least-loaded with a prefix-affinity
override: a request sharing a long prompt prefix with one a replica
served recently goes there, where the prefix cache is warm, unless that
replica is clearly busier than the least-loaded one. With the prefix
directory on, the prefixes replicas advertise in their health frames
decide first.

A replica's death is a non-event: a connection error (or a retryable
reject) marks the backend dead and the request goes to another replica,
so the client sees one answer as long as any replica lives. A probe
thread polls dead backends' ``/healthz`` with an exponential, jittered
backoff, so a replica that rejoins takes traffic again with no
registration call; replicas that report themselves ``stale`` get traffic
only when nothing fresh lives. A request whose deadline cannot be met is
shed at the edge (HTTP 503 with ``Retry-After``).

The router moves JSON lines between sockets: no engine, no tensors.
Armed (``ODTP_OBS``), it reports what the JAX router reports: dispatch,
redispatch, shed, affinity, directory, death and rejoin counters, the
``fleet_replicas_live`` gauge, the dead-peer watchdog on a death, and one
request trace a request (minted here, or adopted from upstream) whose
context rides every forward attempt, so a request moved off a dead replica
keeps one trace across both replicas.
"""
from __future__ import annotations

import collections
import json
import logging
import random
import socket
import threading
import time
from typing import Optional

from opendiloco_torch import obs
from opendiloco_torch.obs import reqtrace
from opendiloco_torch.serve.kvcache import common_prefix_len, prefix_grid_lengths, prefix_key

log = logging.getLogger(__name__)


def _bind_with_fallback(host: str, port: int, what: str) -> socket.socket:
    """``serve.server.bind_with_fallback`` without its retry: the router's
    ingress port is bound once."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        sock.bind((host, port))
    except OSError as e:
        if port == 0:
            sock.close()
            raise
        log.warning(
            "%s port %d unavailable (%s); falling back to an ephemeral port",
            what,
            port,
            e,
        )
        sock.bind((host, 0))
    return sock

_HTTP_VERBS = (b"GET ", b"POST", b"PUT ", b"HEAD", b"DELE", b"OPTI", b"PATC")

# replica-side rejects worth trying on another replica; anything else is
# the request's own fault (bad prompt, too long) and is returned as-is
_RETRYABLE = ("server stopped", "queue full", "timeout")


class _Backend:
    def __init__(self, rid: str, host: str, port: int):
        self.rid = rid
        self.host = host
        self.port = int(port)
        self.dead = False
        self.stale = False
        self.ready = True
        self.inflight = 0
        self.dispatched = 0
        # health-probe pacing: next due time and current interval. The
        # interval backs off exponentially while the backend stays dark
        # and snaps back on contact; jitter on every reschedule keeps a
        # mass revive from synchronizing into a probe thundering herd.
        self.probe_at = 0.0
        self.probe_backoff = 0.0
        self.lock = threading.Lock()
        self.pool: list[socket.socket] = []
        # recent prompts, newest last: the affinity signal for warm-KV
        # routing (mirrors what the replica's prefix cache may still hold)
        self.recent: collections.deque = collections.deque(maxlen=32)
        # prefix-directory advertisement: (key, glen) entries this replica
        # last reported resident in its host KV tier (wholesale-replaced
        # on every health frame — the replica is the source of truth)
        self.prefixes: set = set()

    def acquire(self, timeout: float) -> socket.socket:
        with self.lock:
            if self.pool:
                return self.pool.pop()
        conn = socket.create_connection((self.host, self.port), timeout=2.0)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(timeout)
        return conn

    def release(self, conn: socket.socket) -> None:
        with self.lock:
            if not self.dead and len(self.pool) < 8:
                self.pool.append(conn)
                return
        try:
            conn.close()
        except OSError:
            pass

    def close_pool(self) -> None:
        with self.lock:
            pool, self.pool = self.pool, []
        for conn in pool:
            try:
                conn.close()
            except OSError:
                pass


class FleetRouter:
    def __init__(
        self,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout: float = 120.0,
        affinity_min_tokens: int = 8,
        affinity_max_extra_inflight: int = 2,
        probe_interval_s: float = 1.0,
        prefix_directory: bool = False,
    ):
        self.request_timeout = float(request_timeout)
        self.affinity_min_tokens = int(affinity_min_tokens)
        self.affinity_max_extra_inflight = int(affinity_max_extra_inflight)
        self.probe_interval_s = float(probe_interval_s)
        # fleet prefix-cache directory: (key, glen) -> rids holding that
        # prompt-prefix K/V in their host tier. Fed by replica health
        # advertisements (update_prefixes), consulted by _pick ahead of
        # the recent-prompt heuristic — an exact content-hash match beats
        # a guess — and invalidated on replica death/removal so a killed
        # holder's entries re-route instead of dangling.
        self.prefix_directory = bool(prefix_directory)
        self._prefix_dir: dict[tuple, set] = {}
        self.directory_hits = 0
        self.directory_misses = 0
        # dead-backend probes back off exponentially up to this cap
        self.probe_backoff_cap_s = max(8 * self.probe_interval_s, 10.0)
        self._rng = random.Random(0xD15C0)
        self._backends: dict[str, _Backend] = {}
        self._lock = threading.Lock()
        self.redispatches = 0
        self.deaths = 0
        self.shed = 0
        # latency floor: fastest recent completed dispatch. A request
        # whose remaining deadline budget is below even this is provably
        # unmeetable and is shed at the edge instead of queue-timing-out.
        self._done_lat: collections.deque = collections.deque(maxlen=128)
        self._stop = threading.Event()
        self._sock = _bind_with_fallback(host, port, "fleet-router")
        self._sock.listen(64)
        self.host = host
        self.port = self._sock.getsockname()[1]
        threading.Thread(
            target=self._accept_loop, name="odtp-fleet-router", daemon=True
        ).start()
        threading.Thread(
            target=self._probe_loop, name="odtp-fleet-probe", daemon=True
        ).start()

    # -- membership ----------------------------------------------------------

    def add_replica(self, rid: str, host: str, port: int) -> None:
        b = _Backend(rid, host, port)
        self._reschedule_probe(b)  # first probe one jittered interval out
        with self._lock:
            self._backends[rid] = b
        self._publish_live()

    def remove_replica(self, rid: str) -> None:
        with self._lock:
            b = self._backends.pop(rid, None)
            if b is not None:
                self._drop_directory_locked(b)
        if b is not None:
            b.close_pool()
        self._publish_live()

    # -- prefix-cache directory ----------------------------------------------

    def update_prefixes(self, rid: str, entries: list) -> None:
        """Adopt a replica's host-tier prefix advertisement (health-frame
        ``prefixes`` field): wholesale replace — entries the replica no
        longer reports (LRU-dropped, epoch-purged) leave the directory."""
        if not self.prefix_directory:
            return
        new = {(str(k), int(g)) for k, g in entries}
        with self._lock:
            b = self._backends.get(rid)
            if b is None:
                return
            for kk in b.prefixes - new:
                holders = self._prefix_dir.get(kk)
                if holders is not None:
                    holders.discard(rid)
                    if not holders:
                        del self._prefix_dir[kk]
            for kk in new - b.prefixes:
                self._prefix_dir.setdefault(kk, set()).add(rid)
            b.prefixes = new

    def _drop_directory_locked(self, b: _Backend) -> None:
        """Invalidate every directory entry naming ``b`` (caller holds
        self._lock): a dead/removed holder must not attract traffic."""
        for kk in b.prefixes:
            holders = self._prefix_dir.get(kk)
            if holders is not None:
                holders.discard(b.rid)
                if not holders:
                    del self._prefix_dir[kk]
        b.prefixes = set()

    def _directory_pick(self, prompt: list, cands: list) -> Optional[_Backend]:
        """Longest-prefix directory holder among ``cands`` within the
        affinity inflight slack, or None."""
        by_rid = {b.rid: b for b in cands}
        least = min(cands, key=lambda b: b.inflight)
        for glen in prefix_grid_lengths(len(prompt)):
            kk = (prefix_key(prompt, glen), glen)
            with self._lock:
                holders = list(self._prefix_dir.get(kk) or ())
            for rid in holders:
                b = by_rid.get(rid)
                if (
                    b is not None
                    and b.inflight
                    <= least.inflight + self.affinity_max_extra_inflight
                ):
                    self.directory_hits += 1
                    obs.count("fleet_directory_hits", replica=rid)
                    return b
        self.directory_misses += 1
        obs.count("fleet_directory_misses")
        return None

    def _publish_live(self) -> None:
        with self._lock:
            live = sum(1 for b in self._backends.values() if not b.dead)
        obs.gauge("fleet_replicas_live", live)

    # -- dispatch ------------------------------------------------------------

    def _candidates(self, exclude: set) -> list:
        with self._lock:
            backends = [
                b
                for b in self._backends.values()
                if b.rid not in exclude and not b.dead
            ]
        fresh = [b for b in backends if b.ready and not b.stale]
        return fresh or backends

    def _pick(self, prompt: list, exclude: set) -> Optional[_Backend]:
        cands = self._candidates(exclude)
        if not cands:
            return None
        if self.prefix_directory and len(prompt) >= self.affinity_min_tokens:
            b = self._directory_pick(prompt, cands)
            if b is not None:
                return b
        least = min(cands, key=lambda b: b.inflight)
        if len(prompt) >= self.affinity_min_tokens:
            best, best_p = None, 0
            for b in cands:
                for recent in b.recent:
                    p = common_prefix_len(prompt, recent)
                    if p > best_p:
                        best, best_p = b, p
            if (
                best is not None
                and best_p >= self.affinity_min_tokens
                and best.inflight
                <= least.inflight + self.affinity_max_extra_inflight
            ):
                obs.count("fleet_router_affinity_hits", replica=best.rid)
                return best
        return least

    def _forward(self, b: _Backend, payload: dict) -> dict:
        """One JSONL round trip on a pooled connection. The replica's
        JSONL handler answers one line at a time per connection, so a
        connection carries exactly one in-flight request."""
        conn = b.acquire(self.request_timeout)
        try:
            conn.sendall((json.dumps(payload) + "\n").encode())
            buf = b""
            while b"\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    raise OSError("replica closed mid-request")
                buf += chunk
            line, _, rest = buf.partition(b"\n")
            out = json.loads(line.decode())
        except (OSError, ValueError):
            try:
                conn.close()
            except OSError:
                pass
            raise
        if rest:
            # a pooled conn must be quiescent; drop it rather than reuse
            try:
                conn.close()
            except OSError:
                pass
        else:
            b.release(conn)
        return out

    def _latency_floor_s(self) -> Optional[float]:
        """Fastest recent completed dispatch — the provable minimum a new
        request could possibly take."""
        with self._lock:
            lats = list(self._done_lat)
        return min(lats) if lats else None

    def _shed(self, payload: dict, reason: str) -> dict:
        """Edge rejection: the client gets a structured answer NOW (with
        a back-off hint) instead of a doomed wait in some replica queue."""
        self.shed += 1
        obs.count("fleet_router_shed", reason=reason)
        floor = self._latency_floor_s() or 0.25
        out = {
            "error": "shed",
            "reason": reason,
            "retry_after_s": round(max(0.1, min(30.0, 2 * floor)), 3),
        }
        if payload.get("id") is not None:
            out["id"] = payload["id"]
        return out

    def dispatch(self, payload: dict) -> dict:
        """Route one request: shed it at the edge when its deadline cannot
        be met, else forward it to the picked replica; a connection error
        marks that replica dead and a retryable reject moves on, each time
        to a replica not yet tried, with the deadline's remaining budget."""
        # trace context: adopt one minted upstream, else mint at this edge
        # (the sampler may decline). The SAME context rides every forward
        # attempt — a replica SIGKILL mid-flight re-dispatches the request
        # with its history intact, so one request yields ONE trace
        # spanning both replicas instead of losing the first leg.
        rt = reqtrace.ring()
        tid = None
        if rt is not None:
            ctx = reqtrace.ctx_of(payload)
            if ctx is not None:
                tid = rt.adopt(ctx, at="router")
            else:
                ctx = rt.mint(at="router", req_id=payload.get("id"))
                tid = ctx["id"] if ctx else None
            payload = reqtrace.attach(payload, ctx)
        t_admit = time.perf_counter()
        prompt = [int(t) for t in payload.get("prompt") or []]
        deadline_ms = payload.get("deadline_ms")
        t_deadline = None
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
            t_deadline = time.monotonic() + deadline_ms / 1e3
            floor = self._latency_floor_s()
            if deadline_ms <= 0.0 or (
                floor is not None and deadline_ms / 1e3 < 0.9 * floor
            ):
                return self._traced_shed(
                    payload, "deadline unmeetable", rt, tid
                )
        tried: set = set()
        last_error = "no live replicas"
        with self._lock:
            attempts = max(1, 2 * len(self._backends))
        for _ in range(attempts):
            if t_deadline is not None:
                remaining = t_deadline - time.monotonic()
                if remaining <= 0:
                    return self._traced_shed(
                        payload, "deadline exhausted", rt, tid
                    )
                # the replica sees what budget is LEFT, not what the
                # client started with — its scheduler sheds the doomed
                payload = {
                    **payload, "deadline_ms": round(remaining * 1e3, 3),
                }
            b = self._pick(prompt, tried)
            if b is None:
                break
            if rt is not None and tid is not None:
                rt.span(
                    tid, "admit", t_admit, time.perf_counter(),
                    replica=b.rid, candidates=len(self._backends) - len(tried),
                    prompt_tokens=len(prompt),
                )
            b.inflight += 1
            t0 = time.monotonic()
            tf0 = time.perf_counter()
            try:
                out = self._forward(b, payload)
            except (OSError, ValueError) as e:
                last_error = f"replica {b.rid} failed: {e}"
                tried.add(b.rid)
                self._mark_dead(b)
                self.redispatches += 1
                obs.count("fleet_router_redispatch", replica=b.rid)
                if rt is not None and tid is not None:
                    rt.span(tid, "forward", tf0, time.perf_counter(),
                            replica=b.rid, error=str(e))
                    rt.event(tid, "redispatch", from_replica=b.rid,
                             cause="connection")
                t_admit = time.perf_counter()  # re-admission for the retry
                continue
            finally:
                b.inflight -= 1
            if out.get("error") == "deadline exceeded":
                if rt is not None and tid is not None:
                    rt.span(tid, "forward", tf0, time.perf_counter(),
                            replica=b.rid, error="deadline exceeded")
                return self._traced_shed(
                    payload, "deadline exceeded", rt, tid
                )
            if out.get("error") in _RETRYABLE:
                last_error = f"replica {b.rid}: {out['error']}"
                tried.add(b.rid)
                self.redispatches += 1
                obs.count("fleet_router_redispatch", replica=b.rid)
                if rt is not None and tid is not None:
                    rt.span(tid, "forward", tf0, time.perf_counter(),
                            replica=b.rid, error=out["error"])
                    rt.event(tid, "redispatch", from_replica=b.rid,
                             cause=out["error"])
                t_admit = time.perf_counter()
                continue
            if "error" not in out:
                self._done_lat.append(time.monotonic() - t0)
            b.dispatched += 1
            b.recent.append(prompt)
            obs.count("fleet_router_dispatch", replica=b.rid)
            if rt is not None and tid is not None:
                rt.span(tid, "forward", tf0, time.perf_counter(),
                        replica=b.rid)
                rt.finish(
                    tid,
                    "failed" if "error" in out else "done",
                    replica=b.rid,
                    tokens=len(out.get("tokens") or []),
                    redispatches=len(tried),
                )
            return out
        out = {"error": last_error}
        if payload.get("id") is not None:
            out["id"] = payload["id"]
        if rt is not None and tid is not None:
            rt.finish(tid, "failed", error=last_error,
                      redispatches=len(tried))
        return out

    def _traced_shed(
        self, payload: dict, reason: str, rt, tid
    ) -> dict:
        out = self._shed(payload, reason)
        if rt is not None and tid is not None:
            rt.event(tid, "shed", reason=reason)
            rt.finish(tid, "shed", reason=reason)
        return out

    def _mark_dead(self, b: _Backend) -> None:
        # idempotent under concurrency: two dispatch threads can watch the
        # same replica die mid-flight; exactly one performs the retire
        with self._lock:
            first = not b.dead
            b.dead = True
            if first:
                self.deaths += 1
                self._drop_directory_locked(b)
        if first:
            b.close_pool()
            obs.count("fleet_replica_deaths", replica=b.rid)
            wd = obs.anomaly.watchdog()
            if wd is not None:
                wd.fleet_replica_dead(b.rid)
            log.warning("fleet replica %s marked dead", b.rid)
        self._publish_live()

    # -- health probing ------------------------------------------------------

    def _probe(self, b: _Backend) -> None:
        try:
            conn = socket.create_connection((b.host, b.port), timeout=1.0)
        except OSError:
            if not b.dead:
                self._mark_dead(b)
            return
        try:
            conn.settimeout(2.0)
            conn.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
            raw = b""
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                raw += chunk
            body = raw.partition(b"\r\n\r\n")[2]
            health = json.loads(body.decode() or "{}")
        except (OSError, ValueError):
            if not b.dead:
                self._mark_dead(b)
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass
        if b.dead:
            log.info("fleet replica %s is back; resuming dispatch", b.rid)
            obs.count("fleet_replica_rejoins", replica=b.rid)
        b.dead = False
        b.stale = bool(health.get("stale", False))
        b.ready = bool(health.get("ready", True)) and bool(
            health.get("ok", True)
        )
        self._publish_live()

    def _reschedule_probe(self, b: _Backend) -> None:
        """Exponential backoff while dark, snap back on contact, ±25%
        jitter always — so an autoscaler mass revive never lines every
        probe up into a synchronized thundering herd."""
        if b.dead:
            base = b.probe_backoff or self.probe_interval_s
            b.probe_backoff = min(2 * base, self.probe_backoff_cap_s)
        else:
            b.probe_backoff = self.probe_interval_s
        jitter = 0.75 + 0.5 * self._rng.random()
        b.probe_at = time.monotonic() + b.probe_backoff * jitter

    def _probe_loop(self) -> None:
        tick = min(0.05, self.probe_interval_s / 4) or 0.05
        while not self._stop.wait(tick):
            now = time.monotonic()
            with self._lock:
                due = [
                    b for b in self._backends.values() if b.probe_at <= now
                ]
            for b in due:
                self._probe(b)
                self._reschedule_probe(b)

    # -- front-end server ----------------------------------------------------

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
            conn.settimeout(self.request_timeout)
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
            out = self.dispatch(payload)
            if out.get("error") == "shed":
                self._respond(
                    conn, 503, out,
                    headers={"Retry-After": str(out["retry_after_s"])},
                )
            else:
                self._respond(conn, 400 if "error" in out else 200, out)
        elif method == b"GET" and path.startswith(b"/healthz"):
            with self._lock:
                live = sum(1 for b in self._backends.values() if not b.dead)
                total = len(self._backends)
            self._respond(
                conn, 200, {"ok": live > 0, "live": live, "replicas": total}
            )
        elif method == b"GET" and path.startswith(b"/stats"):
            self._respond(conn, 200, self.stats())
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
                    out = self.dispatch(payload)
                conn.sendall((json.dumps(out) + "\n").encode())
            chunk = conn.recv(65536)
            if not chunk:
                return
            buf += chunk

    # -- introspection -------------------------------------------------------

    def dead_replicas(self) -> list:
        """Registered replicas currently marked dead (autoscaler input:
        these are replacement candidates, not scaling signals)."""
        with self._lock:
            return [rid for rid, b in self._backends.items() if b.dead]

    def live_replicas(self) -> list:
        with self._lock:
            return [rid for rid, b in self._backends.items() if not b.dead]

    def stats(self) -> dict:
        with self._lock:
            backends = dict(self._backends)
        with self._lock:
            dir_stats = (
                {
                    "entries": len(self._prefix_dir),
                    "hits": self.directory_hits,
                    "misses": self.directory_misses,
                }
                if self.prefix_directory
                else None
            )
        return {
            "port": self.port,
            "redispatches": self.redispatches,
            "deaths": self.deaths,
            "shed": self.shed,
            "prefix_directory": dir_stats,
            "replicas": {
                rid: {
                    "host": b.host,
                    "port": b.port,
                    "dead": b.dead,
                    "stale": b.stale,
                    "ready": b.ready,
                    "inflight": b.inflight,
                    "dispatched": b.dispatched,
                }
                for rid, b in backends.items()
            },
        }

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            backends = list(self._backends.values())
        for b in backends:
            b.close_pool()
