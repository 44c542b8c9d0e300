"""TCP (DCN) outer backend: the production hivemind equivalent.

Implements OuterBackend over plain TCP between TPU-VM hosts:

- bootstrap/registration + progress gossip via the rendezvous daemon
  (diloco/rendezvous.py), bootstrap UX = ``--initial-peers host:port``
  (reference multiaddr UX, README.md:80-95)
- per-epoch group formation with ``matchmaking_time`` (reference:
  hivemind_diloco.py:342,403)
- butterfly all-reduce of the flat pseudo-gradient buffer (hivemind
  DecentralizedAverager scheme: peer j owns part j; everyone pushes part j
  to j, j averages and returns it) so lossy wire compression is applied
  exactly twice regardless of group size
- timeout/retry semantics (``averaging_timeout``; failed rounds re-form the
  group without the dead peer, reference elasticity §5.3)
- late-joiner state download (``load_state_from_peers``,
  train_fsdp.py:348-349) served peer-to-peer

The asyncio event loop runs on a background thread; OuterBackend methods are
synchronous bridges (the training loop is synchronous host code).

The port's copy of ``opendiloco_tpu/diloco/tcp.py``, the wire bytes
unchanged, so port and JAX workers average in one group. Armed
(``ODTP_OBS``), it reports what the JAX package reports under the same
names: counters (``rdv_rpcs``, ``peer_frames``, ``wire_tx_bytes``/
``wire_rx_bytes`` with their ``_wan`` split, ``outer_raw_bytes``/
``outer_wire_bytes`` by codec through ``record_wire``,
``fetch_state_calls``), the ``outer/*`` spans, the ``outer/round`` record
and its gauges, the overseer's roll-up on every progress announce and its
merges of the members' rows, and the ``metrics``, ``health`` and
``reqtrace`` RPCs' armed bodies. Unarmed, each hook is one ``is None``
check and no wire byte changes. The per-round stage times (encode,
wire_send, wire_recv, accumulate) are always folded into
``last_round_health``, armed or not, and the armed tracer reads them
from there. The ``fleet`` RPC answers ``fleet.status()``, this process's
serving fleet (``{"enabled": False}`` without one). ``close`` also drops
the round-buffer pool. State payloads go through
:mod:`opendiloco_torch.diloco.state_io`. No torch call runs on the
event-loop thread: the backend moves host numpy buffers only.
"""

from __future__ import annotations

import asyncio
import contextvars
import os
import threading
import time
import uuid
from typing import Any, Callable, Optional

import numpy as np

from opendiloco_torch import obs
from opendiloco_torch.diloco import chaos, linkstate, planner
from opendiloco_torch.diloco.backend import AllReduceError, OuterBackend, PeerProgress
from opendiloco_torch.diloco.compression import (
    Codec,
    chunk_bounds,
    get_codec,
    record_wire,
)
from opendiloco_torch.diloco.schema import WIRE_VERSION, WIRE_VERSION_META_KEY
from opendiloco_torch.diloco.state_io import deserialize_state, serialize_state, state_codec
from opendiloco_torch.diloco.wire import (
    STREAM_LIMIT,
    WireError,
    check_plan,
    chunk_fields,
    chunk_span,
    read_frame,
    request,
    send_frame,
)
from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)


def _mailbox_key(msg: str, meta: dict) -> tuple:
    """Mailbox key for a push/result frame. Pipelined chunk frames append
    the chunk index; whole-part (serial) frames keep the 3-tuple key, so the
    two paths can never consume each other's traffic."""
    key = (
        meta["round"],
        msg,
        meta["part"] if msg == "result" else meta["from"],
    )
    if "chunk" in meta:
        key += (int(meta["chunk"]),)
    return key


def _pipeline_enabled() -> bool:
    """Chunk-pipelined exchange (default). ODTP_PIPELINE=0 restores the
    whole-part serial path. The flag must agree across the swarm: pipelined
    and serial peers key their mailbox frames differently and cannot
    complete a round together."""
    return os.environ.get("ODTP_PIPELINE", "1").lower() not in ("0", "false")


def _pipeline_chunk_elems() -> int:
    """Pipeline chunk size in elements (ODTP_PIPELINE_CHUNK_ELEMS overrides;
    ODTP_PIPELINE_CHUNK_MB, default 8, otherwise). Read per round so tests
    and benches can vary it without rebuilding backends."""
    env = os.environ.get("ODTP_PIPELINE_CHUNK_ELEMS")
    if env:
        return max(1, int(env))
    mb = float(os.environ.get("ODTP_PIPELINE_CHUNK_MB", "8"))
    return max(1, int(mb * (1 << 20)) // 4)


# per-round stage-time accumulator (encode, wire_send, wire_recv,
# accumulate), folded into the round's health row, which the armed
# tracer's ``outer/round`` record reads. A ContextVar, NOT a backend
# attribute: streaming fragment sync runs
# several all-reduce rounds CONCURRENTLY on one backend (one task per
# fragment), and each round task gets its own context copy — a shared
# slot would let round A's finally-clear null out round B's accumulator
# mid-round. Child tasks (asyncio.gather legs) inherit the round task's
# context at creation, so every exchange helper sees its own round's slot.
_STAGE: contextvars.ContextVar[Optional[obs.StageTimes]] = (
    contextvars.ContextVar("odtp_stage", default=None)
)


class TcpBackend(OuterBackend):

    def __init__(
        self,
        initial_peers: list[str],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        peer_id: Optional[str] = None,
        compression: str = "none",
        matchmaking_time: float = 5.0,
        rpc_timeout: float = 30.0,
        expect_peers: int = 0,
        link_adapt: Optional[bool] = None,
    ):
        if not initial_peers:
            raise ValueError("TcpBackend needs at least one rendezvous address")
        # ALL initial peers are usable rendezvous daemons; the swarm fails
        # over in list order when the current one dies (reference capability:
        # the hivemind DHT survives bootstrap-peer death, train_fsdp.py:205-212)
        self.rendezvous_list = [
            (h, int(p)) for h, p in (a.rsplit(":", 1) for a in initial_peers)
        ]
        self._rdv_idx = 0
        self._rdv_last_probe = 0.0
        # worker-hosted rendezvous addresses adopted during a total daemon
        # outage. These are EPHEMERAL (they die with the hosting worker and
        # their ports get recycled by the OS) and must never enter the
        # daemon-membership gossip: they are excluded from known_daemons
        # announces and pruned as soon as any real daemon serves again.
        self._worker_rdv_addrs: set[tuple[str, int]] = set()
        self._RDV_FAILBACK_S = float(os.environ.get("ODTP_RDV_FAILBACK_S", 60.0))
        self.host = host
        self.port = port
        self._peer_id = peer_id or f"peer-{uuid.uuid4().hex[:12]}"
        self.codec: Codec = get_codec(compression)
        self._state_codec = state_codec(self.codec)
        self.matchmaking_time = matchmaking_time
        self.rpc_timeout = rpc_timeout
        # round health ledger: one dict per completed outer round
        # (group_size, expected, elastic, retries, per-stage timings);
        # last_round_health mirrors the newest entry for cheap polling
        self.round_ledger: list[dict] = []
        self._ledger_cap = 256
        self.last_round_health: dict = {}
        # known swarm size: when > 0, the rendezvous closes the matchmaking
        # window as soon as this many joiners arrive instead of waiting out
        # the full window / trusting its (possibly stale) live-peer registry
        self.expect_peers = int(
            expect_peers or os.environ.get("ODTP_EXPECT_PEERS", 0) or 0
        )
        # adaptive outer transport (diloco/linkstate.py): per-peer link
        # telemetry + capacity-proportional butterfly partitioning. The
        # kwarg (config) forces it on; None defers to ODTP_LINK_ADAPT,
        # re-read per round so tests/benches can flip it on a live backend
        self._link_adapt = link_adapt
        self.links = linkstate.LinkEstimator(self._peer_id)

        # every worker is also a rendezvous node (hivemind's every-peer-is-
        # a-DHT-node property, train_fsdp.py:205-212): an embedded server,
        # advertised through the registry as rdv_port, lets the swarm
        # re-form on the lowest-peer-id worker after EVERY daemon dies.
        # ODTP_WORKER_RENDEZVOUS=0 opts out.
        self._rdv_fallback = None
        if os.environ.get("ODTP_WORKER_RENDEZVOUS", "1") not in ("0", "false"):
            from opendiloco_torch.diloco.rendezvous import RendezvousServer

            self._rdv_fallback = RendezvousServer(
                host=host, port=0, identity=f"worker-{self._peer_id}"
            ).start_in_thread()

        self._state_provider: Optional[Callable[[], dict]] = None
        # persistent peer connections: (host, port) -> (reader, writer);
        # per-key locks serialize frames on a connection (event-loop only)
        self._conn_pool: dict[tuple, tuple] = {}
        self._conn_locks: dict[tuple, asyncio.Lock] = {}
        # bulk data plane: large payloads bypass asyncio (diloco/bulk.py)
        self._bulk_threshold = int(os.environ.get("ODTP_BULK_THRESHOLD", 1 << 20))
        self._bulk_server = None
        self._bulk_sender = None
        self._bulk_ports: dict[tuple, Optional[int]] = {}
        if self._bulk_threshold > 0:
            from opendiloco_torch.diloco.bulk import BulkSender, BulkServer

            self._bulk_server = BulkServer(self._deliver_bulk, host)
            self._bulk_sender = BulkSender()
        # round-buffer pool: the flatten / accumulate / reassemble phases
        # each touch a full model-sized f32 buffer per round, and fresh
        # multi-GB allocations hit kernel page-fault/compaction stalls
        # (measured 0.1 GB/s worst-case vs ~1 GB/s into an existing buffer;
        # glibc munmaps >128KB frees, so every round refaults zeroed pages).
        # Buffers check out by exact element count and check back in when
        # the round (or the NEXT round, for buffers backing returned views)
        # is done. Reference analogue: hivemind averages into the outer
        # optimizer's persistent grad buffers (hivemind_diloco.py:68-119).
        self._free_bufs: dict[int, list[np.ndarray]] = {}
        # retired buffers keyed by round TAG: the next all_reduce with the
        # SAME tag reclaims them. Keying matters — streaming fragment sync
        # runs per-fragment rounds concurrently on this backend, and a
        # global retire list would let fragment B's entry reclaim the
        # buffer fragment A's caller is still reading views of.
        self._retired_bufs: dict[str, list[np.ndarray]] = {}
        self._pool_lock = threading.Lock()  # caller + event-loop threads
        self._progress_cache: list[PeerProgress] = []
        self._own_progress: Optional[PeerProgress] = None
        # full registry view (peer_id -> peer json) refreshed from every
        # rendezvous reply. Workers carry the swarm registry so a fresh
        # daemon can be repopulated on failover (the DHT property that every
        # hivemind peer holds the registry, train_fsdp.py:205-212): without
        # it, the first worker to fail over registers alone, the daemon sees
        # a one-peer swarm, and matchmaking closes rounds as solo groups
        self._peers_view: dict[str, dict] = {}
        # peer_id -> site index from the latest round plan, for WAN/intra
        # byte accounting. None (no topology view) counts every frame as
        # WAN — the honest reading for a flat swarm of unknown shape.
        self._round_site_of: Optional[dict[str, int]] = None
        # mailbox: (round, kind, sender_or_part) -> (meta, payload)
        self._mailbox: dict[tuple, tuple[dict, bytes]] = {}
        self._mailbox_cv: Optional[asyncio.Condition] = None

        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._started = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._thread_main, daemon=True)
        self._thread.start()
        if not self._started.wait(15) or self._startup_error:
            # a failed constructor is never close()d: release the embedded
            # rendezvous thread + socket or supervisor retry loops leak both
            if self._rdv_fallback is not None:
                self._rdv_fallback.stop()
            raise RuntimeError(f"TcpBackend failed to start: {self._startup_error}")

    # -- event loop thread -------------------------------------------------

    def _thread_main(self) -> None:
        try:
            asyncio.run(self._main())
        except Exception as e:  # pragma: no cover
            self._startup_error = e
            self._started.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._mailbox_cv = asyncio.Condition()
        try:
            self._server = await asyncio.start_server(
                self._handle_peer, self.host, self.port, limit=STREAM_LIMIT
            )
            self.port = self._server.sockets[0].getsockname()[1]
            _, meta, _ = await self._rdv_request(
                "register", self._register_meta(), timeout=self.rpc_timeout
            )
            self._note_peers(meta)
            log.info(
                "%s registered with rendezvous %s (%d peers known)",
                self._peer_id,
                self.rendezvous,
                len(meta.get("peers", [])),
            )
        except Exception as e:
            self._startup_error = e
            self._started.set()
            return
        self._started.set()
        async with self._server:
            try:
                await self._server.serve_forever()
            except asyncio.CancelledError:
                pass

    @property
    def rendezvous(self) -> tuple[str, int]:
        return self.rendezvous_list[self._rdv_idx]

    def _adaptive(self) -> bool:
        """Adaptive transport on? config kwarg wins, else the env switch."""
        if self._link_adapt is not None:
            return bool(self._link_adapt)
        return linkstate.enabled()

    def _progress_meta(self, progress: Optional[PeerProgress]) -> dict:
        """The ``progress`` dict for a rendezvous announce. When adaptive,
        this worker's link vector rides along: daemons store and replay
        progress verbatim, so the join_group reply hands every group member
        an identical snapshot of the galaxy's link matrix for free."""
        prog = {
            "epoch": progress.epoch if progress else 0,
            "samples": progress.samples if progress else 0,
            "samples_per_second": (
                progress.samples_per_second if progress else 0.0
            ),
            "timestamp": progress.timestamp if progress else 0.0,
        }
        if self._adaptive():
            prog["links"] = self.links.publish()
        ov = obs.overseer.plane()
        if ov is not None:
            # the overseer health roll-up rides the same verbatim-replayed
            # progress dict as the link vector: every register/progress
            # reply and join_group snapshot then carries it galaxy-wide
            # with no new connections (obs/overseer.py)
            roll = ov.rollup(capacity_bps=self.links.published_capacity())
            prog["health"] = roll
            ov.merge(self._peer_id, roll)
        return prog

    def _identity_meta(self) -> dict:
        """The registration identity triple+1: what a daemon needs to
        (re-)register this worker. Shared by register/progress announces
        AND the join_group meta (TTL-lapse transparent re-registration)."""
        return {
            "peer_id": self._peer_id,
            "host": self.host,
            "port": self.port,
            # the embedded rendezvous port rides the registry so every peer
            # knows where this worker can serve rendezvous if the daemons die
            "rdv_port": self._rdv_fallback.port if self._rdv_fallback else 0,
        }

    def _register_meta(self) -> dict:
        return {
            **self._identity_meta(),
            # workers carry the daemon membership the same way they carry
            # the peer registry: every announce tells the daemon which other
            # daemons this worker can reach, so membership learned anywhere
            # propagates everywhere. Worker-hosted fallback addresses are
            # NOT daemons: gossiping one would lodge a dead ephemeral port
            # in every daemon and worker forever once the hosting worker
            # exits (peers reach them via the registry's rdv_port instead)
            "known_daemons": [
                f"{h}:{p}"
                for h, p in self.rendezvous_list
                if (h, p) not in self._worker_rdv_addrs
            ],
        }

    def _note_daemons(self, meta: dict, source=None) -> None:
        """Adopt daemon addresses advertised in a rendezvous reply.

        APPEND semantics (unlike the peer registry's replace): the bootstrap
        list's order is the failover/failback preference, and a daemon this
        worker once knew may be the only one that survives -- dropping it
        because one reply omitted it would shrink the escape hatch. Dead
        daemons cost one fast connection-refused per failover sweep.

        Loopback guard: a daemon bound without --advertise defaults to
        advertising 127.0.0.1:<port>, which only means something on the
        daemon's own host. Adopting it from a REMOTE daemon would point this
        worker's failover at its own loopback (nothing there, or a different
        swarm's local daemon) -- so loopback addresses are only adopted when
        the daemon that advertised them is itself loopback (single-host
        deployments and tests); multi-host daemons must set --advertise.

        ``source`` is the daemon whose reply is being processed -- NOT
        necessarily the current preferred daemon (the failback probe
        announces to earlier-index daemons before switching to them).
        """
        src = source if source is not None else self.rendezvous
        talking_to_loopback = src[0] in ("127.0.0.1", "localhost")
        for a in meta.get("daemons", []):
            try:
                h, p = a.rsplit(":", 1)
                addr = (h, int(p))
            except (ValueError, AttributeError):
                continue
            if h in ("127.0.0.1", "localhost") and not talking_to_loopback:
                continue
            if addr in self._worker_rdv_addrs:
                continue  # ephemeral worker-hosted, never daemon membership
            if addr not in self.rendezvous_list:
                self.rendezvous_list.append(addr)
                log.info("learned rendezvous daemon %s:%d at runtime", *addr)

    def _note_peers(self, meta: dict, source=None) -> None:
        """Adopt a rendezvous reply's peer list as the carried registry.

        REPLACE semantics, not merge: the reply is the daemon's full live
        registry (and every failover/failback announce pushes this view
        before reading a reply, so the daemon already absorbed anything only
        this worker knew). Merging instead would resurrect peers that
        cleanly unregistered or TTL-expired, re-injecting them into daemons
        on every failover and stalling WAIT_FOR_ALL on departed workers.
        """
        self._note_daemons(meta, source=source)
        if "peers" not in meta:
            return
        view = {p["peer_id"]: p for p in meta["peers"] if p.get("peer_id")}
        if view:
            self._peers_view = view

    async def _announce_to(self, addr: tuple[str, int], timeout: float) -> None:
        """Register (and re-push progress) with a specific daemon, carrying
        the full registry view so a daemon that lost (or never had) the
        swarm's registrations recovers them from any single worker."""
        known = [
            p for pid, p in self._peers_view.items() if pid != self._peer_id
        ]
        _, meta, _ = await request(
            *addr,
            "register",
            {**self._register_meta(), "known_peers": known},
            timeout=timeout,
        )
        self._note_peers(meta, source=addr)
        if self._own_progress is not None:
            await request(
                *addr,
                "progress",
                {
                    **self._register_meta(),
                    "progress": self._progress_meta(self._own_progress),
                    "serves_state": self._state_provider is not None,
                },
                timeout=timeout,
            )

    async def _rdv_request(
        self, msg: str, meta: dict, payload: bytes = b"", *, timeout: float = None
    ) -> tuple[str, dict, bytes]:
        """Rendezvous RPC with failover.

        Convergence policy: every peer prefers the LOWEST-index live daemon
        in ``initial_peers``. On connection failure, rotate forward (retrying
        the same daemon once first if the failure was a bare timeout -- one
        slow RPC against a healthy daemon must not split the swarm); while
        running on a higher-index daemon, periodically probe the earlier
        ones and fail back, so peers that diverged onto different daemons
        re-converge within ``_RDV_FAILBACK_S`` seconds.
        """
        timeout = timeout or self.rpc_timeout
        obs.count("rdv_rpcs", msg=msg)
        # fail-back probe toward the preferred (lowest-index) daemon
        if self._rdv_idx != 0 and (
            time.monotonic() - self._rdv_last_probe > self._RDV_FAILBACK_S
        ):
            self._rdv_last_probe = time.monotonic()
            for k in range(self._rdv_idx):
                try:
                    await self._announce_to(
                        self.rendezvous_list[k], min(5.0, timeout)
                    )
                    log.info(
                        "rendezvous failback: %s is reachable again",
                        self.rendezvous_list[k],
                    )
                    self._rdv_idx = k
                    break
                except (OSError, asyncio.TimeoutError, EOFError, WireError):
                    continue

        last_err: Optional[Exception] = None
        retried_timeout = False
        attempts = 0
        cp = chaos.plane()
        while attempts < len(self.rendezvous_list):
            addr = self.rendezvous_list[self._rdv_idx]
            try:
                if cp is not None:
                    d = cp.delay_s("rdv_rpc")
                    if d:
                        await asyncio.sleep(d)
                    if cp.drop_conn("rdv_rpc"):
                        raise ConnectionResetError("chaos: rendezvous RPC dropped")
                resp = await request(*addr, msg, meta, payload, timeout=timeout)
                if self._worker_rdv_addrs and addr not in self._worker_rdv_addrs:
                    self._prune_worker_rdv(keep=addr)
                return resp
            # EOFError covers asyncio.IncompleteReadError: a daemon dying
            # WHILE this worker is parked in join_group closes the stream
            # mid-read (clean FIN, not ECONNRESET) -- that must fail over,
            # not crash the worker; WireError covers a torn partial frame
            # from the dying daemon
            except (OSError, asyncio.TimeoutError, EOFError, WireError) as e:
                last_err = e
                if isinstance(e, asyncio.TimeoutError) and not retried_timeout:
                    retried_timeout = True  # same daemon, one more chance
                    continue
                attempts += 1
                if len(self.rendezvous_list) == 1:
                    break
                self._rdv_idx = (self._rdv_idx + 1) % len(self.rendezvous_list)
                self._rdv_last_probe = time.monotonic()
                nxt = self.rendezvous_list[self._rdv_idx]
                log.warning(
                    "rendezvous %s unreachable (%s); failing over to %s",
                    addr,
                    e,
                    nxt,
                )
                try:
                    await self._announce_to(nxt, timeout)
                except Exception as reg_err:
                    last_err = reg_err
                    continue

        # every configured daemon is down: fall back to WORKER-hosted
        # rendezvous. All peers sort the same registry by peer_id, so the
        # swarm converges on the lowest-id live worker's embedded server;
        # the announce replicates this worker's registry into it, so
        # matchmaking never closes a solo round. The successful address is
        # appended to the failover list — the periodic failback probe still
        # prefers the real daemons (lower index) once any revives.
        # Gated on a non-empty registry view: a worker that NEVER reached a
        # daemon has no swarm to re-form and must fail loudly at startup,
        # not bootstrap a lonely one-peer swarm against itself.
        for addr in (
            self._worker_rendezvous_candidates() if self._peers_view else []
        ):
            try:
                await self._announce_to(addr, timeout)
                resp = await request(*addr, msg, meta, payload, timeout=timeout)
            except (OSError, asyncio.TimeoutError, EOFError, WireError) as e:
                last_err = e
                continue
            self._worker_rdv_addrs.add(addr)
            if addr not in self.rendezvous_list:
                self.rendezvous_list.append(addr)
            self._rdv_idx = self.rendezvous_list.index(addr)
            self._rdv_last_probe = time.monotonic()
            log.warning(
                "all rendezvous daemons down; swarm re-formed on "
                "worker-hosted rendezvous %s:%d",
                *addr,
            )
            return resp
        raise last_err if last_err else OSError("no rendezvous reachable")

    def _prune_worker_rdv(self, keep: tuple[str, int]) -> None:
        """A real daemon is serving again: drop adopted worker-hosted
        addresses from the failover list -- their ports are ephemeral (they
        die with the hosting worker and the OS recycles them), so keeping
        them would eventually aim announce sweeps at an unrelated process.
        ``keep`` is the daemon that just answered; re-aim _rdv_idx at it."""
        self.rendezvous_list = [
            a for a in self.rendezvous_list if a not in self._worker_rdv_addrs
        ]
        self._worker_rdv_addrs.clear()
        self._rdv_idx = self.rendezvous_list.index(keep)

    def _worker_rendezvous_candidates(self) -> list[tuple[str, int]]:
        """Peer-hosted rendezvous addresses from the carried registry (plus
        this worker's own embedded server), sorted by peer_id so every
        worker tries them in the same order and the swarm converges."""
        by_id: dict[str, tuple[str, int]] = {}
        for pid, p in self._peers_view.items():
            rp = int(p.get("rdv_port") or 0)
            if rp and p.get("host"):
                by_id[pid] = (p["host"], rp)
        if self._rdv_fallback is not None:
            by_id[self._peer_id] = (self.host, self._rdv_fallback.port)
        return [
            addr
            for _, addr in sorted(by_id.items())
            if addr not in self.rendezvous_list
        ]

    def _run(self, coro, timeout: Optional[float] = None):
        import concurrent.futures

        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(timeout)
        except concurrent.futures.TimeoutError:
            # kill the timed-out coroutine: a zombie all-reduce round would
            # keep consuming the retry's (round_key, fingerprint) mailbox
            # frames and starve it into AllReduceError
            fut.cancel()
            raise asyncio.TimeoutError(
                f"backend coroutine timed out after {timeout}s"
            ) from None

    # -- peer server ---------------------------------------------------------

    async def _handle_peer(self, reader, writer) -> None:
        """Serve frames until the peer hangs up: connections persist across
        rounds so bulk transfers keep a warmed-up TCP window instead of
        re-running slow-start on every push/result frame."""
        cp = chaos.plane()
        if cp is not None and cp.drop_conn("peer_accept"):
            # refuse the inbound connection outright: the client's pooled
            # connection dies and its retry/backoff paths take over
            writer.close()
            return
        try:
            while True:
                try:
                    msg, meta, payload = await read_frame(reader, timeout=300.0)
                except (
                    asyncio.IncompleteReadError,
                    ConnectionResetError,
                    asyncio.TimeoutError,  # idle between outer rounds
                ):
                    break
                obs.count("peer_frames", msg=msg)
                if msg in ("push", "result"):
                    if cp is not None:
                        d = cp.delay_s("mailbox")
                        if d:  # read-side latency before the frame lands
                            await asyncio.sleep(d)
                    key = _mailbox_key(msg, meta)
                    async with self._mailbox_cv:
                        self._mailbox[key] = (meta, payload)
                        self._gc_mailbox()
                        self._mailbox_cv.notify_all()
                    await send_frame(writer, "ok", {})
                elif msg == "probe":
                    # link micro-probe: empty payload = RTT sample, sized
                    # payload = bandwidth sample (the frame read above
                    # already drained it); the reply closes the timing
                    await send_frame(writer, "ok", {})
                elif msg == "bulk_hello":
                    await send_frame(
                        writer,
                        "ok",
                        {
                            "bulk_port": self._bulk_server.port
                            if self._bulk_server
                            else 0
                        },
                    )
                elif msg == "metrics":
                    # pull-based Prometheus text exposition on the existing
                    # per-worker control port (empty body when obs disarmed)
                    body = obs.export.prometheus_text(obs.tracer()).encode()
                    await send_frame(
                        writer, "ok", {"format": "prometheus-0.0.4"}, body
                    )
                elif msg == "health":
                    # this worker's converged overseer galaxy matrix, for
                    # odtp_top --watch (empty when obs disarmed)
                    ov = obs.overseer.plane()
                    await send_frame(
                        writer, "ok",
                        {"matrix": ov.matrix() if ov is not None else {}},
                    )
                elif msg == "reqtrace":
                    # this process's request-trace ring snapshot, for
                    # odtp_top --requests and the tail-latency report
                    # (None when ODTP_OBS is unset); old peers answer
                    # "error" for the unknown kind — callers treat both
                    # as "no reqtrace plane here"
                    rt = obs.reqtrace.ring()
                    await send_frame(
                        writer, "ok",
                        {
                            "reqtrace": (
                                rt.snapshot(
                                    recent=int(meta.get("recent", 32))
                                )
                                if rt is not None
                                else None
                            )
                        },
                    )
                elif msg == "async_offer":
                    # bounded-staleness matchmaking (async gossip): claim
                    # our standing offer for the sender if compatible;
                    # sync reply computed on the loop thread = atomic vs
                    # our own _async_pair_match between awaits
                    await send_frame(
                        writer, "ok", self._async_offer_reply(meta)
                    )
                elif msg == "fleet":
                    # the serving fleet's roll-up: publisher, router and
                    # replicas of this worker's plane ({"enabled": False}
                    # when no fleet runs here)
                    from opendiloco_torch import fleet as _fleet

                    await send_frame(writer, "ok", _fleet.status())
                elif msg == "fetch_state":
                    if self._state_provider is None:
                        await send_frame(writer, "error", {"error": "no state"})
                    else:
                        smeta, sblob = serialize_state(
                            self._state_provider(), codec=self._state_codec
                        )
                        await send_frame(writer, "state", smeta, sblob)
                else:
                    await send_frame(writer, "error", {"error": f"unknown {msg!r}"})
                    break  # stream sync can't be trusted past an unknown frame
        except Exception:
            log.exception("peer handler error")
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _peer_request(
        self,
        host: str,
        port: int,
        msg: str,
        meta: dict,
        payload: bytes = b"",
        *,
        timeout: float = 30.0,
    ) -> tuple[str, dict, bytes]:
        """RPC to a worker peer over a pooled persistent connection.

        One connection per peer, reused across frames and rounds; a stale
        connection (server dropped it while idle) is re-opened once. A
        timeout mid-transfer is NOT retried -- the caller's round retry
        logic owns that decision.
        """
        key = (host, port)
        lock = self._conn_locks.setdefault(key, asyncio.Lock())
        from opendiloco_torch.diloco.wire import _tune_socket

        cp = chaos.plane()
        for attempt in (0, 1):
            if cp is not None:
                d = cp.delay_s("peer_rpc")
                if d:
                    await asyncio.sleep(d)
                if cp.drop_conn("peer_rpc"):
                    # simulate the connection dying under us: drop the pooled
                    # entry so the existing stale-connection retry reopens it
                    stale = self._conn_pool.pop(key, None)
                    if stale is not None:
                        stale[1].close()
                    if attempt == 1:
                        raise ConnectionResetError("chaos: peer RPC dropped")
                    continue
            async with lock:
                entry = self._conn_pool.get(key)
                if entry is None or entry[1].is_closing():
                    reader, writer = await asyncio.wait_for(
                        asyncio.open_connection(host, port, limit=STREAM_LIMIT),
                        timeout,
                    )
                    _tune_socket(writer)
                    entry = (reader, writer)
                    self._conn_pool[key] = entry
                reader, writer = entry
                try:
                    await send_frame(writer, msg, meta, payload)
                    return await read_frame(reader, timeout=timeout)
                except (
                    OSError,
                    ConnectionError,
                    asyncio.IncompleteReadError,
                    asyncio.TimeoutError,
                ) as e:
                    self._conn_pool.pop(key, None)
                    writer.close()
                    if attempt == 1 or isinstance(e, asyncio.TimeoutError):
                        raise
                except BaseException:
                    # cancellation mid-send leaves a half-written frame on
                    # the wire; a reused connection would desynchronize the
                    # peer's stream parser -- never pool it again
                    self._conn_pool.pop(key, None)
                    writer.close()
                    raise
        raise AssertionError("unreachable")

    async def _probe_links(self, group: list[dict]) -> None:
        """Seed link estimates for group peers this worker has never sent a
        real part to: one empty probe frame for RTT, one sized probe
        (ODTP_LINK_PROBE_BYTES) for a first goodput figure. Best-effort and
        bounded — a failed or slow probe just leaves the peer unseeded (the
        planner fills unknowns with the median known capacity)."""
        pb = linkstate.probe_bytes()

        async def probe_one(p: dict) -> None:
            pid = p["peer_id"]
            try:
                t0 = time.monotonic()
                await self._peer_request(
                    p["host"], p["port"], "probe", {}, timeout=5.0
                )
                rtt = time.monotonic() - t0
                self.links.observe_rtt(pid, rtt)
                if pb > 0:
                    blob = b"\x00" * pb
                    t0 = time.monotonic()
                    await self._peer_request(
                        p["host"], p["port"], "probe", {}, blob, timeout=10.0
                    )
                    dt = max(time.monotonic() - t0 - rtt, 1e-6)
                    self.links.seed(pid, pb / dt, rtt)
            except Exception as e:
                log.debug("link probe to %s failed: %s", pid, e)

        targets = [
            p
            for p in group
            if p["peer_id"] != self._peer_id
            and self.links.needs_probe(p["peer_id"])
        ]
        if not targets:
            return
        try:
            await asyncio.wait_for(
                asyncio.gather(
                    *(probe_one(p) for p in targets), return_exceptions=True
                ),
                timeout=3.0,
            )
        except asyncio.TimeoutError:
            log.debug("link probe sweep timed out; continuing unseeded")

    async def _announce_links(self) -> None:
        """Post-round fire-and-forget progress announce carrying the fresh
        link vector: the daemon's stored progress is replaced per announce,
        so without this the estimates measured during round k would only
        reach the galaxy when the trainer next reports progress."""
        try:
            _, meta, _ = await self._rdv_request(
                "progress",
                {
                    **self._register_meta(),
                    "progress": self._progress_meta(self._own_progress),
                    "serves_state": self._state_provider is not None,
                },
                timeout=self.rpc_timeout,
            )
            ov = obs.overseer.plane()
            for p in meta.get("peers", []):
                self.links.merge_remote(
                    p.get("peer_id", ""), (p.get("progress") or {}).get("links")
                )
                if ov is not None:
                    ov.merge(
                        p.get("peer_id", ""), linkstate.member_health(p)
                    )
        except Exception as e:
            log.debug("links announce failed: %s", e)

    def _deliver_bulk(self, msg: str, meta: dict, payload) -> None:
        """Mailbox delivery from a bulk-server handler thread."""
        if msg not in ("push", "result"):
            return
        key = _mailbox_key(msg, meta)

        def _post():
            async def _set():
                async with self._mailbox_cv:
                    self._mailbox[key] = (meta, payload)
                    self._gc_mailbox()
                    self._mailbox_cv.notify_all()

            asyncio.ensure_future(_set())

        self._loop.call_soon_threadsafe(_post)

    async def _bulk_port_of(self, host: str, port: int) -> Optional[int]:
        """The peer's bulk-plane port (cached; None = peer has no bulk plane)."""
        key = (host, port)
        if key not in self._bulk_ports:
            try:
                msg, meta, _ = await self._peer_request(
                    host, port, "bulk_hello", {}, timeout=self.rpc_timeout
                )
                self._bulk_ports[key] = (
                    int(meta["bulk_port"]) if msg == "ok" and meta.get("bulk_port") else None
                )
            except Exception:
                return None  # transient: don't cache failure
        return self._bulk_ports[key]

    def _is_wan_peer(self, peer_id: Optional[str]) -> bool:
        """Does a frame to/from this peer cross the WAN, for byte
        accounting? With a topology view (planner site map), a different
        site means WAN; without one every link conservatively counts as
        WAN — a flat swarm of unknown shape can't claim intra-site bytes."""
        site_of = self._round_site_of
        if not site_of or not peer_id:
            return True
        mine = site_of.get(self._peer_id)
        theirs = site_of.get(peer_id)
        if mine is None or theirs is None:
            return True
        return mine != theirs

    async def _wan_throttle(self, peer_id: Optional[str], nbytes: int) -> None:
        """Chaos-plane WAN shaping: frames to wan_peers-classified
        destinations drain the per-process WAN token bucket (emulating a
        shared site uplink) before dispatch on either data plane. A no-op
        unless the chaos spec arms both wan_bps and wan_peers."""
        if not peer_id or not nbytes:
            return
        cp = chaos.plane()
        if cp is None or not cp.is_wan_peer(peer_id):
            return
        from opendiloco_torch.diloco.bulk import wan_bucket

        bucket = wan_bucket()
        if bucket is not None:
            await self._loop.run_in_executor(None, bucket.acquire, nbytes)

    async def _send_part(
        self, host: str, port: int, msg: str, meta: dict, payload, *,
        timeout: float, peer_id: Optional[str] = None,
    ) -> None:
        stage = _STAGE.get()
        if stage is None:
            return await self._send_part_inner(
                host, port, msg, meta, payload, timeout=timeout,
                peer_id=peer_id,
            )
        nbytes = payload.nbytes if hasattr(payload, "nbytes") else len(payload)
        t0 = time.perf_counter()
        try:
            return await self._send_part_inner(
                host, port, msg, meta, payload, timeout=timeout,
                peer_id=peer_id,
            )
        finally:
            stage.add("wire_send", time.perf_counter() - t0)
            tr = obs.tracer()
            if tr is not None:
                tr.count("wire_tx_bytes", nbytes)
                if self._is_wan_peer(peer_id):
                    tr.count("wire_tx_bytes_wan", nbytes)

    async def _send_part_inner(
        self, host: str, port: int, msg: str, meta: dict, payload, *,
        timeout: float, peer_id: Optional[str] = None,
    ) -> None:
        """Route one butterfly frame: bulk plane for large payloads, asyncio
        RPC otherwise (and as fallback). With the adaptive layer on, the
        wall-clock of every send feeds the per-peer goodput EWMA (the
        timing wraps the whole transfer, chaos emulation included — an
        emulated slow link measures slow, which is the point)."""
        nbytes = payload.nbytes if hasattr(payload, "nbytes") else len(payload)
        adaptive = peer_id is not None and self._adaptive()
        t_send = time.monotonic() if adaptive else 0.0
        # WAN shaping drains BEFORE plane selection so bulk and RPC frames
        # pay the same emulated cross-site toll (the egress bucket below
        # stays the per-worker NIC cap; this one is the site uplink)
        await self._wan_throttle(peer_id, nbytes)
        if self._bulk_sender is not None and nbytes >= self._bulk_threshold:
            bulk_port = await self._bulk_port_of(host, port)
            if bulk_port:
                if adaptive:
                    bps = self.links.bps_to(peer_id)
                    if bps:
                        self._bulk_sender.set_link(
                            host, bulk_port, bps,
                            self.links.rtt_to(peer_id) or 0.0,
                        )
                try:
                    wire_align = getattr(self.codec, "wire_align_bytes", 1)
                    await self._loop.run_in_executor(
                        None,
                        lambda: self._bulk_sender.send(
                            host, bulk_port, msg, meta, payload,
                            align=wire_align,
                        ),
                    )
                    if adaptive:
                        self.links.observe_send(
                            peer_id, nbytes, time.monotonic() - t_send
                        )
                    return
                except Exception as e:
                    # forget the cached bulk port: the peer may have
                    # restarted with a fresh ephemeral one (re-discovered
                    # via bulk_hello on the next large payload)
                    self._bulk_ports.pop((host, port), None)
                    log.warning(
                        "bulk send to %s:%d failed (%s); using RPC path",
                        host,
                        bulk_port,
                        e,
                    )
        # the RPC path must drain the same egress budget as the bulk plane:
        # small frames (below the bulk threshold) and bulk-fallback sends
        # would otherwise bypass the emulated link cap. After a FAILED bulk
        # attempt this double-charges whatever the stripes already drained —
        # deliberately conservative: an emulated link may only ever
        # under-report throughput, never flatter it
        from opendiloco_torch.diloco.bulk import egress_bucket

        cp = chaos.plane()
        if cp is not None:
            d = cp.straggle_s()
            if d:  # the bulk plane applies straggle inside BulkSender.send
                await asyncio.sleep(d)
        bucket = egress_bucket()
        if bucket is not None and nbytes:
            await self._loop.run_in_executor(None, bucket.acquire, nbytes)
        await self._peer_request(host, port, msg, meta, payload, timeout=timeout)
        if adaptive:
            self.links.observe_send(peer_id, nbytes, time.monotonic() - t_send)

    def _close_conn_pool(self) -> None:
        for _, writer in self._conn_pool.values():
            try:
                writer.close()
            except Exception:
                pass
        self._conn_pool.clear()

    def _gc_mailbox(self, max_age: float = 600.0) -> None:
        """Drop payloads from abandoned rounds (failed retries leave
        orphaned entries; without GC they pin compressed gradient parts in
        host RAM for the whole run)."""
        now = time.monotonic()
        self._mailbox_times = getattr(self, "_mailbox_times", {})
        for k in list(self._mailbox):
            self._mailbox_times.setdefault(k, now)
        dead = [k for k, t in self._mailbox_times.items() if now - t > max_age]
        for k in dead:
            self._mailbox.pop(k, None)
            self._mailbox_times.pop(k, None)
        self._mailbox_times = {
            k: t for k, t in self._mailbox_times.items() if k in self._mailbox
        }

    async def _wait_mailbox(self, key: tuple, deadline: float) -> tuple[dict, bytes]:
        stage = _STAGE.get()
        if stage is None:
            return await self._wait_mailbox_inner(key, deadline)
        t0 = time.perf_counter()
        try:
            meta, payload = await self._wait_mailbox_inner(key, deadline)
        finally:
            stage.add("wire_recv", time.perf_counter() - t0)
        tr = obs.tracer()
        if tr is not None:
            nbytes = (
                payload.nbytes if hasattr(payload, "nbytes") else len(payload)
            )
            tr.count("wire_rx_bytes", nbytes)
            if self._is_wan_peer(meta.get("from")):
                tr.count("wire_rx_bytes_wan", nbytes)
        return meta, payload

    async def _wait_mailbox_inner(
        self, key: tuple, deadline: float
    ) -> tuple[dict, bytes]:
        async with self._mailbox_cv:
            while key not in self._mailbox:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise asyncio.TimeoutError(f"waiting for {key}")
                try:
                    await asyncio.wait_for(
                        self._mailbox_cv.wait(), min(remaining, 1.0)
                    )
                except asyncio.TimeoutError:
                    continue
            return self._mailbox.pop(key)

    # -- OuterBackend API ------------------------------------------------

    @property
    def peer_id(self) -> str:
        return self._peer_id

    def num_peers(self) -> int:
        return max(1, len(self._progress_cache))

    def report_progress(self, progress: PeerProgress) -> None:
        self._own_progress = progress
        self._push_progress()

    def _push_progress(self) -> None:
        progress = self._own_progress
        if progress is None:
            return
        try:
            _, meta, _ = self._run(
                self._rdv_request(
                    "progress",
                    {
                        **self._register_meta(),
                        "progress": self._progress_meta(progress),
                        "serves_state": self._state_provider is not None,
                    },
                    timeout=self.rpc_timeout,
                ),
                timeout=self.rpc_timeout * 3 * len(self.rendezvous_list) + 5,
            )
        except Exception as e:
            log.warning("progress report failed: %s", e)
            return
        self._note_peers(meta)
        cache = []
        ov = obs.overseer.plane()
        for p in meta.get("peers", []):
            prog = p.get("progress") or {}
            self.links.merge_remote(p.get("peer_id", ""), prog.get("links"))
            if ov is not None and p.get("peer_id") != self._peer_id:
                ov.merge(p.get("peer_id", ""), prog.get("health"))
            cache.append(
                PeerProgress(
                    peer_id=p["peer_id"],
                    epoch=prog.get("epoch", 0),
                    samples=prog.get("samples", 0),
                    samples_per_second=prog.get("samples_per_second", 0.0),
                    timestamp=prog.get("timestamp", 0.0),
                )
            )
        self._progress_cache = cache
        self._progress_cache_time = time.monotonic()

    def peer_progress(self) -> list[PeerProgress]:
        # refresh from the rendezvous when stale so WAIT_FOR_ALL polling
        # (backend.py wait_for_peers) observes peers catching up
        if time.monotonic() - getattr(self, "_progress_cache_time", 0.0) > 0.5:
            self._push_progress()
        out = [p for p in self._progress_cache if p.peer_id != self._peer_id]
        if self._own_progress is not None:
            out.append(self._own_progress)
        return out

    # -- gossip pair exchange (diloco/gossip.py) -----------------------------

    def gossip_view(self):
        """(members, link matrix) for the pair scheduler: membership from
        the gossiped progress cache (refreshed when stale by
        peer_progress — no barrier, no rendezvous round), links from the
        same announce channel when the adaptive layer is on."""
        members = {p.peer_id for p in self.peer_progress()}
        members.add(self._peer_id)
        links = self.links.matrix() if self._adaptive() else None
        return sorted(members), links

    def pair_exchange(self, payload, meta, *, partner_id, round_key,
                      timeout=None):
        """One symmetric push-pull with ``partner_id``: push own frame on
        the existing bulk/wire stack (stripes, pipelining, WAN shaping),
        then await the partner's identical push in the generic mailbox.
        Both server planes already mailbox any "push" frame, so the pair
        round is purely client-side. Raises AllReduceError when the
        partner is unknown, unreachable, or never deposits in time."""
        timeout = timeout if timeout else 300.0
        deadline = time.monotonic() + timeout
        try:
            return self._run(
                self._pair_exchange(payload, dict(meta), partner_id,
                                    round_key, deadline),
                timeout=timeout + 10.0,
            )
        except asyncio.TimeoutError as e:
            raise AllReduceError(
                f"gossip pair round {round_key} with {partner_id} "
                f"timed out"
            ) from e

    async def _pair_exchange(self, payload, meta, partner_id, round_key,
                             deadline):
        peer = self._peers_view.get(partner_id)
        if not peer or not peer.get("host"):
            raise AllReduceError(
                f"gossip partner {partner_id} not in registry view"
            )
        send_meta = {
            **meta,
            "round": round_key,
            "from": self._peer_id,
            WIRE_VERSION_META_KEY: WIRE_VERSION,
        }
        await self._send_part(
            peer["host"], int(peer["port"]), "push", send_meta, payload,
            timeout=max(1.0, deadline - time.monotonic()),
            peer_id=partner_id,
        )
        p_meta, p_payload = await self._wait_mailbox(
            (round_key, "push", partner_id), deadline
        )
        return p_meta, bytes(p_payload)

    # -- async bounded-staleness matchmaking (diloco/gossip.py) --------------

    def _async_board(self) -> dict:
        """frag_id -> this worker's standing offer. Owned by the asyncio
        loop thread (handler replies and the match coroutine both run
        there), so no lock: every read-modify-write is atomic between
        awaits."""
        board = getattr(self, "_async_offer_board", None)
        if board is None:
            board = {}
            self._async_offer_board = board
        return board

    def _async_offer_reply(self, meta: dict) -> dict:
        """Respond to a peer's "async_offer" frame: claim our standing
        offer for the sender when compatible. Role split by peer id —
        offers are only ACCEPTED from larger ids (and only SENT to
        smaller ids), so two workers can never claim each other
        concurrently and deadlock both transfers."""
        src = str(meta.get("from", ""))
        frag = int(meta.get("frag", -1))
        offer = self._async_board().get(frag)
        if (
            offer is None or offer["busy"] or offer["fut"].done()
            or not src or src <= self._peer_id
        ):
            return {"match": 0}
        d = abs(int(offer["epoch"]) - int(meta.get("epoch", 0)))
        if d > min(int(offer["window"]), int(meta.get("window", 0))):
            return {"match": 0}
        self._async_seq = getattr(self, "_async_seq", 0) + 1
        lo, hi = sorted((self._peer_id, src))
        key = f"async-f{frag}:{lo}|{hi}:{self._async_seq}"
        offer["fut"].set_result((src, int(meta.get("epoch", 0)), key))
        return {"match": 1, "epoch": int(offer["epoch"]), "key": key}

    def async_pair_match(self, *, frag_id, epoch, window, patience=None):
        """Free-running matchmaking on the control plane: post a standing
        offer claimable by larger-id peers, while sweeping smaller-id
        candidates — whose epochs already ride the progress gossip — with
        "async_offer" RPCs. The responder re-checks its LIVE offer, so a
        stale progress view only costs a "no" reply, never a bad match.
        Any transport failure resolves to None (the caller's self-round):
        matching is best-effort by design."""
        patience = float(patience) if patience else 5.0
        # refresh the candidate epochs from the rendezvous HERE — the
        # sync refresh path uses _run and would deadlock on the loop
        self.peer_progress()
        try:
            return self._run(
                self._async_pair_match(
                    int(frag_id), int(epoch), int(window), patience
                ),
                timeout=patience + 10.0,
            )
        except (AllReduceError, OSError, ConnectionError, EOFError,
                asyncio.TimeoutError) as e:
            log.debug(
                "async match failed (frag %s epoch %s): %s",
                frag_id, epoch, e,
            )
            return None

    async def _async_pair_match(self, frag_id, epoch, window, patience):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + patience
        board = self._async_board()
        offer = {
            "epoch": epoch, "window": window,
            "fut": loop.create_future(), "busy": False,
        }
        board[frag_id] = offer
        try:
            while True:
                if offer["fut"].done():
                    return offer["fut"].result()
                cands = sorted(
                    (abs(epoch - p.epoch), p.peer_id)
                    for p in self._progress_cache
                    if p.peer_id < self._peer_id
                    and abs(epoch - p.epoch) <= window
                )
                for _, pid in cands:
                    peer = self._peers_view.get(pid)
                    if not peer or not peer.get("host"):
                        continue
                    # mid-RPC our offer must not be claimable: a claim
                    # racing a successful sweep would double-match us
                    offer["busy"] = True
                    try:
                        msg, p_meta, _ = await self._peer_request(
                            peer["host"], int(peer["port"]), "async_offer",
                            {
                                "frag": frag_id, "epoch": epoch,
                                "window": window, "from": self._peer_id,
                            },
                            timeout=min(
                                5.0, max(1.0, deadline - loop.time())
                            ),
                        )
                    except (OSError, ConnectionError, EOFError,
                            asyncio.TimeoutError, WireError) as e:
                        log.debug("async offer to %s failed: %s", pid, e)
                        continue
                    finally:
                        offer["busy"] = False
                    if msg == "ok" and p_meta.get("match"):
                        return (
                            pid,
                            int(p_meta["epoch"]),
                            str(p_meta["key"]),
                        )
                remaining = deadline - loop.time()
                if remaining <= 0:
                    return None
                try:
                    await asyncio.wait_for(
                        asyncio.shield(offer["fut"]),
                        min(remaining, 0.25),
                    )
                    return offer["fut"].result()
                except asyncio.TimeoutError:
                    pass
        finally:
            if board.get(frag_id) is offer:
                del board[frag_id]

    def _checkout_buf(self, count: int) -> np.ndarray:
        with self._pool_lock:
            free = self._free_bufs.get(count)
            if free:
                buf = free.pop()
                if not free:  # empty keys must not count toward eviction
                    del self._free_bufs[count]
                return buf
        return np.empty(count, np.float32)

    def _checkin_buf(self, buf: Optional[np.ndarray]) -> None:
        if buf is None:
            return
        with self._pool_lock:
            self._free_bufs.setdefault(buf.size, []).append(buf)
            # keep the pool bounded to the live working set: at most 2
            # buffers per size, 4 sizes. Evict SMALLEST sizes first -- the
            # multi-GB model-flat buffer is exactly the one whose fresh
            # reallocation stalls on kernel page faults, so it must survive
            # transient small sizes (barrier probes, gossip pairs)
            if len(self._free_bufs[buf.size]) > 2:
                self._free_bufs[buf.size].pop(0)
            while len(self._free_bufs) > 4:
                del self._free_bufs[min(self._free_bufs)]

    def _retire_buf(self, round_key: str, buf: np.ndarray) -> None:
        """Park a result buffer whose views the caller still holds; the
        next all_reduce with the SAME tag reclaims it (see the lifetime
        contract on ``all_reduce``)."""
        tag = round_key.split("-epoch-")[0]
        with self._pool_lock:
            self._retired_bufs.setdefault(tag, []).append(buf)

    def _record_round_health(
        self, join_key: str, n: int, expected: int, elastic: bool, timings: dict,
        extra: Optional[dict] = None, attempt: int = 0,
        members: Optional[list] = None,
    ) -> None:
        """Append one row to the round health ledger (and keep the legacy
        ``last_round_timings`` view in sync). Solo and elastic rounds are
        recorded as data, not errors: the bench/soak layers read this
        instead of inferring health from exceptions. ``extra`` carries
        adaptive-transport fields (link_plan, link_shares) when armed.
        ``attempt`` is threaded explicitly from the retry loop — it is set
        on the CALLER thread, so neither an attribute nor a ContextVar
        would reach this loop-thread coroutine reliably once several
        fragment rounds run concurrently."""
        self.last_round_timings = timings
        health = {
            "round": join_key,
            "group_size": n,
            "expected": expected,
            "elastic": elastic,
            "retries": attempt,
            **{k: round(v, 6) for k, v in timings.items()},
            **(extra or {}),
        }
        cp = chaos.plane()
        if cp is not None:
            health["chaos_faults"] = dict(cp.counters)
        self.last_round_health = health
        self.round_ledger.append(health)
        if len(self.round_ledger) > self._ledger_cap:
            del self.round_ledger[: -self._ledger_cap]
        tr = obs.tracer()
        if tr is not None:
            # the per-round record obs_report merges across workers
            tr.instant("outer/round", **health)
            tr.count("outer_rounds")
            if elastic:
                tr.count("outer_rounds_elastic")
            if attempt:
                tr.count("outer_round_retries", attempt)
            tr.gauge("outer_group_size", n)
            if extra and "hier" in extra:
                tr.count("outer_rounds_hier")
                tr.gauge("hier_sites", len(extra["hier"].get("sites", [])))
            if extra and "link_shares" in extra:
                tr.count("outer_rounds_adaptive")
                own = self.links.publish().get("peers", {})
                for pid, vec in own.items():
                    if vec.get("bps"):
                        tr.gauge("link_bps", vec["bps"], peer=pid)
                    if vec.get("rtt_ms"):
                        tr.gauge("link_rtt_ms", vec["rtt_ms"], peer=pid)
        ov = obs.overseer.plane()
        if ov is not None:
            # refresh own galaxy-matrix row, feed the flight recorder, and
            # run the anomaly watchdogs (straggler / divergence / dead-peer
            # / stall) against the freshly recorded round
            ov.note_round(health, own_id=self._peer_id, members=members)

    def all_reduce(
        self, arrays, *, timeout=None, tag: str = "grads", epoch=None, group_cap=0
    ):
        """Rounds are keyed by (tag, own epoch) so all in-sync peers agree on
        the key without coordination; retries after a failed round re-join
        the same key (the rendezvous opens a fresh matchmaking window) and
        the group fingerprint keeps stale traffic out of the new round.
        ``group_cap`` > 0 asks the rendezvous to partition joiners into
        groups of at most that size (gossip mode).

        RESULT LIFETIME: the returned arrays are views of a pooled internal
        buffer that is recycled on the NEXT all_reduce call on this backend
        -- consume (or copy) them before calling again. The lifetime is
        scoped PER TAG: concurrent rounds with distinct tags (streaming
        fragment sync) never reclaim each other's result buffers. Every
        in-tree consumer applies the result immediately
        (optimizer.outer_step / the fragment landing); the pooling is what
        keeps multi-GB rounds from re-faulting freshly mmapped pages every
        epoch."""
        # reclaim buffers whose views this tag's caller has consumed by now
        with self._pool_lock:
            reclaim = self._retired_bufs.pop(tag, [])
        for b in reclaim:
            self._checkin_buf(b)
        timeout = timeout or 300.0
        if epoch is None:
            epoch = self._own_progress.epoch if self._own_progress else 0
        round_key = f"{tag}-epoch-{epoch}"
        last_err: Optional[Exception] = None
        retries = chaos.round_retries()
        for attempt in range(retries):
            # each re-formed round gets a FRESH deadline: a round that
            # wedges on a split-brain group (e.g. divergent membership
            # views after a daemon blackout) burns its whole window
            # waiting on a fingerprint nobody serves, and a retry with
            # only the scraps of a shared deadline dies before the fresh
            # matchmaking window can close
            deadline = time.monotonic() + timeout
            try:
                return self._run(
                    self._all_reduce_round(
                        arrays, round_key, deadline, group_cap=group_cap,
                        attempt=attempt,
                    ),
                    timeout=max(1.0, deadline - time.monotonic()) + 10,
                )
            except (asyncio.TimeoutError, AllReduceError, OSError) as e:
                last_err = e
                if attempt + 1 >= retries:
                    break
                # bounded exponential backoff + jitter before re-forming:
                # an immediate retry after a daemon blackout or peer reset
                # re-forms against the same dead endpoint and burns an
                # attempt; backing off lets failover/TTL machinery settle
                pause = chaos.backoff_s(attempt)
                log.warning(
                    "all-reduce attempt %d failed (%s); re-forming group "
                    "in %.2fs",
                    attempt,
                    e,
                    pause,
                )
                time.sleep(pause)
        raise AllReduceError(f"all-reduce failed: {last_err}")

    async def _all_reduce_round(
        self, arrays: list[np.ndarray], join_key: str, deadline: float,
        group_cap=0, attempt=0,
    ):
        scratch: list[np.ndarray] = []  # pooled buffers local to this round
        try:
            return await self._all_reduce_round_inner(
                arrays, join_key, deadline, scratch, group_cap=group_cap,
                attempt=attempt,
            )
        finally:
            _STAGE.set(None)
            for b in scratch:
                self._checkin_buf(b)

    async def _all_reduce_round_inner(
        self,
        arrays: list[np.ndarray],
        join_key: str,
        deadline: float,
        scratch: list[np.ndarray],
        group_cap=0,
        attempt=0,
    ):
        timings: dict[str, float] = {}
        tr = obs.tracer()
        _STAGE.set(obs.StageTimes())
        t_mm_p = time.perf_counter() if tr is not None else 0.0
        t_mm = time.monotonic()
        # 1. matchmake
        _, meta, _ = await self._rdv_request(
            "join_group",
            {
                "round": join_key,
                "matchmaking_time": self.matchmaking_time,
                "group_cap": group_cap,
                "expect": self.expect_peers,
                # a joiner whose registration TTL lapsed mid-round (one
                # outer round can legitimately outlast the TTL on a slow
                # link) re-registers transparently from this identity
                **self._identity_meta(),
            },
            timeout=max(self.matchmaking_time * 4, self.rpc_timeout),
        )
        group = meta["group"]
        n = len(group)
        my_idx = next(
            (i for i, p in enumerate(group) if p["peer_id"] == self._peer_id), None
        )
        if my_idx is None:
            # stale registry excluded us (e.g. TTL expiry) -- this includes
            # an EMPTY group, which must NOT pass as a solo round: that
            # would silently desync the master. Re-announce and retry.
            # (Async announce, NOT _push_progress: a sync _run from the
            # event-loop thread blocks the loop on a future the loop itself
            # must run -- it can only time out, wedging every peer's frames
            # for rpc_timeout*3 while never actually re-announcing.)
            try:
                await self._announce_to(self.rendezvous, self.rpc_timeout)
            except Exception:
                pass  # the retry's join_group meta re-registers anyway
            raise AllReduceError(f"matchmade group {group} does not contain self")
        # elastic round bookkeeping: the average is always rescaled by the
        # ACTUAL contributor count n (every exchange path divides by n), so a
        # partial group is a correct, smaller average — record it as data
        expected = self.expect_peers or max(n, len(self._peers_view) or n)
        elastic = bool(n < expected)
        if elastic:
            log.warning(
                "elastic round %s: proceeding with %d/%d peers",
                join_key, n, expected,
            )
        if n == 1:
            timings["matchmake_s"] = time.monotonic() - t_mm
            timings["round_s"] = time.monotonic() - t_mm
            if tr is not None:
                tr.add_span(
                    "outer/rendezvous", t_mm_p, time.perf_counter(),
                    round=join_key, group=n,
                )
            self._record_round_health(
                join_key, n, expected, elastic, timings, attempt=attempt,
                members=[self._peer_id],
            )
            return [a.copy() for a in arrays], 1
        # fingerprint the membership: retried rounds (same join_key) must not
        # consume stale mailbox traffic from a differently-shaped group
        round_key = f"{join_key}:{planner.group_fingerprint(group)}"

        ov = obs.overseer.plane()
        if ov is not None:
            # the group snapshot every member received identically also
            # carries every member's health roll-up — merge them so the
            # galaxy matrix converges even between progress announces
            for p in group:
                if p["peer_id"] != self._peer_id:
                    ov.merge(p["peer_id"], linkstate.member_health(p))

        timings["matchmake_s"] = time.monotonic() - t_mm
        if tr is not None:
            tr.add_span(
                "outer/rendezvous", t_mm_p, time.perf_counter(),
                round=join_key, group=n,
            )

        # adaptive partitioning: probe never-measured links, then plan part
        # bounds from the group snapshot every member received identically.
        # Planning is pure and snapshot-only, so every member computes the
        # same bounds; the plan hash on every frame makes that assumption
        # load-bearing instead of hopeful.
        adaptive = self._adaptive()
        if adaptive and n > 1:
            await self._probe_links(group)

        # 2. flatten + split into n parts (by element count). Contiguous-f32
        # leaves flatten as views; a single leaf needs no copy at all (the
        # copy cost matters: the host core also feeds the sockets)
        t_ph = time.monotonic()
        flats = [
            a.reshape(-1)
            if a.dtype == np.float32 and a.flags.c_contiguous
            else np.ascontiguousarray(a, np.float32).reshape(-1)
            for a in arrays
        ]
        if len(flats) == 1:
            flat = flats[0]
        else:
            flat = self._checkout_buf(sum(f.size for f in flats))
            scratch.append(flat)
            np.concatenate(flats, out=flat)
        # planning (flat bounds, site clustering, aggregator election) is
        # pure and snapshot-only — every member derives the identical plan
        rp = planner.plan_round(group, int(flat.size), adaptive=adaptive)
        bounds = rp.bounds
        plan_meta = rp.plan_meta
        health_extra: Optional[dict] = dict(rp.health) or None
        self._round_site_of = rp.site_of
        timings["flatten_s"] = time.monotonic() - t_ph
        if tr is not None:
            tr.add_span(
                "outer/flatten",
                time.perf_counter() - timings["flatten_s"],
                time.perf_counter(),
                round=join_key,
            )
        wan_tx0 = (
            tr.counters().get(("wire_tx_bytes_wan", ()), 0.0)
            if tr is not None else 0.0
        )

        # 3-5. exchange. Hierarchical (two-level) when the planner produced
        # a multi-site plan; otherwise chunk-pipelined by default (encode
        # chunk k+1 while chunk k is on the wire, decode-accumulate as
        # chunks land), serial whole-part path behind ODTP_PIPELINE=0. The
        # flat paths produce bit-identical flat_avg buffers (the parity
        # test in tests/test_bulk_pipeline.py holds the pipelined path to
        # the serial result); the hier path matches them bitwise for
        # codec=none whenever sums are exactly representable (see
        # _exchange_hier).
        if rp.hier is not None:
            flat_avg = await self._exchange_hier(
                group, my_idx, n, flat, rp, round_key, deadline, scratch,
                timings,
            )
        else:
            parts = [flat[bounds[j] : bounds[j + 1]] for j in range(n)]
            exchange = (
                self._exchange_pipelined
                if _pipeline_enabled()
                else self._exchange_serial
            )
            flat_avg = await exchange(
                group, my_idx, n, parts, bounds, flat.size, round_key,
                deadline, scratch, timings, plan_meta,
            )
        if tr is not None:
            # per-round WAN egress as a gauge (the counter is cumulative);
            # obs_report surfaces the intra/WAN split from these
            tr.gauge(
                "wire_bytes_wan",
                tr.counters().get(("wire_tx_bytes_wan", ()), 0.0) - wan_tx0,
            )
        stage = _STAGE.get()
        if stage is not None:
            # fold fine-grained stage wall-clock (encode / wire_send /
            # wire_recv / accumulate, summed across overlapping chunk work)
            # into the round ledger next to the coarse phase timings
            for name, secs in stage.totals.items():
                timings[f"{name}_s"] = round(
                    timings.get(f"{name}_s", 0.0) + secs, 6
                )
        # round wall time (matchmake through exchange) — the figure the
        # straggler watchdog compares against the galaxy median
        timings["round_s"] = time.monotonic() - t_mm
        self._record_round_health(
            join_key, n, expected, elastic, timings, extra=health_extra,
            attempt=attempt, members=[p["peer_id"] for p in group],
        )
        if adaptive:
            # fresh estimates from this round's transfers reach the daemon
            # (and therefore the next round's group snapshot) without
            # waiting for the trainer's next progress report
            asyncio.ensure_future(self._announce_links())

        # 6. hand back per-array views of the reassembled buffer
        out, off = [], 0
        for a in arrays:
            out.append(flat_avg[off : off + a.size].reshape(a.shape))
            off += a.size
        return out, n

    async def _exchange_serial(
        self, group, my_idx, n, parts, bounds, flat_size, round_key, deadline,
        scratch, timings, plan_meta=None,
    ):
        """Whole-part exchange: each butterfly frame carries a full part.

        Accumulation folds contributions in strict GROUP ORDER (not
        own-part-first): per-element addition order is then a property of
        the group, not of which peer owns the part, so re-partitioning the
        butterfly (adaptive bounds) cannot perturb the float sum — the
        bit-parity the adaptive layer's off/on parity test relies on."""
        plan_meta = plan_meta or {}
        my_plan = plan_meta.get("plan")
        stage = _STAGE.get()
        codec = self.codec
        encode = stage.timed("encode", codec.encode) if stage else codec.encode
        dec_acc = (
            stage.timed("accumulate", codec.decode_accumulate)
            if stage
            else codec.decode_accumulate
        )
        dec_into = (
            stage.timed("accumulate", codec.decode_into)
            if stage
            else codec.decode_into
        )

        # 3. push part j to its owner
        async def push(j):
            payload, cmeta = encode(parts[j])
            record_wire(codec.name, parts[j].size * 4, len(payload))
            await self._send_part(
                group[j]["host"],
                group[j]["port"],
                "push",
                {
                    "round": round_key,
                    "from": self._peer_id,
                    "meta": cmeta,
                    "shape": [int(parts[j].size)],
                    **plan_meta,
                },
                payload,
                timeout=max(5.0, deadline - time.monotonic()),
                peer_id=group[j]["peer_id"],
            )

        pushes = [push(j) for j in range(n) if j != my_idx]

        # 4. collect everyone's contribution for my part (fused
        # decode+accumulate; native single-pass kernels when built), folded
        # in group order: the first contributor lands via copy/decode-into,
        # every later one accumulates
        async def collect():
            from opendiloco_torch import native as _native
            from opendiloco_torch.diloco.bulk import release_buffer

            acc = self._checkout_buf(parts[my_idx].size)
            scratch.append(acc)
            first = True
            for p in group:
                if p["peer_id"] == self._peer_id:
                    if first:
                        np.copyto(acc, parts[my_idx])
                    else:
                        _native.add_inplace(acc, parts[my_idx])
                    first = False
                    continue
                pmeta, payload = await self._wait_mailbox(
                    (round_key, "push", p["peer_id"]), deadline
                )
                check_plan(pmeta, my_plan)
                if first:
                    dec_into(payload, pmeta["meta"], acc)
                else:
                    dec_acc(payload, pmeta["meta"], acc)
                first = False
                # fully folded into acc: recycle bulk-plane receive buffers
                # so steady-state rounds stop allocating (no-op for asyncio
                # bytes payloads)
                release_buffer(payload)
            _native.scale_inplace(acc, 1.0 / n)
            return acc

        t_ph = time.monotonic()
        t_ph_p = time.perf_counter()
        results = await asyncio.gather(collect(), *pushes)
        my_avg = results[0]
        timings["scatter_reduce_s"] = time.monotonic() - t_ph
        tr = obs.tracer()
        if tr is not None:
            tr.add_span(
                "outer/scatter_reduce", t_ph_p, time.perf_counter(),
                round=round_key, group=n,
            )

        # 5. fan the averaged part back out; gather the other parts.
        # Encode ONCE — the same payload serves every destination (the old
        # per-destination encode re-quantized identical bytes n-1 times),
        # and the owner adopts the DECODED wire value for its own part too:
        # every peer then reconstructs a bit-identical averaged buffer
        # regardless of codec lossiness (hivemind's averaged tensors have
        # the same property: one compressed result, everyone decodes it)
        result_payload, result_cmeta = encode(my_avg)

        async def send_result(j):
            await self._send_part(
                group[j]["host"],
                group[j]["port"],
                "result",
                {
                    "round": round_key,
                    "part": my_idx,
                    "from": self._peer_id,
                    "meta": result_cmeta,
                    "shape": [int(my_avg.size)],
                    **plan_meta,
                },
                result_payload,
                timeout=max(5.0, deadline - time.monotonic()),
                peer_id=group[j]["peer_id"],
            )

        # the result buffer outlives this round (the caller gets views of
        # it), so it retires instead of joining scratch and is reclaimed at
        # the START of the next all_reduce call (see the lifetime contract
        # on all_reduce). Checked out before the gather: every arriving
        # part decodes STRAIGHT into its slice (one native pass per part,
        # no intermediate array, no reassembly concatenate afterwards).
        flat_avg = self._checkout_buf(flat_size)
        self._retire_buf(round_key, flat_avg)

        async def recv_results():
            from opendiloco_torch.diloco.bulk import release_buffer

            dec_into(
                result_payload,
                result_cmeta,
                flat_avg[bounds[my_idx] : bounds[my_idx + 1]],
            )
            for j in range(n):
                if j == my_idx:
                    continue
                rmeta, payload = await self._wait_mailbox(
                    (round_key, "result", j), deadline
                )
                check_plan(rmeta, my_plan)
                dst = flat_avg[bounds[j] : bounds[j + 1]]
                if int(rmeta["shape"][0]) != dst.size:
                    raise WireError(
                        f"result part {j}: peer claims {rmeta['shape']} "
                        f"elements, expected {dst.size}"
                    )
                # (decode_into additionally validates the actual payload
                # length against dst.size before any native kernel runs)
                dec_into(payload, rmeta["meta"], dst)
                # fully decoded into flat_avg: recycle bulk-plane receive
                # buffers (no-op for asyncio bytes payloads)
                release_buffer(payload)

        t_ph = time.monotonic()
        t_ph_p = time.perf_counter()
        await asyncio.gather(
            recv_results(), *[send_result(j) for j in range(n) if j != my_idx]
        )
        timings["all_gather_s"] = time.monotonic() - t_ph
        if tr is not None:
            tr.add_span(
                "outer/all_gather", t_ph_p, time.perf_counter(),
                round=round_key, group=n,
            )
        return flat_avg

    @staticmethod
    def _check_hier_frame(meta: dict, my_plan: Optional[str]) -> None:
        """Every hierarchical frame carries the v2 wire version and the
        topology-covering plan hash; a peer that disagrees about either is
        running a different round shape and must fail loudly, not fold
        misaligned bytes."""
        v = int(meta.get(WIRE_VERSION_META_KEY, 0) or 0)
        if v != WIRE_VERSION:
            raise WireError(
                f"hier frame wire version {v}, expected {WIRE_VERSION}"
            )
        check_plan(meta, my_plan)

    async def _exchange_hier(
        self, group, my_idx, n, flat, rp, round_key, deadline, scratch,
        timings,
    ):
        """Two-level exchange (ODTP_HIER): intra-site reduce-scatter of raw
        f32 partial sums over the fat links, a member->aggregator handoff
        of the site-summed slices, an aggregators-only butterfly across the
        WAN with the configured codec, and an intra-site broadcast of the
        averaged buffer. Per-stage frames ride the ordinary push/result
        machinery under stage-suffixed round keys (schema.HIER_STAGES).

        Bit-parity contract: contributions fold in canonical orders only —
        site members in group order inside each site, sites in site order
        on the WAN leg — and the 1/n scale (n = TOTAL contributors) runs
        exactly once, on the aggregators, after the full cross-site fold.
        codec=none rounds with exactly-representable sums are therefore
        bit-identical to the flat butterfly under ANY site assignment, and
        every member adopts its aggregator's broadcast bytes verbatim (the
        encode-once/adopt-decoded discipline of the flat path, lifted to
        sites), so lossy WAN codecs still yield one identical buffer
        everywhere."""
        from opendiloco_torch import native as _native
        from opendiloco_torch.diloco.bulk import release_buffer

        hp = rp.hier
        tr = obs.tracer()
        raw = get_codec("none")
        site_idx = hp.site_of[self._peer_id]
        site = hp.sites[site_idx]  # group indices, group order
        li = site.index(my_idx)  # my site-local index
        m = len(site)
        agg_idx = hp.aggregators[site_idx]
        is_agg = agg_idx == my_idx
        ib = hp.intra_bounds[site_idx]
        plan_meta = {**rp.plan_meta, WIRE_VERSION_META_KEY: WIRE_VERSION}
        my_plan = plan_meta.get("plan")

        def _timeout() -> float:
            return max(5.0, deadline - time.monotonic())

        def _meta(stage_key: str, **extra) -> dict:
            return {
                "round": f"{round_key}/{stage_key}",
                "from": self._peer_id,
                **extra,
                **plan_meta,
            }

        # -- stage A: intra-site reduce-scatter (raw f32, fat links) ------
        async def push_intra(k: int):
            j = site[k]
            part = flat[ib[k] : ib[k + 1]]
            payload, cmeta = raw.encode(part)
            record_wire("none", part.size * 4, len(payload))
            await self._send_part(
                group[j]["host"], group[j]["port"], "push",
                _meta("intra", meta=cmeta, shape=[int(part.size)]),
                payload, timeout=_timeout(), peer_id=group[j]["peer_id"],
            )

        async def collect_intra():
            acc = self._checkout_buf(int(ib[li + 1] - ib[li]))
            scratch.append(acc)
            first = True
            for k in range(m):  # site members in group order
                if site[k] == my_idx:
                    src = flat[ib[li] : ib[li + 1]]
                    if first:
                        np.copyto(acc, src)
                    else:
                        _native.add_inplace(acc, src)
                    first = False
                    continue
                pid = group[site[k]]["peer_id"]
                pmeta, payload = await self._wait_mailbox(
                    (f"{round_key}/intra", "push", pid), deadline
                )
                self._check_hier_frame(pmeta, my_plan)
                if first:
                    raw.decode_into(payload, pmeta["meta"], acc)
                else:
                    raw.decode_accumulate(payload, pmeta["meta"], acc)
                first = False
                release_buffer(payload)
            return acc

        t_ph = time.monotonic()
        t_ph_p = time.perf_counter()
        results = await asyncio.gather(
            collect_intra(), *[push_intra(k) for k in range(m) if site[k] != my_idx]
        )
        site_acc = results[0]  # my slice of the site's UNSCALED sum
        timings["intra_reduce_s"] = time.monotonic() - t_ph
        if tr is not None:
            tr.add_span(
                "outer/hier_intra", t_ph_p, time.perf_counter(),
                round=round_key, group=m, site=site_idx,
            )

        # -- stage A2: handoff — aggregator assembles the full site sum ---
        t_ph = time.monotonic()
        t_ph_p = time.perf_counter()
        site_sum = None
        if is_agg:
            site_sum = self._checkout_buf(int(flat.size))
            scratch.append(site_sum)
            np.copyto(site_sum[ib[li] : ib[li + 1]], site_acc)
            for k in range(m):
                if site[k] == my_idx:
                    continue
                pid = group[site[k]]["peer_id"]
                pmeta, payload = await self._wait_mailbox(
                    (f"{round_key}/handoff", "push", pid), deadline
                )
                self._check_hier_frame(pmeta, my_plan)
                dst = site_sum[ib[k] : ib[k + 1]]
                if int(pmeta["shape"][0]) != dst.size:
                    raise WireError(
                        f"handoff slice {k}: peer claims {pmeta['shape']} "
                        f"elements, expected {dst.size}"
                    )
                raw.decode_into(payload, pmeta["meta"], dst)
                release_buffer(payload)
        else:
            payload, cmeta = raw.encode(site_acc)
            record_wire("none", site_acc.size * 4, len(payload))
            await self._send_part(
                group[agg_idx]["host"], group[agg_idx]["port"], "push",
                _meta("handoff", meta=cmeta, shape=[int(site_acc.size)]),
                payload, timeout=_timeout(),
                peer_id=group[agg_idx]["peer_id"],
            )
        timings["handoff_s"] = time.monotonic() - t_ph
        if tr is not None:
            tr.add_span(
                "outer/hier_handoff", t_ph_p, time.perf_counter(),
                round=round_key, group=m, site=site_idx,
            )

        # the caller gets views of flat_avg, so it retires instead of
        # joining scratch (same lifetime contract as the flat paths)
        flat_avg = self._checkout_buf(int(flat.size))
        self._retire_buf(round_key, flat_avg)

        # -- stage B: aggregators-only WAN butterfly (configured codec) ---
        t_ph = time.monotonic()
        t_ph_p = time.perf_counter()
        if is_agg:
            s = hp.n_sites
            wb = hp.wan_bounds
            aggs = hp.aggregators
            codec = self.codec
            stage = _STAGE.get()
            encode = (
                stage.timed("encode", codec.encode) if stage else codec.encode
            )
            dec_acc = (
                stage.timed("accumulate", codec.decode_accumulate)
                if stage else codec.decode_accumulate
            )
            dec_into = (
                stage.timed("accumulate", codec.decode_into)
                if stage else codec.decode_into
            )

            async def push_wan(t: int):
                j = aggs[t]
                part = site_sum[wb[t] : wb[t + 1]]
                payload, cmeta = encode(part)
                record_wire(codec.name, part.size * 4, len(payload))
                await self._send_part(
                    group[j]["host"], group[j]["port"], "push",
                    _meta("wan", meta=cmeta, shape=[int(part.size)]),
                    payload, timeout=_timeout(), peer_id=group[j]["peer_id"],
                )

            async def collect_wan():
                acc = self._checkout_buf(int(wb[site_idx + 1] - wb[site_idx]))
                scratch.append(acc)
                first = True
                for t in range(s):  # sites in site order
                    if aggs[t] == my_idx:
                        src = site_sum[wb[site_idx] : wb[site_idx + 1]]
                        if first:
                            np.copyto(acc, src)
                        else:
                            _native.add_inplace(acc, src)
                        first = False
                        continue
                    pid = group[aggs[t]]["peer_id"]
                    pmeta, payload = await self._wait_mailbox(
                        (f"{round_key}/wan", "push", pid), deadline
                    )
                    self._check_hier_frame(pmeta, my_plan)
                    if first:
                        dec_into(payload, pmeta["meta"], acc)
                    else:
                        dec_acc(payload, pmeta["meta"], acc)
                    first = False
                    release_buffer(payload)
                # the single global scale: site sums were never divided
                _native.scale_inplace(acc, 1.0 / n)
                return acc

            results = await asyncio.gather(
                collect_wan(),
                *[push_wan(t) for t in range(s) if aggs[t] != my_idx],
            )
            wan_avg = results[0]

            # fan the averaged WAN part back out, encoded ONCE; adopt the
            # decoded wire value for our own part (flat path's invariant)
            result_payload, result_cmeta = encode(wan_avg)

            async def send_wan_result(t: int):
                j = aggs[t]
                await self._send_part(
                    group[j]["host"], group[j]["port"], "result",
                    _meta(
                        "wan", part=site_idx, meta=result_cmeta,
                        shape=[int(wan_avg.size)],
                    ),
                    result_payload, timeout=_timeout(),
                    peer_id=group[j]["peer_id"],
                )

            async def recv_wan_results():
                dec_into(
                    result_payload, result_cmeta,
                    flat_avg[wb[site_idx] : wb[site_idx + 1]],
                )
                for t in range(s):
                    if aggs[t] == my_idx:
                        continue
                    rmeta, payload = await self._wait_mailbox(
                        (f"{round_key}/wan", "result", t), deadline
                    )
                    self._check_hier_frame(rmeta, my_plan)
                    dst = flat_avg[wb[t] : wb[t + 1]]
                    if int(rmeta["shape"][0]) != dst.size:
                        raise WireError(
                            f"wan result {t}: peer claims {rmeta['shape']} "
                            f"elements, expected {dst.size}"
                        )
                    dec_into(payload, rmeta["meta"], dst)
                    release_buffer(payload)

            await asyncio.gather(
                recv_wan_results(),
                *[send_wan_result(t) for t in range(s) if aggs[t] != my_idx],
            )
        timings["wan_reduce_s"] = time.monotonic() - t_ph
        if tr is not None:
            tr.add_span(
                "outer/hier_wan", t_ph_p, time.perf_counter(),
                round=round_key, group=hp.n_sites, site=site_idx,
            )

        # -- stage C: intra-site broadcast of the averaged buffer ---------
        t_ph = time.monotonic()
        t_ph_p = time.perf_counter()
        if is_agg:
            payload, cmeta = raw.encode(flat_avg)
            record_wire("none", flat_avg.size * 4, len(payload))
            await asyncio.gather(*[
                self._send_part(
                    group[j]["host"], group[j]["port"], "result",
                    _meta("bcast", part=0, meta=cmeta,
                          shape=[int(flat_avg.size)]),
                    payload, timeout=_timeout(), peer_id=group[j]["peer_id"],
                )
                for j in site if j != my_idx
            ])
        else:
            rmeta, payload = await self._wait_mailbox(
                (f"{round_key}/bcast", "result", 0), deadline
            )
            self._check_hier_frame(rmeta, my_plan)
            if int(rmeta["shape"][0]) != flat_avg.size:
                raise WireError(
                    f"bcast: aggregator claims {rmeta['shape']} elements, "
                    f"expected {flat_avg.size}"
                )
            raw.decode_into(payload, rmeta["meta"], flat_avg)
            release_buffer(payload)
        timings["bcast_s"] = time.monotonic() - t_ph
        if tr is not None:
            tr.add_span(
                "outer/hier_bcast", t_ph_p, time.perf_counter(),
                round=round_key, group=m, site=site_idx,
            )
        return flat_avg

    def _chunk_sender(self, dest: dict, deadline: float):
        """Per-destination chunk transport for the pipelined exchange.

        Returns (send, close) coroutines. The first chunk at/above the bulk
        threshold opens a BulkStream (windowed acks: the socket never idles
        between chunks); smaller payloads and any stream failure use the
        ordinary `_send_part` routing, which re-sends the failed chunk over
        the RPC plane."""
        loop = self._loop
        state: dict = {"stream": None, "tried": False}

        async def send(msg: str, meta: dict, payload) -> None:
            nbytes = payload.nbytes if hasattr(payload, "nbytes") else len(payload)
            if (
                state["stream"] is None
                and not state["tried"]
                and self._bulk_sender is not None
                and nbytes >= self._bulk_threshold
            ):
                state["tried"] = True
                bulk_port = await self._bulk_port_of(dest["host"], dest["port"])
                if bulk_port:
                    try:
                        state["stream"] = await loop.run_in_executor(
                            None,
                            lambda: self._bulk_sender.stream(
                                dest["host"], bulk_port
                            ),
                        )
                    except Exception as e:
                        log.warning(
                            "bulk stream to %s:%s failed to open (%s); RPC path",
                            dest["host"], bulk_port, e,
                        )
            if state["stream"] is not None:
                try:
                    # the RPC fallback below throttles inside
                    # _send_part_inner; only the stream path pays here
                    await self._wan_throttle(dest.get("peer_id"), nbytes)
                    stage = _STAGE.get()
                    t0 = time.perf_counter()
                    await loop.run_in_executor(
                        None, state["stream"].send, msg, meta, payload
                    )
                    if self._adaptive() and dest.get("peer_id"):
                        self.links.observe_send(
                            dest["peer_id"], nbytes, time.perf_counter() - t0
                        )
                    if stage is not None:
                        stage.add("wire_send", time.perf_counter() - t0)
                        tr = obs.tracer()
                        if tr is not None:
                            tr.count("wire_tx_bytes", nbytes)
                            if self._is_wan_peer(dest.get("peer_id")):
                                tr.count("wire_tx_bytes_wan", nbytes)
                    return
                except Exception as e:
                    # the stream poisoned itself and dropped the pooled
                    # connection; this chunk falls through to the RPC path,
                    # later chunks follow it directly
                    state["stream"] = None
                    log.warning(
                        "bulk stream chunk to %s:%s failed (%s); RPC path",
                        dest["host"], dest["port"], e,
                    )
            await self._send_part(
                dest["host"], dest["port"], msg, meta, payload,
                timeout=max(5.0, deadline - time.monotonic()),
                peer_id=dest.get("peer_id"),
            )

        async def close() -> None:
            stream, state["stream"] = state["stream"], None
            if stream is not None:
                try:
                    await loop.run_in_executor(None, stream.close)
                except Exception as e:
                    log.warning(
                        "bulk stream to %s:%s failed at close (%s)",
                        dest["host"], dest["port"], e,
                    )
                    raise

        return send, close

    async def _exchange_pipelined(
        self, group, my_idx, n, parts, bounds, flat_size, round_key, deadline,
        scratch, timings, plan_meta=None,
    ):
        """Chunk-pipelined exchange: every part travels as fixed-size chunk
        frames, with codec work off the event loop (native kernels release
        the GIL) so compression, socket send, socket receive, and fused
        decode-accumulate overlap — encode chunk k+1 while chunk k is on
        the wire, accumulate chunk k as chunk k+1 is received.

        Bit-parity with the serial path: tensor-global codec state comes
        from a whole-part prescan (compression.chunk_state), the accumulate
        loop folds peers in group order with chunks in offset order (the
        serial path's exact per-element addition order), and the all-gather
        adopts decoded wire chunks for the owner's own part too."""
        from opendiloco_torch import native as _native
        from opendiloco_torch.diloco.bulk import release_buffer

        plan_meta = plan_meta or {}
        my_plan = plan_meta.get("plan")
        adaptive = self._adaptive()
        loop = self._loop
        chunk_elems = _pipeline_chunk_elems()
        align = getattr(self.codec, "chunk_align", 1)
        stage = _STAGE.get()
        codec = self.codec
        enc_chunk = (
            stage.timed("encode", codec.encode_chunk)
            if stage
            else codec.encode_chunk
        )
        chunk_state_fn = (
            stage.timed("encode", codec.chunk_state)
            if stage
            else codec.chunk_state
        )
        dec_acc = (
            stage.timed("accumulate", codec.decode_accumulate)
            if stage
            else codec.decode_accumulate
        )
        dec_into = (
            stage.timed("accumulate", codec.decode_into)
            if stage
            else codec.decode_into
        )

        # 3. push part j to its owner, chunk by chunk. With a link estimate
        # for the destination, the chunk size follows its BDP (whole-part
        # codec prescan keeps chunked encodes grid-independent, so per-dest
        # grids cannot perturb the bytes a receiver decodes)
        async def push(j):
            part = parts[j]
            ce = chunk_elems
            if adaptive:
                pid = group[j]["peer_id"]
                bps = self.links.bps_to(pid)
                if bps:
                    ce = linkstate.chunk_elems_for(
                        bps, self.links.rtt_to(pid) or 0.0, chunk_elems,
                        align=align,
                    )
            state = await loop.run_in_executor(None, chunk_state_fn, part)
            grid = chunk_bounds(part.size, ce, align)
            nchunks = len(grid) - 1

            def enc(k):
                payload, cmeta = enc_chunk(part[grid[k] : grid[k + 1]], state)
                record_wire(
                    codec.name, (grid[k + 1] - grid[k]) * 4, len(payload)
                )
                return payload, cmeta

            send, close = self._chunk_sender(group[j], deadline)
            nxt = loop.run_in_executor(None, enc, 0)
            try:
                for k in range(nchunks):
                    payload, cmeta = await nxt
                    if k + 1 < nchunks:
                        nxt = loop.run_in_executor(None, enc, k + 1)
                    await send(
                        "push",
                        {
                            "round": round_key,
                            "from": self._peer_id,
                            "meta": cmeta,
                            "shape": [int(part.size)],
                            **plan_meta,
                            **chunk_fields(
                                k, nchunks, grid[k], grid[k + 1] - grid[k]
                            ),
                        },
                        payload,
                    )
            finally:
                await close()

        # 4. fold incoming chunks into my accumulator as they decode, peers
        # in group order with chunks in offset order (the serial path's
        # exact per-element addition order; see _exchange_serial on why
        # group order — not own-part-first — is what keeps adaptive
        # re-partitioning bit-transparent)
        async def collect():
            acc = self._checkout_buf(parts[my_idx].size)
            scratch.append(acc)
            first = True
            for p in group:
                if p["peer_id"] == self._peer_id:
                    if first:
                        np.copyto(acc, parts[my_idx])
                    else:
                        _native.add_inplace(acc, parts[my_idx])
                    first = False
                    continue
                fold = dec_into if first else dec_acc
                k, nchunks = 0, 1
                while k < nchunks:
                    pmeta, payload = await self._wait_mailbox(
                        (round_key, "push", p["peer_id"], k), deadline
                    )
                    check_plan(pmeta, my_plan)
                    nchunks = int(pmeta.get("nchunks", 1))
                    coff, clen = chunk_span(pmeta, acc.size)
                    await loop.run_in_executor(
                        None,
                        fold,
                        payload,
                        pmeta["meta"],
                        acc[coff : coff + clen],
                    )
                    release_buffer(payload)
                    k += 1
                first = False
            _native.scale_inplace(acc, 1.0 / n)
            return acc

        t_ph = time.monotonic()
        t_ph_p = time.perf_counter()
        results = await asyncio.gather(
            collect(), *[push(j) for j in range(n) if j != my_idx]
        )
        my_avg = results[0]
        timings["scatter_reduce_s"] = time.monotonic() - t_ph
        tr = obs.tracer()
        if tr is not None:
            tr.add_span(
                "outer/scatter_reduce", t_ph_p, time.perf_counter(),
                round=round_key, group=n,
            )

        # 5. fan the averaged part back out chunk by chunk; gather the other
        # parts. Each chunk is encoded ONCE (shared future) and the same
        # payload serves every destination plus the owner's self-adoption of
        # the decoded wire value — the serial path's encode-once invariant
        # at chunk granularity.
        state = await loop.run_in_executor(None, chunk_state_fn, my_avg)
        grid = chunk_bounds(my_avg.size, chunk_elems, align)
        nchunks = len(grid) - 1

        def enc(k):
            return enc_chunk(my_avg[grid[k] : grid[k + 1]], state)

        enc_futs: dict = {}

        def chunk_fut(k):
            if k not in enc_futs:
                enc_futs[k] = loop.run_in_executor(None, enc, k)
            return enc_futs[k]

        flat_avg = self._checkout_buf(flat_size)
        self._retire_buf(round_key, flat_avg)

        async def send_result_to(j):
            send, close = self._chunk_sender(group[j], deadline)
            try:
                for k in range(nchunks):
                    payload, cmeta = await chunk_fut(k)
                    if k + 1 < nchunks:
                        chunk_fut(k + 1)  # encode k+1 while k is on the wire
                    await send(
                        "result",
                        {
                            "round": round_key,
                            "part": my_idx,
                            "from": self._peer_id,
                            "meta": cmeta,
                            "shape": [int(my_avg.size)],
                            **plan_meta,
                            **chunk_fields(
                                k, nchunks, grid[k], grid[k + 1] - grid[k]
                            ),
                        },
                        payload,
                    )
            finally:
                await close()

        async def adopt():
            my_dst = flat_avg[bounds[my_idx] : bounds[my_idx + 1]]
            for k in range(nchunks):
                payload, cmeta = await chunk_fut(k)
                await loop.run_in_executor(
                    None,
                    dec_into,
                    payload,
                    cmeta,
                    my_dst[grid[k] : grid[k + 1]],
                )

        async def recv_from(j):
            dst_part = flat_avg[bounds[j] : bounds[j + 1]]
            k, nchunks_j = 0, 1
            while k < nchunks_j:
                rmeta, payload = await self._wait_mailbox(
                    (round_key, "result", j, k), deadline
                )
                check_plan(rmeta, my_plan)
                nchunks_j = int(rmeta.get("nchunks", 1))
                if int(rmeta["shape"][0]) != dst_part.size:
                    raise WireError(
                        f"result part {j}: peer claims {rmeta['shape']} "
                        f"elements, expected {dst_part.size}"
                    )
                coff, clen = chunk_span(rmeta, dst_part.size)
                # (decode_into additionally validates the actual payload
                # length against the slice size before any native kernel)
                await loop.run_in_executor(
                    None,
                    dec_into,
                    payload,
                    rmeta["meta"],
                    dst_part[coff : coff + clen],
                )
                release_buffer(payload)
                k += 1

        t_ph = time.monotonic()
        t_ph_p = time.perf_counter()
        await asyncio.gather(
            adopt(),
            *[send_result_to(j) for j in range(n) if j != my_idx],
            *[recv_from(j) for j in range(n) if j != my_idx],
        )
        timings["all_gather_s"] = time.monotonic() - t_ph
        if tr is not None:
            tr.add_span(
                "outer/all_gather", t_ph_p, time.perf_counter(),
                round=round_key, group=n,
            )
        return flat_avg

    def _peer_id_epoch_key(self) -> str:
        ep = self._own_progress.epoch if self._own_progress else 0
        return f"epoch-{ep}"

    # -- state serving / fetching -----------------------------------------

    def serve_state(self, get_state) -> None:
        self._state_provider = get_state

    def fetch_state(self) -> Optional[dict]:
        obs.count("fetch_state_calls")
        try:
            _, meta, _ = self._run(
                self._rdv_request(
                    "who_has_state",
                    {"exclude": self._peer_id},
                    timeout=self.rpc_timeout,
                ),
                # headroom for a full failover sweep (request + re-register
                # + progress re-push per rotation)
                timeout=self.rpc_timeout * 3 * len(self.rendezvous_list) + 5,
            )
            peer = meta.get("peer")
            if not peer:
                return None
            msg, smeta, blob = self._run(
                self._peer_request(
                    peer["host"],
                    peer["port"],
                    "fetch_state",
                    {},
                    timeout=self.rpc_timeout * 4,
                ),
                timeout=self.rpc_timeout * 4 + 5,
            )
            if msg != "state":
                return None
            return deserialize_state(smeta, blob)
        except Exception as e:
            log.warning("fetch_state failed: %s", e)
            return None

    def barrier(self, *, timeout: Optional[float] = None) -> None:
        with obs.span("outer/barrier_wait"):
            self.all_reduce(
                [np.zeros(1, np.float32)], timeout=timeout or 60.0, tag="barrier"
            )

    def close(self) -> None:
        try:
            self._run(
                request(  # best-effort, current daemon only: no failover dance
                    *self.rendezvous,
                    "unregister",
                    {"peer_id": self._peer_id},
                    timeout=5.0,
                ),
                timeout=10.0,
            )
        except Exception:
            pass
        if self._bulk_server is not None:
            self._bulk_server.stop()
        if self._bulk_sender is not None:
            self._bulk_sender.close()
        if self._rdv_fallback is not None:
            self._rdv_fallback.stop()
        if self._loop and self._server:
            self._loop.call_soon_threadsafe(self._close_conn_pool)
            self._loop.call_soon_threadsafe(self._server.close)
        # the round buffers (about 2.5x the model's f32 bytes): a process
        # that runs on after its backend, or holds several, gets them back
        with self._pool_lock:
            self._free_bufs.clear()
            self._retired_bufs.clear()
