"""Rendezvous daemon: peer registry, progress gossip, group matchmaking.

The DCN replacement for hivemind's DHT bootstrap peer (`hivemind-dht` CLI
with a fixed identity key, reference: README.md:80-95, run_training.sh:44-53,
open_diloco/fixed_key.pem). Workers bootstrap off ``--initial-peers
host:port`` exactly like the reference's multiaddr UX, report progress
(replacing DiloCoProgressTracker's DHT gossip, hivemind_diloco.py:174-282),
and form per-epoch all-reduce groups (replacing DecentralizedAverager
matchmaking with ``matchmaking_time`` semantics, hivemind_diloco.py:342,403).

Run standalone:  python -m opendiloco_torch.diloco.rendezvous --port 9000

The port's copy of ``opendiloco_tpu/diloco/rendezvous.py``; its protocol
is the JAX daemon's and ``native/odtp-rendezvousd``'s, so workers of
either package meet at any of the three. Armed (``ODTP_OBS``), it counts
``rdv_frames`` by msg and ``rdv_rounds_closed`` and spans
``rdv/join_group``, under the JAX package's names.
"""

from __future__ import annotations

import asyncio
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from opendiloco_torch import obs
from opendiloco_torch.diloco import chaos
from opendiloco_torch.diloco.wire import STREAM_LIMIT, read_frame, send_frame
from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)

PEER_TTL = 60.0  # seconds without contact before a peer is considered dead


@dataclass
class PeerInfo:
    peer_id: str
    host: str
    port: int
    last_seen: float = field(default_factory=time.monotonic)
    # stored and replayed VERBATIM (the native daemon keeps the raw JSON the
    # same way): workers ride extra keys on it — the adaptive transport's
    # "links" vector (diloco/linkstate.py) and the overseer's "health"
    # roll-up (obs/overseer.py), both of which reach every group member
    # through the join_group reply's group snapshot and every peer through
    # register/progress replies. Daemons MUST NOT normalize or filter this
    # dict: it is the galaxy's only barrier-free gossip channel.
    progress: Optional[dict] = None
    serves_state: bool = False
    # the worker's embedded rendezvous port (0 = none): lets the swarm
    # re-form on a worker-hosted rendezvous after every daemon dies — the
    # hivemind property that every peer IS a DHT node
    rdv_port: int = 0

    def to_json(self) -> dict:
        return {
            "peer_id": self.peer_id,
            "host": self.host,
            "port": self.port,
            "progress": self.progress,
            "serves_state": self.serves_state,
            "rdv_port": self.rdv_port,
        }


class _GroupRound:
    """Matchmaking window for one (epoch) all-reduce round."""

    def __init__(self, key: str, window: float, cap: int = 0):
        self.key = key
        self.window = window
        self.cap = cap  # 0 = one global group; k = partition into groups <= k
        self.joiners: dict[str, PeerInfo] = {}
        self.event = asyncio.Event()
        self.opened = time.monotonic()
        self.closed = False
        self.group: list[dict] = []
        self.groups: dict[str, list[dict]] = {}  # per-peer when capped
        # set when a joiner had to be transparently re-registered: the
        # registry is stale, so only the window timer may close the round
        self.no_early_close = False
        # joiner-count hint from the workers (largest wins): when set, the
        # round closes the moment this many joiners arrive — a complete
        # group by definition, independent of registry freshness
        self.expect = 0

    def group_for(self, peer_id: str) -> list[dict]:
        if self.cap:
            return self.groups.get(peer_id, [])
        return self.group


class RendezvousServer:
    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        identity: Optional[str] = None,
        advertise: Optional[str] = None,
        join: Optional[list[str]] = None,
    ):
        self.host = host
        self.port = port
        self.identity = identity or uuid.uuid4().hex[:16]
        self.peers: dict[str, PeerInfo] = {}
        self.rounds: dict[str, _GroupRound] = {}
        # TTL-expired peers that may be mid-re-join: while any exist,
        # matchmaking rounds run their full window (no early close).
        # Cleared on re-register or when a full-window round closes
        # without the peer.
        self.tombstones: dict[str, float] = {}
        # dynamic daemon membership: other rendezvous daemons this one knows
        # of (addr string -> first_seen). Learned from `daemon_hello` (a new
        # daemon announcing itself via --join) and from workers' announces
        # (`known_daemons`). Advertised back to workers in every register/
        # progress reply so the bootstrap list can be a single address and
        # the daemon set can grow while the swarm runs -- the hivemind-DHT
        # property that the peer fabric is not fixed at launch
        # (reference: train_fsdp.py:205-212 initial_peers bootstrap).
        self.daemons: dict[str, float] = {}
        self._advertise = advertise
        self._join = list(join or [])
        self._server: Optional[asyncio.base_events.Server] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._writers: set[asyncio.StreamWriter] = set()  # live connections

    # -- lifecycle -------------------------------------------------------

    def start_in_thread(self) -> "RendezvousServer":
        """Run the server on a background thread (in-process daemon)."""
        self._thread = threading.Thread(target=self._thread_main, daemon=True)
        self._thread.start()
        # --join announces run (synchronously, for determinism) before the
        # started flag; give each unreachable join address its timeout
        if not self._started.wait(10 + 6 * len(self._join)):
            raise RuntimeError("rendezvous server failed to start")
        return self

    def _thread_main(self) -> None:
        asyncio.run(self._serve_forever())

    async def _serve_forever(self, announce: bool = False) -> None:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(self._handle, self.host, self.port, limit=STREAM_LIMIT)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("rendezvous %s listening on %s:%d", self.identity, self.host, self.port)
        for addr in self._join:
            try:
                await self._daemon_hello(addr)
            except Exception as e:
                log.warning("daemon_hello to %s failed: %s", addr, e)
        if announce:
            # the BOUND port (with --port 0 the requested one is useless)
            print(
                f"rendezvous daemon: initial_peers = {self.host}:{self.port}",
                flush=True,
            )
        self._started.set()
        async with self._server:
            try:
                await self._server.serve_forever()
            except asyncio.CancelledError:
                pass

    def stop(self) -> None:
        if self._loop and self._server:

            def _shutdown():
                # close parked connections too (join_group waiters), so
                # clients get the same prompt FIN a killed daemon process
                # would deliver via the kernel -- without this the in-thread
                # server leaks the sockets and a parked worker only notices
                # the death at its RPC timeout
                for w in list(self._writers):
                    try:
                        w.close()
                    except Exception:
                        pass
                self._server.close()

            try:
                self._loop.call_soon_threadsafe(_shutdown)
            except RuntimeError:
                pass  # loop already closed -- stop() is idempotent
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def address(self) -> str:
        return f"{self.host if self.host != '0.0.0.0' else '127.0.0.1'}:{self.port}"

    @property
    def advertised(self) -> str:
        """The address this daemon tells peers/daemons to reach it at."""
        return self._advertise or self.address

    # -- dynamic daemon membership ---------------------------------------

    async def _daemon_hello(self, addr: str) -> None:
        """Announce this daemon to an existing one (--join bootstrap) and
        adopt its registry + daemon set, so a daemon added mid-run serves a
        current swarm view before the first worker ever reaches it."""
        from opendiloco_torch.diloco.wire import request

        host, port = addr.rsplit(":", 1)
        _, meta, _ = await request(
            host,
            int(port),
            "daemon_hello",
            {
                "daemon": self.advertised,
                "identity": self.identity,
                "known_daemons": self._daemon_list(),
            },
            timeout=5.0,
        )
        self._adopt_daemons([addr], source="join")
        self._adopt_daemons(meta.get("daemons", []), source="join reply")
        adopted = self._adopt_peers(meta.get("peers", []))
        log.info(
            "joined daemon fabric via %s (%d peers, %d daemons adopted)",
            addr,
            adopted,
            len(self.daemons),
        )

    def _adopt_peers(self, peers: list) -> int:
        """Adopt unknown registry entries (replication from a worker announce
        or another daemon). Existing -- locally fresher -- entries win;
        adopted peers get a fresh TTL and expire normally if actually dead."""
        adopted = 0
        for p in peers or []:
            pid = p.get("peer_id")
            if not pid or pid in self.peers:
                continue
            self.peers[pid] = PeerInfo(
                pid,
                p.get("host", ""),
                int(p.get("port", 0)),
                progress=p.get("progress"),
                serves_state=bool(p.get("serves_state", False)),
                rdv_port=int(p.get("rdv_port", 0) or 0),
            )
            adopted += 1
        return adopted

    def _daemon_list(self) -> list[str]:
        """This daemon's advertised address plus every daemon it knows."""
        return [self.advertised] + sorted(self.daemons)

    def _adopt_daemons(self, addrs: list, source: str = "") -> None:
        # loopback guard (mirror of TcpBackend._note_daemons): a loopback
        # address only means something on its own host, so a daemon that is
        # itself multi-host-advertised must not adopt -- and re-advertise
        # fabric-wide -- loopback aliases carried in from colocated workers
        self_loopback = self.advertised.split(":")[0] in ("127.0.0.1", "localhost")
        for a in addrs:
            if not isinstance(a, str) or a == self.advertised or a in self.daemons:
                continue
            if a.split(":")[0] in ("127.0.0.1", "localhost") and not self_loopback:
                continue
            self.daemons[a] = time.monotonic()
            log.info("learned rendezvous daemon %s (%s)", a, source)

    # -- request handling ------------------------------------------------

    def _live_peers(self) -> dict[str, PeerInfo]:
        now = time.monotonic()
        dead = [pid for pid, p in self.peers.items() if now - p.last_seen > PEER_TTL]
        for pid in dead:
            log.warning("expiring dead peer %s", pid)
            del self.peers[pid]
            # tombstone: an expired peer may be mid-re-join (slow-link
            # rounds outlast the TTL), so matchmaking withholds early
            # closes until it re-registers OR a full-window round closes
            # without it -- proof the swarm moved on (see _join_group /
            # _close_round)
            self.tombstones[pid] = now
        return self.peers

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._writers.add(writer)
        try:
            msg, meta, _ = await read_frame(reader, timeout=120.0)
        except Exception:
            self._writers.discard(writer)
            writer.close()
            return
        cp = chaos.plane()
        if cp is not None and cp.rdv_blackout(
            meta.get("round") if msg == "join_group" else None
        ):
            # scripted daemon blackout: drop the frame without replying --
            # to the worker this daemon is dead, so failover/worker-hosted
            # rendezvous and round backoff machinery must carry the swarm
            self._writers.discard(writer)
            writer.close()
            return
        obs.count("rdv_frames", msg=msg)
        try:
            if msg == "register":
                info = PeerInfo(
                    meta["peer_id"],
                    meta["host"],
                    meta["port"],
                    rdv_port=int(meta.get("rdv_port", 0) or 0),
                )
                self.peers[info.peer_id] = info
                self.tombstones.pop(info.peer_id, None)
                log.info("peer %s joined from %s:%d", info.peer_id, info.host, info.port)
                # registry replication: a failing-over worker carries the
                # swarm's registry (see TcpBackend._announce_to) so this
                # daemon -- possibly fresh or restarted -- immediately knows
                # every peer and matchmaking never closes a round around the
                # single re-registered worker.
                adopted = self._adopt_peers(meta.get("known_peers", []))
                if adopted:
                    log.info(
                        "adopted %d replicated registration(s) from %s",
                        adopted,
                        info.peer_id,
                    )
                self._adopt_daemons(
                    meta.get("known_daemons", []), source=info.peer_id
                )
                await send_frame(
                    writer,
                    "ok",
                    {
                        "identity": self.identity,
                        "peers": [p.to_json() for p in self._live_peers().values()],
                        "daemons": self._daemon_list(),
                    },
                )
            elif msg == "unregister":
                self.peers.pop(meta["peer_id"], None)
                # a clean departure is positive proof the peer is not
                # mid-re-join: no matchmaking grace needed
                self.tombstones.pop(meta["peer_id"], None)
                await send_frame(writer, "ok", {})
            elif msg == "progress":
                pid = meta["peer_id"]
                if pid not in self.peers and "host" in meta:
                    # TTL-expired peers re-register transparently (a slow
                    # first jit compile must not blacklist a worker)
                    self.peers[pid] = PeerInfo(
                        pid,
                        meta["host"],
                        meta["port"],
                        rdv_port=int(meta.get("rdv_port", 0) or 0),
                    )
                    self.tombstones.pop(pid, None)
                    log.info("peer %s re-registered via progress", pid)
                if pid in self.peers:
                    self.peers[pid].last_seen = time.monotonic()
                    self.peers[pid].progress = meta["progress"]
                    self.peers[pid].serves_state = meta.get("serves_state", False)
                self._adopt_daemons(meta.get("known_daemons", []), source=pid)
                await send_frame(
                    writer,
                    "ok",
                    {
                        "peers": [p.to_json() for p in self._live_peers().values()],
                        "daemons": self._daemon_list(),
                    },
                )
            elif msg == "daemon_hello":
                # a daemon added mid-run announces itself; hand it the full
                # registry + daemon set and record it for worker discovery
                self._adopt_daemons(
                    [meta.get("daemon")] + list(meta.get("known_daemons", [])),
                    source=f"daemon {meta.get('identity', '?')}",
                )
                await send_frame(
                    writer,
                    "ok",
                    {
                        "identity": self.identity,
                        "peers": [p.to_json() for p in self._live_peers().values()],
                        "daemons": self._daemon_list(),
                    },
                )
            elif msg == "join_group":
                await self._join_group(writer, meta)
            elif msg == "who_has_state":
                candidates = [
                    p.to_json()
                    for p in self._live_peers().values()
                    if p.serves_state and p.peer_id != meta.get("exclude")
                ]
                best = max(
                    candidates,
                    key=lambda p: (p["progress"] or {}).get("epoch", -1),
                    default=None,
                )
                await send_frame(writer, "ok", {"peer": best})
            else:
                await send_frame(writer, "error", {"error": f"unknown message {msg!r}"})
        except Exception as e:  # keep the daemon alive on handler errors
            log.exception("rendezvous handler error")
            try:
                await send_frame(writer, "error", {"error": str(e)})
            except Exception:
                pass
        finally:
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _join_group(self, writer: asyncio.StreamWriter, meta: dict) -> None:
        """Collect joiners for ``matchmaking_time``; reply with the group.

        The window closes early once every live registered peer has joined
        (the common case), so rounds don't pay the full window when the
        swarm is healthy.
        """
        key = str(meta["round"])
        window = float(meta.get("matchmaking_time", 5.0))
        pid = meta["peer_id"]
        # stale = ANY registration (the joiner's or a partner's) already
        # outlived the TTL, whether still present or already reaped into a
        # tombstone: the registry cannot be trusted for an early close
        # this round. Checked BEFORE the joiner's refresh -- a fresh peer
        # joining first must not close a solo round while its expired
        # partner is still re-joining.
        now = time.monotonic()
        stale_joiner = bool(self.tombstones) or any(
            now - p.last_seen > PEER_TTL for p in self.peers.values()
        )
        if pid not in self.peers and "host" in meta:
            # TTL lapsed mid-round (a slow-link outer round can outlast the
            # TTL): re-register transparently so the joiner is never
            # matchmade out of its own group
            self.peers[pid] = PeerInfo(
                pid,
                meta["host"],
                int(meta.get("port", 0)),
                rdv_port=int(meta.get("rdv_port", 0) or 0),
            )
            log.info("peer %s re-registered via join_group", pid)
            stale_joiner = True
        if pid in self.peers:
            self.peers[pid].last_seen = time.monotonic()
            self.tombstones.pop(pid, None)  # the joiner itself is back

        rnd = self.rounds.get(key)
        if rnd is None or rnd.closed:
            rnd = _GroupRound(key, window, cap=int(meta.get("group_cap") or 0))
            self.rounds[key] = rnd
            asyncio.create_task(self._close_round_later(rnd))
        if pid in self.peers:
            rnd.joiners[pid] = self.peers[pid]
        if stale_joiner:
            # the registry is known-stale (this joiner had expired, its
            # peers likely did too): closing as soon as "every live peer
            # joined" would matchmake a solo group. Wait the full window so
            # the other expired peers can re-join.
            rnd.no_early_close = True
        rnd.expect = max(rnd.expect, int(meta.get("expect") or 0))
        if rnd.expect:
            # a declared swarm size overrides the registry heuristics in
            # BOTH directions: the round closes the instant all expected
            # joiners arrive (even with a stale registry — the group is
            # complete by definition), and never closes early on the
            # "every live peer joined" rule while joiners are still missing
            # (the registry may simply not know about them yet)
            if len(rnd.joiners) >= rnd.expect:
                self._close_round(rnd)
        elif not rnd.no_early_close and set(rnd.joiners) >= set(
            self._live_peers()
        ):
            self._close_round(rnd)

        tr = obs.tracer()
        if tr is None:
            await rnd.event.wait()
        else:
            t0 = tr.now()
            await rnd.event.wait()
            tr.add_span(
                "rdv/join_group", t0, tr.now(),
                round=key, joiners=len(rnd.joiners),
            )
        await send_frame(writer, "ok", {"group": rnd.group_for(pid)})

    async def _close_round_later(self, rnd: _GroupRound) -> None:
        await asyncio.sleep(rnd.window)
        if not rnd.closed:
            self._close_round(rnd)

    def _close_round(self, rnd: _GroupRound) -> None:
        rnd.closed = True
        obs.count("rdv_rounds_closed")
        # tombstoned peers that had this FULL matchmaking window to re-join
        # and did not: the swarm has demonstrably moved on without them.
        # A tombstone created after the round opened only had part of the
        # window -- it keeps its grace until a round that opened after it
        # closes without the peer.
        for pid in list(self.tombstones):
            if pid not in rnd.joiners and self.tombstones[pid] <= rnd.opened:
                log.info("peer %s did not re-join; forgetting", pid)
                del self.tombstones[pid]
        rnd.group = sorted(
            (p.to_json() for p in rnd.joiners.values()), key=lambda p: p["peer_id"]
        )
        if rnd.cap:
            # partition into groups of <= cap; the shuffle is seeded by the
            # round key so pairings vary epoch to epoch (gossip mixing)
            import random

            order = list(rnd.group)
            random.Random(rnd.key).shuffle(order)
            for i in range(0, len(order), rnd.cap):
                chunk = sorted(
                    order[i : i + rnd.cap], key=lambda p: p["peer_id"]
                )
                for p in chunk:
                    rnd.groups[p["peer_id"]] = chunk
        self.rounds.pop(rnd.key, None)
        rnd.event.set()


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="opendiloco_torch rendezvous daemon")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument(
        "--identity-file",
        default=None,
        help="persist/reuse a stable daemon identity (fixed_key.pem parity)",
    )
    ap.add_argument(
        "--join",
        default=None,
        help="comma list of existing daemon addresses to join (the daemon "
        "announces itself, adopts their registry, and workers learn it "
        "from any daemon's replies)",
    )
    ap.add_argument(
        "--advertise",
        default=None,
        help="address other hosts can reach this daemon at "
        "(default: bind host:port, with 0.0.0.0 as 127.0.0.1). REQUIRED for "
        "multi-host fabrics: workers refuse to adopt loopback addresses "
        "from remote daemons, so an unadvertised daemon is only "
        "discoverable on its own host",
    )
    ap.add_argument(
        "--ttl",
        type=float,
        default=None,
        help="seconds without contact before a peer is considered dead "
        "(default 60; the C++ daemon takes the same flag)",
    )
    args = ap.parse_args(argv)
    if args.ttl is not None:
        global PEER_TTL
        PEER_TTL = args.ttl

    identity = None
    if args.identity_file:
        import os

        if os.path.exists(args.identity_file):
            identity = open(args.identity_file).read().strip()
        else:
            identity = uuid.uuid4().hex[:16]
            with open(args.identity_file, "w") as f:
                f.write(identity)

    server = RendezvousServer(
        args.host,
        args.port,
        identity,
        advertise=args.advertise,
        join=args.join.split(",") if args.join else None,
    )
    asyncio.run(server._serve_forever(announce=True))


if __name__ == "__main__":
    main()
