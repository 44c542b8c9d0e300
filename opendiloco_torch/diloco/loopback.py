"""In-process loopback backend: N worker threads, one shared world.

The port's copy of ``opendiloco_tpu/diloco/loopback.py`` ``LoopbackWorld``
and ``LoopbackBackend``: deterministic and socket-free, so the whole
DiLoCo algorithm runs in one process. A round completes when every *live*
peer has contributed; a peer that closes no longer blocks the group, and
the returned group size is the number of actual contributions.

Each contribution takes the world's codec's wire round trip (encode,
then decode) before the mean, as the JAX backend's does, so a lossy codec
shows in the trajectory as it would over sockets. ``group_cap`` splits
the live peers into capped groups frozen by the round's first arriver;
the gossip plane's wire is here too: ``gossip_view``, the keyed pair
mailbox of ``pair_exchange`` and the offer board of ``async_pair_match``.
The chaos gate (``ODTP_CHAOS``: straggler and latency sleeps, dropped
contributions retried) runs as in the JAX backend, and armed
(``ODTP_OBS``) each fault it injects lands in the flight recorder
(``chaos.py``).
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from opendiloco_torch import obs
from opendiloco_torch.diloco import chaos
from opendiloco_torch.diloco.backend import AllReduceError, OuterBackend, PeerProgress
from opendiloco_torch.diloco.compression import Codec, get_codec, record_wire


class LoopbackWorld:
    """Shared state for an in-process swarm with elastic membership."""

    def __init__(self, n_peers: int, compression: str = "none"):
        self.n_peers = n_peers
        self.codec: Codec = get_codec(compression)
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.progress: dict[str, PeerProgress] = {}
        self.state_provider: Optional[Callable[[], dict[str, Any]]] = None
        self.live: set[str] = set()
        # all-reduce round state, keyed by round key (f"{tag}-epoch-{epoch}");
        # each slot carries its own generation counter because keys repeat
        self._rounds: dict[str, dict] = {}
        # capped-group rounds: round key -> {"_partition": [...], group: {...}}
        self._gossip: dict = {}
        # pair-exchange mailboxes: round_key -> {peer_id: (meta, payload)};
        # "_taken" tracks pickups for GC
        self._pairbox: dict[str, dict] = {}
        # async-gossip offer board: frag_id -> {peer_id: offer}; a claimer
        # pops an offer under the lock and sets its "result", so no two
        # claimers take the same partner
        self._offers: dict[int, dict[str, dict]] = {}
        self._async_seq = 0  # match-key nonce

    def make_backends(self) -> list["LoopbackBackend"]:
        return [LoopbackBackend(self, f"peer-{i}") for i in range(self.n_peers)]


class LoopbackBackend(OuterBackend):
    def __init__(self, world: LoopbackWorld, peer_id: str):
        self.world = world
        self._peer_id = peer_id
        # round health and its ledger, as the JAX backends record them
        self.round_ledger: list[dict] = []
        self.last_round_health: dict = {}
        with world.lock:
            world.live.add(peer_id)

    def _chaos_gate(self) -> None:
        """Straggler and latency sleeps, and dropped contributions retried
        with the TCP round's bounded backoff; nothing when ODTP_CHAOS is
        unset."""
        cp = chaos.plane()
        if cp is None:
            return
        d = cp.straggle_s() + cp.delay_s("loopback")
        if d:
            time.sleep(d)
        attempt = 0
        while cp.drop_conn("loopback"):
            time.sleep(min(chaos.backoff_s(attempt), 1.0))
            attempt += 1

    def _record_round_health(self, tag, epoch, group: int) -> None:
        expected = self.world.n_peers
        health = {
            "round": f"{tag}-epoch-{epoch}",
            "group_size": group,
            "expected": expected,
            "elastic": bool(group < expected),
            "retries": 0,
        }
        self.last_round_health = health
        self.round_ledger.append(health)
        if len(self.round_ledger) > 256:
            del self.round_ledger[:-256]
        tr = obs.tracer()
        if tr is not None:
            tr.instant("outer/round", worker=self._peer_id, **health)
            tr.count("outer_rounds")
            if health["elastic"]:
                tr.count("outer_rounds_elastic")

    @property
    def peer_id(self) -> str:
        return self._peer_id

    def num_peers(self) -> int:
        with self.world.lock:
            return len(self.world.live)

    def gossip_view(self):
        with self.world.lock:
            return sorted(self.world.live), None

    def pair_exchange(self, payload, meta, *, partner_id, round_key, timeout=None):
        """Symmetric push-pull through a keyed in-world mailbox: deposit
        own frame, wait for the partner's. A partner that closes mid-round
        (or a split pairing that puts it on another key) raises
        AllReduceError, the gossip plane's dropped round."""
        self._chaos_gate()
        w = self.world
        deadline = time.monotonic() + (timeout if timeout else 60.0)
        with w.cond:
            slot = w._pairbox.setdefault(round_key, {"_taken": set()})
            slot[self._peer_id] = (dict(meta), bytes(payload))
            w.cond.notify_all()
            while partner_id not in slot:
                if partner_id not in w.live:
                    slot.pop(self._peer_id, None)
                    self._pairbox_gc(round_key)
                    raise AllReduceError(f"gossip partner {partner_id} left mid-round ({round_key})")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    slot.pop(self._peer_id, None)
                    self._pairbox_gc(round_key)
                    raise AllReduceError(f"gossip pair round {round_key} timed out waiting for {partner_id}")
                w.cond.wait(timeout=min(remaining, 0.1))
            p_meta, p_payload = slot[partner_id]
            slot["_taken"].add(self._peer_id)
            self._pairbox_gc(round_key)
        return p_meta, p_payload

    def async_pair_match(self, *, frag_id, epoch, window, patience=None):
        """Bounded-staleness matching through the in-world offer board:
        claim the closest-epoch standing offer within ``window`` (ties by
        peer id), else post one and wait up to ``patience`` to be claimed.
        The claimer mints the match key, so both sides leave with it."""
        w = self.world
        deadline = time.monotonic() + (patience if patience else 5.0)
        with w.cond:
            board = w._offers.setdefault(int(frag_id), {})
            cands = sorted(
                (abs(int(epoch) - o["epoch"]), pid)
                for pid, o in board.items()
                if pid != self._peer_id and o["result"] is None and pid in w.live
                and abs(int(epoch) - o["epoch"]) <= int(window)
            )
            if cands:
                _, pid = cands[0]
                other = board.pop(pid)
                w._async_seq += 1
                lo, hi = sorted((self._peer_id, pid))
                match_key = f"async-f{int(frag_id)}:{lo}|{hi}:{w._async_seq}"
                other["result"] = (self._peer_id, int(epoch), match_key)
                w.cond.notify_all()
                return pid, other["epoch"], match_key
            offer: dict = {"epoch": int(epoch), "result": None}
            board[self._peer_id] = offer
            w.cond.notify_all()
            while offer["result"] is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                w.cond.wait(timeout=min(remaining, 0.05))
            # withdraw if still standing (a claimer pops matched offers)
            if board.get(self._peer_id) is offer:
                board.pop(self._peer_id, None)
            return offer["result"]

    def _pairbox_gc(self, round_key: str) -> None:
        """Under world.lock: drop a consumed (or abandoned) slot and cap the
        box, so dropped rounds' deposits do not pile up."""
        box = self.world._pairbox
        slot = box.get(round_key)
        if slot is not None:
            deposited = set(slot) - {"_taken"}
            if not deposited or deposited <= slot["_taken"]:
                box.pop(round_key, None)
        while len(box) > 256:
            box.pop(next(iter(box)))

    def all_reduce(self, arrays, *, timeout=None, tag="grads", epoch=None, group_cap=0):
        """Average across live peers. The round completes when every live
        peer has contributed; dropped peers stop blocking the group the
        moment they close(). ``group_cap`` averages within capped groups
        instead (:meth:`_group_reduce`)."""
        self._chaos_gate()
        if epoch is None:
            with self.world.lock:
                own = self.world.progress.get(self._peer_id)
            epoch = own.epoch if own else 0
        if group_cap:
            out, n = self._group_reduce(arrays, tag, epoch, group_cap, timeout)
            self._record_round_health(tag, epoch, n)
            return out, n
        w = self.world
        round_key = f"{tag}-epoch-{epoch}"
        # each leaf's wire round trip through the world's codec ("none":
        # a read-only view of an f32 copy). The stage spans are the TCP
        # round's: encode, reduce_wait (until the mean is published), adopt
        codec = w.codec
        tr = obs.tracer()
        t0 = time.perf_counter() if tr is not None else 0.0
        contribution = [codec.decode(*_enc(codec, a)) for a in arrays]
        if tr is not None:
            tr.add_span("outer/encode", t0, time.perf_counter(), worker=self._peer_id, round=round_key)
        t_wait = time.perf_counter() if tr is not None else 0.0
        deadline = time.monotonic() + (timeout or 3600.0)
        with w.cond:
            slot = w._rounds.setdefault(
                round_key,
                {"round": 0, "contrib": {}, "result": None, "result_group": 0,
                 "result_round": -1, "pending": set()},
            )
            my_round = slot["round"]
            slot["contrib"][self._peer_id] = contribution
            w.cond.notify_all()
            while slot["result_round"] < my_round:
                if set(slot["contrib"]) >= w.live and slot["contrib"]:
                    # complete: the first thread to notice publishes the mean
                    contribs = list(slot["contrib"].values())
                    n = len(contribs)
                    slot["result"] = [
                        np.sum([c[i] for c in contribs], axis=0) / n for i in range(len(arrays))
                    ]
                    slot["result_group"] = n
                    slot["result_round"] = my_round
                    slot["round"] += 1
                    slot["pending"] = set(slot["contrib"])
                    slot["contrib"] = {}
                    w.cond.notify_all()
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # retract our contribution so a later round does not
                    # count a stale tensor from a dead peer
                    slot["contrib"].pop(self._peer_id, None)
                    w.cond.notify_all()
                    raise AllReduceError(f"{self._peer_id}: all-reduce timed out")
                w.cond.wait(timeout=min(remaining, 0.1))
            if tr is not None:
                tr.add_span("outer/reduce_wait", t_wait, time.perf_counter(), worker=self._peer_id, round=round_key)
            t_adopt = time.perf_counter() if tr is not None else 0.0
            result = [a.copy() for a in slot["result"]]
            group = slot["result_group"]
            # drop the slot once every live contributor has collected
            slot["pending"] = {p for p in slot["pending"] if p != self._peer_id and p in w.live}
            if not slot["pending"] and not slot["contrib"]:
                w._rounds.pop(round_key, None)
        if tr is not None:
            tr.add_span("outer/adopt", t_adopt, time.perf_counter(), worker=self._peer_id, round=round_key)
        self._record_round_health(tag, epoch, group)
        return result, group

    def _group_reduce(self, arrays, tag, epoch, cap, timeout):
        """Split the live peers into groups of at most ``cap`` for the round
        and average within the group only (the rendezvous daemon's capped
        matchmaking). The first arriver freezes the partition, so later
        joiners and churn cannot split a group."""
        w = self.world
        codec = w.codec
        key = f"{tag}-epoch-{epoch}"
        compressed = [codec.decode(*_enc(codec, a)) for a in arrays]
        deadline = time.monotonic() + (timeout or 3600.0)
        with w.cond:
            round_state = w._gossip.setdefault(key, {})
            if "_partition" not in round_state:
                members = sorted(w.live)
                random.Random(key).shuffle(members)
                round_state["_partition"] = [tuple(sorted(members[i:i + cap])) for i in range(0, len(members), cap)]
            group = next((g for g in round_state["_partition"] if self._peer_id in g), None)
            if group is None:
                # the partition froze before this peer was live, as the TCP
                # client's "group does not contain self"
                raise AllReduceError(f"{self._peer_id}: not in gossip partition")
            slot = round_state.setdefault(group, {"contrib": {}, "done": set()})
            slot["contrib"][self._peer_id] = compressed
            w.cond.notify_all()
            while True:
                live_members = [m for m in group if m in w.live or m in slot["contrib"]]
                if set(slot["contrib"]) >= set(live_members):
                    contribs = [slot["contrib"][m] for m in live_members]
                    n = len(contribs)
                    result = [np.sum([c[i] for c in contribs], axis=0) / n for i in range(len(arrays))]
                    slot["done"].add(self._peer_id)
                    if slot["done"] >= set(live_members):
                        round_state.pop(group, None)
                        if not any(isinstance(k, tuple) for k in round_state):
                            w._gossip.pop(key, None)
                    return [a.copy() for a in result], n
                if time.monotonic() >= deadline:
                    slot["contrib"].pop(self._peer_id, None)
                    w.cond.notify_all()
                    raise AllReduceError(f"{self._peer_id}: gossip round timed out")
                w.cond.wait(timeout=0.1)

    def report_progress(self, progress: PeerProgress) -> None:
        with self.world.lock:
            self.world.progress[progress.peer_id] = progress

    def peer_progress(self) -> list[PeerProgress]:
        with self.world.lock:
            live = self.world.live
            return [p for pid, p in self.world.progress.items() if pid in live]

    def fetch_state(self):
        with self.world.lock:
            provider = self.world.state_provider
        return provider() if provider else None

    def serve_state(self, get_state) -> None:
        with self.world.lock:
            self.world.state_provider = get_state

    def close(self) -> None:
        """Drop out of the swarm: stop blocking in-flight rounds."""
        with self.world.cond:
            self.world.live.discard(self._peer_id)
            self.world.progress.pop(self._peer_id, None)
            self.world.cond.notify_all()


def _enc(codec: Codec, a: np.ndarray):
    payload, meta = codec.encode(a)
    record_wire(codec.name, a.size * 4, len(payload))
    return payload, a.shape, meta
