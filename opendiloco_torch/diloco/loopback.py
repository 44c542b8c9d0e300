"""In-process loopback backend: N worker threads, one shared world.

The port's copy of ``opendiloco_tpu/diloco/loopback.py`` ``LoopbackWorld``
and ``LoopbackBackend``: deterministic and socket-free, so the whole
DiLoCo algorithm runs in one process. A round completes when every *live*
peer has contributed; a peer that closes no longer blocks the group, and
the returned group size is the number of actual contributions.

Each contribution takes the world's codec's wire round trip (encode,
then decode) before the mean, as the JAX backend's does, so a lossy codec
shows in the trajectory as it would over sockets. The chaos and
observability hooks, capped gossip groups and pair exchange of the JAX
backend are left out.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from opendiloco_torch.diloco.backend import AllReduceError, OuterBackend, PeerProgress
from opendiloco_torch.diloco.compression import Codec, get_codec


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

    def make_backends(self) -> list["LoopbackBackend"]:
        return [LoopbackBackend(self, f"peer-{i}") for i in range(self.n_peers)]


class LoopbackBackend(OuterBackend):
    def __init__(self, world: LoopbackWorld, peer_id: str):
        self.world = world
        self._peer_id = peer_id
        # the last round's health, as the JAX backends record it
        self.last_round_health: dict = {}
        with world.lock:
            world.live.add(peer_id)

    def _record_round_health(self, tag, epoch, group: int) -> None:
        expected = self.world.n_peers
        self.last_round_health = {
            "round": f"{tag}-epoch-{epoch}",
            "group_size": group,
            "expected": expected,
            "elastic": bool(group < expected),
            "retries": 0,
        }

    @property
    def peer_id(self) -> str:
        return self._peer_id

    def num_peers(self) -> int:
        with self.world.lock:
            return len(self.world.live)

    def all_reduce(self, arrays, *, timeout=None, tag="grads", epoch=None, group_cap=0):
        """Average across live peers. The round completes when every live
        peer has contributed; dropped peers stop blocking the group the
        moment they close()."""
        if group_cap:
            raise NotImplementedError(
                "capped gossip groups are not ported yet (ROADMAP.md A12b)"
            )
        if epoch is None:
            with self.world.lock:
                own = self.world.progress.get(self._peer_id)
            epoch = own.epoch if own else 0
        w = self.world
        round_key = f"{tag}-epoch-{epoch}"
        # each leaf's wire round trip through the world's codec ("none":
        # a read-only view of an f32 copy)
        codec = w.codec
        contribution = [codec.decode(*_enc(codec, a)) for a in arrays]
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
            result = [a.copy() for a in slot["result"]]
            group = slot["result_group"]
            # drop the slot once every live contributor has collected
            slot["pending"] = {p for p in slot["pending"] if p != self._peer_id and p in w.live}
            if not slot["pending"] and not slot["contrib"]:
                w._rounds.pop(round_key, None)
        self._record_round_health(tag, epoch, group)
        return result, group

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
    return payload, a.shape, meta
