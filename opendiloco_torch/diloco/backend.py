"""Outer-loop communication backend interface.

The port's copy of ``opendiloco_tpu/diloco/backend.py``: everything the
outer loop needs from the network, behind one interface.

- ``all_reduce`` averages pseudo-gradient leaves across whoever is in the
  group this round (elastic group size).
- ``report_progress`` / ``peer_progress`` carry the progress gossip.
- ``fetch_state`` / ``serve_state`` carry late-joiner onboarding.
- ``gossip_view`` / ``pair_exchange`` / ``async_pair_match`` carry the
  gossip pair rounds (``outer_mode="gossip"``, ``diloco/gossip.py``); the
  loopback and TCP backends implement them.
"""
from __future__ import annotations

import abc
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np


@dataclasses.dataclass
class PeerProgress:
    peer_id: str
    epoch: int  # outer-step count
    samples: int  # samples accumulated inside the current inner phase
    samples_per_second: float
    timestamp: float

    def eta_to_epoch_end(self, target_samples: int) -> float:
        if self.samples_per_second <= 0:
            return float("inf")
        remaining = max(0, target_samples - self.samples)
        return remaining / self.samples_per_second


class AllReduceError(RuntimeError):
    pass


class OuterBackend(abc.ABC):
    """Host-side collective fabric between DiLoCo workers."""

    @property
    @abc.abstractmethod
    def peer_id(self) -> str: ...

    @abc.abstractmethod
    def num_peers(self) -> int:
        """Currently-known live peer count (including self)."""

    @abc.abstractmethod
    def all_reduce(
        self,
        arrays: list[np.ndarray],
        *,
        timeout: Optional[float] = None,
        tag: str = "grads",
        epoch: Optional[int] = None,
        group_cap: int = 0,
    ) -> tuple[list[np.ndarray], int]:
        """Average the arrays across the group; returns (averaged,
        group_size). Blocks until the round completes; raises
        AllReduceError on timeout or failure."""

    @abc.abstractmethod
    def report_progress(self, progress: PeerProgress) -> None: ...

    @abc.abstractmethod
    def peer_progress(self) -> list[PeerProgress]:
        """Latest known progress of all peers (including self)."""

    def fetch_state(self) -> Optional[dict[str, Any]]:
        """Download current training state from an up-to-date peer. None
        if no peer can serve."""
        return None

    def serve_state(self, get_state: Callable[[], dict[str, Any]]) -> None:
        """Register a callback that provides state to late joiners."""

    def gossip_view(self) -> tuple[list[str], Optional[dict]]:
        """(sorted live member ids, link matrix or None) — the local view
        the gossip pair scheduler derives pairings from. Default: whoever
        has gossiped progress recently (no barrier, no extra messages)."""
        members = {p.peer_id for p in self.peer_progress()}
        members.add(self.peer_id)
        return sorted(members), None

    def pair_exchange(
        self,
        payload: bytes,
        meta: dict,
        *,
        partner_id: str,
        round_key: str,
        timeout: Optional[float] = None,
    ) -> tuple[dict, bytes]:
        """One symmetric push-pull with ``partner_id`` under ``round_key``:
        deposit own (meta, payload), return the partner's. Raises
        AllReduceError on partner death / timeout (the gossip plane treats
        that as a dropped round, a non-event)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support gossip pair exchange"
        )

    def async_pair_match(
        self,
        *,
        frag_id: int,
        epoch: int,
        window: int,
        patience: Optional[float] = None,
    ) -> Optional[tuple[str, int, str]]:
        """Bounded-staleness matchmaking for free-running async gossip:
        find ANY available partner working fragment ``frag_id`` whose
        outer epoch is within ``window`` of ``epoch`` — no round
        alignment. Returns ``(partner_id, partner_epoch, match_key)``
        with both sides handed the SAME fresh ``match_key`` (the
        subsequent ``pair_exchange`` rides it), or None when no
        compatible partner turned up within ``patience`` seconds (the
        caller steps alone — a fast worker never blocks on a slow one).
        Default: async matching unsupported; callers fall back to the
        lockstep epoch-keyed pairing."""
        return None

    def barrier(self, *, timeout: Optional[float] = None) -> None:
        """Optional synchronization point (used by tests)."""

    def close(self) -> None: ...


def wait_for_peers(
    backend: OuterBackend,
    *,
    target_samples: int,
    own_epoch: int,
    strategy: str,
    timeout_waiting_for_peers: float,
    poll: float = 0.1,
    log=None,
) -> None:
    """WAIT_FOR_ALL straggler policy: poll peer progress until everyone is
    near the epoch boundary, or give up after
    ``timeout_waiting_for_peers`` and proceed without the stragglers.
    NO_WAIT returns immediately."""
    if strategy == "no_wait":
        return
    deadline = time.monotonic() + timeout_waiting_for_peers
    first = True
    while time.monotonic() < deadline:
        others = [p for p in backend.peer_progress() if p.peer_id != backend.peer_id]
        if not others:
            if log is not None:
                log.debug("wait_for_peers: no other peers known; proceeding")
            return
        behind = [
            p
            for p in others
            # peers >= 2 epochs behind will re-onboard at their next epoch
            # start; stalling the round on them buys nothing
            if own_epoch - p.epoch < 2
            and (p.epoch < own_epoch or (p.epoch == own_epoch and p.samples < target_samples))
        ]
        if not behind:
            return
        if first and log is not None:
            log.debug(
                "wait_for_peers: %d peers behind: %s",
                len(behind),
                [(p.peer_id, p.epoch, p.samples) for p in behind],
            )
            first = False
        etas = [p.eta_to_epoch_end(target_samples) for p in behind]
        if max(etas) <= poll:
            return
        time.sleep(min(poll, max(min(etas), 0.01)))
    if log is not None:
        log.warning(
            "timed out waiting %.0fs for slow peers; proceeding without them",
            timeout_waiting_for_peers,
        )
