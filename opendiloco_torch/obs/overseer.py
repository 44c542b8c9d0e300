"""Overseer: a converging galaxy health matrix riding existing gossip.

Each worker folds its telemetry into a compact roll-up dict (round id,
stage times, WAN/intra wire bytes, pseudo-grad norm, loss, tokens/s,
serve staleness, link capacity) and piggybacks it on the channels that
already gossip — the rendezvous ``progress`` dict (daemons store and
replay progress verbatim, see rendezvous.PeerInfo) and the post-round
link-vector announce. Every ``register``/``progress`` reply and every
``join_group`` group snapshot therefore hands each worker the latest
roll-up of every peer, so the whole galaxy converges on one health
matrix with **no new connections and no global barrier** — exactly how
link vectors travel (diloco/linkstate.py), and version-gated the same
way via :data:`HEALTH_VEC_VERSION`.

The matrix survives elastic membership and hier aggregator re-election
for free: it is keyed by peer id and refreshed by whatever announces
still happen; a dead worker's row simply stops updating (its ``ts``
ages), which is itself signal (see obs/anomaly.py dead-peer detection).

Zero-cost when ``ODTP_OBS`` is unset: :func:`plane` is the same
env-dict-hit + cached-compare accessor as ``chaos.plane()``; every hook
site in the transport is one ``is None`` branch.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

_ENV = "ODTP_OBS"

HEALTH_VEC_VERSION = 1

# gauges folded into the roll-up, tracer-name -> roll-up field
_GAUGE_FIELDS = (
    ("inner_loss", "loss"),
    ("inner_tokens_per_second", "tokens_per_s"),
    ("inner_steps_per_second", "steps_per_s"),
    ("pseudo_grad_norm", "pg_norm"),
    ("outer_epoch", "epoch"),
    ("serve_snapshot_staleness", "staleness"),
)
# cumulative counters folded in, tracer-name -> roll-up field
_COUNTER_FIELDS = (
    ("wire_tx_bytes", "wire_tx"),
    ("wire_rx_bytes", "wire_rx"),
    ("wire_tx_bytes_wan", "wire_tx_wan"),
    ("wire_rx_bytes_wan", "wire_rx_wan"),
)
# round-health ledger keys carried verbatim (stage StageTimes rows ride
# as their ``*_s`` ledger names)
_HEALTH_FIELDS = (
    "round", "group_size", "expected", "elastic", "retries",
    # gossip pair rounds (diloco/gossip.py): who this worker mixed with
    # last round, and whether the round was a pair round at all; pair_lag
    # is the epoch distance of an async bounded-staleness match
    "gossip", "partner", "pair_lag",
)
_STAGE_SUFFIX = "_s"


class Overseer:
    """Per-process roll-up builder + merged view of every peer's roll-up."""

    def __init__(self, spec: str):
        self.spec = spec
        self._lock = threading.Lock()
        self._matrix: dict[str, dict] = {}
        self._last_health: Optional[dict] = None
        self._rounds = 0

    # -- producing ------------------------------------------------------------
    def rollup(self, **extra: Any) -> dict:
        """This worker's compact health vector (JSON-ready, ~300 bytes).

        Cheap enough to rebuild on every progress announce: a handful of
        dict reads from the tracer plus the cached last round-health row.
        """
        from opendiloco_torch.obs import trace

        out: dict[str, Any] = {
            "v": HEALTH_VEC_VERSION,
            "ts": round(time.time(), 3),
        }
        tr = trace.tracer()
        if tr is not None:
            if "worker" in tr.identity:
                out["worker"] = tr.identity["worker"]
            gauges = tr.gauges()
            for name, field in _GAUGE_FIELDS:
                v = gauges.get((name, ()))
                if v is not None:
                    out[field] = round(float(v), 6)
            counters = tr.counters()
            for name, field in _COUNTER_FIELDS:
                v = counters.get((name, ()))
                if v:
                    out[field] = int(v)
        with self._lock:
            health = self._last_health
            out["rounds"] = self._rounds
        if health:
            for k in _HEALTH_FIELDS:
                if k in health:
                    out[k] = health[k]
            stages = {
                k: health[k] for k in health
                if k.endswith(_STAGE_SUFFIX) and isinstance(
                    health[k], (int, float))
            }
            if stages:
                out["stages"] = stages
        for k, v in extra.items():
            if v is not None:
                out[k] = v
        return out

    def note_round(self, health: dict, own_id: Optional[str] = None,
                   members: Optional[list] = None) -> None:
        """One completed outer round: refresh own matrix row, feed the
        flight recorder, and run the anomaly watchdogs. Called from the
        transport's round-health ledger append — never from a new channel.
        """
        with self._lock:
            self._last_health = health
            self._rounds += 1
        if own_id is not None:
            self.merge(own_id, self.rollup())
        try:
            from opendiloco_torch.obs import blackbox

            bb = blackbox.recorder()
            if bb is not None:
                bb.note_health(health)
        except Exception:
            pass
        try:
            from opendiloco_torch.obs import anomaly

            wd = anomaly.watchdog()
            if wd is not None:
                wd.on_round(health, self.matrix(), own_id=own_id,
                            members=members)
        except Exception:
            pass

    # -- merging --------------------------------------------------------------
    def merge(self, peer_id: str, vec: Any) -> None:
        """Adopt a peer's roll-up if it is well-formed, version-matched,
        and newer than what we hold (announce replies can replay stale
        progress after a daemon failover)."""
        if not peer_id or not isinstance(vec, dict):
            return
        if int(vec.get("v", 0) or 0) != HEALTH_VEC_VERSION:
            return
        ts = float(vec.get("ts", 0.0) or 0.0)
        with self._lock:
            cur = self._matrix.get(peer_id)
            if cur is not None and float(cur.get("ts", 0.0) or 0.0) > ts:
                return
            self._matrix[peer_id] = vec

    def matrix(self) -> dict[str, dict]:
        """peer_id -> latest roll-up, as this worker currently sees it."""
        with self._lock:
            return {pid: dict(v) for pid, v in self._matrix.items()}


# -- process-wide accessor (same idiom as chaos.plane()) ----------------------
_overseer: Optional[Overseer] = None
_spec: Optional[str] = None
_lock = threading.Lock()


def plane() -> Optional[Overseer]:
    """The process overseer, or None when ODTP_OBS is unset (zero-cost)."""
    global _overseer, _spec
    spec = os.environ.get(_ENV) or None
    if spec == _spec:
        return _overseer
    with _lock:
        if spec != _spec:
            _overseer = Overseer(spec) if spec else None
            _spec = spec
    return _overseer


def reset() -> None:
    """Drop the cached overseer (tests / env changes)."""
    global _overseer, _spec
    with _lock:
        _overseer = None
        _spec = None
