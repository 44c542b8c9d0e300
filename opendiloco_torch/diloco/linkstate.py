"""Adaptive link layer for the outer data plane (``ODTP_LINK_ADAPT``).

The butterfly all-reduce historically split the flat pseudo-gradient into
*equal* parts and pumped every link with one global stripe/chunk policy —
so a single 4x-slower WAN link gated the whole galaxy (the NoLoCo
slowest-participant pathology, arXiv 2506.10911). This module closes the
measure->react loop on telemetry the planes already produce:

- :class:`LinkEstimator` keeps EWMA goodput + RTT per peer from the actual
  bulk/wire transfer timings (seeded by an optional micro-probe at first
  contact) and publishes a compact per-worker link vector.
- The vector gossips inside the worker's ``progress`` dict, which both the
  python and native rendezvous daemons store and replay VERBATIM — so a
  ``join_group`` reply already hands every member an identical snapshot of
  the galaxy's link matrix, with zero daemon changes.
- :func:`planner.plan_bounds` (diloco/planner.py — re-exported here) turns
  that shared snapshot into butterfly part bounds proportional to measured
  capacity (min-share floor, per-round re-planning); determinism comes
  from planning *only* from the shared group snapshot, and
  :func:`planner.plan_hash` rides every push/result frame so a divergent
  plan fails loudly instead of corrupting the reduce.
- :func:`stripes_for` / :func:`chunk_elems_for` derive per-link stripe
  counts and pipeline chunk sizes from bandwidth x RTT (BDP) instead of
  the global ``ODTP_BULK_STREAMS`` / ``ODTP_PIPELINE_CHUNK_MB`` knobs;
  :func:`hedge_deadline_s` gives the bulk plane its straggler-hedging
  deadline.

Everything is inert while ``ODTP_LINK_ADAPT`` is unset: the uniform
butterfly runs exactly as before (parity-tested in tests/test_linkstate.py).

Stability knobs (read per call so tests and benches can flip them):

- ``ODTP_LINK_ADAPT``        master switch (default off).
- ``ODTP_LINK_MIN_SHARE``    floor on a part's share of the uniform size
                             (default 0.25: a slow peer still owns >= 1/4
                             of an equal part — it must not be starved out
                             of the information flow entirely).
- ``ODTP_LINK_HYST``         publish-side hysteresis (default 0.25): a
                             peer's published estimate only moves when the
                             live EWMA drifts >25% from the published
                             value, so plans stay stable round to round.
- ``ODTP_LINK_ALPHA``        EWMA smoothing factor (default 0.4).
- ``ODTP_LINK_PROBE_BYTES``  micro-probe payload (default 256 KiB; 0
                             disables the bandwidth probe, RTT-only).
- ``ODTP_LINK_HEDGE_FACTOR`` stripe lateness multiple before a hedge
                             re-dispatch (default 3.0; 0 disables).

The port's copy of ``opendiloco_tpu/diloco/linkstate.py``: the link
vectors a port worker publishes are the ones a JAX worker reads.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Any, Optional

from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)

# link vectors carry a version so a future incompatible layout can coexist
# with old peers (a mismatched/missing version simply forces uniform plans)
LINK_VEC_VERSION = 1

# samples smaller than this are RTT-dominated and would poison the goodput
# EWMA (a 2 KB control frame "measures" the syscall, not the link)
_MIN_SAMPLE_BYTES = 64 * 1024

# samples this large get the full EWMA weight; smaller ones fold in
# proportionally less. Per-transfer elapsed time on a contended box is
# noise-dominated for short transfers (a scheduler stall is a fixed cost,
# so it distorts a 1 MB sample 8x harder than an 8 MB one) — and once the
# planner shrinks a part, that worker's fan-back samples get SMALLER,
# which un-weighted would spiral its estimate (and share) to the floor.
# Byte-weighting approximates total-bytes/total-time, which is the
# quantity the planner actually wants.
_FULL_WEIGHT_BYTES = 4 << 20

# the BDP->stripe conversion assumes one TCP stream keeps roughly a 4 MB
# window in flight (matches the SO_SNDBUF/SO_RCVBUF tuning in wire/bulk)
_STREAM_WINDOW_BYTES = 4 << 20


def enabled() -> bool:
    """Master switch; read per call (one env dict hit) like chaos.plane()."""
    return os.environ.get("ODTP_LINK_ADAPT", "").lower() in ("1", "true", "on")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def min_share() -> float:
    """Floor on a part's share of the uniform 1/n size, clamped to (0, 1]."""
    return min(1.0, max(0.01, _env_float("ODTP_LINK_MIN_SHARE", 0.25)))


def hysteresis() -> float:
    return max(0.0, _env_float("ODTP_LINK_HYST", 0.25))


def probe_bytes() -> int:
    return max(0, int(_env_float("ODTP_LINK_PROBE_BYTES", float(256 << 10))))


def hedge_factor() -> float:
    return max(0.0, _env_float("ODTP_LINK_HEDGE_FACTOR", 3.0))


class LinkEstimator:
    """Per-peer EWMA goodput/RTT from real transfer timings.

    Thread-safe: observations land from bulk executor threads and the
    asyncio event loop; publication happens on announce paths.

    ``publish()`` applies hysteresis: the *published* value for a peer only
    tracks the live EWMA once it drifts more than ``ODTP_LINK_HYST``
    relative — every consumer plans from published values, so the galaxy's
    plan doesn't flap on per-round measurement noise.
    """

    def __init__(self, own_id: str, alpha: Optional[float] = None):
        self.own_id = own_id
        self.alpha = alpha if alpha is not None else min(
            1.0, max(0.05, _env_float("ODTP_LINK_ALPHA", 0.4))
        )
        self._lock = threading.Lock()
        # peer_id -> [m_x, m_y, m_xx, m_xy, n_bps, rtt_s_ewma, n_rtt]:
        # exponentially-weighted moments of (nbytes, elapsed) samples.
        # The rate estimate fits elapsed = overhead + nbytes/rate, so a
        # fixed per-transfer cost (RTT, scheduler stall on a contended
        # box) lands in the intercept instead of biasing small transfers
        # slow — without this, a worker whose part the planner shrinks
        # MEASURES slower on its smaller sends and spirals to the floor.
        self._est: dict[str, list[float]] = {}
        # peer_id -> {"bps": ..., "rtt_ms": ...} as last published
        self._published: dict[str, dict[str, float]] = {}
        # latest remote vectors (peer_id -> their published vec), kept for
        # observability (the full link matrix view); planning reads the
        # join_group snapshot instead, which is the deterministic source
        self._remote: dict[str, dict] = {}

    # -- observations ------------------------------------------------------

    @staticmethod
    def _new_ent() -> list:
        return [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]

    @staticmethod
    def _rate(ent: list) -> Optional[float]:
        """Rate estimate for one peer from the weighted moments.

        When the sample sizes vary (the adaptive regime: every worker
        sends both push parts and its own fan-back part, two distinct
        sizes per peer per round), the regression slope var(x)/cov(x, y)
        inverts to the link rate with the fixed overhead removed. When
        they don't (cold start, uniform plans), the ratio m_x/m_y — the
        byte-weighted mean goodput — is the best available figure and is
        exactly the old naive estimate."""
        if ent[4] == 0:
            return None
        m_x, m_y, m_xx, m_xy = ent[0], ent[1], ent[2], ent[3]
        if m_y <= 0.0:
            return None
        ratio = m_x / m_y
        var = m_xx - m_x * m_x
        cov = m_xy - m_x * m_y
        if var > 0.05 * m_x * m_x and cov > 0.0:
            rate = var / cov
            # a noise-dominated slope can explode; the ratio (which still
            # CONTAINS the overhead, so it underestimates) bounds it
            if 0.0 < rate < 20.0 * ratio and math.isfinite(rate):
                return rate
        return ratio if ratio > 0.0 and math.isfinite(ratio) else None

    def observe_send(self, peer_id: str, nbytes: int, seconds: float) -> None:
        """Fold one outbound transfer (payload bytes / wall seconds)."""
        if nbytes < _MIN_SAMPLE_BYTES or seconds <= 0.0:
            return
        if not math.isfinite(seconds):
            return
        x, y = float(nbytes), float(seconds)
        w = self.alpha * min(1.0, nbytes / _FULL_WEIGHT_BYTES)
        with self._lock:
            ent = self._est.setdefault(peer_id, self._new_ent())
            if ent[4] == 0:
                ent[0], ent[1], ent[2], ent[3] = x, y, x * x, x * y
            else:
                ent[0] = w * x + (1.0 - w) * ent[0]
                ent[1] = w * y + (1.0 - w) * ent[1]
                ent[2] = w * x * x + (1.0 - w) * ent[2]
                ent[3] = w * x * y + (1.0 - w) * ent[3]
            ent[4] += 1

    def observe_rtt(self, peer_id: str, seconds: float) -> None:
        if seconds <= 0.0 or not math.isfinite(seconds):
            return
        with self._lock:
            ent = self._est.setdefault(peer_id, self._new_ent())
            ent[5] = seconds if ent[6] == 0 else (
                self.alpha * seconds + (1.0 - self.alpha) * ent[5]
            )
            ent[6] += 1

    def seed(self, peer_id: str, bps: float, rtt_s: float) -> None:
        """Micro-probe seeding: only fills peers with no real samples yet
        (a probe must never override goodput measured on actual parts)."""
        with self._lock:
            ent = self._est.setdefault(peer_id, self._new_ent())
            if ent[4] == 0 and bps > 0 and math.isfinite(bps):
                # one synthetic full-weight sample at the probed rate
                x, y = float(_FULL_WEIGHT_BYTES), _FULL_WEIGHT_BYTES / bps
                ent[0], ent[1], ent[2], ent[3] = x, y, x * x, x * y
                ent[4] = 1
            if ent[6] == 0 and rtt_s > 0 and math.isfinite(rtt_s):
                ent[5] = rtt_s
                ent[6] = 1

    def needs_probe(self, peer_id: str) -> bool:
        with self._lock:
            ent = self._est.get(peer_id)
            return ent is None or ent[4] == 0

    # -- queries -----------------------------------------------------------

    def bps_to(self, peer_id: str) -> Optional[float]:
        with self._lock:
            ent = self._est.get(peer_id)
            return self._rate(ent) if ent else None

    def rtt_to(self, peer_id: str) -> Optional[float]:
        with self._lock:
            ent = self._est.get(peer_id)
            return ent[5] if ent and ent[6] else None

    # -- gossip ------------------------------------------------------------

    def publish(self) -> dict:
        """The link vector that rides this worker's progress announces.

        Hysteresis happens HERE, not at observation time: the EWMA keeps
        tracking reality, but the published (and therefore planned-on)
        value only follows once the drift exceeds the threshold.
        """
        hyst = hysteresis()
        with self._lock:
            for pid, ent in self._est.items():
                pub = self._published.setdefault(pid, {})
                bps = self._rate(ent)
                if bps is not None:
                    old = pub.get("bps", 0.0)
                    if old <= 0.0 or abs(bps - old) > hyst * old:
                        pub["bps"] = round(bps, 1)
                if ent[6]:
                    old_ms = pub.get("rtt_ms", 0.0)
                    new_ms = ent[5] * 1e3
                    if old_ms <= 0.0 or abs(new_ms - old_ms) > hyst * old_ms:
                        pub["rtt_ms"] = round(new_ms, 3)
            peers = {
                pid: dict(v) for pid, v in self._published.items() if v
            }
        return {"v": LINK_VEC_VERSION, "peers": peers}

    def published_capacity(self) -> Optional[float]:
        """Median published egress bps across peers — the one-number link
        capacity that rides this worker's overseer health roll-up (the
        per-peer vector already travels separately as ``links``)."""
        with self._lock:
            rates = sorted(
                v["bps"] for v in self._published.values() if v.get("bps")
            )
        if not rates:
            return None
        mid = len(rates) // 2
        return rates[mid] if len(rates) % 2 else 0.5 * (
            rates[mid - 1] + rates[mid])

    def merge_remote(self, peer_id: str, vec: Any) -> None:
        """Keep the latest remote link vector (observability only)."""
        if peer_id == self.own_id or not isinstance(vec, dict):
            return
        if int(vec.get("v", 0) or 0) != LINK_VEC_VERSION:
            return
        with self._lock:
            self._remote[peer_id] = vec

    def matrix(self) -> dict[str, dict]:
        """own + remote published vectors: the galaxy link matrix as this
        worker currently sees it (obs report / debugging)."""
        own = self.publish()
        with self._lock:
            out = {pid: dict(v) for pid, v in self._remote.items()}
        out[self.own_id] = own
        return out


# -- link-vector access (planner input) ---------------------------------------


def _member_links(member: dict) -> Optional[dict]:
    vec = (member.get("progress") or {}).get("links")
    if not isinstance(vec, dict):
        return None
    if int(vec.get("v", 0) or 0) != LINK_VEC_VERSION:
        return None
    peers = vec.get("peers")
    return peers if isinstance(peers, dict) else {}


def member_health(member: dict) -> Optional[dict]:
    """The overseer health roll-up riding a registry/group-snapshot
    member, if any. Version checking stays with the overseer's merge
    (obs/overseer.py) — this is pure extraction, kept here next to
    ``_member_links`` because the two ride the identical channel."""
    vec = (member.get("progress") or {}).get("health")
    return vec if isinstance(vec, dict) else None


# The partition-planning functions (group_capacities, plan_shares,
# plan_bounds, plan_hash, shares_of) moved to diloco/planner.py — the one
# module every transport plans through. Re-exported lazily below so
# existing callers (and the published linkstate API) keep working without
# a circular import at module load.

_PLANNER_EXPORTS = (
    "group_capacities", "plan_shares", "plan_bounds", "plan_hash", "shares_of",
)


def __getattr__(name: str):
    if name in _PLANNER_EXPORTS:
        from opendiloco_torch.diloco import planner

        return getattr(planner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# -- BDP-derived transport parameters -----------------------------------------


def stripes_for(
    nbytes: int, bps: float, rtt_s: float, max_streams: Optional[int] = None
) -> int:
    """Stripe count for one bulk transfer from bandwidth x delay.

    One TCP stream sustains roughly window/RTT; the link needs
    ceil(BDP / window) streams to stay full. Clamped to [1, max_streams]
    (default: 2x the static ODTP_BULK_STREAMS knob) and never more than
    one stripe per MB of payload (tiny stripes cost more in thread/frame
    overhead than they recover)."""
    if max_streams is None:
        try:
            max_streams = 2 * max(
                1, int(os.environ.get("ODTP_BULK_STREAMS", "4"))
            )
        except ValueError:
            max_streams = 8
    if bps <= 0 or rtt_s < 0:
        return 1
    bdp = bps * max(rtt_s, 1e-4)
    want = int(math.ceil(bdp / _STREAM_WINDOW_BYTES))
    cap = max(1, nbytes // (1 << 20))
    return max(1, min(want, max_streams, cap))


def chunk_elems_for(bps: float, rtt_s: float, fallback: int, align: int = 1) -> int:
    """Pipeline chunk size (f32 elements) for one destination: grown from
    the static default toward one BDP per chunk, capped at 32 MiB of
    payload. Never SMALLER than ``fallback`` (the static chunk knob): BDP
    sizing exists to keep fat links full; shrinking chunks below the
    default only multiplies per-chunk overhead — and on a contended box
    that extra overhead feeds back into a lower goodput estimate, which
    would shrink the chunk further.

    ``align`` rounds the result down to the codec's ``chunk_align``
    granularity (never below ``align`` itself) so chunk boundaries stay on
    block/nibble multiples — blockwise codecs need block-grid-aligned
    chunks and 4-bit packing needs even element counts."""
    if bps <= 0:
        ce = fallback
    else:
        bdp = bps * max(rtt_s, 1e-3)
        nbytes = min(max(bdp, 4.0 * fallback), float(32 << 20))
        ce = max(fallback, int(nbytes) // 4)
    if align > 1:
        ce = max(align, ce - (ce % align))
    return ce


def hedge_deadline_s(nbytes: int, bps: float, rtt_s: float, streams: int) -> float:
    """How long a stripe may lag before it is re-dispatched over another
    connection. ``bps`` is the whole link's estimate; each of ``streams``
    concurrent stripes gets ~1/streams of it. 0 disables hedging."""
    factor = hedge_factor()
    if factor <= 0.0 or bps <= 0.0:
        return 0.0
    expected = nbytes * max(1, streams) / bps
    return factor * expected + 2.0 * max(rtt_s, 0.0) + 0.25
