"""Anomaly watchdogs: detect trouble, record it, never kill the run.

Four detectors, each sourced from telemetry that already exists:

- **straggler** — any worker whose round wall time exceeds
  ``ODTP_WATCHDOG_STRAGGLER_X`` x the galaxy median, or whose inner
  tokens/s falls below 1/X of it (both ride the overseer roll-ups; the
  throughput signal is the one that LOCALIZES a slow host, since a
  barrier-synchronized round spreads its delay over everyone);
- **divergence** — own pseudo-grad-norm or loss is a
  ``ODTP_WATCHDOG_DIVERGE_Z``-sigma outlier vs the galaxy;
- **stall** — no outer-round progress for ``ODTP_WATCHDOG_STALL_S``
  seconds (0 = off), checked by one low-frequency daemon thread;
- **dead peer** — an elastic round is missing a worker that completed
  earlier rounds (the overseer saw it in a group before);
- **stale worker** — under async bounded-staleness gossip
  (``ODTP_ASYNC_STALENESS`` > 0), a worker's epoch lags the galaxy's
  front-runner by more than the window: it can no longer be matched, so
  its progress stops mixing into the galaxy;
- **serve staleness breach** — the serving plane's adopted snapshot is
  older than its own ``max_stale_rounds`` bound;
- **SLO breach** — a serving replica's measured request p99 crossed the
  fleet's declared SLO; the trip carries exemplar request-trace IDs
  (obs/reqtrace.py) naming the offending requests.

Every trip emits an ``odtp_anomaly_<kind>`` counter, an
``anomaly/<kind>`` instant span, and a flight-recorder dump — and
nothing else: watchdogs observe, operators decide. Trips are
cooldown-limited per (kind, subject) so a persistent condition counts
once per window instead of flooding.

Armed by ``ODTP_OBS`` like the rest of the obs plane; :func:`watchdog`
is the same zero-cost accessor idiom as ``chaos.plane()``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)

_ENV = "ODTP_OBS"
_STALL_ENV = "ODTP_WATCHDOG_STALL_S"
_STRAGGLER_ENV = "ODTP_WATCHDOG_STRAGGLER_X"
_DIVERGE_ENV = "ODTP_WATCHDOG_DIVERGE_Z"
_ASYNC_WINDOW_ENV = "ODTP_ASYNC_STALENESS"
_DEFAULT_STALL_S = 0.0
_DEFAULT_STRAGGLER_X = 3.0
_DEFAULT_DIVERGE_Z = 6.0

# one trip per (kind, subject) per cooldown window; counters still
# increment per trip, so persistent conditions show a growing count
_COOLDOWN_S = 30.0

# straggler comparisons only consider roll-ups measured within this many
# seconds of the freshest one: a gossip matrix keeps a departed worker's
# last vector forever, and a stale vector reflects a different load
# regime (compile warm-up, different galaxy population) than the rows
# it would be compared against. Wide enough that a slow host that only
# joins every few elastic rounds still lands in the window
_STRAGGLER_FRESH_S = 60.0


def _median(vals: list) -> float:
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


class Watchdog:
    """Stateful detectors over round-health rows + the overseer matrix."""

    def __init__(self, spec: str):
        self.spec = spec
        self.stall_s = float(os.environ.get(_STALL_ENV, _DEFAULT_STALL_S))
        self.straggler_x = float(
            os.environ.get(_STRAGGLER_ENV, _DEFAULT_STRAGGLER_X))
        self.diverge_z = float(os.environ.get(_DIVERGE_ENV, _DEFAULT_DIVERGE_Z))
        # async gossip's bounded-staleness window: a worker whose epoch
        # lag exceeds it can no longer be matched, which is worth an
        # anomaly even though training proceeds without it
        self.async_window = int(os.environ.get(_ASYNC_WINDOW_ENV, "0") or 0)
        self._lock = threading.Lock()
        self._last_progress: Optional[float] = None
        self._last_trip: dict[tuple, float] = {}
        self._grouped: set = set()  # peers seen completing a round with us
        self._stall_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- trip plumbing --------------------------------------------------------
    def _trip(self, kind: str, subject: str = "", **attrs: Any) -> bool:
        """Record one anomaly (counter + instant + blackbox dump), unless
        the same (kind, subject) tripped within the cooldown window."""
        now = time.monotonic()
        with self._lock:
            key = (kind, subject)
            if now - self._last_trip.get(key, -_COOLDOWN_S) < _COOLDOWN_S:
                return False
            self._last_trip[key] = now
        log.warning("watchdog: %s %s %s", kind, subject, attrs)
        from opendiloco_torch.obs import trace

        tr = trace.tracer()
        if tr is not None:
            labels = {"peer": subject} if subject else {}
            tr.count(f"anomaly_{kind}", **labels)
            tr.instant(f"anomaly/{kind}", subject=subject, **attrs)
        try:
            from opendiloco_torch.obs import blackbox

            bb = blackbox.recorder()
            if bb is not None:
                bb.note_anomaly({
                    "wall": round(time.time(), 3), "kind": kind,
                    "subject": subject, **attrs,
                })
        except Exception:
            pass
        return True

    # -- detectors ------------------------------------------------------------
    def on_round(self, health: dict, matrix: dict,
                 own_id: Optional[str] = None,
                 members: Optional[list] = None) -> None:
        """Run the per-round detectors. ``matrix`` is the overseer's
        current galaxy view; ``members`` the group that just completed."""
        self.note_progress()
        self._check_straggler(matrix)
        self._check_divergence(health, matrix, own_id)
        self._check_dead_peers(health, members)
        self._check_stale_worker(matrix)

    def _check_straggler(self, matrix: dict) -> None:
        """Two signals, same threshold factor. Round wall time catches a
        worker whose rounds genuinely diverge from the galaxy's (retry
        loops, elastic regroups). Tokens/s catches the classic slow host:
        a barrier-synchronized round absorbs a straggler's delay into
        EVERYONE's round time, so only per-worker inner throughput
        localizes who the galaxy is waiting on. Both signals skip stale
        roll-ups (departed workers' frozen vectors) and first-round ones
        (compile warm-up dominates the timings)."""
        if self.straggler_x <= 0.0:
            return
        fresh_ts = max(
            (float(v["ts"]) for v in matrix.values()
             if isinstance(v.get("ts"), (int, float))), default=0.0)
        warm = {
            pid: v for pid, v in matrix.items()
            if isinstance(v.get("ts"), (int, float))
            and fresh_ts - float(v["ts"]) <= _STRAGGLER_FRESH_S
            and isinstance(v.get("rounds"), (int, float))
            and v["rounds"] >= 2
        }
        times = {
            pid: float(v["stages"]["round_s"])
            for pid, v in warm.items()
            if isinstance(v.get("stages"), dict)
            and v["stages"].get("round_s")
        }
        if len(times) >= 3:  # a median of two is just the other worker
            med = _median(list(times.values()))
            if med > 0.0:
                for pid, t in times.items():
                    if t > self.straggler_x * med:
                        self._trip(
                            "straggler", subject=pid,
                            round_s=round(t, 3),
                            galaxy_median_s=round(med, 3),
                            factor=round(t / med, 2),
                        )
        tps = {
            pid: float(v["tokens_per_s"]) for pid, v in warm.items()
            if isinstance(v.get("tokens_per_s"), (int, float))
            and v["tokens_per_s"] > 0
        }
        if len(tps) >= 3:
            med = _median(list(tps.values()))
            if med > 0.0:
                for pid, t in tps.items():
                    if t * self.straggler_x < med:
                        self._trip(
                            "straggler", subject=pid,
                            tokens_per_s=round(t, 1),
                            galaxy_median_tokens_per_s=round(med, 1),
                            factor=round(med / t, 2),
                        )

    def _check_stale_worker(self, matrix: dict) -> None:
        """Async bounded-staleness gossip only (window > 0): a worker
        whose epoch lags the galaxy's front-runner by MORE than the
        staleness window has fallen out of matchable range — nobody will
        mix with it until it catches up (or desync-onboards), so its
        local progress stops reaching the galaxy. Epochs ride the same
        overseer roll-ups odtp_top renders; stale vectors are skipped the
        same way the straggler detector skips them."""
        if self.async_window <= 0:
            return
        fresh_ts = max(
            (float(v["ts"]) for v in matrix.values()
             if isinstance(v.get("ts"), (int, float))), default=0.0)
        epochs = {
            pid: int(v["epoch"]) for pid, v in matrix.items()
            if isinstance(v.get("epoch"), (int, float))
            and isinstance(v.get("ts"), (int, float))
            and fresh_ts - float(v["ts"]) <= _STRAGGLER_FRESH_S
        }
        if len(epochs) < 2:
            return
        front = max(epochs.values())
        for pid, e in epochs.items():
            lag = front - e
            if lag > self.async_window:
                self._trip(
                    "stale_worker", subject=pid,
                    epoch=e, galaxy_front_epoch=front,
                    lag=lag, window=self.async_window,
                )

    def _check_divergence(self, health: dict, matrix: dict,
                          own_id: Optional[str]) -> None:
        if self.diverge_z <= 0.0 or own_id is None:
            return
        for field in ("pg_norm", "loss"):
            vals = {
                pid: float(v[field]) for pid, v in matrix.items()
                if isinstance(v.get(field), (int, float))
            }
            own = vals.get(own_id)
            if own is None or len(vals) < 4:
                continue
            others = [v for pid, v in vals.items() if pid != own_id]
            mean = sum(others) / len(others)
            var = sum((v - mean) ** 2 for v in others) / len(others)
            std = var ** 0.5
            if std <= 0.0:
                continue
            z = abs(own - mean) / std
            if z > self.diverge_z:
                self._trip(
                    "divergence", subject=str(field),
                    value=round(own, 6), galaxy_mean=round(mean, 6),
                    z=round(z, 2), round=health.get("round"),
                )

    def _check_dead_peers(self, health: dict,
                         members: Optional[list]) -> None:
        if not members:
            return
        current = set(members)
        with self._lock:
            missing = (self._grouped - current) if health.get("elastic") \
                else set()
            self._grouped |= current
        for pid in sorted(missing):
            if self._trip("dead_peer", subject=str(pid),
                          round=health.get("round")):
                with self._lock:
                    # once reported, a peer must complete a round with us
                    # again before it can be declared dead a second time
                    self._grouped.discard(pid)

    def serve_staleness(
        self, staleness: float, bound: float, exemplars: Any = ()
    ) -> None:
        """Serving-plane hook: adopted-snapshot staleness vs its bound.
        ``exemplars`` names recent request-trace IDs served while stale,
        so the anomaly record points at reviewable evidence."""
        if bound > 0 and staleness > bound:
            self._trip(
                "serve_staleness", staleness=round(float(staleness), 3),
                bound=float(bound), exemplars=list(exemplars),
            )

    def slo_breach(
        self,
        p99_ms: float,
        bound_ms: float,
        subject: str = "",
        exemplars: Any = (),
    ) -> bool:
        """Serving-fleet hook: measured request p99 crossed the declared
        SLO. ``exemplars`` carries the offending trace IDs (reqtrace
        ring exemplars) so every breach — and the scale-up it triggers —
        is explainable from recorded evidence."""
        if bound_ms > 0 and p99_ms > bound_ms:
            return self._trip(
                "slo_breach", subject=subject,
                p99_ms=round(float(p99_ms), 3), bound_ms=float(bound_ms),
                exemplars=list(exemplars),
            )
        return False

    def fleet_replica_dead(self, replica_id: str) -> bool:
        """Fleet-router hook: a serving replica stopped answering. Same
        anomaly kind as a departed training peer — the subject prefix
        tells the two planes apart in the counters."""
        return self._trip("dead_peer", subject=f"replica:{replica_id}")

    # -- stall deadline -------------------------------------------------------
    def note_progress(self, epoch: Optional[int] = None) -> None:
        """Any sign of outer progress resets the stall deadline. Called
        per round by the overseer and per outer step by the optimizer (so
        every backend feeds it, not just TCP)."""
        with self._lock:
            self._last_progress = time.monotonic()
            if (self.stall_s > 0.0 and self._stall_thread is None
                    and not self._stop.is_set()):
                self._stall_thread = threading.Thread(
                    target=self._stall_loop, name="odtp-watchdog-stall",
                    daemon=True,
                )
                self._stall_thread.start()

    def _stall_loop(self) -> None:
        # low-frequency: the deadline is in seconds-to-minutes territory
        period = max(1.0, self.stall_s / 4.0)
        while not self._stop.wait(period):
            with self._lock:
                last = self._last_progress
            if last is None:
                continue
            idle = time.monotonic() - last
            if idle > self.stall_s:
                self._trip("stall", idle_s=round(idle, 1),
                           deadline_s=self.stall_s)
                with self._lock:
                    # re-arm: a continuing stall trips once per deadline,
                    # not once per poll
                    self._last_progress = time.monotonic()

    def close(self) -> None:
        self._stop.set()
        t = self._stall_thread
        if t is not None:
            t.join(timeout=2.0)
            self._stall_thread = None


# -- process-wide accessor (same idiom as chaos.plane()) ----------------------
_watchdog: Optional[Watchdog] = None
_spec: Optional[str] = None
_lock = threading.Lock()


def watchdog() -> Optional[Watchdog]:
    """The process watchdog set, or None when ODTP_OBS is unset."""
    global _watchdog, _spec
    spec = os.environ.get(_ENV) or None
    if spec == _spec:
        return _watchdog
    with _lock:
        if spec != _spec:
            old, _watchdog = _watchdog, (Watchdog(spec) if spec else None)
            _spec = spec
            if old is not None:
                old.close()
    return _watchdog


def reset() -> None:
    """Drop the cached watchdog (tests / env changes); stops the thread."""
    global _watchdog, _spec
    with _lock:
        if _watchdog is not None:
            _watchdog.close()
        _watchdog = None
        _spec = None
