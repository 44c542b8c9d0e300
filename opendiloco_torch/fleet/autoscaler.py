"""SLO-driven fleet autoscaler: a closed loop from health to headcount.

The port's copy of ``opendiloco_tpu/fleet/autoscaler.py``. A control
thread reads the fleet's health matrix (each replica's queue depth, slot
occupancy, p99 and staleness, from the push channel's replies:
:meth:`FleetManager.health_matrix`) and steers the number of replicas the
router holds against a declared SLO::

    breach:  p99 > slo_p99_ms  OR  queue depth > slo_queue_depth
    clear:   p99 < slo_p99_ms/2 AND queues drained

with hysteresis (``up_evals`` breached ticks before growing,
``down_evals`` clear ticks before shrinking), a cooldown of one scaling
action per ``cooldown_s``, and ``min_replicas``/``max_replicas`` bounds.
Scale-up promotes a warm spare (a replica on the push channel that the
router does not know) before it boots a cold one; scale-down demotes to
spare while the pool has room. A replica the router marked dead is
retired and replaced at the same target count, with no cooldown. Every
action lands in the ``decisions`` log.

Env overrides: ``ODTP_FLEET_SLO_P99_MS``, ``ODTP_FLEET_WARM_SPARES``,
``ODTP_FLEET_SCALE_COOLDOWN_S``. The module moves names and addresses,
never weights. Armed (``ODTP_OBS``), as in the JAX package: a scale-up
names the slowest recent request traces (the replicas' exemplars, else
this process's ring), every action counts ``fleet_autoscale_decisions``
and lands in the flight recorder, an SLO breach trips the watchdog, and
each tick sets the ``fleet_replicas_target`` and
``fleet_warm_spares_ready`` gauges; the matrix it reads is overlaid with
the overseer's replica rows.
"""
from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Callable, Optional

from opendiloco_torch import obs

log = logging.getLogger(__name__)


class FleetAutoscaler:
    """Observe → decide → act loop over a FleetManager + FleetRouter.

    ``boot_fn(rid, register)`` must create a replica and attach it to
    the manager (``router_register=register``); ``retire_fn(rid)`` must
    detach and reap it. Both are supplied by ``build_fleet`` so the
    loop itself stays process-model agnostic (inprocess or subprocess)
    and unit-testable with fakes.
    """

    def __init__(
        self,
        manager,
        router,
        *,
        slo_p99_ms: float = 0.0,
        slo_queue_depth: int = 8,
        min_replicas: int = 1,
        max_replicas: int = 8,
        warm_spares: int = 0,
        cooldown_s: float = 5.0,
        eval_interval_s: float = 0.5,
        up_evals: int = 2,
        down_evals: int = 8,
        boot_fn: Optional[Callable[[str, bool], None]] = None,
        retire_fn: Optional[Callable[[str], None]] = None,
    ):
        env = os.environ.get("ODTP_FLEET_SLO_P99_MS")
        self.slo_p99_ms = float(env) if env else float(slo_p99_ms)
        env = os.environ.get("ODTP_FLEET_WARM_SPARES")
        self.warm_spares = int(env) if env else int(warm_spares)
        env = os.environ.get("ODTP_FLEET_SCALE_COOLDOWN_S")
        self.cooldown_s = float(env) if env else float(cooldown_s)
        self.manager = manager
        self.router = router
        self.slo_queue_depth = int(slo_queue_depth)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.eval_interval_s = float(eval_interval_s)
        self.up_evals = max(1, int(up_evals))
        self.down_evals = max(1, int(down_evals))
        self._boot_fn = boot_fn
        self._retire_fn = retire_fn
        self._lock = threading.Lock()
        self.decisions: collections.deque = collections.deque(maxlen=256)
        self.ticks = 0
        self._up_streak = 0
        self._down_streak = 0
        # monotonic time of the last scale action; None: none yet (the
        # monotonic clock starts near 0 at boot, so a 0.0 start would hold
        # a fresh machine's first action for cooldown_s)
        self._last_scale: Optional[float] = None
        self._seq = 0  # autoscaled-replica name counter
        self._booting: set = set()  # spare boots in flight (background)
        self._booting_active: set = set()  # cold scale-up boots in flight
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetAutoscaler":
        self._thread = threading.Thread(
            target=self._loop, name="odtp-fleet-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.eval_interval_s):
            try:
                self.evaluate()
            except Exception:
                # the control loop must outlive any single bad tick; the
                # fleet keeps serving at its current size either way
                log.exception("autoscaler tick failed")

    # -- observe -------------------------------------------------------------

    def _active(self) -> list:
        """Router-registered replicas — the traffic-taking set."""
        return sorted(self.router.stats()["replicas"])

    def _fleet_load(self, active: list) -> tuple:
        """Worst-replica load over the active set: (p99_ms, queue_depth).
        Max, not mean — one hot replica violating the SLO is a breach
        even if its siblings idle (dispatch imbalance is real load)."""
        matrix = self.manager.health_matrix()
        p99s = [
            matrix[rid]["p99_ms"]
            for rid in active
            if matrix.get(rid, {}).get("p99_ms") is not None
        ]
        depths = [
            matrix[rid]["queue_depth"]
            for rid in active
            if matrix.get(rid, {}).get("queue_depth") is not None
        ]
        return (
            max(p99s) if p99s else None,
            max(depths) if depths else 0,
        )

    def ready_spares(self) -> list:
        return [
            rid for rid in self.manager.spares()
            if self.manager.spare_ready(rid)
        ]

    def _breach_evidence(self, active: list) -> tuple:
        """(worst-p99 replica, exemplar trace ids) behind a breach.

        Exemplars are the breaching replicas' slowest recent request
        traces (``slo_exemplars`` riding their health rows), worst
        replica first, else this process's own request-trace ring (an
        in-process fleet shares one ring)."""
        matrix = self.manager.health_matrix()
        rows = [(rid, matrix.get(rid) or {}) for rid in active]
        rows.sort(key=lambda kv: -(kv[1].get("p99_ms") or 0.0))
        worst = rows[0][0] if rows else ""
        exemplars: list = []
        for _, row in rows:
            for tid in row.get("slo_exemplars") or []:
                if tid not in exemplars:
                    exemplars.append(tid)
        if not exemplars:
            rt = obs.reqtrace.ring()
            if rt is not None:
                exemplars = [ex["id"] for ex in rt.exemplars()]
        return worst, exemplars[:5]

    # -- act -----------------------------------------------------------------

    def _record(self, action: str, **detail) -> dict:
        rec = {"action": action, "tick": self.ticks, **detail}
        with self._lock:
            self.decisions.append(rec)
        log.info("autoscale %s: %s", action, detail)
        obs.count("fleet_autoscale_decisions", action=action)
        from opendiloco_torch.obs import blackbox

        bb = blackbox.recorder()
        if bb is not None:
            bb.note_decision(rec)
        return rec

    def _next_rid(self, prefix: str) -> str:
        with self._lock:
            return self._next_rid_locked(prefix)

    def _next_rid_locked(self, prefix: str) -> str:
        self._seq += 1
        return f"{prefix}{self._seq}"

    def _add_capacity(self) -> Optional[dict]:
        """One more traffic-taking replica: promote a ready spare
        (instant) or boot a cold one (slow). Cold boots run on a
        background thread — the control loop must keep ticking while a
        process boots, or a replica death during the boot would go
        unreplaced for the whole provisioning time. At most one cold
        boot is in flight at a time: a breach that persists while one
        races toward the router does not justify a second."""
        for rid in self.ready_spares():
            if self.manager.promote(rid):
                return {"replica": rid, "mode": "spare_promotion"}
        if self._boot_fn is None:
            return None
        with self._lock:
            if self._booting_active:
                return None
            rid = self._next_rid_locked("a")
            self._booting_active.add(rid)
        threading.Thread(
            target=self._boot_active, args=(rid,),
            name=f"odtp-fleet-boot-{rid}", daemon=True,
        ).start()
        return {"replica": rid, "mode": "cold_boot"}

    def _boot_active(self, rid: str) -> None:
        try:
            self._boot_fn(rid, True)
        except Exception:
            log.exception("replica %s failed to boot", rid)
        finally:
            with self._lock:
                self._booting_active.discard(rid)

    def _replenish_spares(self) -> None:
        """Keep the spare pool at its target. Boots run on background
        threads so a slow cold boot never stalls the control loop (a
        replacement decision mid-spike must not wait on provisioning),
        and never count against cooldown: spares take no traffic, so
        this is provisioning, not scaling."""
        if self._boot_fn is None:
            return
        with self._lock:
            short = (
                self.warm_spares
                - len(self.manager.spares())
                - len(self._booting)
            )
            rids = [self._next_rid_locked("s") for _ in range(max(0, short))]
            self._booting.update(rids)
        for rid in rids:
            threading.Thread(
                target=self._boot_spare, args=(rid,),
                name=f"odtp-fleet-boot-{rid}", daemon=True,
            ).start()
            self._record("boot_spare", replica=rid)

    def _boot_spare(self, rid: str) -> None:
        try:
            self._boot_fn(rid, False)
        except Exception:
            log.exception("spare %s failed to boot", rid)
        finally:
            with self._lock:
                self._booting.discard(rid)

    def _replace_dead(self) -> int:
        """Retire router-dead replicas and restore the same capacity.
        Not cooldown-gated: replacement holds the target size steady."""
        replaced = 0
        for rid in self.router.dead_replicas():
            if self._retire_fn is not None:
                self._retire_fn(rid)
            else:
                self.manager.detach(rid)
            sub = self._add_capacity()
            self._record("replace", dead=rid, **(sub or {"mode": "none"}))
            replaced += 1
        return replaced

    # -- decide --------------------------------------------------------------

    def evaluate(self) -> list:
        """One control tick; returns the decisions it made (tests drive
        this directly, the loop thread calls it on an interval)."""
        self.ticks += 1
        n0 = len(self.decisions)
        self._replace_dead()
        self._replenish_spares()

        active = self._active()
        p99, depth = self._fleet_load(active)
        breach = (
            self.slo_p99_ms > 0 and p99 is not None and p99 > self.slo_p99_ms
        ) or depth > self.slo_queue_depth
        clear = (
            self.slo_p99_ms <= 0
            or p99 is None
            or p99 < 0.5 * self.slo_p99_ms
        ) and depth <= max(1, self.slo_queue_depth // 4)
        self._up_streak = self._up_streak + 1 if breach else 0
        self._down_streak = self._down_streak + 1 if clear else 0

        exemplars: list = []
        if breach:
            worst, exemplars = self._breach_evidence(active)
            if self.slo_p99_ms > 0 and p99 is not None and p99 > self.slo_p99_ms:
                wd = obs.anomaly.watchdog()
                if wd is not None:
                    # the breach record carries the offending trace ids
                    wd.slo_breach(p99, self.slo_p99_ms, subject=worst, exemplars=exemplars)

        now = time.monotonic()
        cooled = self._last_scale is None or now - self._last_scale >= self.cooldown_s
        with self._lock:
            pending = len(self._booting_active)
        if (
            breach
            and self._up_streak >= self.up_evals
            and cooled
            and len(active) + pending < self.max_replicas
        ):
            sub = self._add_capacity()
            if sub is not None:
                self._last_scale = now
                self._up_streak = 0
                self._record(
                    "scale_up", p99_ms=p99, queue_depth=depth,
                    replicas=len(active) + 1, exemplars=exemplars, **sub,
                )
        elif (
            clear
            and self._down_streak >= self.down_evals
            and cooled
            and len(active) > self.min_replicas
        ):
            # shed the least-loaded replica; demote keeps it warm when
            # the spare pool has room, retire otherwise
            stats = self.router.stats()["replicas"]
            victim = min(
                (r for r in active if not stats[r]["dead"]),
                key=lambda r: (stats[r]["inflight"], stats[r]["dispatched"]),
                default=None,
            )
            if victim is not None:
                # with a spare pool configured, shrink by demotion: the
                # pool may transiently exceed its target (promotion
                # drains it first on the next breach), warmth is free
                if self.warm_spares > 0:
                    self.manager.demote(victim)
                    mode = "demote_to_spare"
                elif self._retire_fn is not None:
                    self._retire_fn(victim)
                    mode = "retire"
                else:
                    self.manager.detach(victim)
                    mode = "detach"
                self._last_scale = now
                self._down_streak = 0
                self._record(
                    "scale_down", p99_ms=p99, queue_depth=depth,
                    replica=victim, mode=mode, replicas=len(active) - 1,
                )

        obs.gauge("fleet_replicas_target", len(self._active()))
        obs.gauge("fleet_warm_spares_ready", len(self.ready_spares()))
        with self._lock:
            return list(self.decisions)[n0:]

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            decisions = list(self.decisions)[-32:]
        return {
            "slo_p99_ms": self.slo_p99_ms,
            "slo_queue_depth": self.slo_queue_depth,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "warm_spares": self.warm_spares,
            "ticks": self.ticks,
            "active": self._active(),
            "spares": self.manager.spares(),
            "spares_ready": self.ready_spares(),
            "decisions": decisions,
        }
