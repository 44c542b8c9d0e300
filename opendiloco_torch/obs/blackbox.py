"""Flight recorder: an always-on, bounded black box per worker.

While the tracer (obs/trace.py) records *everything* up to a cap and
flushes once at exit, the flight recorder keeps only the *recent past*
— a ring of the last spans/instants, the last round-health rows, the
last metric snapshots, injected chaos faults, and watchdog anomalies —
and persists it whenever something interesting happens, so a worker
that dies mid-round (SIGKILL included) leaves a readable black box
behind. Dump triggers:

- fatal signal (SIGTERM/SIGABRT via chained handlers; hard crashes via
  ``faulthandler`` into a sidecar ``.crash`` file) and ``atexit``;
- chaos-plane fault injection (rate-limited by the flush interval);
- a watchdog trip (obs/anomaly.py) — always immediate;
- every round-health row, rate-limited by ``ODTP_OBS_BLACKBOX_FLUSH_S``
  — this continuous autodump is what survives a SIGKILL.

Dumps go atomically (tmp + ``os.replace``) to
``ODTP_OBS_DIR/blackbox-<worker>-<pid>.json`` (pid-suffixed so a worker
restarted under the same rank cannot overwrite its dead predecessor's
evidence); ``scripts/odtp_postmortem.py`` merges them across workers
into one causally-ordered round timeline.

The plane is armed by ``ODTP_OBS`` and zero-cost when unset: the
:func:`recorder` accessor is the same env-dict-hit + cached-compare
idiom as ``chaos.plane()`` / ``obs.tracer()``.

Environment knobs (read lazily at arm time):

- ``ODTP_OBS_BLACKBOX_CAP``      event-ring length (default 512)
- ``ODTP_OBS_BLACKBOX_FLUSH_S``  min seconds between rate-limited
                                 autodumps (default 5.0; 0 = dump on
                                 every trigger)
"""
from __future__ import annotations

import atexit
import faulthandler
import json
import os
import signal
import threading
import time
from collections import deque
from typing import Any, Optional

_ENV = "ODTP_OBS"
_DIR_ENV = "ODTP_OBS_DIR"
_CAP_ENV = "ODTP_OBS_BLACKBOX_CAP"
_FLUSH_ENV = "ODTP_OBS_BLACKBOX_FLUSH_S"
_DEFAULT_CAP = 512
_DEFAULT_FLUSH_S = 5.0

BLACKBOX_VERSION = 1

# signals that normally terminate a worker and can still run Python code
# (SIGKILL can't be caught -- the periodic autodump covers it)
_FATAL_SIGNALS = ("SIGTERM", "SIGABRT", "SIGHUP")


class FlightRecorder:
    """Bounded rings of recent telemetry + atomic dump-on-trouble."""

    def __init__(self, spec: str):
        self.spec = spec
        self.pid = os.getpid()
        self.cap = int(os.environ.get(_CAP_ENV, _DEFAULT_CAP))
        self.flush_s = float(os.environ.get(_FLUSH_ENV, _DEFAULT_FLUSH_S))
        self._lock = threading.Lock()
        self.events: deque = deque(maxlen=self.cap)
        self.health: deque = deque(maxlen=64)
        self.snapshots: deque = deque(maxlen=16)
        self.faults: deque = deque(maxlen=128)
        self.anomalies: deque = deque(maxlen=64)
        self.decisions: deque = deque(maxlen=128)
        self.dumps = 0
        self._last_dump = 0.0
        self._last_reason: Optional[str] = None
        self._installed = False
        self._prev_handlers: dict[int, Any] = {}
        self._crash_file = None

    # -- feeds (all O(1), ring-bounded) ---------------------------------------
    def note_event(self, ev: dict) -> None:
        """Mirror one tracer event (span/instant/counter-track) into the
        ring. Called from Tracer._record, so only when the plane is armed."""
        with self._lock:
            self.events.append(ev)

    def note_health(self, row: dict) -> None:
        """One round-health ledger row; also snapshots metrics and ticks
        the rate-limited autodump (the SIGKILL-survival path)."""
        with self._lock:
            self.health.append(row)
            self.snapshots.append({
                "wall": round(time.time(), 3),
                "round": row.get("round"),
                "metrics": self._flat_metrics(),
            })
        self.autodump("round")

    def note_fault(self, kind: str, site: str, detail: dict) -> None:
        """One chaos-plane injected fault (called from ChaosPlane._record)."""
        with self._lock:
            self.faults.append({
                "wall": round(time.time(), 3), "kind": kind, "site": site,
                **detail,
            })
        self.autodump(f"chaos:{kind}")

    def note_decision(self, rec: dict) -> None:
        """One control-plane decision (autoscaler scale/replace/shed
        policy change): ring-recorded and rate-limit-dumped, so a
        postmortem can line fleet actions up against the health rows
        that drove them."""
        with self._lock:
            self.decisions.append({"wall": round(time.time(), 3), **rec})
        self.autodump(f"decision:{rec.get('action', '?')}")

    def note_anomaly(self, rec: dict) -> None:
        """A watchdog trip: recorded and dumped immediately (no rate limit
        -- trips are already cooldown-limited by the watchdog itself)."""
        with self._lock:
            self.anomalies.append(rec)
        self.dump(reason=f"anomaly:{rec.get('kind', '?')}")

    # -- dumping --------------------------------------------------------------
    def autodump(self, reason: str) -> Optional[str]:
        """Dump unless one already happened within the flush interval."""
        now = time.monotonic()
        with self._lock:
            if self._last_dump and now - self._last_dump < self.flush_s:
                return None
        return self.dump(reason=reason)

    def path(self) -> Optional[str]:
        out_dir = os.environ.get(_DIR_ENV)
        if not out_dir:
            return None
        # pid-suffixed like trace-w<rank>-<pid>.jsonl: a worker restarted
        # under the same rank must not overwrite its dead predecessor's
        # black box -- that file IS the crash evidence
        return os.path.join(
            out_dir, f"blackbox-{self._worker()}-{self.pid}.json"
        )

    def _worker(self) -> Any:
        from opendiloco_torch.obs import trace

        tr = trace.tracer()
        if tr is not None and "worker" in tr.identity:
            return tr.identity["worker"]
        return self.pid

    def _flat_metrics(self) -> dict:
        from opendiloco_torch.obs import trace

        tr = trace.tracer()
        if tr is None:
            return {}
        snap = tr.snapshot()
        return {
            "counters": trace._flat_metrics(snap["counters"]),
            "gauges": trace._flat_metrics(snap["gauges"]),
        }

    def dump(self, reason: str = "manual", path: Optional[str] = None
             ) -> Optional[str]:
        """Atomically persist the black box. Returns the path, or None
        when no ``ODTP_OBS_DIR`` is set (the rings still accumulate)."""
        from opendiloco_torch.obs import trace

        path = path or self.path()
        if path is None:
            return None
        tr = trace.tracer()
        galaxy: dict = {}
        try:
            from opendiloco_torch.obs import overseer

            ov = overseer.plane()
            if ov is not None:
                galaxy = ov.matrix()
        except Exception:
            pass
        reqtrace_report: dict = {}
        try:
            from opendiloco_torch.obs import reqtrace as _reqtrace

            rt = _reqtrace.ring()
            if rt is not None:
                reqtrace_report = rt.report()
        except Exception:
            pass
        with self._lock:
            self.dumps += 1
            self._last_dump = time.monotonic()
            self._last_reason = reason
            box = {
                "version": BLACKBOX_VERSION,
                "worker": self._worker(),
                "pid": self.pid,
                "reason": reason,
                "wall": round(time.time(), 3),
                "origin_wall": tr.origin_wall if tr is not None else 0.0,
                "identity": dict(tr.identity) if tr is not None else {},
                "spec": self.spec,
                "dumps": self.dumps,
                "events": list(self.events),
                "health": list(self.health),
                "snapshots": list(self.snapshots),
                "faults": list(self.faults),
                "anomalies": list(self.anomalies),
                "decisions": list(self.decisions),
                "metrics": self._flat_metrics(),
                "galaxy": galaxy,
                "reqtrace": reqtrace_report,
            }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{self.pid}"
        with open(tmp, "w") as f:
            json.dump(trace._jsonable(box), f)
            f.write("\n")
        os.replace(tmp, path)
        return path

    # -- crash hooks ----------------------------------------------------------
    def install(self) -> None:
        """Idempotently install atexit / fatal-signal / faulthandler hooks.

        Called by long-lived entry points (train.py, serve scheduler) --
        NOT by the accessor, so short-lived tools and tests that arm the
        plane don't take over process signal handling as a side effect.
        """
        with self._lock:
            if self._installed:
                return
            self._installed = True
        atexit.register(self._atexit_dump)
        for name in _FATAL_SIGNALS:
            sig = getattr(signal, name, None)
            if sig is None:
                continue
            try:  # main thread only; embedded uses keep working without
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except (ValueError, OSError):
                pass
        path = self.path()
        if path is not None:
            # hard crashes (SIGSEGV/SIGFPE/...) can't run Python: route the
            # C-level traceback to a sidecar next to the JSON black box
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self._crash_file = open(path + ".crash", "w")
                faulthandler.enable(self._crash_file)
            except Exception:
                self._crash_file = None

    def _atexit_dump(self) -> None:
        try:
            self.dump(reason="atexit")
        except Exception:
            pass

    def _on_signal(self, signum, frame) -> None:
        try:
            self.dump(reason=f"signal:{signum}")
        except Exception:
            pass
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev != signal.SIG_IGN:
            # restore the default disposition and re-deliver so the exit
            # status still reflects the signal
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def close(self) -> None:
        if not self._installed:
            return
        try:
            atexit.unregister(self._atexit_dump)
        except Exception:
            pass
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
        if self._crash_file is not None:
            try:
                faulthandler.disable()
                self._crash_file.close()
            except Exception:
                pass
            self._crash_file = None
        self._installed = False


# -- process-wide accessor (same idiom as chaos.plane()) ----------------------
_rec: Optional[FlightRecorder] = None
_spec: Optional[str] = None
_lock = threading.Lock()


def recorder() -> Optional[FlightRecorder]:
    """The process flight recorder, or None when ODTP_OBS is unset."""
    global _rec, _spec
    spec = os.environ.get(_ENV) or None
    if spec == _spec:
        return _rec
    with _lock:
        if spec != _spec:
            old, _rec = _rec, (FlightRecorder(spec) if spec else None)
            _spec = spec
            if old is not None:
                old.close()
    return _rec


def install() -> Optional[FlightRecorder]:
    """Arm-and-install convenience for process entry points."""
    bb = recorder()
    if bb is not None:
        bb.install()
    return bb


def reset() -> None:
    """Drop the cached recorder (tests / env changes); restores signals."""
    global _rec, _spec
    with _lock:
        if _rec is not None:
            _rec.close()
        _rec = None
        _spec = None
