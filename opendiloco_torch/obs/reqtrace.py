"""Per-request distributed tracing ring for the serving path.

Every request entering the serving plane gets a trace context minted at
the edge (router or server); the context rides the existing JSON payload
as the optional ``schema.TRACE_CTX_KEY`` field, and each hop appends
causally-ordered stage spans — admission, candidate choice, re-dispatch,
queue wait, prefill, per-decode-step batches, hot-swap pauses, terminal
retire/shed — into this process-local bounded ring.

Blackbox-style and zero-cost when ``ODTP_OBS`` is unset: the :func:`ring`
accessor is the same cached env-lookup idiom as ``trace.tracer()`` and
every hook site is one ``is None`` branch. Sampling is deterministic
(``ODTP_REQTRACE_SAMPLE``) and decided once at mint time: a request the
edge skipped carries no context, so downstream hops do no work either.

Cross-process assembly happens offline: each process records only the
spans it witnessed, keyed by the shared trace id, and
``scripts/obs_report.py --reqtrace`` (or ``odtp_top --requests``) merges
the per-process views. Span timestamps are milliseconds relative to the
local trace origin; ``wall0`` pins that origin to the wall clock for
cross-process ordering, the same arithmetic as ``export.clock_shifts``.

Environment knobs (all registered in analysis/knobs.py):

- ``ODTP_REQTRACE_CAP``     completed-trace ring bound (default 256)
- ``ODTP_REQTRACE_SAMPLE``  fraction of edge requests traced (default 1.0)
- ``ODTP_REQTRACE_EXPORT``  explicit dump path; defaults to
                            ``ODTP_OBS_DIR/reqtrace-<worker>-<pid>.json``
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Any, Optional

from opendiloco_torch.diloco.schema import (
    REQTRACE_STAGES,
    TRACE_CTX_KEY,
)

_ENV = "ODTP_OBS"
_DIR_ENV = "ODTP_OBS_DIR"
_CAP_ENV = "ODTP_REQTRACE_CAP"
_SAMPLE_ENV = "ODTP_REQTRACE_SAMPLE"
_EXPORT_ENV = "ODTP_REQTRACE_EXPORT"

# per-trace span-list bound: a long generation's decode steps coalesce
# past this (stage seconds keep accruing exactly; only the span list
# stops growing), so one 10k-token request cannot own the ring's memory
MAX_SPANS_PER_TRACE = 128

_DUMP_MIN_INTERVAL_S = 5.0


# -- trace-context payload helpers -------------------------------------------


def ctx_of(payload: Any) -> Optional[dict]:
    """The request's trace context, or None (absent/malformed — old peers
    and untraced requests look identical)."""
    if not isinstance(payload, dict):
        return None
    ctx = payload.get(TRACE_CTX_KEY)
    if isinstance(ctx, dict) and isinstance(ctx.get("id"), str):
        return ctx
    return None


def attach(payload: dict, ctx: Optional[dict]) -> dict:
    """Payload with the trace context attached (copy); identity when
    ``ctx`` is None so untraced requests stay byte-identical on the wire."""
    if ctx is None:
        return payload
    return {**payload, TRACE_CTX_KEY: {"id": ctx["id"], "o": ctx.get("o", "")}}


def _pctl(xs: list, q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


class RequestTraceRing:
    """Bounded per-process request-trace recorder. Thread-safe."""

    def __init__(self, spec: str):
        self.spec = spec
        self.pid = os.getpid()
        self.cap = int(os.environ.get(_CAP_ENV, "256"))
        self.sample = float(os.environ.get(_SAMPLE_ENV, "1.0"))
        self.worker: Any = "x"
        self.origin = time.perf_counter()
        self.origin_wall = time.time()
        self._lock = threading.Lock()
        self._salt = os.urandom(3).hex()
        self._seen = 0  # edge arrivals, sampled or not
        self._seq = 0
        self.inflight: dict[str, dict] = {}
        self.completed: deque = deque()
        self._done_index: dict[str, dict] = {}
        self.minted = 0
        self.adopted = 0
        self.finished = 0
        self.evicted = 0
        self._last_dump = 0.0
        if os.environ.get(_EXPORT_ENV) or os.environ.get(_DIR_ENV):
            atexit.register(self._atexit_dump)

    def set_identity(self, worker: Any) -> None:
        self.worker = worker

    # -- trace lifecycle ----------------------------------------------------
    def mint(self, **attrs: Any) -> Optional[dict]:
        """Mint a trace context for one edge arrival, or None when the
        deterministic sampler skips it. The returned dict is the wire
        context (``{"id", "o"}``) to attach to the request payload."""
        with self._lock:
            self._seen += 1
            if int(self._seen * self.sample) == int((self._seen - 1) * self.sample):
                return None
            self._seq += 1
            tid = f"{self.worker}-{self.pid:x}-{self._salt}-{self._seq:x}"
            self._begin_locked(tid, str(self.worker), attrs)
            self.minted += 1
        return {"id": tid, "o": str(self.worker)}

    def adopt(self, ctx: Optional[dict], **attrs: Any) -> Optional[str]:
        """Begin the local record for a context minted upstream (the
        sampling decision already happened at the edge). Idempotent."""
        if ctx is None or not isinstance(ctx.get("id"), str):
            return None
        tid = ctx["id"]
        with self._lock:
            if tid not in self.inflight and tid not in self._done_index:
                self._begin_locked(tid, str(ctx.get("o", "")), attrs)
                self.adopted += 1
        return tid

    def _begin_locked(self, tid: str, origin: str, attrs: dict) -> None:
        self.inflight[tid] = {
            "id": tid,
            "origin": origin,
            "worker": str(self.worker),
            "pid": self.pid,
            "t0": time.perf_counter(),
            "wall0": time.time(),
            "spans": [],
            "spans_dropped": 0,
            "stages_s": {},
            "attrs": dict(attrs),
            "status": None,
            "e2e_ms": None,
        }

    def _find(self, tid: Optional[str]) -> Optional[dict]:
        if tid is None:
            return None
        tr = self.inflight.get(tid)
        if tr is None:
            tr = self._done_index.get(tid)
        return tr

    def span(
        self, tid: Optional[str], stage: str, t0: float, t1: float, **attrs: Any
    ) -> None:
        """Append one completed stage interval (perf_counter stamps).

        Late spans landing after finish() still accrue (a re-dispatched
        request's first forward may complete its error path after the
        retry already answered) — causal order is by timestamp, not by
        arrival."""
        with self._lock:
            tr = self._find(tid)
            if tr is None:
                return
            dur = max(0.0, t1 - t0)
            tr["stages_s"][stage] = tr["stages_s"].get(stage, 0.0) + dur
            if len(tr["spans"]) >= MAX_SPANS_PER_TRACE:
                tr["spans_dropped"] += 1
                return
            tr["spans"].append({
                "stage": stage,
                "ts": (t0 - tr["t0"]) * 1e3,
                "ms": dur * 1e3,
                "attrs": attrs,
            })

    def event(self, tid: Optional[str], stage: str, **attrs: Any) -> None:
        """Zero-width span (e.g. a re-dispatch marker)."""
        now = time.perf_counter()
        self.span(tid, stage, now, now, **attrs)

    def annotate(self, tid: Optional[str], **attrs: Any) -> None:
        with self._lock:
            tr = self._find(tid)
            if tr is not None:
                tr["attrs"].update(attrs)

    def finish(
        self, tid: Optional[str], status: str = "done", **attrs: Any
    ) -> None:
        """Move the trace to the completed ring with a terminal status
        (done / shed / failed / cancelled). Idempotent."""
        with self._lock:
            tr = self.inflight.pop(tid, None) if tid else None
            if tr is None:
                return
            tr["status"] = status
            tr["e2e_ms"] = (time.perf_counter() - tr["t0"]) * 1e3
            tr["attrs"].update(attrs)
            self.completed.append(tr)
            self._done_index[tid] = tr
            self.finished += 1
            while len(self.completed) > self.cap:
                old = self.completed.popleft()
                self._done_index.pop(old["id"], None)
                self.evicted += 1

    # -- queries ------------------------------------------------------------
    def get(self, tid: str) -> Optional[dict]:
        with self._lock:
            tr = self._find(tid)
            return json.loads(json.dumps(tr, default=str)) if tr else None

    def has(self, tid: str) -> bool:
        with self._lock:
            return self._find(tid) is not None

    def inflight_ids(self) -> list:
        with self._lock:
            return list(self.inflight)

    def exemplars(self, n: int = 3) -> list:
        """The slowest recently-completed traces, worst first — the
        evidence an SLO-breach decision links to."""
        with self._lock:
            done = sorted(
                self.completed, key=lambda t: t["e2e_ms"] or 0.0, reverse=True
            )[: max(0, n)]
            return [
                {"id": t["id"], "e2e_ms": round(t["e2e_ms"], 3),
                 "status": t["status"]}
                for t in done
            ]

    # -- aggregation --------------------------------------------------------
    def report(self) -> dict:
        """Fleet-mergeable per-stage decomposition: per-request stage
        totals' p50/p99 + counts, plus end-to-end latency percentiles."""
        with self._lock:
            done = list(self.completed)
            n_inflight = len(self.inflight)
        stages: dict[str, dict] = {}
        for stage in REQTRACE_STAGES:
            samples = [
                t["stages_s"][stage] * 1e3
                for t in done
                if stage in t["stages_s"]
            ]
            if not samples:
                continue
            stages[stage] = {
                "count": len(samples),
                "p50_ms": round(_pctl(samples, 0.50), 3),
                "p99_ms": round(_pctl(samples, 0.99), 3),
                "total_s": round(sum(samples) / 1e3, 6),
            }
        e2e = [t["e2e_ms"] for t in done if t["e2e_ms"] is not None]
        statuses: dict[str, int] = {}
        for t in done:
            statuses[t["status"]] = statuses.get(t["status"], 0) + 1
        dominant = max(
            stages, key=lambda s: stages[s]["p99_ms"], default=None
        )
        return {
            "worker": str(self.worker),
            "pid": self.pid,
            "completed": len(done),
            "inflight": n_inflight,
            "minted": self.minted,
            "adopted": self.adopted,
            "evicted": self.evicted,
            "statuses": statuses,
            "e2e_ms": {
                "count": len(e2e),
                "p50": round(_pctl(e2e, 0.50), 3),
                "p99": round(_pctl(e2e, 0.99), 3),
            },
            "stages": stages,
            "dominant_stage_p99": dominant,
        }

    def snapshot(self, recent: int = 32) -> dict:
        """Control-frame body: the report plus compact inflight + recent
        trace rows for the odtp_top --requests live view."""
        now = time.perf_counter()
        with self._lock:
            infl = [
                {
                    "id": t["id"],
                    "age_ms": round((now - t["t0"]) * 1e3, 3),
                    "last_stage": (
                        t["spans"][-1]["stage"] if t["spans"] else None
                    ),
                    "stages_ms": {
                        k: round(v * 1e3, 3) for k, v in t["stages_s"].items()
                    },
                }
                for t in self.inflight.values()
            ]
            done = [
                {
                    "id": t["id"],
                    "status": t["status"],
                    "e2e_ms": round(t["e2e_ms"], 3),
                    "stages_ms": {
                        k: round(v * 1e3, 3) for k, v in t["stages_s"].items()
                    },
                    "attrs": t["attrs"],
                }
                for t in list(self.completed)[-max(0, recent):]
            ]
        return {"report": self.report(), "inflight": infl, "recent": done}

    def traces(self) -> list:
        """Full completed traces (spans included) — dump/merge payload."""
        with self._lock:
            return json.loads(json.dumps(list(self.completed), default=str))

    # -- sinks --------------------------------------------------------------
    def dump_path(self) -> Optional[str]:
        explicit = os.environ.get(_EXPORT_ENV) or None
        if explicit:
            return explicit
        out_dir = os.environ.get(_DIR_ENV)
        if not out_dir:
            return None
        return os.path.join(
            out_dir, f"reqtrace-{self.worker}-{self.pid}.json"
        )

    def dump(self, path: Optional[str] = None, reason: str = "") -> Optional[str]:
        path = path or self.dump_path()
        if path is None:
            return None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        body = {
            "reason": reason,
            "spec": self.spec,
            "worker": str(self.worker),
            "pid": self.pid,
            "origin_wall": self.origin_wall,
            "report": self.report(),
            "traces": self.traces(),
            "inflight": self.snapshot(recent=0)["inflight"],
        }
        tmp = f"{path}.tmp.{self.pid}"
        with open(tmp, "w") as f:
            json.dump(body, f)
            f.write("\n")
        os.replace(tmp, path)
        self._last_dump = time.monotonic()
        return path

    def autodump(self, reason: str = "") -> Optional[str]:
        """Rate-limited dump (blackbox idiom) for periodic hook sites."""
        if time.monotonic() - self._last_dump < _DUMP_MIN_INTERVAL_S:
            return None
        return self.dump(reason=reason)

    def _atexit_dump(self) -> None:
        try:
            self.dump(reason="atexit")
        except Exception:
            pass

    def close(self) -> None:
        try:
            atexit.unregister(self._atexit_dump)
        except Exception:
            pass


# -- process-wide accessor (same idiom as trace.tracer()) --------------------
_ring: Optional[RequestTraceRing] = None
_spec: Optional[str] = None
_lock = threading.Lock()


def ring() -> Optional[RequestTraceRing]:
    """The process request-trace ring, or None when ODTP_OBS is unset
    (zero-cost: one env lookup + cached string compare)."""
    global _ring, _spec
    spec = os.environ.get(_ENV) or None
    if spec == _spec:
        return _ring
    with _lock:
        if spec != _spec:
            old, _ring = _ring, (RequestTraceRing(spec) if spec else None)
            _spec = spec
            if old is not None:
                old.close()
    return _ring


def reset() -> None:
    """Drop the cached ring (tests / env changes)."""
    global _ring, _spec
    with _lock:
        if _ring is not None:
            _ring.close()
        _ring = None
        _spec = None
