"""Zero-dependency tracing + metrics plane for the whole stack.

One process-wide :class:`Tracer` records spans (Chrome ``trace_event``
compatible, monotonic-clock timed), counters and gauges. The plane is
armed by ``ODTP_OBS`` and is zero-cost when unset: the :func:`tracer`
accessor is a single environment-dict lookup plus a cached string
compare returning ``None`` (the same idiom as ``chaos.plane()``), and
every hook site in the data plane is one ``is None`` branch.

Environment knobs (all read lazily, so tests can flip them):

- ``ODTP_OBS``            arm the plane ("1", or a free-form tag)
- ``ODTP_OBS_DIR``        directory for the JSONL event sink; when set,
                          the tracer flushes ``trace-w<rank>-<pid>.jsonl``
                          there at exit (and on explicit ``flush()``)
- ``ODTP_OBS_PROM_PORT``  bind a pull-based Prometheus text endpoint on
                          this port (0 = ephemeral). No port is ever
                          bound while ``ODTP_OBS`` is unset.
- ``ODTP_OBS_EVENTS_CAP`` ring limit for recorded events (default 65536);
                          overflow increments ``tracer().dropped``.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Callable, Optional

_ENV = "ODTP_OBS"
_DIR_ENV = "ODTP_OBS_DIR"
_PROM_ENV = "ODTP_OBS_PROM_PORT"
_CAP_ENV = "ODTP_OBS_EVENTS_CAP"
_DEFAULT_CAP = 65536


class _NullSpan:
    """Inert context manager returned by :func:`span` when disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "name", "attrs", "t0")

    def __init__(self, tr: "Tracer", name: str, attrs: dict):
        self._tr = tr
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        tr = self._tr
        stack = tr._stack()
        if stack:
            self.attrs.setdefault("parent", stack[-1])
        stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        t1 = time.perf_counter()
        stack = self._tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self._tr.add_span(self.name, self.t0, t1, **self.attrs)
        return False


class StageTimes:
    """Thread-safe per-stage wall-clock accumulator for one round.

    Concurrent stages (a pipelined encode overlapping a send) sum past
    wall-clock by design: the totals answer "where did work time go",
    not "how long did the round take".
    """

    __slots__ = ("_lock", "totals")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.totals: dict[str, float] = {}

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.totals[stage] = self.totals.get(stage, 0.0) + seconds

    def timed(self, stage: str, fn: Callable) -> Callable:
        """Wrap ``fn`` so its wall time accrues to ``stage``."""

        def run(*args: Any, **kwargs: Any) -> Any:
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(stage, time.perf_counter() - t0)

        return run


class Tracer:
    """Process-wide span/counter/gauge recorder. Thread-safe."""

    def __init__(self, spec: str):
        self.spec = spec
        self.pid = os.getpid()
        self.origin = time.perf_counter()
        self.origin_wall = time.time()
        self.cap = int(os.environ.get(_CAP_ENV, _DEFAULT_CAP))
        self.events: list[dict] = []
        self.dropped = 0
        self.identity: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._local = threading.local()
        self.prom = None
        port = os.environ.get(_PROM_ENV)
        if port is not None and port != "":
            from opendiloco_torch.obs import prom as _prom

            self.prom = _prom.start(int(port), self)
        if os.environ.get(_DIR_ENV):
            atexit.register(self.flush)

    # -- identity / time ----------------------------------------------------
    def set_identity(self, **attrs: Any) -> None:
        self.identity.update(attrs)

    def now(self) -> float:
        return time.perf_counter()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- spans --------------------------------------------------------------
    def span(self, name: str, **attrs: Any) -> _Span:
        return _Span(self, name, attrs)

    def add_span(self, name: str, t0: float, t1: float, **attrs: Any) -> None:
        """Record a completed interval (perf_counter stamps)."""
        self._record({
            "name": name,
            "ph": "X",
            "ts": (t0 - self.origin) * 1e6,
            "dur": max(0.0, (t1 - t0) * 1e6),
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": attrs,
        })

    def instant(self, name: str, **attrs: Any) -> None:
        self._record({
            "name": name,
            "ph": "i",
            "ts": (time.perf_counter() - self.origin) * 1e6,
            "s": "t",
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": attrs,
        })

    def _record(self, ev: dict) -> None:
        with self._lock:
            if len(self.events) >= self.cap:
                self.dropped += 1
            else:
                self.events.append(ev)
        # mirror into the flight recorder's ring of the RECENT past --
        # including events the capped main buffer dropped (a long run's
        # tail is exactly what a postmortem needs). Outside self._lock:
        # the recorder has its own lock and must not nest under ours.
        from opendiloco_torch.obs import blackbox

        bb = blackbox.recorder()
        if bb is not None:
            bb.note_event(ev)

    # -- counters / gauges --------------------------------------------------
    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    def count(self, name: str, n: float = 1, **labels: Any) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + n

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        v = float(value)
        with self._lock:
            self._gauges[self._key(name, labels)] = v
        # gauges double as Chrome ``counter`` events (ph="C") so Perfetto
        # renders loss / tokens_per_s / pseudo_grad_norm as value tracks
        # alongside the spans; labels fold into the track name the same
        # way _flat_metrics renders them
        if labels:
            body = ",".join(f"{k}={lv}" for k, lv in sorted(labels.items()))
            track = f"{name}{{{body}}}"
        else:
            track = name
        self._record({
            "name": track,
            "ph": "C",
            "ts": (time.perf_counter() - self.origin) * 1e6,
            "tid": 0,
            "args": {"value": v},
        })

    def counters(self) -> dict:
        with self._lock:
            return {k: v for k, v in self._counters.items()}

    def gauges(self) -> dict:
        with self._lock:
            return {k: v for k, v in self._gauges.items()}

    def snapshot(self) -> dict:
        """Counters + gauges with the chaos plane folded in first-class."""
        counters = self.counters()
        try:
            from opendiloco_torch.diloco import chaos

            cp = chaos.plane()
            if cp is not None:
                for kind, n in dict(cp.counters).items():
                    counters[self._key("chaos_faults", {"kind": kind})] = n
        except Exception:
            pass
        return {
            "counters": counters,
            "gauges": self.gauges(),
            "events": len(self.events),
            "dropped": self.dropped,
        }

    # -- sinks --------------------------------------------------------------
    def jsonl_path(self) -> Optional[str]:
        out_dir = os.environ.get(_DIR_ENV)
        if not out_dir:
            return None
        worker = self.identity.get("worker", "x")
        return os.path.join(out_dir, f"trace-w{worker}-{self.pid}.jsonl")

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Write all events + a trailing meta record as JSONL."""
        path = path or self.jsonl_path()
        if path is None:
            return None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        snap = self.snapshot()
        with self._lock:
            events = list(self.events)
        tmp = f"{path}.tmp.{self.pid}"
        with open(tmp, "w") as f:
            for ev in events:
                f.write(json.dumps(_jsonable(ev)) + "\n")
            meta = {
                "name": "meta",
                "ph": "M",
                "origin_wall": self.origin_wall,
                "pid": self.pid,
                "identity": _jsonable(self.identity),
                "counters": _flat_metrics(snap["counters"]),
                "gauges": _flat_metrics(snap["gauges"]),
                "dropped": snap["dropped"],
                "spec": self.spec,
            }
            f.write(json.dumps(meta) + "\n")
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        if self.prom is not None:
            self.prom.stop()
            self.prom = None
        try:
            atexit.unregister(self.flush)
        except Exception:
            pass


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    try:
        return float(obj)
    except Exception:
        return str(obj)


def _flat_metrics(metrics: dict) -> dict:
    """(name, labels) tuple keys -> 'name{a=b}' flat string keys."""
    out = {}
    for (name, labels), value in sorted(metrics.items(), key=str):
        if labels:
            body = ",".join(f"{k}={v}" for k, v in labels)
            out[f"{name}{{{body}}}"] = value
        else:
            out[name] = value
    return out


# -- process-wide accessor (same idiom as chaos.plane()) --------------------
_tracer: Optional[Tracer] = None
_spec: Optional[str] = None
_lock = threading.Lock()


def tracer() -> Optional[Tracer]:
    """The process tracer, or None when ODTP_OBS is unset (zero-cost)."""
    global _tracer, _spec
    spec = os.environ.get(_ENV) or None
    if spec == _spec:
        return _tracer
    with _lock:
        if spec != _spec:
            old, _tracer = _tracer, (Tracer(spec) if spec else None)
            _spec = spec
            if old is not None:
                old.close()
    return _tracer


def enabled() -> bool:
    return tracer() is not None


def span(name: str, **attrs: Any):
    """Module-level span: inert singleton context when disabled."""
    tr = tracer()
    if tr is None:
        return _NULL_SPAN
    return tr.span(name, **attrs)


def count(name: str, n: float = 1, **labels: Any) -> None:
    tr = tracer()
    if tr is not None:
        tr.count(name, n, **labels)


def gauge(name: str, value: float, **labels: Any) -> None:
    tr = tracer()
    if tr is not None:
        tr.gauge(name, value, **labels)


def reset() -> None:
    """Drop the cached tracer (tests / env changes); stops any endpoint."""
    global _tracer, _spec
    with _lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = None
        _spec = None
