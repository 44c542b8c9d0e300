"""Exporters for the obs plane: Chrome trace_event, Prometheus text, JSONL.

The Chrome output is the JSON Object Format of the ``trace_event`` spec
(a ``traceEvents`` list plus metadata) and loads directly in Perfetto /
``chrome://tracing``. The Prometheus output is version 0.0.4 text
exposition (``# TYPE`` comments, ``name{label="v"} value`` samples).
"""
from __future__ import annotations

import json
import re
from typing import Any, Iterable, Optional

from opendiloco_torch.obs.trace import Tracer, _flat_metrics

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


# -- Chrome trace_event -----------------------------------------------------
def clock_shifts(
    workers: "list[tuple[Any, list[dict], dict]]",
) -> "tuple[float, list[float]]":
    """Cross-process clock alignment: ``(t0, shifts_us)``.

    Each worker's events carry microsecond timestamps relative to its own
    monotonic origin; its meta record pins that origin to the wall clock
    (``origin_wall``). Shifting worker *i* by ``shifts_us[i]`` puts every
    event on one shared timeline whose zero is the earliest origin ``t0``.
    Both the Chrome merge below and ``scripts/odtp_postmortem.py`` order
    cross-worker events with exactly this arithmetic.
    """
    origins = [m.get("origin_wall", 0.0) for _, _, m in workers]
    t0 = min(origins) if origins else 0.0
    shifts = [
        (m.get("origin_wall", t0) - t0) * 1e6 for _, _, m in workers
    ]
    return t0, shifts


def chrome_trace(
    workers: "list[tuple[Any, list[dict], dict]]",
) -> dict:
    """Merge per-worker event lists into one Chrome trace object.

    ``workers`` is ``[(worker_id, events, meta), ...]`` where ``meta``
    is the trailing JSONL meta record (needs ``origin_wall`` to align
    monotonic clocks across processes). Each worker becomes one Chrome
    ``pid`` row, named ``worker <id>``.
    """
    _, shifts = clock_shifts(workers)
    trace_events: list[dict] = []
    for pid, (worker, events, meta) in enumerate(workers):
        shift_us = shifts[pid]
        trace_events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"worker {worker}"},
        })
        for ev in events:
            out = {
                "name": ev.get("name", "?"),
                "ph": ev.get("ph", "X"),
                "ts": float(ev.get("ts", 0.0)) + shift_us,
                "pid": pid,
                "tid": int(ev.get("tid", 0)),
                "args": ev.get("args", {}),
            }
            if out["ph"] == "X":
                out["dur"] = float(ev.get("dur", 0.0))
            elif out["ph"] == "i":
                out["s"] = ev.get("s", "t")
            elif out["ph"] == "C":
                # gauge counter track (see Tracer.gauge): Perfetto keys the
                # track on (pid, name) and plots args["value"] over time
                out["args"] = {"value": float(
                    (ev.get("args") or {}).get("value", 0.0))}
            trace_events.append(out)
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "opendiloco_torch.obs"},
    }


def tracer_chrome_trace(tr: Tracer) -> dict:
    """Single-process convenience wrapper around :func:`chrome_trace`."""
    with tr._lock:
        events = list(tr.events)
    meta = {"origin_wall": tr.origin_wall}
    worker = tr.identity.get("worker", tr.pid)
    return chrome_trace([(worker, events, meta)])


def write_chrome_trace(path: str, trace: dict) -> None:
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")


# -- JSONL ------------------------------------------------------------------
def load_jsonl(path: str) -> "tuple[list[dict], dict]":
    """Read one worker trace file -> (events, meta record)."""
    events: list[dict] = []
    meta: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("ph") == "M" and rec.get("name") == "meta":
                meta = rec
            else:
                events.append(rec)
    return events, meta


# -- Prometheus text exposition ---------------------------------------------
def _metric_name(name: str) -> str:
    name = _NAME_OK.sub("_", str(name))
    if not name or not re.match(r"[a-zA-Z_:]", name[0]):
        name = "_" + name
    return f"odtp_{name}"


def _label_pairs(labels: Iterable) -> str:
    parts = []
    for k, v in labels:
        key = _LABEL_OK.sub("_", str(k))
        val = str(v).replace("\\", r"\\").replace('"', r"\"")
        val = val.replace("\n", r"\n")
        parts.append(f'{key}="{val}"')
    return "{" + ",".join(parts) + "}" if parts else ""


# curated help strings for metrics whose meaning isn't obvious from the
# name; everything else gets the generic family line
_HELP = {
    "odtp_link_bps": "EWMA goodput toward labelled peer, bytes/second "
    "(adaptive outer transport, diloco/linkstate.py)",
    "odtp_link_rtt_ms": "EWMA round-trip time toward labelled peer, ms "
    "(adaptive outer transport)",
    "odtp_outer_rounds_adaptive": "outer rounds run with adaptive "
    "(link-proportional) butterfly partitioning",
    "odtp_bulk_stripe_hedges": "lagging bulk stripes re-dispatched over an "
    "idle connection (straggler hedging)",
}


def _render_family(
    out: list, metrics: dict, kind: str
) -> None:
    by_name: dict[str, list] = {}
    for (name, labels), value in metrics.items():
        by_name.setdefault(_metric_name(name), []).append((labels, value))
    for name in sorted(by_name):
        help_txt = _HELP.get(name, f"opendiloco_torch obs {kind}")
        out.append(f"# HELP {name} {help_txt}")
        out.append(f"# TYPE {name} {kind}")
        for labels, value in sorted(by_name[name], key=str):
            out.append(f"{name}{_label_pairs(labels)} {float(value)}")


def prometheus_text(tr: Optional[Tracer]) -> str:
    """Render the tracer snapshot as Prometheus 0.0.4 text exposition."""
    if tr is None:
        return ""
    snap = tr.snapshot()
    out: list[str] = []
    _render_family(out, snap["counters"], "counter")
    _render_family(out, snap["gauges"], "gauge")
    out.append("# HELP odtp_obs_events_total obs events recorded")
    out.append("# TYPE odtp_obs_events_total counter")
    out.append(f"odtp_obs_events_total {float(snap['events'])}")
    out.append("# HELP odtp_obs_events_dropped_total obs events dropped")
    out.append("# TYPE odtp_obs_events_dropped_total counter")
    out.append(f"odtp_obs_events_dropped_total {float(snap['dropped'])}")
    return "\n".join(out) + "\n"


__all__ = [
    "chrome_trace",
    "clock_shifts",
    "tracer_chrome_trace",
    "write_chrome_trace",
    "load_jsonl",
    "prometheus_text",
    "_flat_metrics",
]
