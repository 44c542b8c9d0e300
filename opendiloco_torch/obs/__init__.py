"""Unified tracing + metrics plane (spans, counters, gauges, exporters).

Hook-site idiom, mirroring ``chaos.plane()``::

    from opendiloco_torch import obs
    tr = obs.tracer()          # None when ODTP_OBS is unset (zero-cost)
    if tr is not None:
        t0 = tr.now()
        ...
        tr.add_span("outer/encode", t0, tr.now(), round=key, worker=r)

or, in plain synchronous code::

    with obs.span("outer/rendezvous", round=key):
        ...

See ``obs/trace.py`` for the env knobs and ``obs/export.py`` for the
Chrome-trace / Prometheus / JSONL exporters.
"""
from opendiloco_torch.obs.trace import (  # noqa: F401
    StageTimes,
    Tracer,
    count,
    enabled,
    gauge,
    span,
    tracer,
)
from opendiloco_torch.obs import (  # noqa: F401
    anomaly,
    blackbox,
    export,
    mfu,
    overseer,
    reqtrace,
)
from opendiloco_torch.obs import trace as _trace


def reset() -> None:
    """Drop every cached obs singleton (tests / env changes): tracer,
    flight recorder, request-trace ring, overseer, and watchdogs."""
    anomaly.reset()
    blackbox.reset()
    reqtrace.reset()
    overseer.reset()
    _trace.reset()


__all__ = [
    "StageTimes",
    "Tracer",
    "anomaly",
    "blackbox",
    "count",
    "enabled",
    "export",
    "gauge",
    "mfu",
    "overseer",
    "reqtrace",
    "reset",
    "span",
    "tracer",
]
