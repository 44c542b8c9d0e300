"""Metric loggers and the text logger.

The port's copy of ``opendiloco_tpu/utils/logger.py``: every logger routes
rows through :func:`normalize_row`, so the on-disk schema is flat
JSON-typed scalars whichever backend wrote it. ``DummyLogger`` pickles
its rows (the integration tests' metrics spy). The wandb and JSONL
backends are not ported yet.
"""
from __future__ import annotations

import contextlib
import logging
import os
import pickle
import threading
from typing import Any, Iterator, Protocol


def normalize_row(metrics: dict[str, Any]) -> dict[str, Any]:
    """Coerce a metrics row to a flat dict of JSON-typed scalars: tensors
    and numpy scalars become floats, nested dicts flatten to
    ``outer/inner`` keys, anything else is stringified."""
    out: dict[str, Any] = {}

    def put(key: str, value: Any) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                put(f"{key}/{k}", v)
            return
        if value is None or isinstance(value, (bool, str, int, float)):
            out[key] = value
            return
        try:
            out[key] = float(value)
        except Exception:
            out[key] = str(value)

    for k, v in metrics.items():
        put(str(k), v)
    return out


class Logger(Protocol):
    def log(self, metrics: dict[str, Any]) -> None: ...

    def finish(self) -> None: ...


class DummyLogger:
    """Accumulates metric rows and pickles them to ``project`` on
    finish(), atomically (tmp file + ``os.replace``)."""

    def __init__(self, project: str, config: dict[str, Any], *_args, **_kwargs):
        self.project = project
        self.config = config
        open(project, "wb").close()  # fail fast on an unwritable path
        self.data: list[dict[str, Any]] = []

    def log(self, metrics: dict[str, Any]) -> None:
        self.data.append(normalize_row(metrics))

    def finish(self) -> None:
        tmp = f"{self.project}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(self.data, f)
        os.replace(tmp, self.project)


def get_logger(logger_type: str, project: str, config: dict[str, Any], resume: bool = False) -> Logger:
    if logger_type == "dummy":
        return DummyLogger(project=project, config=config)
    if logger_type in ("wandb", "jsonl"):
        raise NotImplementedError(
            f"the {logger_type} metric logger is not ported yet (ROADMAP.md A15); "
            "use metric_logger_type 'dummy'"
        )
    raise ValueError(f"unknown metric_logger_type {logger_type!r}")


_LOG_FORMAT = "[rank %(rank)s] %(asctime)s [%(levelname)s] [%(name)s] %(message)s"
_thread_rank = threading.local()


@contextlib.contextmanager
def log_rank(rank: int) -> Iterator[None]:
    """Label this thread's text log lines with ``rank`` while the block
    runs. Workers that share a process, one thread each, keep their own
    labels; outside any block the label is ``DILOCO_WORLD_RANK`` (0 when
    unset)."""
    prev = getattr(_thread_rank, "rank", None)
    _thread_rank.rank = rank
    try:
        yield
    finally:
        _thread_rank.rank = prev


class _RankFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        rank = getattr(_thread_rank, "rank", None)
        record.rank = os.environ.get("DILOCO_WORLD_RANK", "0") if rank is None else rank
        return True


def get_text_logger(name: str = "opendiloco_torch") -> logging.Logger:
    """Rank-prefixed text logger (the rank of :func:`log_rank`)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.addFilter(_RankFilter())
        handler.setFormatter(logging.Formatter(_LOG_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("OPENDILOCO_TORCH_LOG_LEVEL", "INFO"))
        logger.propagate = False
    return logger
