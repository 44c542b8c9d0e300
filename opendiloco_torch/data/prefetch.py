"""Input read-ahead: host batches sharded and copied to the device one or
more steps ahead of the training loop, on a thread.

The port's counterpart of ``opendiloco_tpu/data/prefetch.py``
``DevicePrefetcher``, with the same interface and semantics: it wraps a
host batch iterator and yields ``(host_batch, device_batch)``;
``state_dict()`` is the loader state of the last batch *consumed* (not of
the read-ahead position), so a checkpoint resumes with exactly the batches
the trainer never saw, whatever the depth; exhaustion latches, a worker
error is raised in the consumer, and :meth:`stop` drains the queue.

On the card the copies run on a CUDA stream of the prefetcher's own:
``shard_fn`` runs on the worker thread with that stream current (for
``InnerTrainer.shard_batch(..., pinned=True)``: staged in pinned host
memory, copied with ``non_blocking=True``), and an event recorded after
it travels with the batch. The consumer's stream waits on that event
before the batch is used, and each device tensor is marked with
``record_stream`` for the consumer's stream, so that the caching allocator
does not hand its memory to the copy stream again while the step still
reads it. A pinned staging buffer is not reused before its copy has run:
PyTorch's caching host allocator records the copy's event on the buffer
and holds it until the event completes. On the CPU there is no stream and
no pinning; the same thread and queue logic runs.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import torch

from opendiloco_torch.device import DeviceLike, resolve_device


def _tensors(tree) -> list:
    """The tensors of a batch (a tensor, or dicts, lists and tuples of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


class DevicePrefetcher:
    """Wraps a host batch iterator; yields (host_batch, device_batch).

    ``shard_fn(host_batch) -> device_batch`` runs on the worker thread
    (``trainer.shard_batch``; it must issue no collective, which would
    interleave with the training thread's on the same group). ``state_fn``
    (optional) is called after each ``next()`` of ``data_iter`` to snapshot
    its resumable state. ``device`` (default: the card) is where
    ``shard_fn`` puts the batch: on the card its copies run on the
    prefetcher's stream."""

    def __init__(
        self,
        data_iter: Iterator[Any],
        shard_fn: Callable[[Any], Any],
        *,
        depth: int = 2,
        state_fn: Optional[Callable[[], Any]] = None,
        device: DeviceLike = None,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._iter = data_iter
        self._shard = shard_fn
        self._state_fn = state_fn
        self._last_state = state_fn() if state_fn is not None else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, name="odtp-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up once stop() is requested (a producer
        never waits for a consumer that has gone away)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, host):
        """``shard_fn(host)`` and the event after its copies (None on the
        CPU)."""
        if self._stream is None:
            return self._shard(host), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev = self._shard(host)
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    host = next(self._iter)
                except StopIteration:
                    self._put(("end", None))
                    return
                snap = self._state_fn() if self._state_fn is not None else None
                dev, event = self._to_device(host)
                if not self._put(("item", (host, dev, snap, event))):
                    return
        except Exception as e:  # loader and copy errors surface in the consumer
            self._put(("error", e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        kind, val = self._q.get()
        if kind == "end":
            # exhaustion latches: a later next() raises StopIteration again
            # instead of blocking on an empty queue
            self._stop.set()
            raise StopIteration
        if kind == "error":
            self.stop()
            raise val
        host, dev, snap, event = val
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in _tensors(dev):
                t.record_stream(consumer)
        if snap is not None:
            self._last_state = snap
        return host, dev

    def state_dict(self) -> Any:
        """The loader state as of the last batch handed to the consumer
        (not the read-ahead position)."""
        return self._last_state

    def stop(self) -> None:
        self._stop.set()
        # drain, so that a blocked producer sees the stop flag promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
