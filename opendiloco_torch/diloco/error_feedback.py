"""Per-worker error feedback for lossy outer compression.

The port's copy of ``opendiloco_tpu/diloco/error_feedback.py``
``ErrorFeedback``. A lossy codec drops signal every round; error feedback
keeps each leaf's quantization or sparsification error in a residual and
adds it to the NEXT round's pseudo-gradient before encoding, so the
dropped mass is delayed, not lost. Residuals are keyed per leaf, which
covers streaming fragments (a fragment is a set of leaf indices) and the
blocking path alike.

The optimizer drives each round:

  prepare(key, idxs, pgs)   pg += residual (host placement; the device
                            plane adds it on the card as it forms the
                            pseudo-gradient), then stage the codec round
                            trip error err = pg - decode(encode(pg))
                            under ``key``
  commit(key)               the round's average was applied: the staged
                            errors become the live residual
  abort(key)                the round was dropped: the staged errors go,
                            the previous residual stays (the next
                            pseudo-gradient, master - params, re-captures
                            the dropped update, so nothing is lost or
                            counted twice)

Streaming rounds prepare from their comm threads concurrently, so the
staging map has a lock; at most one round is in flight per key.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np

from opendiloco_torch.diloco.compression import Codec


class ErrorFeedback:
    """Residuals and the staged rounds of one worker.

    Host placement keeps the live residuals here; device placement passes
    ``device_setter`` (the plane keeps them on the card) and this class
    only computes and stages each round's error."""

    def __init__(self, codec: Codec, n_leaves: int, *,
                 device_setter: Optional[Callable[[Sequence[int], list[np.ndarray]], None]] = None):
        self.codec = codec
        self.n_leaves = int(n_leaves)
        self._device_setter = device_setter
        # host placement's residuals; None until a leaf's first committed round
        self.residual: list[Optional[np.ndarray]] = [None] * self.n_leaves
        self._pending: dict = {}
        self._lock = threading.Lock()

    @property
    def on_device(self) -> bool:
        return self._device_setter is not None

    def prepare(self, key, idxs: Sequence[int], pgs: list[np.ndarray]) -> None:
        """Add the residual to this round's pseudo-gradient in place (host
        placement only) and stage the codec round trip error under
        ``key``."""
        errs: list[np.ndarray] = []
        for j, i in enumerate(idxs):
            pg = pgs[j]
            if not self.on_device:
                r = self.residual[i]
                if r is not None:
                    np.add(pg, r.reshape(pg.shape), out=pg)
            payload, meta = self.codec.encode(pg)
            dec = self.codec.decode(payload, pg.shape, meta)
            # err = pg - roundtrip(pg), into the decode's buffer
            errs.append(np.subtract(pg, dec, out=np.asarray(dec, np.float32)))
        with self._lock:
            self._pending[key] = (list(idxs), errs)

    def commit(self, key) -> None:
        """The staged errors become the live residual; no-op when ``key``
        was never prepared."""
        with self._lock:
            item = self._pending.pop(key, None)
        if item is None:
            return
        idxs, errs = item
        if self.on_device:
            self._device_setter(idxs, errs)
        else:
            for i, e in zip(idxs, errs):
                self.residual[i] = e

    def abort(self, key) -> None:
        """Drop a round's staged errors; the previous residual stays."""
        with self._lock:
            self._pending.pop(key, None)

    def abort_all(self) -> None:
        with self._lock:
            self._pending.clear()

    # -- checkpoints (host placement; the device plane has ef_host_state
    # and load_ef) ----------------------------------------------------------

    def host_residuals(self) -> Optional[list[Optional[np.ndarray]]]:
        """The residuals for ``state_dict`` (None for a leaf that never
        committed); None when nothing has committed."""
        if all(r is None for r in self.residual):
            return None
        return [None if r is None else r.copy() for r in self.residual]

    def load(self, residuals: Optional[Sequence]) -> None:
        """Adopt checkpointed residuals (the list may hold None)."""
        if residuals is None:
            self.residual = [None] * self.n_leaves
            return
        self.residual = [None if r is None else np.asarray(r, np.float32).copy() for r in residuals]
