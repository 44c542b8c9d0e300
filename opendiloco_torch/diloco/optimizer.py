"""DiLoCoOptimizer: the outer loop around one worker's inner trainer.

The port's copy of ``opendiloco_tpu/diloco/optimizer.py``
``DiLoCoOptimizer``, its host-placement blocking path:

  every step:        inner AdamW step on the device
  every local_steps: pseudo_grad = master - device params        [D2H]
                     averaged    = backend.all_reduce(pseudo_grad)
                     outer Nesterov SGD updates the host master
                     device params <- master                      [H2D]

The master copy lives in host RAM as f32 numpy leaves in
:func:`~opendiloco_torch.models.llama.flatten_params` order (the JAX
package's ``jax.tree.flatten`` order), so the all-reduce lines up leaf
for leaf with a JAX worker's. The inner AdamW state is not reset at an
outer step: only the params become the master.

Every ``average_state_every``-th outer step also averages the master
itself across the group (tag ``"state"``) before it goes to the device.

The master is never written in place: every update builds new arrays and
rebinds ``self.master``, so references taken under ``_serve_lock`` (a
peer's state fetch, the serving plane's :meth:`master_snapshot`) stay
bit-stable without a copy.

Not ported yet, and raising: the device-resident outer plane
(``outer_placement="device"``, ROADMAP.md A11), overlapped communication
and streaming fragments (A11), error feedback (A11) and gossip rounds
(A12). The multihost world-messenger split is not ported either: one
process drives one device.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco.backend import OuterBackend, PeerProgress, wait_for_peers
from opendiloco_torch.diloco.compression import get_codec
from opendiloco_torch.diloco.outer_optimizer import OuterSGD
from opendiloco_torch.diloco.state_io import state_codec
from opendiloco_torch.models.llama import flatten_params
from opendiloco_torch.utils.debug import schema_fingerprint
from opendiloco_torch.utils.logger import get_text_logger
from opendiloco_torch.utils.spans import span

log = get_text_logger(__name__)


class PeerDropError(RuntimeError):
    """Raised when a DiLoCo worker disappears and fail_rank_drop is set."""


def resolve_outer_placement(cfg: DilocoConfig) -> str:
    """'host' or 'device'. 'auto' picks device only on a TPU, so it is
    'host' here; an explicit 'device' raises until the device plane is
    ported."""
    if cfg.outer_placement == "device":
        raise NotImplementedError(
            "outer_placement='device' (the device-resident outer plane) is not "
            "ported yet (ROADMAP.md A11); use 'host' or 'auto'"
        )
    return "host"


def _check_ported(cfg: DilocoConfig) -> None:
    unported = [
        (cfg.overlap_comm != "none", f"overlap_comm={cfg.overlap_comm!r}", "A11"),
        (cfg.streaming_fragments > 1, "streaming_fragments > 1", "A11"),
        (cfg.outer_mode == "gossip", "outer_mode='gossip'", "A12"),
        (cfg.error_feedback, "error_feedback", "A11"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(f"DiLoCo {what} is not ported yet (ROADMAP.md {item})")


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    return leaf.detach().to("cpu", torch.float32).numpy()


class DiLoCoOptimizer:
    """Owns inner trainer state transitions and the outer DiLoCo loop."""

    def __init__(self, trainer, backend: Optional[OuterBackend], cfg: DilocoConfig, state: dict,
                 batch_size: int):
        if backend is None:
            raise ValueError("DiLoCoOptimizer needs a backend")
        _check_ported(cfg)
        self.trainer = trainer
        self.backend = backend
        self.cfg = cfg
        self.batch_size = batch_size
        self.target_samples = batch_size * cfg.local_steps
        self.placement = resolve_outer_placement(cfg)
        self.master: list[np.ndarray] = [
            np.array(_to_host(x), dtype=np.float32, copy=True) for x in flatten_params(state["params"])
        ]
        self.outer_opt = OuterSGD(lr=cfg.outer_lr, momentum=cfg.outer_momentum, nesterov=cfg.outer_nesterov)
        self._schema = schema_fingerprint(state["params"])
        self.epoch = 0  # completed outer steps
        self.local_step = 0  # inner steps within the current epoch
        self.samples_in_epoch = 0
        self.max_num_peers = 1
        self._epoch_t0 = time.monotonic()
        self._last_report = 0.0
        # pre-round snapshot served while the blocking outer step runs, so
        # an onboarding peer never fetches a torn master
        self._blocking_snap: Optional[dict[str, Any]] = None
        self._serve_lock = threading.Lock()
        # persistent pseudo-gradient buffers (fresh model-sized allocations
        # every round stall on page faults at scale)
        self._pg_bufs: Optional[list[np.ndarray]] = None

        self.backend.serve_state(self._state_for_peers)
        # announce at join, so a faster peer's WAIT_FOR_ALL sees this one
        try:
            self._announce(samples=0, sps=0.0)
        except Exception as e:  # never kill the joiner over gossip
            log.warning("join announce failed: %s", e)

    def _announce(self, *, samples: int, sps: float, epoch: Optional[int] = None) -> None:
        self.backend.report_progress(
            PeerProgress(
                peer_id=self.backend.peer_id,
                epoch=self.epoch if epoch is None else epoch,
                samples=samples,
                samples_per_second=sps,
                timestamp=time.time(),
            )
        )

    def _pseudo_grad_into(self, boundary: list) -> list[np.ndarray]:
        """master - boundary, written into the persistent buffers."""
        bufs = self._pg_bufs
        if bufs is None or any(b.shape != m.shape for b, m in zip(bufs, self.master)):
            bufs = self._pg_bufs = [np.empty(m.shape, np.float32) for m in self.master]
        return [np.subtract(m, d, out=b) for m, d, b in zip(self.master, boundary, bufs)]

    # ------------------------------------------------------------------
    # onboarding
    # ------------------------------------------------------------------

    def _state_refs_unlocked(self) -> tuple[list, int, dict]:
        """(master, epoch, outer optimizer refs), under ``_serve_lock``:
        while a blocking outer step runs, its consistent pre-round
        snapshot, never the mid-round master."""
        snap = self._blocking_snap
        if snap is not None:
            return snap["master"], snap["epoch"], snap["outer_opt"]
        return self.master, self.epoch, self.outer_opt.state_dict_refs()

    def _state_for_peers(self) -> dict[str, Any]:
        with self._serve_lock:
            master, epoch, opt_sd = self._state_refs_unlocked()
        bufs = opt_sd.get("bufs")
        return {
            "master": [m.copy() for m in master],
            "epoch": epoch,
            "outer_opt": {**opt_sd, "bufs": None if bufs is None else [b.copy() for b in bufs]},
        }

    # ------------------------------------------------------------------
    # the serving plane's snapshot export
    # ------------------------------------------------------------------

    def master_snapshot(self) -> tuple[int, list[np.ndarray]]:
        """(epoch, master leaves) for the in-process serving plane, by the
        rules of a peer's state fetch (a blocking round serves its
        pre-round snapshot), with no copies: the master is only ever
        rebound."""
        with self._serve_lock:
            master, epoch, _ = self._state_refs_unlocked()
        return epoch, list(master)

    def master_snapshot_wire(self) -> tuple[int, list[tuple], str]:
        """Codec-encoded master snapshot, the serving engine's hot-swap
        feed: (epoch, blobs, codec_name) with ``blobs[i] = (payload, meta,
        shape)`` per master leaf in ``flatten_params`` order. The codec is
        the state payloads' (:func:`state_codec`: fp16 by default,
        ``ODTP_STATE_CODEC`` overrides)."""
        codec = state_codec(get_codec(self.cfg.compression))
        epoch, masters = self.master_snapshot()
        blobs = []
        for m in masters:
            payload, meta = codec.encode(np.ascontiguousarray(m).reshape(-1))
            blobs.append((payload, meta, tuple(m.shape)))
        return epoch, blobs, codec.name

    def load_state_from_peers(self, state: dict) -> Optional[dict]:
        """Adopt a peer's master, epoch and outer momentum; returns the
        updated device state (None when no peer serves)."""
        remote = self.backend.fetch_state()
        if remote is None:
            return None
        with self._serve_lock:
            self._blocking_snap = None
            self.master = [np.asarray(m, np.float32).copy() for m in remote["master"]]
            self.epoch = int(remote["epoch"])
            self.outer_opt.load_state_dict(remote["outer_opt"])
            self.local_step = 0
            self.samples_in_epoch = 0
        state = self._write_master_to_device(state)
        # resume the LR schedule where the swarm is, not at warmup step 0
        return self.trainer.force_step_position(state, self.epoch * self.cfg.local_steps)

    def _behind_swarm(self) -> bool:
        """True when another peer is >= 2 epochs ahead."""
        for p in self.backend.peer_progress():
            if p.peer_id != self.backend.peer_id and p.epoch >= self.epoch + 2:
                return True
        return False

    # ------------------------------------------------------------------
    # inner step
    # ------------------------------------------------------------------

    def step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One inner optimizer step; triggers the outer step at the epoch
        boundary. Returns (state, metrics)."""
        if self.local_step == 0 and self._behind_swarm():
            updated = self.load_state_from_peers(state)
            if updated is not None:
                state = updated
                log.warning("desynced from swarm; re-downloaded state at epoch %d", self.epoch)
        state, metrics = self.trainer.train_step(state, batch)
        self.local_step += 1
        self.samples_in_epoch += self.batch_size
        now = time.monotonic()
        at_boundary = self.local_step >= self.cfg.local_steps
        if at_boundary or now - self._last_report > 0.5:
            self._last_report = now
            elapsed = max(now - self._epoch_t0, 1e-6)
            self._announce(samples=self.samples_in_epoch, sps=self.samples_in_epoch / elapsed)
        metrics = dict(metrics)
        metrics["epoch"] = self.epoch
        if at_boundary:
            state, outer_metrics = self.outer_step(state)
            metrics.update(outer_metrics)
        return state, metrics

    # ------------------------------------------------------------------
    # outer step
    # ------------------------------------------------------------------

    def outer_step(self, state: dict) -> tuple[dict, dict]:
        if schema_fingerprint(state["params"]) != self._schema:
            raise AssertionError("parameter schema changed mid-epoch")
        with self._serve_lock:
            self._blocking_snap = {
                "master": self.master,
                "epoch": self.epoch,
                "outer_opt": self.outer_opt.state_dict_refs(),
            }
        t0 = time.monotonic()
        # the D2H copy of the boundary params overlaps the straggler wait,
        # which runs on a thread of its own (the copy stays on this thread,
        # where a profiler sees it)
        waited: list = []

        def wait():
            try:
                wait_for_peers(
                    self.backend,
                    target_samples=self.target_samples,
                    own_epoch=self.epoch,
                    strategy=self.cfg.all_reduce_strategy,
                    timeout_waiting_for_peers=self.cfg.timeout_waiting_for_peers,
                    log=log,
                )
                waited.append(time.monotonic() - t0)
            except BaseException as e:  # re-raised on this thread below
                waited.append(e)

        waiter = threading.Thread(target=wait)
        waiter.start()
        try:
            with span("outer.d2h"):
                boundary = [_to_host(x) for x in flatten_params(state["params"])]
            d2h_s = time.monotonic() - t0
        finally:
            waiter.join()
        if isinstance(waited[0], BaseException):
            raise waited[0]
        wait_s = waited[0]
        t1 = time.monotonic()
        with span("outer.pseudo_grad"):
            pseudo_grad = self._pseudo_grad_into(boundary)
        del boundary
        t2 = time.monotonic()
        with span("outer.all_reduce"):
            averaged, group_size = self.backend.all_reduce(
                pseudo_grad, timeout=self.cfg.averaging_timeout, epoch=self.epoch
            )
        self._check_group_size(group_size)
        t3 = time.monotonic()
        allreduce_s = t3 - t2
        log.info("outer step %d: all-reduce over %d peers took %.3fs", self.epoch, group_size, allreduce_s)

        # clone-then-rebind: published master and momentum arrays stay
        # bit-stable for a concurrent state fetch
        with span("outer.nesterov"):
            new_master = [m.copy() for m in self.master]
            new_opt = self.outer_opt.clone()
            new_opt.step(new_master, averaged)
        self.master = new_master
        self.outer_opt = new_opt
        if self._is_state_avg_epoch():
            # periodic full-state averaging (hivemind average_state_every):
            # corrects the drift a lossy pseudo-gradient codec accumulates
            averaged_state, n = self.backend.all_reduce(
                self.master, timeout=self.cfg.averaging_timeout, tag="state"
            )
            # np.array copies: the result may live in a backend buffer that
            # the next all_reduce reuses
            self.master = [np.array(a, dtype=np.float32) for a in averaged_state]
            log.info("averaged full state over %d peers at epoch %d", n, self.epoch)
        t4 = time.monotonic()
        with span("outer.h2d"):
            state = self._write_master_to_device(state)
        t5 = time.monotonic()

        with self._serve_lock:
            self.epoch += 1
            self.local_step = 0
            self.samples_in_epoch = 0
            self._blocking_snap = None
        self._epoch_t0 = time.monotonic()
        outer_metrics = {
            "outer_step_s": time.monotonic() - t0,
            "outer_allreduce_s": allreduce_s,
            "outer_wait_s": wait_s,
            # the phases: the D2H overlaps the wait; the rest run in turn
            "outer_d2h_s": d2h_s,
            "outer_pseudo_grad_s": t2 - t1,
            "outer_nesterov_s": t4 - t3,
            "outer_h2d_s": t5 - t4,
            "num_peers": group_size,
            **self._round_health_metrics(),
        }
        return state, outer_metrics

    def _is_state_avg_epoch(self) -> bool:
        return self.cfg.average_state_every > 0 and (self.epoch + 1) % self.cfg.average_state_every == 0

    def _round_health_metrics(self) -> dict:
        health = getattr(self.backend, "last_round_health", None) or {}
        out = {}
        if "elastic" in health:
            out["elastic"] = bool(health["elastic"])
            out["expected_peers"] = int(health.get("expected", 0))
        if health.get("retries"):
            out["round_retries"] = int(health["retries"])
        return out

    def _check_group_size(self, group_size: int) -> None:
        if group_size < self.max_num_peers:
            msg = f"Lost a diloco worker: {group_size} < {self.max_num_peers}"
            if self.cfg.fail_rank_drop:
                raise PeerDropError(msg)
            log.warning(msg)
        self.max_num_peers = max(self.max_num_peers, group_size)

    @torch.no_grad()
    def _write_master_to_device(self, state: dict) -> dict:
        """Copy the master into the device params in place (the JAX
        package builds fresh device arrays); the inner optimizer state is
        left as it is."""
        for p, m in zip(flatten_params(state["params"]), self.master):
            p.copy_(torch.from_numpy(m), non_blocking=False)
        return state

    # ------------------------------------------------------------------
    # checkpoint integration
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "master": [m.copy() for m in self.master],
            "outer_opt": self.outer_opt.state_dict(),
            "epoch": self.epoch,
            "local_step": self.local_step,
            "samples_in_epoch": self.samples_in_epoch,
        }

    def load_state_dict(self, sd: dict) -> None:
        with self._serve_lock:
            self._blocking_snap = None
            self.master = [np.asarray(m, np.float32).copy() for m in sd["master"]]
            self.outer_opt.load_state_dict(sd["outer_opt"])
            self.epoch = int(sd["epoch"])
            self.local_step = int(sd["local_step"])
            self.samples_in_epoch = int(sd.get("samples_in_epoch", self.local_step * self.batch_size))
