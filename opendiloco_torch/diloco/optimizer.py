"""DiLoCoOptimizer: the outer loop around one worker's inner trainer.

The port's copy of ``opendiloco_tpu/diloco/optimizer.py``
``DiLoCoOptimizer``:

  every step:        inner AdamW step on the device
  every local_steps: pseudo_grad = master - device params
                     averaged    = backend.all_reduce(pseudo_grad)
                     outer Nesterov SGD updates the master
                     device params <- master

Two placements of the master and its momentum (``outer_placement``):

- **host**: f32 numpy leaves in host RAM, in
  :func:`~opendiloco_torch.models.llama.flatten_params` order (the JAX
  package's ``jax.tree.flatten`` order), so the all-reduce lines up leaf
  for leaf with a JAX worker's. The master is never written in place:
  every update builds new arrays and rebinds ``self.master``, so
  references taken under ``_serve_lock`` (a peer's state fetch, the
  serving plane's :meth:`master_snapshot`) stay bit-stable without a copy.
- **device**: :class:`~opendiloco_torch.diloco.outer_device.DeviceOuterPlane`
  on the trainer's device; only pseudo-gradients cross to the host and
  averages back. Its updates repeat the host path's bits.

Rounds may block (the default), or overlap inner training
(``overlap_comm``: "delayed" applies the round as a delta when it lands,
"eager" applies the local estimate at once and corrects it on landing),
or stream (``streaming_fragments`` > 1: one fragment a boundary when
blocking, every fragment every epoch on a staggered schedule under
overlap, :mod:`~opendiloco_torch.diloco.streaming`). ``error_feedback``
carries each leaf's codec round trip error into the next round
(:mod:`~opendiloco_torch.diloco.error_feedback`). Every
``average_state_every``-th outer step also averages the master itself
(tag ``"state"``). The inner AdamW state is not reset at an outer step:
only the params become the master.

A worker of several processes (``world``, a
:class:`~opendiloco_torch.parallel.world.DistWorld`) runs the
world-messenger split of the JAX package: only rank 0 holds a backend;
boundary params reach every rank whole through ``trainer.host_params``,
the messenger's averages and control values fan out through
``world.broadcast_*`` (a header first, so a failure on the messenger
raises on every rank), every rank replays the same host Nesterov step and
writes its blocks (``trainer.host_block``). With more than one process the
device placement and streaming x overlap fall back (to host placement
and blocking fragments), as in the JAX package. Every rank makes the
same calls in the same order: the poll of a round in flight agrees on
the messenger's verdict through one small broadcast.

Not ported yet, and raising: gossip rounds (A12b).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco.backend import OuterBackend, PeerProgress, wait_for_peers
from opendiloco_torch.diloco.compression import device_wire_dtype, get_codec
from opendiloco_torch.diloco.error_feedback import ErrorFeedback
from opendiloco_torch.diloco.outer_device import DeviceOuterPlane
from opendiloco_torch.diloco.outer_optimizer import OuterSGD
from opendiloco_torch.diloco.planner import fragment_partition
from opendiloco_torch.diloco.state_io import state_codec
from opendiloco_torch.diloco.streaming import StreamScheduler
from opendiloco_torch.models.llama import flatten_params
from opendiloco_torch.parallel.world import HostWorld
from opendiloco_torch.utils.debug import schema_fingerprint
from opendiloco_torch.utils.logger import get_text_logger
from opendiloco_torch.utils.spans import span

log = get_text_logger(__name__)


class PeerDropError(RuntimeError):
    """Raised when a DiLoCo worker disappears and fail_rank_drop is set."""


def resolve_outer_placement(cfg: DilocoConfig, world: Optional[HostWorld] = None) -> str:
    """'host' or 'device'. 'auto' picks the device plane only on a TPU, as
    the JAX package does, so it is 'host' here; 'device' is the device
    plane on the trainer's device, on a worker of one process (several
    fall back to host, as in the JAX package)."""
    if cfg.outer_placement != "device":
        return "host"
    if world is not None and world.process_count > 1:
        log.warning(
            "outer_placement=device is single-process only (multihost "
            "slices replicate the host master); falling back to host"
        )
        return "host"
    return "device"


def _check_ported(cfg: DilocoConfig) -> None:
    if cfg.outer_mode == "gossip":
        raise NotImplementedError("DiLoCo outer_mode='gossip' is not ported yet (ROADMAP.md A12b)")


class DiLoCoOptimizer:
    """Owns inner trainer state transitions and the outer DiLoCo loop."""

    def __init__(self, trainer, backend: Optional[OuterBackend], cfg: DilocoConfig, state: dict,
                 batch_size: int, world: Optional[HostWorld] = None):
        # the world-messenger split: only the messenger holds a backend
        self.world = world if world is not None else HostWorld()
        if self.world.is_messenger and backend is None:
            raise ValueError("DiLoCoOptimizer needs a backend on the world messenger")
        _check_ported(cfg)
        self.trainer = trainer
        self.backend = backend if self.world.is_messenger else None
        self.cfg = cfg
        self.batch_size = batch_size
        self.target_samples = batch_size * cfg.local_steps
        self.placement = resolve_outer_placement(cfg, self.world)
        leaves = flatten_params(state["params"])
        self._plane: Optional[DeviceOuterPlane] = None
        if self.placement == "device":
            self._plane = DeviceOuterPlane(leaves, lr=cfg.outer_lr, momentum=cfg.outer_momentum,
                                           nesterov=cfg.outer_nesterov, compression=cfg.compression,
                                           error_feedback=cfg.error_feedback)
            # the plane owns master and momentum; the host list stays empty
            self.master: list[np.ndarray] = []
        else:
            self.master = trainer.host_params(leaves)
        # error feedback: the device plane adds the residual on the card as
        # it forms the pseudo-gradient and keeps it there; host placement
        # adds it in prepare()
        self._ef: Optional[ErrorFeedback] = None
        if cfg.error_feedback:
            self._ef = ErrorFeedback(get_codec(cfg.compression), len(leaves),
                                     device_setter=self._plane.set_ef_residuals if self._plane else None)
        # host placement's optimizer; under device placement it mirrors the
        # scalars only
        self.outer_opt = OuterSGD(lr=cfg.outer_lr, momentum=cfg.outer_momentum, nesterov=cfg.outer_nesterov)
        self._schema = schema_fingerprint(state["params"])
        # streaming fragments: a size-balanced contiguous partition of the
        # leaves, the same on every peer; blocking rounds sync fragment
        # epoch mod N
        self._fragments: Optional[list[list[int]]] = None
        if cfg.streaming_fragments > 1:
            sizes = [int(x.numel()) for x in leaves]
            self._fragments = fragment_partition(sizes, min(cfg.streaming_fragments, len(sizes)))
        self.epoch = 0  # completed outer steps
        self.local_step = 0  # inner steps within the current epoch
        self.samples_in_epoch = 0
        self.max_num_peers = 1
        self._epoch_t0 = time.monotonic()
        self._last_report = 0.0
        self.last_outer_metrics: dict[str, Any] = {}
        # an overlapped round in flight (at most one)
        self._pending: Optional[dict[str, Any]] = None
        # pre-round snapshot served while a blocking outer step runs, so an
        # onboarding peer never fetches a torn master
        self._blocking_snap: Optional[dict[str, Any]] = None
        # lock order everywhere: plane.lock, then _serve_lock
        self._serve_lock = threading.Lock()
        self._abandoned: Optional[concurrent.futures.Future] = None  # a dropped round still running
        self._landed_metrics: Optional[dict[str, Any]] = None
        # persistent pseudo-gradient buffers (fresh model-sized allocations
        # every round stall on page faults at scale); two slots, so an
        # overlapped round never writes into buffers an abandoned round may
        # still be reading; the slot alternates explicitly, not by epoch
        # parity (onboarding moves the epoch)
        self._pg_bufs: list[Optional[list[np.ndarray]]] = [None, None]
        self._pg_slot = 0
        # streaming x overlap: fragment rounds launched from the trainer's
        # post-dispatch hook, inside the inner phase
        self._stream: Optional[StreamScheduler] = None
        if self._fragments is not None and cfg.overlap_comm != "none":
            if self.world.process_count > 1:
                log.warning(
                    "streaming_fragments x overlap_comm is single-process "
                    "only; falling back to blocking fragment sync"
                )
            else:
                self._stream = StreamScheduler(self)
                trainer.add_post_dispatch_hook(self._stream_tick)

        if self.backend is not None:
            self.backend.serve_state(self._state_for_peers)
            # announce at join, so a faster peer's WAIT_FOR_ALL sees this one
            try:
                self._announce(samples=0, sps=0.0)
            except Exception as e:  # never kill the joiner over gossip
                log.warning("join announce failed: %s", e)

    def _announce(self, *, samples: int, sps: float, epoch: Optional[int] = None) -> None:
        if self.backend is None:
            return
        self.backend.report_progress(
            PeerProgress(
                peer_id=self.backend.peer_id,
                epoch=self.epoch if epoch is None else epoch,
                samples=samples,
                samples_per_second=sps,
                timestamp=time.time(),
            )
        )

    def _fetch_params(self, leaves: list, frag: Optional[list[int]] = None) -> list[np.ndarray]:
        """Whole host f32 copies that own their memory (the trainer writes
        its params in place) of the leaves, or of ``frag``'s: a collective
        on a worker of several processes."""
        return self.trainer.host_params(leaves, frag)

    def _pseudo_grad_into(self, boundary: list, slot: int) -> list[np.ndarray]:
        """master - boundary, written into the persistent slot buffers."""
        bufs = self._pg_bufs[slot]
        if bufs is None or len(bufs) != len(self.master) or any(
                b.shape != m.shape for b, m in zip(bufs, self.master)):
            bufs = self._pg_bufs[slot] = [np.empty(m.shape, np.float32) for m in self.master]
        return [np.subtract(m, d, out=b) for m, d, b in zip(self.master, boundary, bufs)]

    # ------------------------------------------------------------------
    # onboarding
    # ------------------------------------------------------------------

    def _state_refs_unlocked(self) -> tuple[list, int, dict]:
        """(master, epoch, outer optimizer refs), under ``_serve_lock``:
        while a round is in flight (epoch already advanced) or a blocking
        round runs, its consistent pre-round snapshot."""
        p = self._pending
        if p is not None:
            return p["master_snap"], p["epoch"], p["opt_snap"].state_dict_refs()
        snap = self._blocking_snap
        if snap is not None:
            return snap["master"], snap["epoch"], snap["outer_opt"]
        return self.master, self.epoch, self.outer_opt.state_dict_refs()

    def _plane_refs(self) -> tuple[list, Optional[list], int]:
        """Under plane.lock and ``_serve_lock``: the plane arrays a snapshot
        reads, and their epoch. An overlapped round in flight has advanced
        the epoch and may have rebound the plane to its estimate: its
        retained pre-round arrays instead."""
        p = self._pending
        if p is not None and "plane_pre" in p:
            m, b = p["plane_pre"]
            return m, b, p["epoch"]
        return list(self._plane.masters), self._plane.bufs, self.epoch

    def _device_state_for_peers(self) -> dict[str, Any]:
        """A peer's state fetch under device placement: the pre-published
        host snapshot of a state-averaging round if there is one (under
        ``_serve_lock`` alone, so a fetch never waits out a WAN leg), else
        host copies of the plane made under plane.lock (the copies wait
        for the trainer's writes; holding the lock pins the (plane, epoch)
        pair)."""
        plane = self._plane
        with self._serve_lock:
            snap = self._blocking_snap
            if snap is not None:
                opt = snap["outer_opt"]
                bufs = opt.get("bufs")
                return {
                    "master": [m.copy() for m in snap["master"]],
                    "epoch": snap["epoch"],
                    "outer_opt": {**{k: opt[k] for k in ("lr", "momentum", "nesterov")},
                                  "bufs": None if bufs is None else [b.copy() for b in bufs]},
                }
        with plane.lock:
            with self._serve_lock:
                m_refs, b_refs, epoch = self._plane_refs()
            master, bufs = plane.host_state((m_refs, b_refs))
        return {
            "master": master,
            "epoch": epoch,
            "outer_opt": {"lr": plane.lr, "momentum": plane.momentum, "nesterov": plane.nesterov, "bufs": bufs},
        }

    def _state_for_peers(self) -> dict[str, Any]:
        if self._plane is not None:
            return self._device_state_for_peers()
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

    def master_snapshot(self, wire_dtype: Optional[str] = None) -> tuple[int, list[np.ndarray]]:
        """(epoch, master leaves) for the in-process serving plane, by the
        rules of a peer's state fetch (a round in flight serves its
        pre-round snapshot). Host placement makes no copies (the master is
        only ever rebound); device placement copies under plane.lock, cast
        to ``wire_dtype`` on the device first when given (plain-fp16 state
        codec: half the D2H bytes)."""
        plane = self._plane
        with self._serve_lock:
            if plane is None:
                master, epoch, _ = self._state_refs_unlocked()
                return epoch, list(master)
            snap = self._blocking_snap
            if snap is not None:
                return snap["epoch"], list(snap["master"])
        with plane.lock:
            with self._serve_lock:
                m_refs, _, epoch = self._plane_refs()
            return epoch, plane.host_masters(m_refs, wire_dtype=wire_dtype)

    def master_snapshot_wire(self) -> tuple[int, list[tuple], str]:
        """Codec-encoded master snapshot, the serving engine's hot-swap
        feed: (epoch, blobs, codec_name) with ``blobs[i] = (payload, meta,
        shape)`` per master leaf in ``flatten_params`` order. The codec is
        the state payloads' (:func:`state_codec`: fp16 by default,
        ``ODTP_STATE_CODEC`` overrides); the device plane casts to the
        wire dtype before the D2H where the codec's encode is idempotent
        under it (:func:`device_wire_dtype`)."""
        codec = state_codec(get_codec(self.cfg.compression))
        epoch, masters = self.master_snapshot(wire_dtype=device_wire_dtype(codec.name))
        blobs = []
        for m in masters:
            payload, meta = codec.encode(np.ascontiguousarray(m).reshape(-1))
            blobs.append((payload, meta, tuple(m.shape)))
        return epoch, blobs, codec.name

    def _broadcast_remote_state(self, remote: Optional[dict]) -> Optional[dict]:
        """A fetched swarm state from the messenger to every rank (every
        rank calls; followers pass None): a small header, then the master
        and momentum arrays."""
        w = self.world
        header = None
        if remote is not None:
            opt = remote["outer_opt"]
            header = {"epoch": int(remote["epoch"]),
                      "opt_scalars": {k: opt[k] for k in ("lr", "momentum", "nesterov")},
                      "has_bufs": opt.get("bufs") is not None}
        header = w.broadcast_obj(header)
        if header is None:
            return None
        tmpl = [np.zeros(m.shape, np.float32) for m in self.master]
        master = w.broadcast_arrays(remote["master"] if remote is not None else tmpl)
        bufs = None
        if header["has_bufs"]:
            bufs = w.broadcast_arrays(remote["outer_opt"]["bufs"] if remote is not None else tmpl)
        return {"master": master, "epoch": header["epoch"], "outer_opt": {**header["opt_scalars"], "bufs": bufs}}

    def load_state_from_peers(self, state: dict) -> Optional[dict]:
        """Adopt a peer's master, epoch and outer momentum; returns the
        updated device state (None when no peer serves). A collective on a
        worker of several processes."""
        self.drop_pending()  # adopted state supersedes rounds in flight
        remote = self.backend.fetch_state() if self.world.is_messenger else None
        if self.world.process_count > 1:
            remote = self._broadcast_remote_state(remote)
        if remote is None:
            return None
        if self._plane is not None:
            opt = remote["outer_opt"]
            with self._plane.lock:
                self._plane.load(remote["master"], opt.get("bufs"), lr=opt.get("lr"), momentum=opt.get("momentum"),
                                 nesterov=opt.get("nesterov"))
                self.outer_opt.load_state_dict({**opt, "bufs": None})  # scalars only
                with self._serve_lock:
                    self._blocking_snap = None
                    self.epoch = int(remote["epoch"])
                    self.local_step = 0
                    self.samples_in_epoch = 0
                self._plane.sync_params(flatten_params(state["params"]))
        else:
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
        if self.backend is None:
            return False
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
        if self._pending is not None:
            state = self._poll_pending(state, block=False)
        if self.local_step == 0 and self._desynced():
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
        if self._landed_metrics is not None:  # an overlapped round landed
            metrics.update(self._landed_metrics)
            self._landed_metrics = None
        if at_boundary:
            if self._stream is not None:
                # the fragments synced inside the phase (or still fly): the
                # boundary is bookkeeping
                state, outer_metrics = self._stream.boundary(state)
            elif self.cfg.overlap_comm != "none" and self._fragments is None and not self._is_state_avg_epoch():
                state, outer_metrics = self._outer_step_overlapped(state)
            else:
                state, outer_metrics = self.outer_step(state)
            metrics.update(outer_metrics)
        return state, metrics

    def _desynced(self) -> bool:
        """The messenger's desync verdict, the same on every rank (one small
        broadcast at each epoch start on a worker of several processes)."""
        behind = self._behind_swarm() if self.world.is_messenger else False
        if self.world.process_count > 1:
            behind = bool(self.world.broadcast_obj(behind))
        return behind

    def _stream_tick(self, state: dict) -> dict:
        """The trainer's post-dispatch hook: fires after every inner step,
        before step() counts it, so that step is ``local_step + 1``."""
        return self._stream.tick(state, self.local_step + 1)

    def _is_state_avg_epoch(self) -> bool:
        """State-averaging epochs take the blocking path (they rewrite the
        master wholesale)."""
        return self.cfg.average_state_every > 0 and (self.epoch + 1) % self.cfg.average_state_every == 0

    # ------------------------------------------------------------------
    # overlapped outer step (Eager Updates for Overlapped Communication
    # and Computation in DiLoCo, arxiv 2502.12996)
    # ------------------------------------------------------------------

    def _wait_beside(self, work):
        """Run ``work()`` on this thread while the straggler wait runs on a
        helper (a profiler records this thread); returns (work's result,
        seconds until both ended)."""
        t0 = time.monotonic()
        if self.backend is None:  # a follower has no peer view: no wait
            return work(), time.monotonic() - t0
        waited: list = []

        def wait():
            try:
                wait_for_peers(self.backend, target_samples=self.target_samples, own_epoch=self.epoch,
                               strategy=self.cfg.all_reduce_strategy,
                               timeout_waiting_for_peers=self.cfg.timeout_waiting_for_peers, log=log)
                waited.append(None)
            except BaseException as e:  # re-raised on this thread below
                waited.append(e)

        waiter = threading.Thread(target=wait)
        waiter.start()
        try:
            out = work()
        finally:
            waiter.join()
        if waited[0] is not None:
            raise waited[0]
        return out, time.monotonic() - t0

    def _outer_step_overlapped(self, state: dict) -> tuple[dict, dict]:
        """Launch the outer all-reduce in the background and keep training.

        Blocking DiLoCo rewrites the params from the boundary params b to
        the new master M'. Overlapped, the params keep stepping from b and
        the SAME rewrite lands later as a delta, params += M' - b. "eager"
        applies the update estimated from the local pseudo-gradient at once
        and corrects it by M'_true - M'_est on landing."""
        if self._plane is not None:
            return self._outer_step_overlapped_device(state)
        if schema_fingerprint(state["params"]) != self._schema:
            raise AssertionError("parameter schema changed mid-epoch")
        t0 = time.monotonic()
        if self._pending is not None:  # at most one round in flight
            state = self._poll_pending(state, block=True)
        self._drain_abandoned()
        leaves = flatten_params(state["params"])
        boundary, wait_s = self._wait_beside(lambda: self._fetch_params(leaves))
        self._pg_slot ^= 1
        pseudo_grad = self._pseudo_grad_into(boundary, slot=self._pg_slot)
        if self._ef is not None:
            # the residual goes into the wire pg and the eager estimate (which
            # must match what the swarm averages); the round trip error
            # stages until the landing commits it
            self._ef.prepare("main", range(len(pseudo_grad)), pseudo_grad)
        pending: dict[str, Any] = {
            # references: the master and optimizer are only ever rebound
            "master_snap": list(self.master),
            "opt_snap": self.outer_opt,
            "boundary": boundary,
            "epoch": self.epoch,
            "t_launch": t0,
            # a follower carries no future: the messenger's landing fans out
            "future": self._spawn_all_reduce(pseudo_grad, self.epoch) if self.world.is_messenger else None,
        }
        if self.cfg.overlap_comm == "eager":
            est_opt = self.outer_opt.clone()
            est_master = [m.copy() for m in self.master]
            est_opt.step(est_master, pseudo_grad)
            state = self._apply_delta_to_device(state, [e - b for e, b in zip(est_master, boundary)])
            pending["est_master"] = est_master
        # the eager rebind, the pending round and the epoch advance appear
        # together to the serve thread
        with self._serve_lock:
            if "est_master" in pending:
                self.master = pending["est_master"]
            self._pending = pending
            self.epoch += 1
            self.local_step = 0
            self.samples_in_epoch = 0
        self._epoch_t0 = time.monotonic()
        outer_metrics = {"outer_step_s": time.monotonic() - t0, "outer_wait_s": wait_s, "outer_overlapped": 1}
        self.last_outer_metrics = outer_metrics
        return state, outer_metrics

    def _outer_step_overlapped_device(self, state: dict) -> tuple[dict, dict]:
        """Device placement's overlapped launch: a f32 device copy of the
        boundary params for the landing (the delta is new master -
        boundary, the host path's association), the pseudo-gradient at
        wire width to the host, the eager estimate on the device."""
        plane = self._plane
        if schema_fingerprint(state["params"]) != self._schema:
            raise AssertionError("parameter schema changed mid-epoch")
        t0 = time.monotonic()
        if self._pending is not None:  # at most one round in flight
            state = self._poll_pending(state, block=True)
        self._drain_abandoned()
        eager = self.cfg.overlap_comm == "eager"
        leaves = flatten_params(state["params"])
        boundary_dev = plane.copy_leaves(leaves)
        (pg_host, pg_dev, _), wait_s = self._wait_beside(lambda: plane.pseudo_grad(leaves, keep_device=eager))
        if self._ef is not None:
            # the plane added the residual; stage the round trip error
            self._ef.prepare("main", range(len(pg_host)), pg_host)
        pending: dict[str, Any] = {"epoch": self.epoch, "t_launch": t0,
                                   "future": self._spawn_all_reduce(pg_host, self.epoch)}
        # the plane's estimate, the pending round and the epoch advance
        # appear together to the serve thread (plane.lock, then _serve_lock)
        with plane.lock:
            pending["plane_pre"] = (list(plane.masters), None if plane.bufs is None else list(plane.bufs))
            if eager:
                state = self._apply_delta_to_device(state, plane.estimate(pg_dev, boundary_dev))
            else:
                pending["boundary_dev"] = boundary_dev
            with self._serve_lock:
                self._pending = pending
                self.epoch += 1
                self.local_step = 0
                self.samples_in_epoch = 0
        self._epoch_t0 = time.monotonic()
        outer_metrics = {"outer_step_s": time.monotonic() - t0, "outer_wait_s": wait_s, "outer_overlapped": 1}
        self.last_outer_metrics = outer_metrics
        return state, outer_metrics

    def _drain_abandoned(self) -> None:
        """A dropped round may still be running (its reduce cannot be
        cancelled): let it drain before fresh pseudo-gradients go into
        slot buffers it may still read."""
        if self._abandoned is None:
            return
        drained = True
        try:
            self._abandoned.result(timeout=self.cfg.averaging_timeout + 60)
        except (TimeoutError, concurrent.futures.TimeoutError):
            drained = False
        except Exception:
            pass
        self._abandoned = None
        if not drained:
            # a wedged round may still read its buffers: leave both slots
            # to it
            self._pg_bufs = [None, None]

    def _spawn_all_reduce(self, pseudo_grad: list, epoch: int) -> concurrent.futures.Future:
        """backend.all_reduce on a daemon thread (a wedged round must not
        block exit), with the round's epoch fixed at submit time."""
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _run():
            if not fut.set_running_or_notify_cancel():
                return  # dropped before the round started
            try:
                fut.set_result(self.backend.all_reduce(pseudo_grad, timeout=self.cfg.averaging_timeout,
                                                       epoch=epoch))
            except BaseException as e:  # surfaced through fut.result()
                fut.set_exception(e)

        threading.Thread(target=_run, name="diloco-outer-comm", daemon=True).start()
        return fut

    def _messenger_fanout(self, produce, shapes: list):
        """Run ``produce() -> (arrays, meta)`` on the messenger and fan the
        result out: a small header first (so a failure there raises on
        every rank instead of leaving the followers at the array
        broadcast), then the arrays (followers pass zero templates of
        ``shapes``). Returns ``(arrays, meta)``."""
        exc: Optional[BaseException] = None
        arrays, meta = None, {}
        if self.world.is_messenger:
            try:
                arrays, meta = produce()
                # own the data: backend results may be views of pooled buffers
                arrays = [np.array(a, dtype=np.float32) for a in arrays]
            except BaseException as e:
                exc = e
        header = self.world.broadcast_obj(
            {"err": None if exc is None else f"{type(exc).__name__}: {exc}", "meta": meta}
            if self.world.is_messenger else None)
        if exc is not None:
            raise exc
        if header["err"] is not None:
            raise RuntimeError(f"messenger outer round failed: {header['err']}")
        arrays = self.world.broadcast_arrays(
            arrays if self.world.is_messenger else [np.zeros(sh, np.float32) for sh in shapes])
        return arrays, header["meta"]

    def _wan_all_reduce(self, arrays: list, **kw) -> tuple[list, int]:
        """backend.all_reduce on the messenger, its result on every rank."""
        kw.setdefault("timeout", self.cfg.averaging_timeout)
        if self.world.process_count == 1:
            return self.backend.all_reduce(arrays, **kw)

        def produce():
            avg, n = self.backend.all_reduce(arrays, **kw)
            return avg, {"n": n}

        avg, meta = self._messenger_fanout(produce, [a.shape for a in arrays])
        return avg, int(meta["n"])

    def _overlap_result(self, pending: dict, *, block: bool) -> tuple[list, int]:
        """(averaged, group size) of the round in flight, on every rank."""
        fut = pending["future"]
        timeout = self.cfg.averaging_timeout + 60 if block else None
        if self.world.process_count == 1:
            return fut.result(timeout=timeout)

        def produce():
            avg, n = fut.result(timeout=timeout)
            return avg, {"n": n}

        avg, meta = self._messenger_fanout(produce, [m.shape for m in pending["master_snap"]])
        return avg, int(meta["n"])

    def _poll_pending(self, state: dict, *, block: bool) -> dict:
        """Land the round in flight if it resolved (or wait for it when
        ``block``): the (corrected) outer update goes to the params as a
        delta. ``_pending`` stays published until the landed master is in
        place, so a snapshot never pairs the new epoch with the old
        master. On several processes whether the round landed is the
        messenger's fact, broadcast to every rank."""
        pending = self._pending
        if pending is None:
            return state
        fut = pending["future"]
        if not block:
            done = fut.done() if fut is not None else False
            if self.world.process_count > 1:
                done = bool(self.world.broadcast_obj(done if self.world.is_messenger else None))
            if not done:
                return state
        try:
            avg, group_size = self._overlap_result(pending, block=block)
            self._check_group_size(group_size)
            if self._ef is not None:
                # the swarm adopted the compressed pg: its round trip error
                # becomes the live residual
                self._ef.commit("main")
            if "plane_pre" in pending:
                # plane.lock from the landing's writes until the round is
                # cleared: a snapshot must not read the pre-round arrays
                # the landing steps in place
                plane = self._plane
                pre_m, pre_b = pending["plane_pre"]
                with plane.lock:
                    if "boundary_dev" in pending:
                        delta = plane.land_delayed(pre_m, pre_b, pending["boundary_dev"], avg)
                    else:
                        delta = plane.land_eager(pre_m, pre_b, avg)
                    state = self._apply_delta_to_device(state, delta)
                    with self._serve_lock:
                        self._pending = None
            else:
                master = [m.copy() for m in pending["master_snap"]]
                opt = pending["opt_snap"].clone()
                opt.step(master, avg)
                base = pending["est_master"] if "est_master" in pending else pending["boundary"]
                state = self._apply_delta_to_device(state, [t - b for t, b in zip(master, base)])
                with self._serve_lock:
                    self.outer_opt = opt
                    self.master = master
        except BaseException:
            if self._ef is not None:
                # a dropped round: keep the previous residual (the next
                # pseudo-gradient re-captures the lost update)
                self._ef.abort("main")
            raise
        finally:
            with self._serve_lock:
                self._pending = None
        landed_s = time.monotonic() - pending["t_launch"]
        # the landing shows in the next metrics row
        self._landed_metrics = {"outer_allreduce_s": landed_s, "num_peers": group_size,
                                **self._round_health_metrics()}
        self.last_outer_metrics = dict(self._landed_metrics)
        log.info("outer step %d (overlapped): all-reduce over %d peers landed after %.3fs", pending["epoch"],
                 group_size, landed_s)
        return state

    def drop_pending(self) -> None:
        """Abandon the rounds in flight (their results are never applied).
        A running reduce cannot be cancelled; it is kept so the next launch
        drains it first."""
        if self._stream is not None:
            self._stream.drop_all()
        if self._pending is not None:
            fut = self._pending["future"]
            if fut is not None and not fut.cancel():
                self._abandoned = fut
            self._pending = None
        if self._ef is not None:
            # abandoned rounds never commit; the live residual stays
            self._ef.abort_all()

    def flush(self, state: dict) -> dict:
        """Land every round in flight, waiting for each (before a
        checkpoint or at shutdown, so the master holds every launched
        round)."""
        if self._stream is not None:
            state = self._stream.flush(state)
        return self._poll_pending(state, block=True)

    @torch.no_grad()
    def _apply_frag_delta(self, state: dict, frag: list, delta: list) -> dict:
        """params += delta over one fragment's leaves, in place; a host
        delta moves to the device one leaf at a time."""
        leaves = flatten_params(state["params"])
        for i, d in zip(frag, delta):
            p = leaves[i]
            if not isinstance(d, torch.Tensor):  # this rank's block of a host delta
                d = torch.from_numpy(self.trainer.host_block(i, d)).to(p.device)
            p.add_(d)
        return state

    def _apply_delta_to_device(self, state: dict, delta: list) -> dict:
        return self._apply_frag_delta(state, list(range(len(delta))), delta)

    # ------------------------------------------------------------------
    # blocking outer step
    # ------------------------------------------------------------------

    def outer_step(self, state: dict) -> tuple[dict, dict]:
        if self._pending is not None:  # a blocking round supersedes overlap
            state = self._poll_pending(state, block=True)
        self._drain_abandoned()
        if schema_fingerprint(state["params"]) != self._schema:
            raise AssertionError("parameter schema changed mid-epoch")
        if self._plane is not None:
            return self._outer_step_device(state)
        with self._serve_lock:
            self._blocking_snap = {"master": self.master, "epoch": self.epoch,
                                   "outer_opt": self.outer_opt.state_dict_refs()}
        t0 = time.monotonic()
        # streaming without overlap: this boundary's fragment alone forms a
        # pseudo-gradient and crosses D2H, H2D and the wire
        frag = self._fragments[self.epoch % len(self._fragments)] if self._fragments is not None else None
        leaves = flatten_params(state["params"])

        def d2h():
            with span("outer.d2h"):
                boundary = self._fetch_params(leaves, frag)
            return boundary, time.monotonic() - t0

        # the D2H overlaps the straggler wait
        (boundary, d2h_s), wait_s = self._wait_beside(d2h)
        t1 = time.monotonic()
        with span("outer.pseudo_grad"):
            if frag is not None:
                pseudo_grad = [np.subtract(self.master[i], d) for i, d in zip(frag, boundary)]
            else:
                pseudo_grad = self._pseudo_grad_into(boundary, slot=0)
            if self._ef is not None:
                self._ef.prepare("main", frag if frag is not None else range(len(pseudo_grad)), pseudo_grad)
        del boundary
        t2 = time.monotonic()
        averaged, group_size, allreduce_s = self._all_reduce_round(pseudo_grad)
        t3 = time.monotonic()
        # clone-then-rebind: published master and momentum arrays stay
        # bit-stable for a concurrent state fetch
        with span("outer.nesterov"):
            new_master = [m.copy() for m in self.master]
            new_opt = self.outer_opt.clone()
            if frag is not None:
                new_opt.step_indices(new_master, averaged, frag)
            else:
                new_opt.step(new_master, averaged)
        self.master = new_master
        self.outer_opt = new_opt
        if self._is_state_avg_epoch():
            # periodic full-state averaging (hivemind average_state_every)
            averaged_state, n = self._wan_all_reduce(self.master, tag="state")
            # copies: the result may live in a backend buffer the next
            # all_reduce reuses
            self.master = [np.array(a, dtype=np.float32) for a in averaged_state]
            log.info("averaged full state over %d peers at epoch %d", n, self.epoch)
        t4 = time.monotonic()
        with span("outer.h2d"):
            # streaming: only the synced fragment resets to the master, the
            # other leaves keep their local progress
            state = self._write_master_to_device(state, frag)
        t5 = time.monotonic()
        with self._serve_lock:
            self.epoch += 1
            self.local_step = 0
            self.samples_in_epoch = 0
            self._blocking_snap = None
        return state, self._round_metrics(t0, wait_s, d2h_s, t2 - t1, allreduce_s, t4 - t3, t5 - t4, group_size)

    def _all_reduce_round(self, pseudo_grad: list) -> tuple[list, int, float]:
        """The round's all-reduce with error feedback's commit or abort
        around it: (averaged, group size, seconds)."""
        t = time.monotonic()
        try:
            with span("outer.all_reduce"):
                averaged, group_size = self._wan_all_reduce(pseudo_grad, epoch=self.epoch)
            self._check_group_size(group_size)
        except BaseException:
            if self._ef is not None:
                self._ef.abort("main")
            raise
        if self._ef is not None:
            self._ef.commit("main")
        allreduce_s = time.monotonic() - t
        log.info("outer step %d: all-reduce over %d peers took %.3fs", self.epoch, group_size, allreduce_s)
        return averaged, group_size, allreduce_s

    def _round_metrics(self, t0, wait_s, d2h_s, pseudo_grad_s, allreduce_s, nesterov_s, h2d_s, group_size) -> dict:
        self._epoch_t0 = time.monotonic()
        outer_metrics = {
            "outer_step_s": time.monotonic() - t0,
            "outer_allreduce_s": allreduce_s,
            "outer_wait_s": wait_s,
            # the phases: the D2H (device placement: with the
            # pseudo-gradient before it) overlaps the wait; the rest run in
            # turn
            "outer_d2h_s": d2h_s,
            "outer_pseudo_grad_s": pseudo_grad_s,
            "outer_nesterov_s": nesterov_s,
            "outer_h2d_s": h2d_s,
            "num_peers": group_size,
            **self._round_health_metrics(),
        }
        self.last_outer_metrics = outer_metrics
        return outer_metrics

    def _outer_step_device(self, state: dict) -> tuple[dict, dict]:
        """The blocking round under device placement: the pseudo-gradient
        on the device and its D2H (wire width), the all-reduce on the
        host, the averaged pseudo-gradient H2D and the Nesterov apply with
        params <- master on the device, one leaf at a time. A normal round
        publishes no host snapshot: its writes and the epoch advance happen
        under plane.lock, which a snapshot takes too. A state-averaging
        round does (its WAN leg would hold fetches behind the lock)."""
        plane = self._plane
        state_avg = self._is_state_avg_epoch()
        if state_avg:
            master_snap, buf_snap = plane.host_state()
            with self._serve_lock:
                self._blocking_snap = {
                    "master": master_snap, "epoch": self.epoch,
                    "outer_opt": {"lr": plane.lr, "momentum": plane.momentum, "nesterov": plane.nesterov,
                                  "bufs": buf_snap},
                }
        t0 = time.monotonic()
        frag = self._fragments[self.epoch % len(self._fragments)] if self._fragments is not None else None
        leaves = flatten_params(state["params"])
        src = leaves if frag is None else [leaves[i] for i in frag]

        def fetch():
            with span("outer.d2h"):
                host, _, secs = plane.pseudo_grad(src, frag)
            return host, secs, time.monotonic() - t0

        # the pseudo-gradient and its D2H overlap the straggler wait
        (pseudo_grad, pg_secs, fetch_s), wait_s = self._wait_beside(fetch)
        t1 = time.monotonic()
        if self._ef is not None:
            # the plane added the residual; stage the round trip error
            self._ef.prepare("main", frag if frag is not None else range(len(pseudo_grad)), pseudo_grad)
        averaged, group_size, allreduce_s = self._all_reduce_round(pseudo_grad)
        del pseudo_grad
        if state_avg:
            # the apply, then the full-state leg: masters to the host,
            # averaged, adopted back; the published snapshot serves fetches
            with span("outer.nesterov"):
                secs = plane.apply_average(averaged, frag)
            averaged_state, n = self.backend.all_reduce(plane.host_state()[0], timeout=self.cfg.averaging_timeout,
                                                        tag="state")
            plane.load_masters(averaged_state)
            log.info("averaged full state over %d peers at epoch %d", n, self.epoch)
            with plane.lock:
                plane.sync_params(leaves, frag)
                with self._serve_lock:
                    self.epoch += 1
                    self.local_step = 0
                    self.samples_in_epoch = 0
                    self._blocking_snap = None
        else:
            # plane.lock spans the apply, params <- master and the epoch
            # advance: a snapshot sees the pre- or the post-round pair
            with plane.lock:
                with span("outer.nesterov"):
                    secs = plane.apply_average(averaged, frag, sync=leaves)
                with self._serve_lock:
                    self.epoch += 1
                    self.local_step = 0
                    self.samples_in_epoch = 0
        del averaged
        # the D2H row is the fetch less its pseudo-gradient part; the H2D
        # and Nesterov rows split the apply
        return state, self._round_metrics(t0, wait_s, fetch_s - pg_secs["pseudo_grad_s"], pg_secs["pseudo_grad_s"],
                                          allreduce_s, secs["nesterov_s"], secs["h2d_s"], group_size)

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
    def _write_master_to_device(self, state: dict, frag: Optional[list[int]] = None) -> dict:
        """Copy the host master into the device params in place (all
        leaves, or those of ``frag``); the inner optimizer state is left
        as it is."""
        leaves = flatten_params(state["params"])
        for i in range(len(leaves)) if frag is None else frag:
            leaves[i].copy_(torch.from_numpy(self.trainer.host_block(i, self.master[i])), non_blocking=False)
        return state

    # ------------------------------------------------------------------
    # checkpoint integration
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """The host view under either placement (checkpoints carry over
        between them); ``ef_residual`` with error feedback."""
        if self._pending is not None:
            log.warning("state_dict() with an outer round in flight; call flush(state) first for a master "
                        "that includes it")
        if self._plane is not None:
            master, bufs = self._plane.host_state()
            sd = {"master": master,
                  "outer_opt": {"lr": self._plane.lr, "momentum": self._plane.momentum,
                                "nesterov": self._plane.nesterov, "bufs": bufs}}
            ef = self._plane.ef_host_state() if self._ef is not None else None
        else:
            sd = {"master": [m.copy() for m in self.master], "outer_opt": self.outer_opt.state_dict()}
            ef = self._ef.host_residuals() if self._ef is not None else None
        sd.update(epoch=self.epoch, local_step=self.local_step, samples_in_epoch=self.samples_in_epoch)
        if self._ef is not None:
            sd["ef_residual"] = ef
        return sd

    def load_state_dict(self, sd: dict) -> None:
        opt = sd["outer_opt"]
        plane = self._plane
        # lock order: plane.lock, then _serve_lock
        with plane.lock if plane is not None else contextlib.nullcontext():
            if plane is not None:
                plane.load(sd["master"], opt.get("bufs"), lr=opt.get("lr"), momentum=opt.get("momentum"),
                           nesterov=opt.get("nesterov"))
                if self._ef is not None:
                    # None entries (a host checkpoint's leaves that never
                    # committed) load as zeros
                    plane.load_ef(sd.get("ef_residual"))
                self.outer_opt.load_state_dict({**opt, "bufs": None})  # scalars only
            with self._serve_lock:
                self._blocking_snap = None
                if plane is None:
                    self.master = [np.asarray(m, np.float32).copy() for m in sd["master"]]
                    self.outer_opt.load_state_dict(opt)
                    if self._ef is not None:
                        self._ef.load(sd.get("ef_residual"))
                self.epoch = int(sd["epoch"])
                self.local_step = int(sd["local_step"])
                self.samples_in_epoch = int(sd.get("samples_in_epoch", self.local_step * self.batch_size))
