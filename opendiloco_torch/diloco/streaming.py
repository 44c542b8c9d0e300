"""Streaming outer sync: staggered fragment all-reduces inside the inner
phase.

The port's copy of ``opendiloco_tpu/diloco/streaming.py``
``launch_schedule`` and ``StreamScheduler``.
With ``streaming_fragments=N`` and ``overlap_comm`` on, every fragment
syncs every epoch: fragment k's all-reduce opens after inner step
``min(H, int(k*stagger*H/N)+1)`` and lands when the swarm completes it,
while inner training goes on. The boundary is bookkeeping only.

Per fragment round:

  launch (training thread, the trainer's post-dispatch hook):
    pg    = master_frag - params_frag
    eager: params_frag += est(pg) - params_frag   (the local first-step
                                                   estimate)
    a comm thread opens all_reduce(tag=f"frag{k}", epoch=e)

  land (training thread, the first tick after the round resolved):
    true  = outer_sgd(master_frag, avg)
    eager: params_frag += true - est   (with the launch's delta, exactly
                                        the blocking rewrite, in two parts)
    delayed: params_frag += true - boundary
    master_frag <- true

While rounds fly the master is fragment-mixed, each fragment at its own
landing. A round that fails is dropped with a warning: the eager estimate
stays applied and the fragment's next pseudo-gradient re-captures it.

Under gossip the comm thread carries the fragment's (master, momentum)
beside its pseudo-gradient into a pair round and runs the NoLoCo step
itself (``noloco_step``); the landing adopts the new master and momentum
and applies ``new - est`` (eager) or ``new - boundary`` (delayed) to the
fragment's params.

The schedule is a pure function of (local_steps, fragments, stagger) and
the partition of the shared leaf sizes, so every peer opens round
``frag{k}-epoch-{e}`` with the same shapes and no coordination. On the
device plane the comm thread makes the D2H copy of its fragment's
pseudo-gradient itself, on the plane's copy stream after the launch's
event (:meth:`DeviceOuterPlane.fetch`).
"""
from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Any, Optional

import numpy as np

from opendiloco_torch import obs
from opendiloco_torch.diloco.backend import AllReduceError
from opendiloco_torch.diloco.outer_optimizer import OuterSGD, noloco_step
from opendiloco_torch.models.llama import flatten_params
from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)


def launch_schedule(local_steps: int, n_fragments: int, stagger: float) -> list[int]:
    """The inner step after which each fragment launches (1-based: slot s
    fires right after the s-th inner step of the epoch). ``stagger=1.0``
    spreads launches over the phase; smaller values front-load them."""
    h, n = int(local_steps), int(n_fragments)
    return [min(h, int(k * stagger * h / n) + 1) for k in range(n)]


class StreamScheduler:
    """One in-flight all-reduce per fragment, at most, in place of the
    optimizer's single ``_pending`` round. Every entry point runs on the
    training thread; only the all-reduce (and, on the device plane, its
    D2H) rides a daemon comm thread per round."""

    def __init__(self, opt):
        self.opt = opt
        self.n = len(opt._fragments)
        self.schedule = launch_schedule(opt.cfg.local_steps, self.n, opt.cfg.stream_stagger)
        # rounds of one fragment are ordered: a relaunch lands its
        # predecessor first
        self._inflight: dict[int, dict[str, Any]] = {}
        self._launched: set[int] = set()

    # -- heartbeat ---------------------------------------------------------

    def tick(self, state: dict, step: int) -> dict:
        """After every inner step: land the rounds that resolved, then open
        those whose slot has come (``<=`` heals a slot missed by a
        mid-epoch restore)."""
        for k in list(self._inflight):
            if self._inflight[k]["future"].done():
                state = self._land(state, k)
        for k in range(self.n):
            if k not in self._launched and self.schedule[k] <= step:
                state = self._launch(state, k)
        return state

    def boundary(self, state: dict) -> tuple[dict, dict]:
        """The epoch boundary: launch any fragment whose slot never fired,
        land what resolved, advance the epoch. No barrier, no wire
        traffic, no params rewrite."""
        t0 = time.monotonic()
        tr = obs.tracer()
        t0p = time.perf_counter() if tr is not None else 0.0
        for k in range(self.n):
            if k not in self._launched:
                state = self._launch(state, k)
        for k in list(self._inflight):
            if self._inflight[k]["future"].done():
                state = self._land(state, k)
        opt = self.opt
        with opt._serve_lock:
            opt.epoch += 1
            opt.local_step = 0
            opt.samples_in_epoch = 0
        self._launched.clear()
        opt._epoch_t0 = time.monotonic()
        metrics = {
            "outer_step_s": time.monotonic() - t0,
            "outer_overlapped": 1,
            "outer_streaming_fragments": self.n,
            "outer_inflight_fragments": len(self._inflight),
        }
        if tr is not None:
            tr.add_span("outer/launch", t0p, time.perf_counter(), epoch=opt.epoch - 1)
            tr.gauge("outer_inflight_fragments", len(self._inflight))
        opt.last_outer_metrics = metrics
        return state, metrics

    def flush(self, state: dict) -> dict:
        """Land every in-flight round, waiting for each (checkpoint and
        shutdown: the master must hold every launched round)."""
        for k in list(self._inflight):
            state = self._land(state, k, block=True)
        return state

    def drop_all(self) -> None:
        """Forget every in-flight round (adopted state supersedes them);
        each owns its fragment-sized buffers, so nothing needs draining."""
        for rec in self._inflight.values():
            rec["future"].cancel()
        self._inflight.clear()
        self._launched.clear()

    def wait_inflight(self, timeout: float = 60.0) -> None:
        """Wait until every in-flight round resolved, without landing it
        (landing needs the training thread's state): pins the landing
        schedule for tests and the smoke."""
        deadline = time.monotonic() + timeout
        for rec in list(self._inflight.values()):
            concurrent.futures.wait([rec["future"]], timeout=max(deadline - time.monotonic(), 0.001))

    # -- launch ------------------------------------------------------------

    def _launch(self, state: dict, k: int) -> dict:
        opt = self.opt
        if k in self._inflight:
            # the predecessor still flies at this fragment's next slot: land
            # it first (the one place streaming blocks)
            state = self._land(state, k, block=True)
        frag = opt._fragments[k]
        epoch = opt.epoch
        eager = opt.cfg.overlap_comm == "eager"
        tr = obs.tracer()
        t0p = time.perf_counter() if tr is not None else 0.0
        rec: dict[str, Any] = {"frag": frag, "epoch": epoch, "eager": eager, "t_launch": time.monotonic(),
                               "round": f"frag{k}-epoch-{epoch}"}
        leaves = flatten_params(state["params"])
        if opt._plane is not None:
            # pseudo-gradient, wire cast and eager estimate on the device,
            # nothing written in place: the plane stays pre-round for this
            # fragment until its landing
            wire, delta, retained, ready = opt._plane.stream_launch(leaves, frag, eager=eager)
            rec["placement"] = "device"
            rec["retained"] = retained
            if opt._gossip is not None:
                # the pair round carries (master, momentum) beside the pg:
                # the launch never rebinds and a gossip landing rebinds, so
                # these refs stay this fragment's pre-round values
                with opt._plane.lock:
                    rec["m_refs"] = opt._plane._sel(opt._plane.masters, frag)
                    rec["b_refs"] = opt._plane._sel(opt._plane.bufs, frag) if opt._plane.bufs is not None else None
            if eager:
                state = opt._apply_frag_delta(state, frag, delta)
            fut = self._spawn(k, epoch, wire=wire, ready=ready, rec=rec)
        else:
            # host placement: own the boundary bytes now, on the training
            # thread (the next inner step writes these params in place)
            bh = opt._fetch_params(leaves, frag)
            pg = [np.subtract(opt.master[i], b) for i, b in zip(frag, bh)]
            if opt._ef is not None:
                # the residual goes into the wire pg and the eager estimate
                # below; the round trip error stages until this round lands
                opt._ef.prepare(rec["round"], frag, pg)
            rec["placement"] = "host"
            oo = opt.outer_opt
            if opt._gossip is not None:
                # the master and momentum are only ever rebound: these refs
                # stay the pre-round values for the comm thread
                rec["m_refs"] = [opt.master[i] for i in frag]
                rec["b_refs"] = None if oo.bufs is None else [oo.bufs[i] for i in frag]
            if eager:
                est_opt = OuterSGD(lr=oo.lr, momentum=oo.momentum, nesterov=oo.nesterov)
                est_opt.bufs = None if oo.bufs is None else [oo.bufs[i].copy() for i in frag]
                est_m = [opt.master[i].copy() for i in frag]
                est_opt.step(est_m, pg)
                state = opt._apply_frag_delta(state, frag, [e - b for e, b in zip(est_m, bh)])
                rec["est_m"] = est_m
            else:
                rec["boundary"] = bh
            fut = self._spawn(k, epoch, pg=pg, rec=rec)
        rec["future"] = fut
        self._inflight[k] = rec
        self._launched.add(k)
        if tr is not None:
            tr.add_span("outer/fragment_launch", t0p, time.perf_counter(), frag=k, epoch=epoch, round=rec["round"])
            tr.gauge("outer_inflight_fragments", len(self._inflight))
            tr.count("outer_fragment_rounds")
        return state

    def _spawn(self, k: int, epoch: int, *, pg: Optional[list] = None, wire: Optional[list] = None,
               ready=None, rec: dict):
        """Open fragment k's all-reduce on a daemon comm thread. On the
        device plane the thread makes the D2H copy of ``wire`` (fresh
        tensors nothing writes again) itself, after the launch's event,
        and stages the error feedback there, where the host pg first
        exists. The result is copied out of the backend's buffers."""
        opt = self.opt
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _run():
            if not fut.set_running_or_notify_cancel():
                return
            try:
                arrays = pg
                if arrays is None:
                    arrays = [x if x.dtype == np.float32 else x.astype(np.float32)
                              for x in opt._plane.fetch(wire, after=ready)]
                    if opt._ef is not None:
                        opt._ef.prepare(rec["round"], rec["frag"], arrays)
                if opt._gossip is not None:
                    fut.set_result(self._gossip_round(k, epoch, arrays, rec, ready))
                    return
                avg, n = opt.backend.all_reduce(arrays, timeout=opt.cfg.averaging_timeout, tag=f"frag{k}",
                                                epoch=epoch)
                fut.set_result(([np.array(a, np.float32) for a in avg], n))
            except BaseException as e:  # surfaced through fut.result()
                fut.set_exception(e)

        threading.Thread(target=_run, name=f"diloco-stream-frag{k}", daemon=True).start()
        return fut

    def _gossip_round(self, k: int, epoch: int, pgs: list, rec: dict, ready) -> tuple:
        """The comm thread's pair round for fragment k: host copies of the
        retained refs, the exchange, and the NoLoCo step. Returns ((new
        masters, new momentum), pair size); a dropped round raises (its
        per-partner residual was kept by the exchange). Lockstep pairs on
        the (epoch, fragment) key; async matches any in-window partner on
        fragment k, and a patience miss lands as a self-round."""
        opt = self.opt
        m_refs, b_refs = rec["m_refs"], rec["b_refs"]
        if rec["placement"] == "device":
            m_np = opt._plane.fetch(m_refs, after=ready)
            b_np = None if b_refs is None else opt._plane.fetch(b_refs, after=ready)
        else:
            m_np = [np.array(x, np.float32) for x in m_refs]
            b_np = None if b_refs is None else [np.array(x, np.float32) for x in b_refs]
        if b_np is None and opt.cfg.outer_momentum != 0.0:
            b_np = [np.zeros_like(m) for m in m_np]
        res = opt._gossip.exchange(epoch=epoch, frag_id=k, idxs=rec["frag"], masters=m_np, bufs=b_np, pgs=pgs,
                                   timeout=opt.cfg.averaging_timeout)
        if res is None:
            raise AllReduceError(f"gossip pair round dropped (frag {k} epoch {epoch})")
        mix_m, mix_b, avg_g, _partner, n = res
        new = noloco_step(mix_m, mix_b, avg_g, lr=opt.cfg.outer_lr, momentum=opt.cfg.outer_momentum,
                          nesterov=opt.cfg.outer_nesterov)
        return new, n

    # -- land --------------------------------------------------------------

    def _land(self, state: dict, k: int, *, block: bool = False) -> dict:
        opt = self.opt
        rec = self._inflight.pop(k)
        tr = obs.tracer()
        t0p = time.perf_counter() if tr is not None else 0.0
        try:
            avg, group = rec["future"].result(timeout=(opt.cfg.averaging_timeout + 60) if block else 0)
        except BaseException as e:
            # a dropped round: the eager estimate stays applied and the
            # fragment's next pseudo-gradient re-captures it
            log.warning("fragment %d round (epoch %d) dropped: %s", k, rec["epoch"], e)
            if opt._ef is not None:
                opt._ef.abort(rec["round"])
            if tr is not None:
                tr.count("outer_fragment_rounds_dropped")
                tr.gauge("outer_inflight_fragments", len(self._inflight))
            return state
        if opt._gossip is None:
            opt._check_group_size(group)
        if opt._ef is not None:
            opt._ef.commit(rec["round"])
        frag = rec["frag"]
        # under gossip the comm thread ran the NoLoCo step: ``avg`` is the
        # fragment's new (master, momentum), landed like an all-reduce's
        # true step against the retained estimate or boundary
        if rec["placement"] == "device":
            if opt._gossip is not None:
                delta = opt._plane.gossip_land(frag, *avg, base=rec["retained"])
            elif rec["eager"]:
                delta = opt._plane.stream_land(frag, avg, est_m=rec["retained"])
            else:
                delta = opt._plane.stream_land(frag, avg, boundary=rec["retained"])
            state = opt._apply_frag_delta(state, frag, delta)
        else:
            if opt._gossip is not None:
                true_m, true_b = avg
            else:
                # the true fragment step on copies of the live (pre-round for
                # this fragment) master and momentum
                oo = opt.outer_opt
                true_opt = OuterSGD(lr=oo.lr, momentum=oo.momentum, nesterov=oo.nesterov)
                true_opt.bufs = None if oo.bufs is None else [oo.bufs[i].copy() for i in frag]
                true_m = [opt.master[i].copy() for i in frag]
                true_opt.step(true_m, avg)
                true_b = true_opt.bufs
            base = rec["est_m"] if rec["eager"] else rec["boundary"]
            state = opt._apply_frag_delta(state, frag, [t - b for t, b in zip(true_m, base)])
            self._rebind(frag, true_m, true_b)
        landed_s = time.monotonic() - rec["t_launch"]
        lm = opt._landed_metrics or {}
        lm.update({"outer_allreduce_s": landed_s, "num_peers": group, **opt._round_health_metrics()})
        lm["outer_fragments_landed"] = lm.get("outer_fragments_landed", 0) + 1
        opt._landed_metrics = lm
        opt.last_outer_metrics = dict(lm)
        if tr is not None:
            tr.add_span("outer/fragment_land", t0p, time.perf_counter(), frag=k, epoch=rec["epoch"],
                        round=rec["round"], group=group, landed_s=round(landed_s, 6))
            tr.gauge("outer_inflight_fragments", len(self._inflight))
            tr.gauge("outer_allreduce_s", landed_s)
        log.info("fragment %d (epoch %d): all-reduce over %d peers landed after %.3fs", k, rec["epoch"], group,
                 landed_s)
        return state

    def _rebind(self, frag: list, masters: list, bufs: Optional[list]) -> None:
        """Publish a fragment's new master and momentum by rebinding, the
        other leaves' arrays shared (a published array is never written)."""
        opt = self.opt
        oo = opt.outer_opt
        new_master = list(opt.master)
        for j, i in enumerate(frag):
            new_master[i] = np.asarray(masters[j], np.float32)
        new_opt = OuterSGD(lr=oo.lr, momentum=oo.momentum, nesterov=oo.nesterov)
        if oo.momentum != 0.0:
            new_bufs = [np.zeros_like(p) for p in opt.master] if oo.bufs is None else list(oo.bufs)
            if bufs is not None:
                for j, i in enumerate(frag):
                    new_bufs[i] = np.asarray(bufs[j], np.float32)
            new_opt.bufs = new_bufs
        with opt._serve_lock:
            opt.master = new_master
            opt.outer_opt = new_opt
