"""Device-resident outer plane: the DiLoCo master and its Nesterov
momentum on the trainer's device.

The port's copy of ``opendiloco_tpu/diloco/outer_device.py``
``DeviceOuterPlane`` with its fused entry points as plain functions on
lists of tensors. With ``outer_placement="device"`` the outer data plane
stays on the card:

  pseudo-gradient   pg = master - params           (+ residual under error
                                                    feedback)
  outer Nesterov    buf *= m; buf += g; t = m * buf; d = g + t; p -= lr * d

and only the pseudo-gradient crosses to the host (f16 when the codec is
plain fp16, see :func:`~opendiloco_torch.diloco.compression.device_wire_dtype`)
and the averaged pseudo-gradient back, one leaf at a time.

**Exactness.** Every update is written as separately rounded f32
operations in the order of the host path's
:meth:`~opendiloco_torch.diloco.outer_optimizer.OuterSGD.step_indices`
(one op per kernel: nothing can contract a multiply and an add into an
FMA), so device placement gives masters, momentum and losses bit for bit
equal to host placement. The JAX package lets XLA fuse ``m*buf + g``, and
its own host-versus-device parity misses by an ulp.

**In place where JAX donates.** The apply and the landings step the
masters and momentum in place; the eager estimate and a streaming launch
write only fresh tensors, so the pre-round arrays stay for the landing.
params <- master is always a copy (``p.copy_(m)``), never a rebind, and
the master is a fresh f32 copy of the params at construction.

**Threads and streams.** Every entry point that writes the plane holds
``self.lock`` (an RLock) and runs on the stream that was current when the
plane was built (the trainer's), then records an event. A host copy made
on another thread (a serving snapshot, a peer's state fetch, a streaming
comm thread) holds the lock too, and on the card runs on a copy stream of
its own that first waits for that event: it reads what the trainer's
stream wrote and does not wait for the trainer's later work. Host copies
own their memory (on the CPU a tensor's ``.numpy()`` is a view that a
later in-place apply would change).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from opendiloco_torch.diloco.compression import device_wire_dtype

_DTYPES = {"float16": torch.float16}


# -- the update rule, and the fused entry points --------------------------------
# JAX donates its inputs; here the same functions write in place where the
# caller is done with the input, and name it.


def _nesterov_step_(m: torch.Tensor, b: Optional[torch.Tensor], g: torch.Tensor, lr: float, momentum: float,
                    nesterov: bool) -> None:
    """One leaf of the outer rule, in place on ``m`` and ``b`` (``b`` None:
    no momentum): buf *= momentum; buf += g; t = momentum * buf;
    d = g + t; m -= lr * d, each op rounded on its own, in the host's order.
    ``g`` is read, never written; ``d`` lives in one temporary."""
    if b is None:
        d = torch.mul(g, lr)
    else:
        b.mul_(momentum)
        b.add_(g)
        if nesterov:
            d = torch.mul(b, momentum)
            d.add_(g)
        else:
            d = b.clone()
        d.mul_(lr)
    m.sub_(d)


def _nesterov_step(masters, bufs, grads, lr, momentum, nesterov, has_mom) -> None:
    """:func:`_nesterov_step_` over lists, in place on ``masters`` and
    ``bufs`` (``bufs`` ignored without momentum)."""
    for i, (m, g) in enumerate(zip(masters, grads)):
        _nesterov_step_(m, bufs[i] if has_mom else None, g, lr, momentum, nesterov)


def _pg_f32(masters, params) -> list:
    return [torch.sub(m, p) for m, p in zip(masters, params)]


def _pg_f32_ef(masters, params, res) -> list:
    """Error feedback: pg = (master - params) + residual, full width (the
    host must see the exact f32 it encodes to measure the round trip
    error)."""
    return [torch.sub(m, p).add_(r) for m, p, r in zip(masters, params, res)]


def _pg_wire(masters, params, wire_dtype, keep32) -> tuple[list, list]:
    """(f32 pg if ``keep32`` else [], pg cast to ``wire_dtype``)."""
    pg = _pg_f32(masters, params)
    return (pg if keep32 else []), [g.to(wire_dtype) for g in pg]


def _apply_fused(masters, bufs, avg, lr, momentum, *, nesterov, has_mom) -> None:
    """Blocking apply, in place on ``masters`` and ``bufs``."""
    _nesterov_step(masters, bufs, avg, lr, momentum, nesterov, has_mom)


def _apply_sync_fused(masters, bufs, avg, params, lr, momentum, *, nesterov, has_mom) -> None:
    """Blocking apply, then params <- master (a copy: the trainer steps
    its params in place, and a rebind would let it step the master)."""
    _apply_fused(masters, bufs, avg, lr, momentum, nesterov=nesterov, has_mom=has_mom)
    for p, m in zip(params, masters):
        p.copy_(m)


def _estimate(masters, bufs, pg, lr, momentum, nesterov, has_mom) -> tuple[list, list]:
    """(est_m, est_b): the step from the LOCAL pseudo-gradient on fresh
    copies; the pre-round masters and momentum (None before the first
    armed step: zeros) are left as they are."""
    est_m = [m.clone() for m in masters]
    est_b = ([b.clone() for b in bufs] if bufs else [torch.zeros_like(m) for m in masters]) if has_mom else []
    _nesterov_step(est_m, est_b, pg, lr, momentum, nesterov, has_mom)
    return est_m, est_b


def _estimate_fused(masters, bufs, pg, boundary, lr, momentum, *, nesterov, has_mom) -> tuple[list, list, list]:
    """Eager launch: (est_m, est_b, delta) with delta = est_m - boundary
    written into ``boundary``'s buffers (the caller is done with it).
    delta keeps the host path's association; pg - lr*d would round at the
    pseudo-gradient's scale."""
    est_m, est_b = _estimate(masters, bufs, pg, lr, momentum, nesterov, has_mom)
    return est_m, est_b, [torch.sub(e, b, out=b) for e, b in zip(est_m, boundary)]


def _land_delayed_fused(masters, bufs, boundary, avg, lr, momentum, *, nesterov, has_mom) -> list:
    """Delayed landing: the true step in place on the pre-round
    ``masters``/``bufs``, and delta = new master - boundary into
    ``boundary``'s buffers."""
    _apply_fused(masters, bufs, avg, lr, momentum, nesterov=nesterov, has_mom=has_mom)
    return [torch.sub(m, b, out=b) for m, b in zip(masters, boundary)]


def _land_eager_fused(masters, bufs, est_m, avg, lr, momentum, *, nesterov, has_mom) -> list:
    """Eager landing: the true step in place on the pre-round
    ``masters``/``bufs``, and delta = true - estimate into ``est_m``'s
    buffers."""
    _apply_fused(masters, bufs, avg, lr, momentum, nesterov=nesterov, has_mom=has_mom)
    return [torch.sub(t, e, out=e) for t, e in zip(masters, est_m)]


def _stream_launch_fused(masters, bufs, params, lr, momentum, *, wire_dtype, nesterov, has_mom, eager,
                         res=None) -> tuple[list, list, list]:
    """A streaming fragment's launch; every output is fresh and nothing is
    written in place, so the live plane stays pre-round for the fragment
    and several fragment rounds can be in flight. ``res``: the error
    feedback residuals (full width: no wire cast).

    eager:   (wire, delta, est_m): delta = est_m - params, the first-step
             estimate to apply now; est_m for the landing.
    delayed: (wire, boundary, []): a f32 copy of the boundary params."""
    pg = _pg_f32(masters, params) if res is None else _pg_f32_ef(masters, params, res)
    wire = [g.to(wire_dtype) for g in pg] if wire_dtype is not None else pg
    if not eager:
        return wire, [p.detach().to(torch.float32, copy=True) for p in params], []
    est_m, _ = _estimate(masters, bufs, pg, lr, momentum, nesterov, has_mom)
    return wire, [torch.sub(e, p) for e, p in zip(est_m, params)], est_m


def _stream_launch_fused_ef(masters, bufs, params, res, lr, momentum, *, nesterov, has_mom, eager):
    """:func:`_stream_launch_fused` with the residual add, no wire cast."""
    return _stream_launch_fused(masters, bufs, params, lr, momentum, wire_dtype=None, nesterov=nesterov,
                                has_mom=has_mom, eager=eager, res=res)


def _overwrite_fused(masters, params) -> None:
    """params <- master, as copies."""
    for p, m in zip(params, masters):
        p.copy_(m)


def _sub_fused(new, base) -> list:
    """delta = new - base into ``base``'s buffers."""
    return [torch.sub(a, b, out=b) for a, b in zip(new, base)]


def _cast_fused(leaves, dtype) -> list:
    """Fresh casts (the serving snapshot's narrowing before its D2H)."""
    return [x.to(dtype) for x in leaves]


def _copy_fused(leaves) -> list:
    """Fresh f32 copies that alias nothing."""
    return [x.detach().to(torch.float32, copy=True) for x in leaves]


class DeviceOuterPlane:
    """Master, momentum and error-feedback residuals on the trainer's
    device, and the outer-boundary operations on them."""

    def __init__(self, param_leaves: Sequence[torch.Tensor], *, lr: float, momentum: float, nesterov: bool,
                 compression: str = "none", error_feedback: bool = False):
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.error_feedback = bool(error_feedback)
        wire = device_wire_dtype(compression)
        # error feedback moves the full-width pseudo-gradient: a cast on the
        # card would hide the cast's error from the residual
        self._wire_dtype = _DTYPES[wire] if wire is not None and not self.error_feedback else None
        self.device = param_leaves[0].device
        on_card = self.device.type == "cuda"
        self.stream = torch.cuda.current_stream(self.device) if on_card else None
        self._copy_stream = torch.cuda.Stream(self.device) if on_card else None
        self._written = None  # event after the plane's last write (card only)
        self.lock = threading.RLock()
        with self._run():
            self.masters: list[torch.Tensor] = _copy_fused(param_leaves)
            self._mark()
        self.bufs: Optional[list[torch.Tensor]] = None
        # residuals on the device, zeros at the first pseudo-gradient that
        # needs them; None without error feedback
        self.ef_res: Optional[list[torch.Tensor]] = None

    # -- helpers -----------------------------------------------------------

    @contextlib.contextmanager
    def _run(self):
        """Plane work: no autograd, on the trainer's stream."""
        with torch.no_grad(), (torch.cuda.stream(self.stream) if self.stream is not None
                               else contextlib.nullcontext()):
            yield

    def _mark(self):
        """Record the plane's last write; returns the event (None on the
        CPU)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        self._written = ev
        return ev

    def fetch(self, tensors: Sequence[torch.Tensor], after=None, dtype=None) -> list[np.ndarray]:
        """Host copies that own their memory (cast to ``dtype`` on the
        device first, one leaf at a time, when given). On the card they
        run on the copy stream once ``after`` (default: the plane's last
        write) has passed, so any thread may call this; each copy has
        ended when it returns."""
        with torch.no_grad(), self._copying(after):
            return [(t if dtype is None else _cast_fused([t], dtype)[0]).to("cpu", copy=True).numpy()
                    for t in tensors]

    @contextlib.contextmanager
    def _copying(self, after):
        if self.stream is None:
            yield
            return
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(after if after is not None else self._written)
            yield

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of it: backends may
        reuse their result buffers)."""
        a = np.ascontiguousarray(a, dtype=np.float32)
        if not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a).to(self.device, copy=True)

    def _sel(self, leaves, frag: Optional[list[int]]) -> list:
        if leaves is None:
            return []
        return list(leaves) if frag is None else [leaves[i] for i in frag]

    def _ensure_bufs(self) -> None:
        if self.momentum != 0.0 and self.bufs is None:
            # zeros for every leaf at the first armed step (OuterSGD: leaves
            # of other fragments keep their momentum frozen)
            self.bufs = [torch.zeros_like(m) for m in self.masters]

    def _ensure_ef(self) -> None:
        if self.error_feedback and self.ef_res is None:
            self.ef_res = [torch.zeros_like(m) for m in self.masters]

    @property
    def _has_mom(self) -> bool:
        return self.momentum != 0.0

    def _sync(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()

    # -- boundary ops ------------------------------------------------------

    def pseudo_grad(self, param_leaves: Sequence[torch.Tensor], frag: Optional[list[int]] = None, *,
                    keep_device: bool = False) -> tuple[list[np.ndarray], Optional[list], dict]:
        """(host f32 pseudo-gradient, device f32 pseudo-gradient if
        ``keep_device`` else None, seconds {"pseudo_grad_s", "d2h_s"}).

        One leaf at a time: the pseudo-gradient on the device, then its D2H
        (wire width under plain fp16, widened to f32 on the host), so the
        device holds one leaf's pseudo-gradient unless ``keep_device``."""
        host, kept, secs = [], [], {"pseudo_grad_s": 0.0, "d2h_s": 0.0}
        with self.lock, self._run():
            if self.error_feedback:
                self._ensure_ef()
            m = self._sel(self.masters, frag)
            r = self._sel(self.ef_res, frag) if self.error_feedback else None
            for j, p in enumerate(param_leaves):
                t0 = time.perf_counter()
                if r is not None:
                    pg = _pg_f32_ef([m[j]], [p], [r[j]])
                elif self._wire_dtype is not None:
                    kept32, pg = _pg_wire([m[j]], [p], self._wire_dtype, keep_device)
                    kept.extend(kept32)
                else:
                    pg = _pg_f32([m[j]], [p])
                if keep_device and self._wire_dtype is None:
                    kept.extend(pg)
                self._sync()
                t1 = time.perf_counter()
                x = pg[0].to("cpu", copy=True).numpy()
                host.append(x if x.dtype == np.float32 else x.astype(np.float32))
                secs["pseudo_grad_s"] += t1 - t0
                secs["d2h_s"] += time.perf_counter() - t1
        return host, (kept if keep_device else None), secs

    def apply_average(self, averaged: Sequence[np.ndarray], frag: Optional[list[int]] = None,
                      sync: Optional[Sequence[torch.Tensor]] = None) -> dict:
        """Blocking apply: H2D the averaged pseudo-gradient and step the
        masters and momentum in place, one leaf at a time; with ``sync``
        (the live param leaves, all of them) params <- master follows each
        leaf's step. Returns seconds {"h2d_s", "nesterov_s"}."""
        secs = {"h2d_s": 0.0, "nesterov_s": 0.0}
        with self.lock, self._run():
            self._ensure_bufs()
            m = self._sel(self.masters, frag)
            b = self._sel(self.bufs, frag)
            p = self._sel(sync, frag) if sync is not None else None
            for j, a in enumerate(averaged):
                t0 = time.perf_counter()
                g = self._h2d(a)
                self._sync()
                t1 = time.perf_counter()
                bj = b[j:j + 1] if self._has_mom else []
                if p is None:
                    _apply_fused([m[j]], bj, [g], self.lr, self.momentum, nesterov=self.nesterov,
                                 has_mom=self._has_mom)
                else:
                    _apply_sync_fused([m[j]], bj, [g], [p[j]], self.lr, self.momentum, nesterov=self.nesterov,
                                      has_mom=self._has_mom)
                del g
                self._sync()
                secs["h2d_s"] += t1 - t0
                secs["nesterov_s"] += time.perf_counter() - t1
            self._mark()
        return secs

    def copy_leaves(self, leaves: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Fresh f32 device copies (the overlapped rounds' boundary: the
        trainer steps its params in place)."""
        with self._run():
            return _copy_fused(leaves)

    def estimate(self, pg_dev: list[torch.Tensor], boundary: list[torch.Tensor]) -> list[torch.Tensor]:
        """Eager launch: rebind the live masters and momentum to fresh
        arrays stepped from the local pseudo-gradient (the pre-round
        arrays stay for the landing) and return the device delta for the
        params (in ``boundary``'s buffers)."""
        with self.lock, self._run():
            # no _ensure_bufs: the first armed round's pre-round momentum
            # stays None (zeros here), as the host's pre-round snapshot
            est_m, est_b, delta = _estimate_fused(self.masters, self.bufs, pg_dev, boundary, self.lr,
                                                  self.momentum, nesterov=self.nesterov, has_mom=self._has_mom)
            self.masters = est_m
            if self._has_mom:
                self.bufs = est_b
            self._mark()
            return delta

    def _pre_bufs(self, pre_masters, pre_bufs):
        if not self._has_mom:
            return []
        return pre_bufs if pre_bufs else [torch.zeros_like(m) for m in pre_masters]

    def land_delayed(self, pre_masters: list, pre_bufs: Optional[list], boundary: list,
                     averaged: Sequence[np.ndarray]) -> list[torch.Tensor]:
        """Delayed landing: the true step on the pre-round arrays (in
        place; the caller is done with them) and the deferred boundary
        rewrite as a delta (in ``boundary``'s buffers)."""
        with self.lock, self._run():
            avg = [self._h2d(a) for a in averaged]
            pre_b = self._pre_bufs(pre_masters, pre_bufs)
            delta = _land_delayed_fused(pre_masters, pre_b, boundary, avg, self.lr, self.momentum,
                                        nesterov=self.nesterov, has_mom=self._has_mom)
            self.masters = list(pre_masters)
            if self._has_mom:
                self.bufs = list(pre_b)
            self._mark()
            return delta

    def land_eager(self, pre_masters: list, pre_bufs: Optional[list], averaged: Sequence[np.ndarray]) -> list:
        """Eager landing: the true step on the pre-round arrays, corrected
        against the live (estimated) masters, whose buffers take the
        delta."""
        with self.lock, self._run():
            avg = [self._h2d(a) for a in averaged]
            pre_b = self._pre_bufs(pre_masters, pre_bufs)
            delta = _land_eager_fused(pre_masters, pre_b, self.masters, avg, self.lr, self.momentum,
                                      nesterov=self.nesterov, has_mom=self._has_mom)
            self.masters = list(pre_masters)
            if self._has_mom:
                self.bufs = list(pre_b)
            self._mark()
            return delta

    def stream_launch(self, param_leaves: Sequence[torch.Tensor], frag: list[int], *, eager: bool):
        """A streaming fragment's launch: the fragment's pseudo-gradient
        (cast for the D2H under plain fp16) and, eager, the first-step
        estimate. Nothing is written in place and the plane is not
        rebound: it stays pre-round for this fragment until
        :meth:`stream_land`.

        Returns ``(wire, delta, retained, ready)``: ``wire`` for the comm
        thread to :meth:`fetch` after ``ready`` (never written again);
        ``delta`` (eager) for the fragment's params now, else None;
        ``retained`` the estimate (eager) or the boundary copy (delayed)."""
        with self.lock, self._run():
            m = self._sel(self.masters, frag)
            b = self._sel(self.bufs, frag)
            p = [param_leaves[i] for i in frag]
            if self.error_feedback:
                self._ensure_ef()
                wire, aux, est_m = _stream_launch_fused_ef(m, b, p, self._sel(self.ef_res, frag), self.lr,
                                                           self.momentum, nesterov=self.nesterov,
                                                           has_mom=self._has_mom, eager=eager)
            else:
                wire, aux, est_m = _stream_launch_fused(m, b, p, self.lr, self.momentum,
                                                        wire_dtype=self._wire_dtype, nesterov=self.nesterov,
                                                        has_mom=self._has_mom, eager=eager)
            ready = self._mark()
        if eager:
            return wire, aux, est_m, ready
        return wire, None, aux, ready

    def stream_land(self, frag: list[int], averaged: Sequence[np.ndarray], *,
                    est_m: Optional[list] = None, boundary: Optional[list] = None) -> list[torch.Tensor]:
        """A streaming fragment's landing: the true step on the live
        fragment arrays (still pre-round: launches never write them), in
        place, reconciled against the retained estimate (eager) or
        boundary copy (delayed), whose buffers take the delta for the
        fragment's params."""
        with self.lock, self._run():
            self._ensure_bufs()
            avg = [self._h2d(a) for a in averaged]
            pre_m = self._sel(self.masters, frag)
            pre_b = self._sel(self.bufs, frag)
            if est_m is not None:
                delta = _land_eager_fused(pre_m, pre_b, est_m, avg, self.lr, self.momentum,
                                          nesterov=self.nesterov, has_mom=self._has_mom)
            else:
                delta = _land_delayed_fused(pre_m, pre_b, boundary, avg, self.lr, self.momentum,
                                            nesterov=self.nesterov, has_mom=self._has_mom)
            self._mark()
            return delta

    def sync_params(self, param_leaves: Sequence[torch.Tensor], frag: Optional[list[int]] = None) -> None:
        """params <- master (copies) for the leaves of ``frag`` (all when
        None); the other leaves keep their local progress."""
        with self.lock, self._run():
            _overwrite_fused(self._sel(self.masters, frag), self._sel(param_leaves, frag))

    def host_frag(self, frag: Optional[list[int]]) -> tuple[list[np.ndarray], Optional[list[np.ndarray]]]:
        """Host copies of one fragment's (masters, momentum); momentum None
        until it arms."""
        with self.lock:
            m = self.fetch(self._sel(self.masters, frag))
            b = self.fetch(self._sel(self.bufs, frag)) if self.bufs is not None else None
        return m, b

    def gossip_land(self, frag: Optional[list[int]], masters_np: Sequence[np.ndarray],
                    bufs_np: Optional[Sequence[np.ndarray]], *, sync: Optional[Sequence[torch.Tensor]] = None,
                    base: Optional[list[torch.Tensor]] = None) -> Optional[list[torch.Tensor]]:
        """Adopt a NoLoCo-stepped fragment (host numpy from ``noloco_step``):
        copy the new masters and momentum to the device and rebind the
        fragment's entries. The blocking path passes ``sync`` (the live
        param leaves, all of them) and the fragment's params become copies
        of the new masters; streaming passes ``base`` (the launch's
        retained estimate or boundary copy) and gets the device delta
        ``new - base`` back, in ``base``'s buffers. The landing is ordered
        after the plane's earlier writes (the trainer's stream), and a
        later host copy waits for it (:meth:`fetch`)."""
        idxs = list(range(len(self.masters))) if frag is None else list(frag)
        with self.lock, self._run():
            new_m = [self._h2d(m) for m in masters_np]
            masters = list(self.masters)
            for j, i in enumerate(idxs):
                masters[i] = new_m[j]
            self.masters = masters
            if self._has_mom and bufs_np is not None:
                self._ensure_bufs()
                bufs = list(self.bufs)
                for j, i in enumerate(idxs):
                    bufs[i] = self._h2d(bufs_np[j])
                self.bufs = bufs
            out = None
            if sync is not None:
                _overwrite_fused(new_m, self._sel(sync, frag))
            elif base is not None:
                out = _sub_fused(new_m, base)
            self._mark()
            return out

    def set_ef_residuals(self, idxs: Sequence[int], host_errs: list[np.ndarray]) -> None:
        """ErrorFeedback's commit: the round's round trip errors become the
        live residuals of ``idxs``."""
        with self.lock, self._run():
            self._ensure_ef()
            merged = list(self.ef_res)
            for i, e in zip(idxs, host_errs):
                merged[i] = self._h2d(np.asarray(e).reshape(self.masters[i].shape))
            self.ef_res = merged
            self._mark()

    # -- host boundary (serving, peers, checkpoints, state averaging) ------

    def ef_host_state(self) -> Optional[list[np.ndarray]]:
        """Host copies of the residuals (None before the first pseudo-gradient
        with error feedback)."""
        with self.lock:
            if self.ef_res is None:
                return None
            return self.fetch(self.ef_res)

    def load_ef(self, residuals_np: Optional[Sequence]) -> None:
        """Adopt checkpointed residuals; None entries (a host-placement
        checkpoint's leaves that never committed) load as zeros."""
        with self.lock, self._run():
            if residuals_np is None:
                self.ef_res = None
            else:
                self.ef_res = [torch.zeros_like(m) if r is None else self._h2d(np.asarray(r).reshape(m.shape))
                               for r, m in zip(residuals_np, self.masters)]
            self._mark()

    def host_state(self, refs: Optional[tuple] = None) -> tuple[list[np.ndarray], Optional[list[np.ndarray]]]:
        """Host copies of (masters, momentum), or of an explicit
        ``(masters, bufs)`` pair (a pending round's pre-round arrays; its
        bufs may be None)."""
        with self.lock:
            masters, bufs = refs if refs is not None else (self.masters, self.bufs)
            return self.fetch(masters), (self.fetch(bufs) if bufs else None)

    def host_masters(self, refs: Optional[list] = None, wire_dtype: Optional[str] = None) -> list[np.ndarray]:
        """The masters alone for the serving plane's hot swap; with
        ``wire_dtype`` ("float16" for the plain fp16 state codec) each
        leaf is cast on the device first, so its D2H moves half the
        bytes."""
        with self.lock:
            masters = list(refs) if refs is not None else self.masters
            return self.fetch(masters, dtype=None if wire_dtype is None else _DTYPES[wire_dtype])

    def load(self, masters_np: Sequence[np.ndarray], bufs_np: Optional[Sequence[np.ndarray]], *,
             lr: Optional[float] = None, momentum: Optional[float] = None, nesterov: Optional[bool] = None) -> None:
        """Adopt a host master and momentum (checkpoint restore, a peer's
        state) and, optionally, the optimizer's scalars."""
        with self.lock, self._run():
            if lr is not None:
                self.lr = float(lr)
            if momentum is not None:
                self.momentum = float(momentum)
            if nesterov is not None:
                self.nesterov = bool(nesterov)
            self.masters = [self._h2d(m) for m in masters_np]
            self.bufs = None if bufs_np is None or self.momentum == 0.0 else [self._h2d(b) for b in bufs_np]
            self._mark()

    def load_masters(self, masters_np: Sequence[np.ndarray]) -> None:
        """Adopt averaged masters (the ``average_state_every`` leg), in
        place; momentum stays, as on the host path."""
        with self.lock, self._run():
            for m, a in zip(self.masters, masters_np):
                m.copy_(self._h2d(a))
            self._mark()
