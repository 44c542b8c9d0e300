"""Continuous-batching scheduler: request queue and the decode loop.

The counterpart of ``opendiloco_tpu/serve/scheduler.py``
``ContinuousBatcher``, with its request tracing and metrics plane
(:mod:`~opendiloco_torch.obs`: counters, gauges every
``gauge_every_steps`` decode steps, the staleness watchdog, reqtrace
stage spans; all off unless ``ODTP_OBS`` is set). One
daemon thread owns the engine and runs the cycle: retire finished
sequences (their slots free at once), admit queued prompts into free
slots (a prefill joins them to the batch; with ``prefix_cache`` a prompt
that shares at least ``MIN_PREFIX_TOKENS`` leading tokens with a live
slot reuses that slot's prefix K/V), take one decode step, or one
speculative round when the engine has ``spec_k > 0``, for every live
slot, and every ``swap_every_steps`` decode steps (and when idle) let the
engine hot-swap its weights (``ServeEngine.maybe_swap``). Any thread may
:meth:`ContinuousBatcher.submit`; each request signals completion
through its own event. Nothing is dropped: a request completes, is
rejected at submit, or is failed explicitly when the loop dies or the
batcher stops.

With a ``kv_tier`` (:class:`~opendiloco_torch.serve.kvcache.HostKVTier`)
the batcher time-slices more live sequences than the ring holds: a
queued request may displace the longest-resident slot, whose ring rows
go to host memory, and a paused sequence resumes where it stopped when
a slot frees or its turn comes. With ``prefix_cache`` too, a cold
prefill's prompt prefix is stored in the tier, and a later prompt with
that prefix installs it when no live slot holds it.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
import traceback
from typing import Optional, Sequence

import numpy as np

from opendiloco_torch import obs
from opendiloco_torch.obs import reqtrace
from opendiloco_torch.ops.attention import ring_live_rows
from opendiloco_torch.serve.engine import ServeEngine
from opendiloco_torch.serve.kvcache import (
    HostKVTier,
    SlotAllocator,
    common_prefix_len,
    pick_bucket,
    prefix_grid_lengths,
    prefix_key,
)

# a reused prefix must be worth the copy: below this many shared tokens the
# batcher prefills cold (the suffix pass would cover about the whole prompt)
MIN_PREFIX_TOKENS = 4

# slot evictions started per scheduler iteration: bounds the page-out work
# one pass stacks between decode steps, so a long queue drains the batch
# gradually instead of stalling a step
EVICT_PER_PASS = 2


@dataclasses.dataclass
class Request:
    prompt: list
    max_new_tokens: int
    eos_id: Optional[int] = None
    id: int = 0
    # lower tier = more important; t_deadline is absolute time.monotonic():
    # a request past it is shed instead of decoded
    priority: int = 0
    t_deadline: Optional[float] = None
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    tokens: list = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    epoch: Optional[int] = None  # weights epoch that finished the request
    cancelled: bool = False
    trace: Optional[dict] = None  # the reqtrace context (obs armed, request traced)
    _done: threading.Event = dataclasses.field(default_factory=threading.Event)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def cancel(self) -> None:
        """Ask the loop to retire this request; its slot frees on the next
        scheduler iteration."""
        self.cancelled = True

    def finish(self, error: Optional[str] = None) -> None:
        self.error = error
        self.t_done = time.perf_counter()
        self._done.set()

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_submit


@dataclasses.dataclass
class _Slot:
    req: Request
    cache_len: int  # tokens in the ring page (position of the next write)
    last_token: int
    # decode steps since this tenancy began (admit or resume): the
    # eviction order and its guard against thrashing
    resident_steps: int = 0


@dataclasses.dataclass
class _Paused:
    """A live request whose ring rows are in the host tier (keyed by
    ``req.id``): what it needs to resume decoding where it stopped."""

    req: Request
    cache_len: int
    last_token: int


class ContinuousBatcher:
    def __init__(
        self,
        engine: ServeEngine,
        *,
        max_queue: int = 1024,
        swap_every_steps: int = 16,
        gauge_every_steps: int = 32,
        prefix_cache: bool = False,
        kv_tier: Optional[HostKVTier] = None,
        tier_quantum_steps: int = 8,
        tier_min_resident_steps: int = 2,
    ):
        """``kv_tier`` None keeps every sequence resident. With a tier,
        ``tier_quantum_steps`` is how many steps a slot holds the batch
        before a paused sequence may displace it (the rotation period),
        and ``tier_min_resident_steps`` the floor before a queued request
        may displace it (never a slot that has not decoded). With obs
        armed the gauges publish every ``gauge_every_steps`` decode
        steps."""
        self.engine = engine
        self.max_queue = int(max_queue)
        self.swap_every_steps = max(1, int(swap_every_steps))
        self.gauge_every_steps = max(1, int(gauge_every_steps))
        self.prefix_cache = bool(prefix_cache)
        self.kv_tier = kv_tier
        self.tier_quantum_steps = max(1, int(tier_quantum_steps))
        self.tier_min_resident_steps = max(1, int(tier_min_resident_steps))
        self.spec_decode = engine.spec_k > 0
        self._kernel_probed = False
        # kernel launches of the one-time kernel probe (obs armed), by name:
        # measurement, not the decode path's
        self.probe_launches: dict = {}
        self.slots = SlotAllocator(engine.num_slots)
        self._active: dict[int, _Slot] = {}  # slot id -> state
        self._queue: collections.deque[Request] = collections.deque()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_id = 0
        self.decode_steps = 0
        self._t_step_end: Optional[float] = None
        # stats (mutated only by the loop thread)
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.cancelled = 0
        self.shed = 0
        self.total_new_tokens = 0
        # EWMA of completed-request latency: the wait estimate behind the
        # front end's Retry-After hints
        self._lat_ewma: Optional[float] = None
        self._latencies: collections.deque = collections.deque(maxlen=4096)
        self._ttfts: collections.deque = collections.deque(maxlen=4096)
        # decode steps by the staleness of the weights that took them
        self.staleness_hist: collections.Counter = collections.Counter()
        self._rate_mark = (time.perf_counter(), 0)
        self.loop_error: Optional[str] = None
        # speculative-decode and prefix-reuse accounting (loop thread only)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prefix_hits = 0  # live-slot copies and host-tier installs
        self.prefix_tokens_saved = 0
        self.host_prefix_hits = 0
        # KV-tier state (loop thread only): paused requests in pause order,
        # page-outs whose copy is in flight, prefix pages waiting to be
        # encoded into the tier
        self._paused: collections.OrderedDict[int, _Paused] = collections.OrderedDict()
        self._pending_evict: list = []
        self._pending_prefix: list = []
        self.evictions = 0
        self.resumes = 0
        self.paused_peak = 0

    # -- client API --------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 16,
        eos_id: Optional[int] = None,
        priority: int = 0,
        deadline_ms: Optional[float] = None,
        trace: Optional[dict] = None,
    ) -> Request:
        """Queue a prompt; the returned Request's ``wait()`` unblocks when
        generation completes or it was rejected (check ``error``). The
        queue is ordered by (priority, deadline); a request whose deadline
        passes before it reaches a slot is shed. ``trace`` is a
        request-trace context (``schema.TRACE_CTX_KEY``'s shape) adopted
        into this process's reqtrace ring, which then records every stage
        the request passes."""
        req = Request(
            prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens),
            eos_id=eos_id,
            priority=int(priority),
            t_deadline=(
                None if deadline_ms is None else time.monotonic() + float(deadline_ms) / 1e3
            ),
            t_submit=time.perf_counter(),
        )
        rt = reqtrace.ring()
        if rt is not None and trace is not None:
            req.trace = rt.adopt(trace, priority=req.priority, deadline_ms=deadline_ms)
        if req.t_deadline is not None and float(deadline_ms) <= 0:
            self.shed += 1
            obs.count("serve_shed", reason="deadline")
            req.finish("deadline exceeded")
            self._trace_terminal(req, "shed", "shed", reason="deadline")
            return req
        reject = None
        if not req.prompt:
            reject = "empty prompt"
        elif not self.engine.prompt_fits(len(req.prompt)):
            reject = f"prompt length {len(req.prompt)} exceeds max prefill bucket"
        elif req.max_new_tokens < 1:
            reject = "max_new_tokens must be >= 1"
        with self._cond:
            if reject is None and self._stop.is_set():
                reject = "server stopped"
            elif reject is None and len(self._queue) >= self.max_queue:
                reject = "queue full"
            if reject is None:
                req.id = self._next_id
                self._next_id += 1
                self._queue.append(req)
                self._cond.notify()
                return req
        self.rejected += 1
        req.finish(reject)
        if reject == "server stopped":
            self._trace_terminal(req, "shed", "shed", reason="stopped")
        elif reject == "queue full":
            self._trace_terminal(req, "shed", "shed", reason="queue_full")
        else:
            self._trace_terminal(req, "retire", "failed", error=req.error)
        return req

    @staticmethod
    def _trace_terminal(req: Request, stage: str, status: str, **attrs) -> None:
        """Close ``req``'s trace with a zero-width terminal stage event."""
        if req.trace is None:
            return
        rt = reqtrace.ring()
        if rt is None:
            return
        rt.event(req.trace, stage, **attrs)
        rt.finish(req.trace, status, tokens=len(req.tokens), **attrs)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ContinuousBatcher":
        self._thread = threading.Thread(target=self._run, name="odt-serve-batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        # fail whatever is still in flight so no client blocks forever
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            self.failed += 1
            req.finish("server stopped")
            self._trace_terminal(req, "retire", "failed", error=req.error)
        for st in self._active.values():
            self.failed += 1
            st.req.finish("server stopped")
            self._trace_terminal(st.req, "retire", "failed", error=st.req.error)
        self._active.clear()
        self._fail_cold("server stopped")

    def _fail_cold(self, error: str) -> None:
        """Fail every request in the tier (paused or mid-page-out), so that
        no client waits for ever when the batcher stops or its loop dies."""
        for st, _pk, _pv, _t0 in self._pending_evict:
            self.failed += 1
            st.req.finish(error)
            self._trace_terminal(st.req, "retire", "failed", error=error)
        self._pending_evict.clear()
        for p in self._paused.values():
            if self.kv_tier is not None:
                self.kv_tier.drop_paused(p.req.id)
            self.failed += 1
            p.req.finish(error)
            self._trace_terminal(p.req, "retire", "failed", error=error)
        self._paused.clear()

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until the queue, the batch and the tier's paused requests
        are empty."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                if not self._queue and not self._active and not self._paused and not self._pending_evict:
                    return True
            time.sleep(0.01)
        return False

    # -- the decode loop ---------------------------------------------------

    def _run(self) -> None:
        try:
            t_carry = None
            while not self._stop.is_set():
                # consecutive decode spans tile: each starts where the
                # previous iteration's accounting ended, so what a live
                # request sat through (sweeps, a co-tenant's prefill,
                # retires, gauges) is in its decode residency, and a
                # trace's stages add up to its latency
                it0 = t_carry if t_carry is not None else time.perf_counter()
                self._sweep_cancelled()
                # page-outs started last iteration land here: their copies
                # overlapped the decode step in between
                self._finish_pageouts()
                admitted = self._admit()
                stepped = self._decode(it0)
                if stepped and self.decode_steps % self.swap_every_steps == 0:
                    self._maybe_swap()
                if stepped and self.decode_steps % self.gauge_every_steps == 0 and obs.tracer() is not None:
                    self._publish_gauges()
                t_carry = self._t_step_end if stepped else None
                if not admitted and not stepped:
                    # idle: still honour the staleness bound, then sleep
                    self._maybe_swap()
                    with self._cond:
                        if not self._queue and not self._stop.is_set():
                            self._cond.wait(timeout=0.05)
        except Exception as e:  # noqa: BLE001 -- fail loudly, never hang clients
            traceback.print_exc()
            self.loop_error = f"{type(e).__name__}: {e}"
            for slot, st in list(self._active.items()):
                self._retire(st, error=self.loop_error)
                self.slots.free(slot)
            self._active.clear()
            self._fail_cold(self.loop_error)
            with self._cond:
                pending = list(self._queue)
                self._queue.clear()
            for req in pending:
                self.failed += 1
                req.finish(self.loop_error)
                self._trace_terminal(req, "retire", "failed", error=req.error)

    def _maybe_swap(self) -> None:
        """Hot-swap check; after a swap the tier's prefix entries of older
        weights never serve again (paused pages stay). A swap is a pause
        that every live request sat through: a ``swap`` span on each
        traced one."""
        t0 = time.perf_counter()
        swapped = self.engine.maybe_swap()
        t1 = time.perf_counter()
        if not swapped:
            return
        if self.kv_tier is not None:
            self.kv_tier.purge_stale(self.engine.weights_epoch)
        rt = reqtrace.ring()
        if rt is None:
            return
        for st in self._active.values():
            if st.req.trace is not None:
                rt.span(st.req.trace, "swap", t0, t1, epoch=self.engine.weights_epoch)

    def _sweep_cancelled(self) -> None:
        """Retire cancelled and deadline-expired requests: queued ones
        finish at once, active ones free their slot before the next step."""
        now = time.monotonic()

        def expired(req: Request) -> bool:
            return req.t_deadline is not None and now > req.t_deadline

        with self._cond:
            if any(r.cancelled or expired(r) for r in self._queue):
                keep: collections.deque = collections.deque()
                for req in self._queue:
                    if req.cancelled:
                        self.cancelled += 1
                        obs.count("serve_cancelled")
                        self._trace_terminal(req, "retire", "cancelled")
                        req.finish("cancelled")
                    elif expired(req):
                        self.shed += 1
                        obs.count("serve_shed", reason="deadline")
                        self._trace_terminal(req, "shed", "shed", reason="deadline")
                        req.finish("deadline exceeded")
                    else:
                        keep.append(req)
                self._queue = keep
        for slot in [s for s, st in self._active.items() if st.req.cancelled or expired(st.req)]:
            st = self._active.pop(slot)
            self.slots.free(slot)
            st.req.epoch = self.engine.weights_epoch
            if st.req.cancelled:
                self.cancelled += 1
                obs.count("serve_cancelled")
                self._trace_terminal(st.req, "retire", "cancelled")
                st.req.finish("cancelled")
            else:
                self.shed += 1
                obs.count("serve_shed", reason="deadline")
                self._trace_terminal(st.req, "shed", "shed", reason="deadline")
                st.req.finish("deadline exceeded")
        # paused requests: the same sweep, and the tier drops the page, so
        # a gone client's cold state holds no host budget
        for rid in [r for r, p in self._paused.items() if p.req.cancelled or expired(p.req)]:
            p = self._paused.pop(rid)
            if self.kv_tier is not None:
                self.kv_tier.drop_paused(rid)
            if p.req.cancelled:
                self.cancelled += 1
                obs.count("serve_cancelled")
                self._trace_terminal(p.req, "retire", "cancelled")
                p.req.finish("cancelled")
            else:
                self.shed += 1
                obs.count("serve_shed", reason="deadline")
                self._trace_terminal(p.req, "shed", "shed", reason="deadline")
                p.req.finish("deadline exceeded")

    def _pop_next(self) -> Optional[Request]:
        """Most urgent queued request: lowest priority tier, then earliest
        deadline (deadline-free last within a tier), then submit order."""
        with self._cond:
            if not self._queue:
                return None
            best = min(
                self._queue,
                key=lambda r: (
                    r.priority,
                    r.t_deadline if r.t_deadline is not None else float("inf"),
                    r.id,
                ),
            )
            self._queue.remove(best)
            return best

    def _admit(self) -> bool:
        """Fill free slots, and with a tier make slots when there is
        demand: resume the oldest paused request first (it has had its
        first token; first in, first out bounds its latency), then admit
        queued prompts; with the batch full, a queued request may displace
        the longest-resident slot (``tier_min_resident_steps`` floor) and a
        paused one a slot that has held its quantum. That is round-robin
        time-slicing over more sequences than the ring holds."""
        admitted = False
        evictions = 0
        while True:
            if self.slots.num_free:
                if self._paused:
                    self._resume_one(self.slots.alloc())
                    admitted = True
                    continue
                req = self._pop_next()
                if req is None:
                    break
                self._admit_into(self.slots.alloc(), req)
                admitted = True
                continue
            if self.kv_tier is None or evictions >= EVICT_PER_PASS:
                break
            req = self._pop_next()
            if req is not None:
                # a request that has not started is worth an early
                # eviction: the displaced sequence keeps its state in the
                # tier and rotates back in
                if self._evict_one(self.tier_min_resident_steps):
                    evictions += 1
                    self._admit_into(self.slots.alloc(), req)
                    admitted = True
                    continue
                with self._cond:
                    self._queue.append(req)  # nothing evictable yet
                break
            if self._paused:
                # rotation: the oldest paused request displaces the slot
                # that has held the batch longest, once per quantum
                if self._evict_one(self.tier_quantum_steps):
                    evictions += 1
                    self._resume_one(self.slots.alloc())
                    admitted = True
                    continue
            break
        return admitted

    def _find_prefix(self, prompt: list) -> tuple[Optional[int], int]:
        """Longest usable shared prompt prefix among the live slots. A
        source qualifies while its ring has not wrapped (rows < plen still
        hold the prefix K/V); ``tail_width`` of headroom keeps the next
        speculative tail from wrapping before the copy lands. The reused
        length stops one short of the prompt, so that the suffix pass has
        at least the last token to run (its logits seed decode)."""
        best_src, best = None, 0
        for slot, st in self._active.items():
            if st.cache_len + self.engine.tail_width > self.engine.max_context:
                continue
            p = min(common_prefix_len(prompt, st.req.prompt), len(prompt) - 1)
            if p > best:
                best_src, best = slot, p
        if best >= MIN_PREFIX_TOKENS:
            return best_src, best
        return None, 0

    def _admit_into(self, slot: int, req: Request) -> None:
        rt = reqtrace.ring()
        t_slot = time.perf_counter()
        src, plen, host = None, 0, None
        if self.prefix_cache:
            src, plen = self._find_prefix(req.prompt)
            if src is None and self.kv_tier is not None:
                host, plen = self._host_prefix_lookup(req.prompt)
        if src is not None:
            tok, _ = self.engine.admit(slot, req.prompt, prefix_src=src, prefix_len=plen)
            self.prefix_hits += 1
            self.prefix_tokens_saved += plen
            obs.count("serve_prefix_hits")
            obs.count("serve_prefix_tokens_saved", plen)
        elif host is not None:
            tok, _ = self.engine.admit(slot, req.prompt, host_prefix=host)
            self.prefix_hits += 1
            self.host_prefix_hits += 1
            self.prefix_tokens_saved += plen
            obs.count("serve_prefix_hits")
            obs.count("serve_host_prefix_hits")
            obs.count("serve_prefix_tokens_saved", plen)
        else:
            tok, _ = self.engine.admit(slot, req.prompt)
            self._maybe_store_prefix(slot, req.prompt)
        req.t_first = time.perf_counter()
        if rt is not None and req.trace is not None:
            rt.span(req.trace, "queue", req.t_submit, t_slot, slot=slot)
            rt.span(req.trace, "prefill", t_slot, req.t_first, tokens=len(req.prompt),
                    bucket=pick_bucket(len(req.prompt), self.engine.prefill_buckets), prefix_reused=plen)
        req.tokens.append(tok)
        st = _Slot(req=req, cache_len=len(req.prompt), last_token=tok)
        if self._finished(st):
            self._retire(st)
            self.slots.free(slot)
        else:
            self._active[slot] = st

    # -- KV tiering (evict, resume, host prefix store) ------------------------

    def _evict_one(self, min_resident: int) -> bool:
        """Page the coldest slot out to the host tier and free it. Coldest
        is the most decode steps since its tenancy began (every live slot
        decodes every step, so residency age is the order of last page-in);
        ``min_resident`` guards against thrashing. The copy is only started
        here: :meth:`_finish_pageouts` stores it next iteration, after it
        overlapped a decode step."""
        # page-outs in flight land in the tier next iteration: count them
        # against the pin budget now, or a two-evict pass could overflow it
        if self.kv_tier.paused_count + len(self._pending_evict) >= self.kv_tier.host_slots:
            return False
        best_slot = None
        for slot, st in self._active.items():
            if st.resident_steps < min_resident:
                continue
            if best_slot is None or st.resident_steps > self._active[best_slot].resident_steps:
                best_slot = slot
        if best_slot is None:
            return False
        st = self._active.pop(best_slot)
        t0 = time.perf_counter()
        rows = ring_live_rows(st.cache_len, self.engine.max_context)
        pk, pv = self.engine.fetch_slot_pages(best_slot, rows)
        self._pending_evict.append((st, pk, pv, t0))
        self.slots.free(best_slot)
        self.evictions += 1
        obs.count("serve_tier_evictions")
        return True

    def _finish_pageouts(self) -> None:
        if not self._pending_evict:
            self._finish_prefix_stores()
            return
        pending, self._pending_evict = self._pending_evict, []
        rt = reqtrace.ring()
        for st, pk, pv, t0 in pending:
            k, v = np.asarray(pk), np.asarray(pv)
            self.kv_tier.put_paused(st.req.id, k, v)
            self._paused[st.req.id] = _Paused(req=st.req, cache_len=st.cache_len, last_token=st.last_token)
            t1 = time.perf_counter()
            self.engine.stage_seconds["page_out"] += t1 - t0
            obs.count("serve_page_out_bytes", k.nbytes + v.nbytes)
            if rt is not None and st.req.trace is not None:
                rt.span(st.req.trace, "page_out", t0, t1, tokens=st.cache_len, bytes=k.nbytes + v.nbytes)
        self.paused_peak = max(self.paused_peak, len(self._paused))
        self._finish_prefix_stores()

    def _resume_one(self, slot: int) -> None:
        """Page the oldest paused request back in: it rejoins the batch
        where it stopped (its tokens, cache_len and last token are its
        own; the ring rows come back from the tier)."""
        rid, p = self._paused.popitem(last=False)
        t0 = time.perf_counter()
        k, v = self.kv_tier.pop_paused(rid)
        self.engine.install_slot_pages(slot, k, v)
        t1 = time.perf_counter()
        self._active[slot] = _Slot(req=p.req, cache_len=p.cache_len, last_token=p.last_token)
        self.resumes += 1
        obs.count("serve_tier_resumes")
        obs.count("serve_page_in_bytes", k.nbytes + v.nbytes)
        rt = reqtrace.ring()
        if rt is not None and p.req.trace is not None:
            rt.span(p.req.trace, "page_in", t0, t1, tokens=p.cache_len, bytes=k.nbytes + v.nbytes)

    def _host_prefix_lookup(self, prompt: list):
        """Longest grid-length prompt prefix the tier holds at the current
        weights epoch: ``((k, v, glen), glen)``, or ``(None, 0)``."""
        epoch = self.engine.weights_epoch
        for glen in prefix_grid_lengths(len(prompt)):
            got = self.kv_tier.get_prefix(prefix_key(prompt, glen), glen, epoch)
            if got is not None:
                return (got[0], got[1], glen), glen
        return None, 0

    def _maybe_store_prefix(self, slot: int, prompt: list) -> None:
        """After a cold prefill, copy the prompt's longest grid-length
        prefix towards the tier (stored next iteration): prefix reuse that
        outlives the slot."""
        if self.kv_tier is None or not self.prefix_cache:
            return
        grid = prefix_grid_lengths(len(prompt))
        if not grid:
            return
        glen = grid[0]
        key = prefix_key(prompt, glen)
        epoch = self.engine.weights_epoch
        if self.kv_tier.has_prefix(key, glen, epoch):
            return
        t0 = time.perf_counter()
        pk, pv = self.engine.fetch_slot_pages(slot, glen)
        self._pending_prefix.append((key, glen, epoch, pk, pv, t0))

    def _finish_prefix_stores(self) -> None:
        if not self._pending_prefix:
            return
        pending, self._pending_prefix = self._pending_prefix, []
        for key, glen, epoch, pk, pv, t0 in pending:
            if epoch != self.engine.weights_epoch:
                continue  # the weights swapped since the copy: stale, dropped
            k, v = np.asarray(pk), np.asarray(pv)
            self.kv_tier.put_prefix(key, glen, epoch, k, v)
            self.engine.stage_seconds["page_out"] += time.perf_counter() - t0
            obs.count("serve_page_out_bytes", k.nbytes + v.nbytes)

    def resident_prefixes(self) -> list:
        """``[[key, glen], ...]`` of the tier's prefix entries at the current
        weights epoch (what a fleet directory advertises); [] without a
        tier."""
        if self.kv_tier is None:
            return []
        return self.kv_tier.resident_prefixes(self.engine.weights_epoch)

    def _step_inputs(self) -> tuple[np.ndarray, np.ndarray]:
        """Dense [S] current tokens and cache lengths; free slots pass 0s
        (their ring writes land in masked rows that the next tenant
        overwrites)."""
        S = self.engine.num_slots
        tokens = np.zeros((S,), np.int32)
        lens = np.zeros((S,), np.int32)
        for slot, st in self._active.items():
            tokens[slot] = st.last_token
            lens[slot] = st.cache_len
        return tokens, lens

    def _decode(self, t0: Optional[float] = None) -> bool:
        """One decode step. A traced request's ``decode`` span covers the
        whole step from ``t0`` (batch assembly, the engine call, the emit),
        so the scheduler's time per step is its requests'."""
        if not self._active:
            return False
        if self.spec_decode:
            return self._decode_spec(t0)
        if t0 is None:
            t0 = time.perf_counter()
        next_tokens, _ = self.engine.decode_step(*self._step_inputs())
        self.staleness_hist[self.engine.staleness()] += 1
        obs.count("serve_tokens_generated", len(self._active))
        batch = len(self._active)
        # counted before any request of this step finishes, so a client
        # that wakes on completion reads consistent stats
        self.decode_steps += 1
        done_slots = []
        for slot, st in self._active.items():
            tok = int(next_tokens[slot])
            st.req.tokens.append(tok)
            st.cache_len += 1
            st.last_token = tok
            st.resident_steps += 1
            self.total_new_tokens += 1
            if self._finished(st):
                done_slots.append(slot)
        # the next iteration's window starts here, so the spans, retires
        # and swap and gauge checks below go to the step that pays for them
        t1 = self._t_step_end = time.perf_counter()
        rt = reqtrace.ring()
        if rt is not None:
            for st in self._active.values():
                if st.req.trace is not None:
                    # a slot admitted this iteration starts where its prefill ended
                    rt.span(st.req.trace, "decode", max(t0, st.req.t_first), t1, batch=batch, tokens=1,
                            kernel=self.engine.decode_kernel)
        for slot in done_slots:
            self.slots.free(slot)
            self._retire(self._active.pop(slot))
        return True

    def _decode_spec(self, t0: Optional[float] = None) -> bool:
        """One speculative round: every live slot takes its accepted
        proposals and the corrected token, 1..k+1 tokens, exactly what as
        many plain decode steps would have given (``ServeEngine.spec_step``).
        A round counts as one decode step."""
        if t0 is None:
            t0 = time.perf_counter()
        g, m = self.engine.spec_step(*self._step_inputs())
        self.staleness_hist[self.engine.staleness()] += 1
        self.decode_steps += 1  # before any request finishes: see _decode
        proposed = self.engine.spec_k * len(self._active)
        accepted = sum(int(m[slot]) for slot in self._active)
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        obs.count("serve_spec_proposed", proposed)
        obs.count("serve_spec_accepted", accepted)
        batch = len(self._active)
        done_slots = []
        emitted = 0
        rt = reqtrace.ring()
        emitted_by_slot = {} if rt is not None else None  # for the traced spans only
        for slot, st in self._active.items():
            st.resident_steps += 1
            slot_emitted = 0
            for tok in g[slot, : int(m[slot]) + 1].tolist():
                st.req.tokens.append(int(tok))
                st.cache_len += 1
                st.last_token = int(tok)
                self.total_new_tokens += 1
                slot_emitted += 1
                if self._finished(st):
                    done_slots.append(slot)
                    break
            emitted += slot_emitted
            if emitted_by_slot is not None:
                emitted_by_slot[slot] = slot_emitted
        t1 = self._t_step_end = time.perf_counter()
        if rt is not None:
            for slot, st in self._active.items():
                if st.req.trace is not None:
                    rt.span(st.req.trace, "decode", max(t0, st.req.t_first), t1, batch=batch,
                            tokens=emitted_by_slot[slot], proposed=self.engine.spec_k, accepted=int(m[slot]),
                            kernel=self.engine.decode_kernel)
        obs.count("serve_tokens_generated", emitted)
        for slot in done_slots:
            self.slots.free(slot)
            self._retire(self._active.pop(slot))
        return True

    def _finished(self, st: _Slot) -> bool:
        req = st.req
        if len(req.tokens) >= req.max_new_tokens:
            return True
        return req.eos_id is not None and st.last_token == req.eos_id

    def _retire(self, st: _Slot, error: Optional[str] = None) -> None:
        req = st.req
        if req.eos_id is not None and req.tokens and req.tokens[-1] == req.eos_id:
            req.tokens.pop()  # eos terminates, is not part of the text
        req.epoch = self.engine.weights_epoch
        if error is None:
            self.completed += 1  # before finish: see decode_steps
        else:
            self.failed += 1
        # the trace closes before the client wakes
        self._trace_terminal(req, "retire", "done" if error is None else "failed", epoch=req.epoch,
                             **({} if error is None else {"error": error}))
        req.finish(error)
        if error is None:
            self._latencies.append(req.latency_s)
            ewma = self._lat_ewma
            self._lat_ewma = req.latency_s if ewma is None else 0.8 * ewma + 0.2 * req.latency_s
            if req.ttft_s is not None:
                self._ttfts.append(req.ttft_s)
            obs.count("serve_requests_completed")

    def estimate_wait_s(self) -> float:
        """Rough time a new request spends queued: the queue length over
        the slots, paced by the completed-latency EWMA (0.25 s before the
        first completion). A hint for Retry-After, not a promise."""
        ewma = self._lat_ewma if self._lat_ewma is not None else 0.25
        with self._cond:
            depth = len(self._queue)
        return (depth / max(1, self.slots.num_slots)) * ewma

    # -- metrics -----------------------------------------------------------

    def _publish_gauges(self) -> None:
        """The serving gauges (the loop calls this with obs armed): latency
        percentiles, token rate, occupancy, staleness and its watchdog,
        spec acceptance, the tier's, queue depth; once a process, the
        kernel probe's (its launches go to ``probe_launches``)."""
        if not self._kernel_probed:
            # attribution only: never takes down the serving loop
            self._kernel_probed = True
            from opendiloco_torch.ops.launch import LAUNCHES

            me = threading.get_ident()
            before = LAUNCHES.by_thread().get(me, {})
            try:
                self.engine.kernel_probe()
            except Exception:
                obs.count("serve_kernel_probe_errors")
            after = LAUNCHES.by_thread().get(me, {})
            self.probe_launches = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        lat = np.asarray(self._latencies, np.float64)
        if lat.size:
            obs.gauge("serve_p50_ms", float(np.percentile(lat, 50)) * 1e3)
            obs.gauge("serve_p99_ms", float(np.percentile(lat, 99)) * 1e3)
        now = time.perf_counter()
        t0, n0 = self._rate_mark
        if now > t0:
            obs.gauge("serve_tokens_per_s", (self.total_new_tokens - n0) / (now - t0))
        self._rate_mark = (now, self.total_new_tokens)
        obs.gauge("serve_batch_occupancy", self.slots.num_active / self.slots.num_slots)
        staleness = self.engine.staleness()
        obs.gauge("serve_snapshot_staleness", staleness)
        wd = obs.anomaly.watchdog()
        if wd is not None:
            # a breach here means maybe_swap could not restore the bound (no
            # fresher snapshot): the watchdog records it, serving goes on
            wd.serve_staleness(staleness, self.engine.max_stale_rounds, exemplars=self._slo_exemplars())
        if self.spec_proposed:
            obs.gauge("serve_spec_acceptance", self.spec_accepted / self.spec_proposed)
        if self.kv_tier is not None:
            obs.gauge("serve_tier_occupancy", self.kv_tier.occupancy())
            obs.gauge("serve_tier_paused", len(self._paused))
            obs.gauge("serve_tier_prefix_entries", self.kv_tier.prefix_count)
            obs.gauge("serve_tier_stored_bytes", self.kv_tier.stored_bytes())
        with self._cond:
            obs.gauge("serve_queue_depth", len(self._queue))

    @staticmethod
    def _slo_exemplars(n: int = 3) -> list:
        """Trace ids of the slowest recent requests in this process's
        reqtrace ring: the evidence a staleness or SLO breach carries."""
        rt = reqtrace.ring()
        if rt is None:
            return []
        return [ex["id"] for ex in rt.exemplars(n)]

    def health(self) -> dict:
        """Compact load vector: queue depth, occupancy, p99 latency, the
        wait estimate, completed and shed counts, and with a tier its
        occupancy and paused count."""
        lat = np.asarray(self._latencies, np.float64)
        with self._cond:
            depth = len(self._queue)
        out = {
            "queue_depth": depth,
            "occupancy": round(self.slots.num_active / self.slots.num_slots, 4),
            "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3) if lat.size else None,
            "wait_estimate_s": round(self.estimate_wait_s(), 4),
            "completed": self.completed,
            "shed": self.shed,
        }
        if self.kv_tier is not None:
            out["tier_occupancy"] = round(self.kv_tier.occupancy(), 4)
            out["tier_paused"] = len(self._paused)
        exemplars = self._slo_exemplars()
        if exemplars:
            out["slo_exemplars"] = exemplars
        return out

    def stats(self) -> dict:
        """Point-in-time summary, in the reference batcher's schema: request
        counts, tokens, latency and time-to-first-token percentiles in ms
        (completed requests), weight swaps and staleness, stage seconds,
        spec and prefix counters, and the tier's (None without one)."""
        lat = np.asarray(self._latencies, np.float64) * 1e3
        ttft = np.asarray(self._ttfts, np.float64) * 1e3

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else None

        return {
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "shed": self.shed,
            "queued": len(self._queue),
            "active": self.slots.num_active,
            "decode_steps": self.decode_steps,
            "new_tokens": self.total_new_tokens,
            "latency_ms": {
                "p50": pct(lat, 50),
                "p90": pct(lat, 90),
                "p99": pct(lat, 99),
                "mean": float(lat.mean()) if lat.size else None,
            },
            "ttft_ms": {"p50": pct(ttft, 50), "p99": pct(ttft, 99)},
            "weight_swaps": self.engine.swap_count,
            "weights_epoch": self.engine.weights_epoch,
            "staleness": self.engine.staleness(),
            # int keys in numeric order
            "staleness_hist": {int(k): v for k, v in sorted(self.staleness_hist.items())},
            "stages_s": {k: round(v, 6) for k, v in self.engine.stage_seconds.items()},
            "spec": {
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "acceptance_rate": (
                    self.spec_accepted / self.spec_proposed if self.spec_proposed else None
                ),
            },
            "prefix": {
                "hits": self.prefix_hits,
                "host_hits": self.host_prefix_hits,
                "tokens_saved": self.prefix_tokens_saved,
            },
            "tier": (
                {
                    **self.kv_tier.stats(),
                    "evictions": self.evictions,
                    "resumes": self.resumes,
                    "paused": len(self._paused),
                    "paused_peak": self.paused_peak,
                }
                if self.kv_tier is not None
                else None
            ),
            "loop_error": self.loop_error,
        }
