"""Continuous-batching scheduler: request queue and the decode loop.

The counterpart of ``opendiloco_tpu/serve/scheduler.py``
``ContinuousBatcher`` without its KV tier and request tracing. One daemon
thread owns the engine and runs the cycle: retire finished sequences
(their slots free at once), admit queued prompts into free slots (a
prefill joins them to the batch; with ``prefix_cache`` a prompt that
shares at least ``MIN_PREFIX_TOKENS`` leading tokens with a live slot
reuses that slot's prefix K/V), take one decode step, or one speculative
round when the engine has ``spec_k > 0``, for every live slot, and every
``swap_every_steps`` decode steps (and when idle) let the engine hot-swap
its weights (``ServeEngine.maybe_swap``). Any thread may
:meth:`ContinuousBatcher.submit`; each request signals completion
through its own event. Nothing is dropped: a request completes, is
rejected at submit, or is failed explicitly when the loop dies or the
batcher stops.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
import traceback
from typing import Optional, Sequence

import numpy as np

from opendiloco_torch.serve.engine import ServeEngine, not_ported
from opendiloco_torch.serve.kvcache import SlotAllocator, common_prefix_len

# a reused prefix must be worth the copy: below this many shared tokens the
# batcher prefills cold (the suffix pass would cover about the whole prompt)
MIN_PREFIX_TOKENS = 4


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


class ContinuousBatcher:
    def __init__(
        self,
        engine: ServeEngine,
        *,
        max_queue: int = 1024,
        swap_every_steps: int = 16,
        prefix_cache: bool = False,
        kv_tier=None,
    ):
        if kv_tier is not None:
            raise not_ported("the KV tier", "KV tier")
        self.engine = engine
        self.max_queue = int(max_queue)
        self.swap_every_steps = max(1, int(swap_every_steps))
        self.prefix_cache = bool(prefix_cache)
        self.spec_decode = engine.spec_k > 0
        self.slots = SlotAllocator(engine.num_slots)
        self._active: dict[int, _Slot] = {}  # slot id -> state
        self._queue: collections.deque[Request] = collections.deque()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_id = 0
        self.decode_steps = 0
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
        self.loop_error: Optional[str] = None
        # speculative-decode and prefix-reuse accounting (loop thread only)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0

    # -- client API --------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 16,
        eos_id: Optional[int] = None,
        priority: int = 0,
        deadline_ms: Optional[float] = None,
    ) -> Request:
        """Queue a prompt; the returned Request's ``wait()`` unblocks when
        generation completes or it was rejected (check ``error``). The
        queue is ordered by (priority, deadline); a request whose deadline
        passes before it reaches a slot is shed."""
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
        if req.t_deadline is not None and float(deadline_ms) <= 0:
            self.shed += 1
            req.finish("deadline exceeded")
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
        return req

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
        for st in self._active.values():
            self.failed += 1
            st.req.finish("server stopped")
        self._active.clear()

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until the queue and the batch are empty."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                if not self._queue and not self._active:
                    return True
            time.sleep(0.01)
        return False

    # -- the decode loop ---------------------------------------------------

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._sweep_cancelled()
                admitted = self._admit()
                stepped = self._decode()
                if stepped and self.decode_steps % self.swap_every_steps == 0:
                    self.engine.maybe_swap()
                if not admitted and not stepped:
                    # idle: still honour the staleness bound, then sleep
                    self.engine.maybe_swap()
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
            with self._cond:
                pending = list(self._queue)
                self._queue.clear()
            for req in pending:
                self.failed += 1
                req.finish(self.loop_error)

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
                        req.finish("cancelled")
                    elif expired(req):
                        self.shed += 1
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
                st.req.finish("cancelled")
            else:
                self.shed += 1
                st.req.finish("deadline exceeded")

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
        """Fill free slots from the queue."""
        admitted = False
        while self.slots.num_free:
            req = self._pop_next()
            if req is None:
                break
            self._admit_into(self.slots.alloc(), req)
            admitted = True
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
        src, plen = self._find_prefix(req.prompt) if self.prefix_cache else (None, 0)
        if src is not None:
            tok, _ = self.engine.admit(slot, req.prompt, prefix_src=src, prefix_len=plen)
            self.prefix_hits += 1
            self.prefix_tokens_saved += plen
        else:
            tok, _ = self.engine.admit(slot, req.prompt)
        req.t_first = time.perf_counter()
        req.tokens.append(tok)
        st = _Slot(req=req, cache_len=len(req.prompt), last_token=tok)
        if self._finished(st):
            self._retire(st)
            self.slots.free(slot)
        else:
            self._active[slot] = st

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

    def _decode(self) -> bool:
        if not self._active:
            return False
        if self.spec_decode:
            return self._decode_spec()
        next_tokens, _ = self.engine.decode_step(*self._step_inputs())
        self.staleness_hist[self.engine.staleness()] += 1
        # counted before any request of this step finishes, so a client
        # that wakes on completion reads consistent stats
        self.decode_steps += 1
        done_slots = []
        for slot, st in self._active.items():
            tok = int(next_tokens[slot])
            st.req.tokens.append(tok)
            st.cache_len += 1
            st.last_token = tok
            self.total_new_tokens += 1
            if self._finished(st):
                done_slots.append(slot)
        for slot in done_slots:
            self.slots.free(slot)
            self._retire(self._active.pop(slot))
        return True

    def _decode_spec(self) -> bool:
        """One speculative round: every live slot takes its accepted
        proposals and the corrected token, 1..k+1 tokens, exactly what as
        many plain decode steps would have given (``ServeEngine.spec_step``).
        A round counts as one decode step."""
        g, m = self.engine.spec_step(*self._step_inputs())
        self.staleness_hist[self.engine.staleness()] += 1
        self.decode_steps += 1  # before any request finishes: see _decode
        self.spec_proposed += self.engine.spec_k * len(self._active)
        self.spec_accepted += sum(int(m[slot]) for slot in self._active)
        done_slots = []
        for slot, st in self._active.items():
            for tok in g[slot, : int(m[slot]) + 1].tolist():
                st.req.tokens.append(int(tok))
                st.cache_len += 1
                st.last_token = int(tok)
                self.total_new_tokens += 1
                if self._finished(st):
                    done_slots.append(slot)
                    break
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
        req.finish(error)
        if error is None:
            self._latencies.append(req.latency_s)
            ewma = self._lat_ewma
            self._lat_ewma = req.latency_s if ewma is None else 0.8 * ewma + 0.2 * req.latency_s
            if req.ttft_s is not None:
                self._ttfts.append(req.ttft_s)

    def estimate_wait_s(self) -> float:
        """Rough time a new request spends queued: the queue length over
        the slots, paced by the completed-latency EWMA (0.25 s before the
        first completion). A hint for Retry-After, not a promise."""
        ewma = self._lat_ewma if self._lat_ewma is not None else 0.25
        with self._cond:
            depth = len(self._queue)
        return (depth / max(1, self.slots.num_slots)) * ewma

    # -- metrics -----------------------------------------------------------

    def health(self) -> dict:
        """Compact load vector: queue depth, occupancy, p99 latency, the
        wait estimate, completed and shed counts."""
        lat = np.asarray(self._latencies, np.float64)
        with self._cond:
            depth = len(self._queue)
        return {
            "queue_depth": depth,
            "occupancy": round(self.slots.num_active / self.slots.num_slots, 4),
            "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3) if lat.size else None,
            "wait_estimate_s": round(self.estimate_wait_s(), 4),
            "completed": self.completed,
            "shed": self.shed,
        }

    def stats(self) -> dict:
        """Point-in-time summary, in the reference batcher's schema: request
        counts, tokens, latency and time-to-first-token percentiles in ms
        (completed requests), weight swaps and staleness, stage seconds,
        spec and prefix counters. The port has no host KV tier yet: its
        keys read 0 host hits and None."""
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
            "prefix": {"hits": self.prefix_hits, "host_hits": 0, "tokens_saved": self.prefix_tokens_saved},
            "tier": None,
            "loop_error": self.loop_error,
        }
