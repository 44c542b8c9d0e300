"""Continuous-batching scheduler: request queue and the decode loop.

The counterpart of ``opendiloco_tpu/serve/scheduler.py``
``ContinuousBatcher`` without its tier, prefix-reuse and speculative
branches. One daemon thread owns the engine and runs the cycle: retire
finished sequences (their slots free at once), admit queued prompts into
free slots (a cold prefill joins them to the batch), and take one decode
step for every live slot. Any thread may :meth:`ContinuousBatcher.submit`;
each request signals completion through its own event. Nothing is dropped:
a request completes, is rejected at submit, or is failed explicitly when
the loop dies or the batcher stops.
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
from opendiloco_torch.serve.kvcache import SlotAllocator


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
        prefix_cache: bool = False,
        kv_tier=None,
    ):
        if prefix_cache:
            raise not_ported("prefix reuse", "speculative decode and prefix reuse")
        if kv_tier is not None:
            raise not_ported("the KV tier", "KV tier")
        self.engine = engine
        self.max_queue = int(max_queue)
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
        self._latencies: collections.deque = collections.deque(maxlen=4096)
        self._ttfts: collections.deque = collections.deque(maxlen=4096)
        self.loop_error: Optional[str] = None

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
                if not admitted and not stepped:
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

    def _admit_into(self, slot: int, req: Request) -> None:
        tok, _ = self.engine.admit(slot, req.prompt)
        req.t_first = time.perf_counter()
        req.tokens.append(tok)
        st = _Slot(req=req, cache_len=len(req.prompt), last_token=tok)
        if self._finished(st):
            self._retire(st)
            self.slots.free(slot)
        else:
            self._active[slot] = st

    def _decode(self) -> bool:
        if not self._active:
            return False
        S = self.engine.num_slots
        tokens = np.zeros((S,), np.int32)
        lens = np.zeros((S,), np.int32)
        for slot, st in self._active.items():
            tokens[slot] = st.last_token
            lens[slot] = st.cache_len
        next_tokens, _ = self.engine.decode_step(tokens, lens)
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
            if req.ttft_s is not None:
                self._ttfts.append(req.ttft_s)

    # -- metrics -----------------------------------------------------------

    def stats(self) -> dict:
        """Point-in-time summary: request counts, tokens, and the latency
        and time-to-first-token lists in seconds (completed requests)."""
        return {
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "shed": self.shed,
            "queued": len(self._queue),
            "active": self.slots.num_active,
            "decode_steps": self.decode_steps,
            "total_new_tokens": self.total_new_tokens,
            "latency_s": list(self._latencies),
            "ttft_s": list(self._ttfts),
            "stages_s": dict(self.engine.stage_seconds),
            "loop_error": self.loop_error,
        }
