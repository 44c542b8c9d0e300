"""Serving engine: bucketed prefill, batched incremental decode,
self-speculative decode and shared-prefix reuse over a slot-paged ring KV
cache, on the card.

The PyTorch counterpart of ``opendiloco_tpu/serve/engine.py``
``ServeEngine``: ``admit`` prefills a prompt into a free slot (cold, or
continuing from a live slot's prefix), ``decode_step`` takes one greedy
token for every slot, and ``spec_step`` (``spec_k > 0``) drafts k tokens
per slot from the first ``draft_layers`` layers of the same weights and
verifies them in one full-depth pass, keeping the longest agreeing
prefix plus the corrected token (Leviathan et al., arXiv 2211.17192,
greedy case): token for token what the one-token loop emits. All are
called from one scheduler thread; the engine is not thread-safe, which
lets it update the cache in place (where the JAX engine donates the
cache buffers to its jits).

``weight_format="w4"`` keeps the stacked decoder matmul weights packed
blockwise-4-bit at rest (:mod:`opendiloco_torch.quant`); every matmul on
them goes through the fused dequant-matmul kernel. Decode attention goes
through the paged-decode-attention kernel, and the attention of the
draft, verify and continued-prefill passes through the spec-tail-attention
kernel. On the CPU each takes its plain version. ``decode_kernel`` (the
JAX package's ``ServeConfig.decode_kernel``, resolved by
:func:`resolve_decode_kernel`) chooses: "pallas" runs the kernels, "xla"
their plain versions on any device.

Weight hot swap: with a ``snapshot_fn`` (``DiLoCoOptimizer.
master_snapshot_wire``), :meth:`maybe_swap` pulls a codec-encoded master
snapshot when the served weights lag the trainer by more than
``max_stale_rounds`` outer rounds, and :meth:`install_wire` rebinds the
weights between decode steps. The KV cache is not touched: cached K/V
stays what the weights that made it gave, and the staleness bound limits
how far the weights may lag (DiLoCo-fresh serving, arXiv 2311.08105).
Under ``w4`` a ``blockwise4bit`` snapshot is re-sliced straight into the
packed layout where the codec's block grid lands on layer boundaries.

On the card the engine runs on a CUDA stream of its own, so that its
syncs wait for its own work and never for a training step queued on the
same card by another thread.

KV tiering: :meth:`fetch_slot_pages` starts a by-value copy of a slot's
leading ring rows to host memory (f32, asynchronous on the card) and
:meth:`install_slot_pages` writes host rows back into a slot; the
batcher's host tier (``serve.kvcache.HostKVTier``) stores them between
the two. ``admit(host_prefix=(k, v, plen))`` installs a stored prompt
prefix and runs only the suffix, as a live-slot prefix hit does.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import math
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from opendiloco_torch import obs
from opendiloco_torch.config import DECODE_KERNELS, WEIGHT_FORMATS
from opendiloco_torch.device import DeviceLike, resolve_device
from opendiloco_torch.diloco.compression import get_codec, split_blockwise4_stacked
from opendiloco_torch.models.llama import (
    LlamaConfig,
    PackedW4,
    cache_insert,
    decode_forward,
    draft_propose,
    flatten_params,
    init_kv_cache,
    prefill_forward,
    prefix_copy,
    spec_cache_insert,
    suffix_insert,
    unflatten_params,
    verify_forward,
)
from opendiloco_torch.ops.attention import decode_attention, spec_tail_attention
from opendiloco_torch.ops.decode_kernels import (
    paged_decode_attention,
    spec_tail_attention_fused,
    w4_matmul,
)
from opendiloco_torch.quant import dequant_w4, pack_blockwise4_stacked
from opendiloco_torch.serve.kvcache import accept_counts, pick_bucket


# snapshot_fn contract: () -> (epoch, blobs, codec_name) with blobs[i] =
# (payload, meta, shape) per master leaf in flatten_params order, as
# DiLoCoOptimizer.master_snapshot_wire returns
SnapshotFn = Callable[[], tuple]

_STAGES = ("prefill", "draft", "verify", "insert", "decode", "swap", "page_out", "page_in")


def resolve_decode_kernel(spec: Optional[str], device: torch.device) -> str:
    """The decode path, "pallas" (the hand-written kernels) or "xla" (their
    plain versions), from ``spec`` (``ServeConfig.decode_kernel``; None or
    empty: the ``ODTP_DECODE_KERNEL`` variable, else "auto"), as the JAX
    package's ``resolve_decode_kernel`` does. "auto" takes the kernels on
    the card and the plain versions elsewhere. A forced "pallas" off the
    card raises: a CUDA kernel has no interpreter, and running its plain
    version under the kernel's name would hide that."""
    spec = spec or os.environ.get("ODTP_DECODE_KERNEL") or "auto"
    if spec not in DECODE_KERNELS:
        raise ValueError(f"serve.decode_kernel must be one of {DECODE_KERNELS}, got {spec!r}")
    if spec == "auto":
        return "pallas" if device.type == "cuda" else "xla"
    if spec == "pallas" and device.type != "cuda":
        raise ValueError(f"serve.decode_kernel='pallas' needs the card; the engine is on {device} "
                         "(use 'auto' or 'xla')")
    return spec


class HostPage:
    """One page of a slot's ring rows on its way to the host, f32
    [L, rows, Nkv, Dh]. On the card the copy runs asynchronously on the
    engine's stream, from a fresh device tensor (the gather is by value,
    so the slot may take a new tenant at once) into pinned host memory;
    ``np.asarray(page)`` waits for it. The device tensor is held until
    then, so that the caching allocator cannot hand its memory to another
    stream while the copy reads it."""

    def __init__(self, host: torch.Tensor, src: Optional[torch.Tensor] = None, event=None):
        self._host, self._src, self._event = host, src, event

    @property
    def shape(self) -> tuple:
        return tuple(self._host.shape)

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = self._src = None
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        if dtype is not None:
            out = out.astype(dtype, copy=False)
        return out.copy() if copy else out


def _on_engine_stream(fn):
    """Run an engine entry point with the engine's CUDA stream current."""

    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        with self._streamed():
            return fn(self, *args, **kwargs)

    return run


class ServeEngine:
    def __init__(
        self,
        cfg: LlamaConfig,
        params: dict,
        *,
        num_slots: int = 8,
        max_context: int = 512,
        prefill_buckets: Sequence[int] = (32, 128, 512),
        compute_dtype: Optional[torch.dtype] = None,
        epoch: int = 0,
        weight_format: str = "fp32",
        device: DeviceLike = None,
        spec_k: int = 0,
        draft_layers: int = 0,
        snapshot_fn: Optional[SnapshotFn] = None,
        epoch_fn: Optional[Callable[[], int]] = None,
        max_stale_rounds: int = 0,
        decode_kernel: Optional[str] = None,
    ):
        """``device`` defaults to the card (and raises without one);
        ``compute_dtype`` defaults to bf16 on the card, f32 on the CPU.
        ``spec_k > 0`` turns on speculative decode with a draft of
        ``draft_layers`` layers (0: half the stack, at least 1).
        ``snapshot_fn`` and ``epoch_fn`` feed hot swap (see
        :meth:`maybe_swap`). ``decode_kernel`` "auto" (None), "pallas" or
        "xla": see :func:`resolve_decode_kernel`."""
        if weight_format not in WEIGHT_FORMATS:
            raise ValueError(f"unknown weight_format {weight_format!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        # the decode path, by the JAX package's names; also the obs label
        # (serve_decode_kernel_pallas / _xla)
        self.decode_kernel = resolve_decode_kernel(decode_kernel, self.device)
        self._kernels = self.decode_kernel == "pallas"
        # the engine's own stream on the card (None on the CPU)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.snapshot_fn = snapshot_fn
        self.epoch_fn = epoch_fn
        self.max_stale_rounds = int(max_stale_rounds)
        if compute_dtype is None:  # bf16 on the card; f32 on the CPU, where bf16 matmuls are slow
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.compute_dtype = compute_dtype
        self.num_slots = int(num_slots)
        self.max_context = int(max_context)
        self.prefill_buckets = sorted(min(int(b), self.max_context) for b in prefill_buckets)
        self.weight_format = weight_format
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.draft_layers = 0
        if self.spec_k:
            L = cfg.num_hidden_layers
            ld = int(draft_layers) or max(1, L // 2)
            if not 1 <= ld < L:
                raise ValueError(f"draft_layers {ld} outside [1, {L}) for spec decode")
            if self.spec_k + 1 > self.max_context:
                raise ValueError(
                    f"spec_k {self.spec_k} + 1 exceeds max_context {self.max_context}"
                )
            self.draft_layers = ld
        # widest unverified tail a slot may carry: the current token and k
        # drafts. The scheduler keeps that much ring headroom for prefix reuse
        self.tail_width = self.spec_k + 1
        # host hook (tests swap in adversarial proposers): (tokens [S],
        # lens [S]) -> proposals [S, spec_k] on the host
        self.propose_fn: Callable[[np.ndarray, np.ndarray], np.ndarray] = self._propose_draft
        # leaf layout in flatten_params order: what a snapshot must match
        self._shapes = [tuple(np.shape(x)) for x in flatten_params(params)]
        self._template = unflatten_params(params, list(range(len(self._shapes))))
        with self._copying_in():
            self.params = self._assemble(params)
            cache = init_kv_cache(
                cfg, self.num_slots, self.max_context, self.compute_dtype, self.device
            )
        # the leaves held packed (w4): where a snapshot may take the fast path
        self._packable = [isinstance(w, PackedW4) for w in flatten_params(self.params)]
        self.cache_k, self.cache_v = cache["k"], cache["v"]
        self.weights_epoch = int(epoch)
        self.swap_count = 0
        # each swap's wall seconds by part (maybe_swap): encode, decode,
        # h2d, pack and total, with the epoch installed
        self.swap_log: collections.deque = collections.deque(maxlen=256)
        # wall seconds per stage, each ending in a sync of the engine's
        # stream, but for page_out and page_in: the host's time to queue
        # the copies (and the batcher's wait for a page-out to land)
        self.stage_seconds = {k: 0.0 for k in _STAGES}

    def _streamed(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    @contextlib.contextmanager
    def _copying_in(self):
        """Copy weights in on the engine's stream: after the work queued
        on the caller's stream (they may be a trainer's live tensors), and
        synced at the end, so that the caller may write them again, or
        read ``self.params``, once the call returns."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            yield
        self._sync()

    @property
    def swap_seconds(self) -> float:
        """Wall seconds of every hot swap so far, encode included."""
        return self.stage_seconds["swap"]

    # -- weight residency ---------------------------------------------------

    def _assemble(self, params: dict, times: Optional[dict] = None) -> dict:
        """The engine's own copy of ``params`` on its device. Dense leaves
        are held in the compute dtype: the JAX engine keeps f32 masters
        and casts them at every forward, which gives the same weights,
        while the card holds one copy. Under ``w4`` the stacked decoder
        matmuls ([L, in, out] leaves under "layers") are packed instead;
        norms, embeddings and the lm head stay dense. A leaf that is
        already a :class:`PackedW4` is kept. With ``times``, the wall
        seconds of the copies to the device and of the packing are added
        to its ``h2d_s`` and ``pack_s``, each ending in a sync."""

        def timed(key, fn):
            if times is None:
                return fn()
            t0 = time.perf_counter()
            out = fn()
            self._sync()
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0
            return out

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            if isinstance(tree, PackedW4):
                return tree
            x = torch.as_tensor(tree).detach()
            if self.weight_format == "w4" and path[0] == "layers" and x.dim() == 3:
                xd = timed("h2d_s", lambda: x.to(self.device, torch.float32))
                q, s = timed("pack_s", lambda: pack_blockwise4_stacked(xd))
                return PackedW4(q, s, tuple(x.shape[1:]))
            return timed("h2d_s", lambda: x.to(device=self.device, dtype=self.compute_dtype, copy=True))

        return walk(params, ())

    def install_params(self, epoch: int, params: dict) -> None:
        """Direct rebind of uncompressed weights (static-weight serving)."""
        with self._copying_in():
            self.params = self._assemble(params)
        self.weights_epoch = int(epoch)
        self.swap_count += 1

    # -- weight hot swap ---------------------------------------------------

    def staleness(self) -> int:
        """Outer rounds the served weights lag the trainer's masters."""
        if self.epoch_fn is None:
            return 0
        return max(0, int(self.epoch_fn()) - self.weights_epoch)

    @_on_engine_stream
    def maybe_swap(self) -> bool:
        """Adopt the trainer's current master snapshot when the staleness
        exceeds ``max_stale_rounds``. Called between decode steps, so no
        request is mid-forward across the rebind; the KV cache is not
        touched. The snapshot is encoded on this thread: the encode is
        part of the pause that serving sees. Each swap's seconds by part
        go to ``swap_log``."""
        if self.snapshot_fn is None or self.staleness() <= self.max_stale_rounds:
            return False
        t0 = time.perf_counter()
        epoch, blobs, codec_name = self.snapshot_fn()
        t1 = time.perf_counter()
        if epoch <= self.weights_epoch:
            return False  # raced an in-flight round: keep the current weights
        times = self.install_wire(epoch, blobs, codec_name)
        dt = time.perf_counter() - t0
        self.stage_seconds["swap"] += dt
        self.swap_log.append({"epoch": int(epoch), "codec": codec_name, "encode_s": t1 - t0, **times,
                              "total_s": dt})
        obs.count("serve_weight_swaps")
        obs.gauge("serve_last_swap_ms", dt * 1e3)
        return True

    def install_wire(self, epoch: int, blobs, codec_name: str) -> dict:
        """Decode a codec-encoded master snapshot (``blobs[i] = (payload,
        meta, shape)`` in :func:`flatten_params` order) and rebind the
        weights. With ``weight_format="w4"`` and a ``blockwise4bit``
        snapshot, each packable leaf whose codec block grid lands on layer
        boundaries is re-sliced from the payload into the packed layout
        (the fp16 scale bits viewed as int16), with no decode and repack;
        every other leaf is decoded to f32 on the host and assembled.
        Returns the wall seconds of the host decode (``decode_s``), the
        copies to the device (``h2d_s``) and the packing (``pack_s``)."""
        codec = get_codec(codec_name)
        if len(blobs) != len(self._shapes):
            raise ValueError(f"snapshot has {len(blobs)} leaves, engine expects {len(self._shapes)}")
        fast = self.weight_format == "w4" and codec_name == "blockwise4bit"
        times = {"decode_s": 0.0, "h2d_s": 0.0, "pack_s": 0.0}
        leaves = []
        with self._copying_in():
            for (payload, meta, shape), want, packable in zip(blobs, self._shapes, self._packable):
                if tuple(shape) != want:
                    raise ValueError(f"snapshot leaf shape {tuple(shape)} != {want}")
                size = math.prod(shape)
                if fast and packable:
                    res = split_blockwise4_stacked(payload, meta, int(shape[0]), size // int(shape[0]))
                    if res is not None:
                        q, s = res
                        t0 = time.perf_counter()
                        packed = PackedW4(torch.from_numpy(q).to(self.device),
                                          torch.from_numpy(s.view(np.int16)).to(self.device), tuple(shape[1:]))
                        self._sync()
                        times["h2d_s"] += time.perf_counter() - t0
                        leaves.append(packed)
                        continue
                t0 = time.perf_counter()
                leaves.append(np.asarray(codec.decode(payload, (size,), meta), np.float32).reshape(shape))
                times["decode_s"] += time.perf_counter() - t0
            self.params = self._assemble(unflatten_params(self._template, leaves), times)
            self.weights_epoch = int(epoch)
            self.swap_count += 1
        return times

    @_on_engine_stream
    def kernel_probe(self, iters: int = 3) -> dict:
        """Time the decode-path kernels alone on the engine's live shapes:
        B6 (one query per slot) and B7 (a ``tail_width`` tail per slot)
        over layer 0's ring pages with half the ring live, and under
        ``w4`` B8 on the first packed weight at M = num_slots. Returns the
        best of ``iters`` host-clock microseconds per call, each ending in
        a device sync, as ``decode_attn_us``, ``verify_attn_us`` and
        ``w4_matmul_us``, on the engine's decode path: under "xla" the
        plain versions (the dequant then the matmul for B8). Each is
        published as the gauge ``serve_<name>``, with
        ``serve_decode_kernel_pallas`` 1 where the kernels ran."""
        cfg, cd, dev = self.cfg, self.compute_dtype, self.device
        S, T = self.num_slots, self.max_context
        Nh, Nkv, Dh = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        g = torch.Generator(device=dev).manual_seed(0)
        ck, cv = self.cache_k[0], self.cache_v[0]
        lens = torch.full((S,), T // 2, dtype=torch.int32, device=dev)
        kq = self.tail_width
        q1 = torch.randn(S, Nh, Dh, generator=g, device=dev).to(cd)
        qt = torch.randn(S, kq, Nh, Dh, generator=g, device=dev).to(cd)
        tk = torch.randn(S, kq, Nkv, Dh, generator=g, device=dev).to(cd)

        def best_us(fn, *args) -> float:
            fn(*args)  # builds and loads the kernel outside the timing
            best = float("inf")
            for _ in range(max(1, int(iters))):
                self._sync()
                t0 = time.perf_counter()
                fn(*args)
                self._sync()
                best = min(best, time.perf_counter() - t0)
            return best * 1e6

        k = self._kernels
        out = {
            "decode_attn_us": best_us(paged_decode_attention if k else decode_attention, q1, ck, cv, lens),
            "verify_attn_us": best_us(spec_tail_attention_fused if k else spec_tail_attention, qt, ck, cv, tk, tk,
                                      lens),
        }
        packed = next((w for w in self.params["layers"].values() if isinstance(w, PackedW4)), None)
        if packed is not None:
            x = torch.randn(S, packed.shape[0], generator=g, device=dev).to(cd)
            wmm = w4_matmul if k else lambda x, q, s, shape, dtype: x @ dequant_w4(q, s, shape, dtype)
            out["w4_matmul_us"] = best_us(wmm, x, packed.q[0], packed.s[0], packed.shape, cd)
        for name, us in out.items():
            obs.gauge(f"serve_{name}", us)
        obs.gauge("serve_decode_kernel_pallas", 1.0 if self.decode_kernel == "pallas" else 0.0)
        return out

    def _sync(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()

    # -- admission ---------------------------------------------------------

    def prompt_fits(self, n: int) -> bool:
        return pick_bucket(n, self.prefill_buckets) is not None

    @_on_engine_stream
    def admit(
        self,
        slot: int,
        prompt: Sequence[int],
        *,
        prefix_src: Optional[int] = None,
        prefix_len: int = 0,
        host_prefix: Optional[tuple] = None,
    ) -> tuple[int, np.ndarray]:
        """Prefill ``prompt`` into ``slot`` and return (first greedy token,
        last-position logits [V] f32 on the host). The prompt must fit a
        prefill bucket.

        With ``prefix_src``/``prefix_len`` (0 < prefix_len < len(prompt))
        the first ``prefix_len`` tokens are not recomputed: their K/V rows
        are copied from the live source slot (what a cold prefill writes
        there: causal attention makes prefix K/V independent of anything
        after it) and only the suffix runs through the model.
        ``host_prefix=(k, v, plen)`` takes the prefix rows from the host
        prefix store instead ([L, rows >= plen, Nkv, Dh] f32 host arrays,
        written at rows [0, rows) of ``slot``)."""
        n = len(prompt)
        bucket = pick_bucket(n, self.prefill_buckets)
        if bucket is None:
            raise ValueError(
                f"prompt length {n} exceeds max bucket {self.prefill_buckets[-1]}"
            )
        t0 = time.perf_counter()
        if host_prefix is not None and 0 < host_prefix[2] < n:
            hk, hv, plen = host_prefix
            self._install_rows(slot, hk, hv)
            tok, row = self._run_suffix(slot, prompt, int(plen))
        elif prefix_src is not None and 0 < prefix_len < n:
            prefix_copy(self.cache_k, self.cache_v, prefix_src, slot, prefix_len)
            tok, row = self._run_suffix(slot, prompt, prefix_len)
        else:
            ids = torch.zeros((1, bucket), dtype=torch.int64)
            ids[0, :n] = torch.as_tensor(np.asarray(prompt, np.int64))
            logits, ks, vs = prefill_forward(
                self.params, ids.to(self.device), n, self.cfg,
                compute_dtype=self.compute_dtype, kernels=self._kernels,
            )
            cache_insert(self.cache_k, self.cache_v, ks, vs, slot)
            row = logits[0].cpu().numpy()  # waits for the device
            tok = int(row.argmax())
        dt = time.perf_counter() - t0
        self.stage_seconds["prefill"] += dt
        tr = obs.tracer()
        if tr is not None:
            tr.add_span("serve_prefill", t0, t0 + dt, tokens=n)
        return tok, row

    def _run_suffix(self, slot: int, prompt: Sequence[int], plen: int) -> tuple[int, np.ndarray]:
        """Continued prefill of ``slot``, whose ring already holds the
        first ``plen`` rows: the verify pass over the slot's own page with
        S = 1 and the suffix, padded to its bucket, as the tail."""
        suffix = np.asarray(prompt[plen:], np.int64)
        ns = int(suffix.size)
        tail = torch.zeros((1, pick_bucket(ns, self.prefill_buckets)), dtype=torch.int64)
        tail[0, :ns] = torch.as_tensor(suffix)
        lens = torch.tensor([plen], dtype=torch.int32, device=self.device)
        page = slice(slot, slot + 1)
        logits, tks, tvs = verify_forward(
            self.params, tail.to(self.device), lens, self.cache_k[:, page], self.cache_v[:, page],
            self.cfg, compute_dtype=self.compute_dtype, kernels=self._kernels,
        )
        suffix_insert(self.cache_k, self.cache_v, tks[:, 0], tvs[:, 0], slot, plen, ns)
        row = logits[0, ns - 1].cpu().numpy()  # waits for the device
        return int(row.argmax()), row

    # -- KV-tier page transfers ---------------------------------------------

    def page_rows(self, rows: int) -> int:
        """Transfer row count for ``rows`` live ring rows: padded up the
        prefill-bucket grid, as the JAX engine pads it, so that the pages
        of the two packages have the same shapes. Padding rows carry an
        earlier tenant's masked rows, which a restore writes back as they
        were (``ops.attention.ring_live_rows``)."""
        if not 0 < rows <= self.max_context:
            raise ValueError(f"rows {rows} outside (0, {self.max_context}]")
        return pick_bucket(rows, self.prefill_buckets) or self.max_context

    @_on_engine_stream
    def fetch_slot_pages(self, slot: int, rows: int) -> tuple[HostPage, HostPage]:
        """Start copying ``slot``'s leading ``rows`` ring rows (padded by
        :meth:`page_rows`) to the host as f32. Returns two :class:`HostPage`
        (k, v) whose ``np.asarray`` waits for the copy: the batcher reads
        them on a later iteration, so that the copy overlaps a decode step.
        On the card the rows are gathered into a fresh tensor on the
        engine's stream and copied into pinned memory without blocking;
        bf16 to f32 is exact. Work queued after the call (a new tenant's
        prefill) cannot change what is copied."""
        t0 = time.perf_counter()
        r = self.page_rows(rows)
        pages = []
        for cache in (self.cache_k, self.cache_v):
            src = torch.empty((cache.shape[0], r) + tuple(cache.shape[3:]), dtype=torch.float32,
                              device=self.device)
            src.copy_(cache[:, slot, :r])
            if self.stream is None:
                pages.append(HostPage(src))
                continue
            host = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
            pages.append(HostPage(host, src, event))
        self.stage_seconds["page_out"] += time.perf_counter() - t0
        return pages[0], pages[1]

    @_on_engine_stream
    def install_slot_pages(self, slot: int, k: np.ndarray, v: np.ndarray) -> None:
        """Write host rows back into ``slot`` (a tier restore): rows [0, R)
        of the ring page from ``k``/``v`` [L, R, Nkv, Dh], cast to the cache
        dtype. On the card the copy is queued on the engine's stream and
        the call returns at once; the next decode step runs after it."""
        t0 = time.perf_counter()
        self._install_rows(slot, k, v)
        self.stage_seconds["page_in"] += time.perf_counter() - t0

    def _install_rows(self, slot: int, k: np.ndarray, v: np.ndarray) -> None:
        for cache, rows in ((self.cache_k, k), (self.cache_v, v)):
            rows = np.asarray(rows, np.float32)
            if self.stream is None:
                src = torch.from_numpy(rows.copy())  # the tier's arrays may be read-only
            else:
                # staged through pinned memory; the caching host allocator
                # keeps the buffer until the copy that reads it completes
                staged = torch.empty(rows.shape, dtype=torch.float32, pin_memory=True)
                staged.numpy()[...] = rows
                src = staged.to(self.device, non_blocking=True)
            cache[:, slot, : src.shape[1]].copy_(src)

    # -- decode ------------------------------------------------------------

    @_on_engine_stream
    def decode_step(
        self, tokens: np.ndarray, lens: np.ndarray
    ) -> tuple[np.ndarray, torch.Tensor]:
        """One greedy token per slot. ``tokens``/``lens`` are dense [S] host
        arrays (inactive slots pass 0s; their ring writes land in masked
        rows that the slot's next tenant overwrites). Returns (next tokens
        [S] int32 on the host, logits [S, V] on the device)."""
        t0 = time.perf_counter()
        tok = torch.as_tensor(np.asarray(tokens, np.int64)).to(self.device)
        ln = torch.as_tensor(np.asarray(lens, np.int32)).to(self.device)
        logits, _, _ = decode_forward(
            self.params, tok, ln, self.cache_k, self.cache_v, self.cfg,
            compute_dtype=self.compute_dtype, kernels=self._kernels,
        )
        nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()  # waits
        self.stage_seconds["decode"] += time.perf_counter() - t0
        obs.count(f"serve_decode_kernel_{self.decode_kernel}")
        return nxt, logits

    def _propose_draft(self, tokens: np.ndarray, lens: np.ndarray) -> np.ndarray:
        props = draft_propose(
            self.params,
            torch.as_tensor(np.asarray(tokens, np.int64)).to(self.device),
            torch.as_tensor(np.asarray(lens, np.int32)).to(self.device),
            self.cache_k, self.cache_v, self.cfg,
            k_steps=self.spec_k, draft_layers=self.draft_layers,
            compute_dtype=self.compute_dtype, kernels=self._kernels,
        )
        return props.cpu().numpy()  # waits for the device

    @_on_engine_stream
    def spec_step(self, tokens: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One self-speculative round over all S slots: draft k proposals,
        verify the [current, d_1..d_k] tail at full depth, keep the
        longest agreeing prefix. Returns (g [S, k+1] int32, m [S] int32):
        slot s emits ``g[s, :m[s]+1]``, its next m[s]+1 greedy tokens,
        token-identical to m[s]+1 plain decode steps, and its ring now
        holds tail rows 0..m[s] (rejected proposals were never inserted:
        that is the rollback)."""
        if not self.spec_k:
            raise RuntimeError("spec_step requires spec_k > 0")
        t0 = time.perf_counter()
        props = np.asarray(self.propose_fn(tokens, lens), np.int32)  # [S, k]
        t1 = time.perf_counter()
        tail = np.concatenate([np.asarray(tokens, np.int64)[:, None], props], axis=1)
        ln = torch.as_tensor(np.asarray(lens, np.int32)).to(self.device)
        logits, tks, tvs = verify_forward(
            self.params, torch.as_tensor(tail).to(self.device), ln, self.cache_k, self.cache_v,
            self.cfg, compute_dtype=self.compute_dtype, kernels=self._kernels,
        )
        g = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()  # [S, k+1]; waits
        t2 = time.perf_counter()
        m = accept_counts(props, g)
        spec_cache_insert(self.cache_k, self.cache_v, tks, tvs, ln, torch.as_tensor(m))
        self._sync()
        t3 = time.perf_counter()
        self.stage_seconds["draft"] += t1 - t0
        self.stage_seconds["verify"] += t2 - t1
        self.stage_seconds["insert"] += t3 - t2
        obs.count(f"serve_decode_kernel_{self.decode_kernel}")
        tr = obs.tracer()
        if tr is not None:
            tr.add_span("serve_draft", t0, t1, k=self.spec_k)
            tr.add_span("serve_verify", t1, t2)
            tr.add_span("serve_spec_insert", t2, t3)
        return g, m
