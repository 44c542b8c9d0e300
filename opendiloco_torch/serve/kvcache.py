"""Host-side bookkeeping of the slot-paged ring KV cache, and its host tier.

The device tensors live in ``models.llama.init_kv_cache`` ([L, S, T, Nkv,
Dh]: one fixed ring page per batch slot); this module tracks which slots
are free, which prefill bucket a prompt pads to, how many speculative
proposals a verify pass accepts and how long a prompt prefix two requests
share. A copy of the same pieces of ``opendiloco_tpu/serve/kvcache.py``.

:class:`HostKVTier` is the cold tier behind KV tiering (``ServeConfig.
kv_tier``): host memory for slot pages evicted between decode steps,
stored through one of the port's codecs (``none`` or ``blockwise4bit``),
and a prefix namespace (prompt-prefix K/V keyed by a content hash and the
weights epoch) that outlives slot churn. Its entries are byte for byte
the JAX package's tier's on the same inputs.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np

from opendiloco_torch.diloco.compression import get_codec


class SlotAllocator:
    """Free-list over the cache's S batch slots. A finished sequence frees
    its slot between decode steps and the next queued prompt claims it;
    the page is reused in place (stale rows stay masked until the new
    tenant's writes reach them)."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError(f"need at least one slot, got {num_slots}")
        self.num_slots = num_slots
        # pop() takes from the tail: slot 0 is handed out first
        self._free = list(range(num_slots))[::-1]

    def alloc(self) -> Optional[int]:
        """Claim a slot, or None when the batch is full."""
        return self._free.pop() if self._free else None

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return self.num_slots - len(self._free)


def pick_bucket(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest prefill bucket that fits an n-token prompt, or None when the
    prompt exceeds every bucket (the scheduler rejects it)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return None


def accept_counts(draft: np.ndarray, verified: np.ndarray) -> np.ndarray:
    """Speculative accept/reject bookkeeping (host side, exact).

    draft [S, k] are the proposed tokens; verified [S, k+1] are the
    full-depth greedy tokens, where verified[:, j] is the model's true
    next token after tail position j. Proposal j is accepted iff every
    proposal before it was and ``draft[:, j] == verified[:, j]``: the
    longest agreeing prefix. Returns m [S] int32 in [0, k]: the slot
    emits ``verified[:, :m+1]`` (m accepted drafts plus the corrected or
    bonus token), and the ring keeps exactly tail rows 0..m. Rejected
    tokens are never inserted, which is the rollback."""
    draft = np.asarray(draft)
    verified = np.asarray(verified)
    S, k = draft.shape
    if verified.shape != (S, k + 1):
        raise ValueError(f"verified shape {verified.shape} != {(S, k + 1)}")
    agree = draft == verified[:, :k]
    # index of the first disagreement == count of accepted proposals
    return np.where(
        agree.all(axis=1), np.int32(k), np.argmin(agree, axis=1).astype(np.int32)
    )


def common_prefix_len(a: Sequence[int], b: Sequence[int]) -> int:
    """Length of the shared leading run of two prompts (prefix-cache
    detection)."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


# -- prefix hashing -------------------------------------------------------------

# the lengths at which prompt prefixes are stored and looked up, so that a
# store and a later lookup (or a fleet directory) agree on the key
PREFIX_GRID = (16, 32, 64, 128, 256, 512, 1024, 2048)


def prefix_key(prompt: Sequence[int], glen: int) -> str:
    """Content hash of ``prompt[:glen]``, stable across processes: sha1 over
    the int32 token bytes, 16 hex characters."""
    raw = np.asarray(list(prompt[:glen]), np.int32).tobytes()
    return hashlib.sha1(raw).hexdigest()[:16]


def prefix_grid_lengths(n: int) -> list:
    """Grid lengths usable for an n-token prompt, longest first, at most
    n - 1: the suffix pass keeps at least the last prompt token (its logits
    seed decode), as live-slot prefix reuse does."""
    return [g for g in sorted(PREFIX_GRID, reverse=True) if g <= n - 1]


# -- host-memory cold tier ------------------------------------------------------


@dataclasses.dataclass
class _TierEntry:
    payload_k: bytes
    payload_v: bytes
    meta_k: dict
    meta_v: dict
    shape: tuple  # [L, rows, Kh, Dh] of one page (k and v have the same shape)
    raw_bytes: int  # the f32 bytes of both pages uncompressed
    epoch: int = 0  # weights epoch (prefix entries only; -1 = any)


class HostKVTier:
    """Host-memory cold KV tier: evicted slot pages and a prefix store.

    Two namespaces share one ``host_slots`` page budget:

    - **paused pages** (``put_paused``/``pop_paused``, keyed by request
      id): the ring page of a live sequence that gave up its slot, paged
      back on resume. Pinned: a paused sequence's state is never
      discarded; when pinned pages fill the budget the scheduler stops
      evicting.
    - **prefix entries** (``put_prefix``/``get_prefix``, keyed by
      ``(prefix_key, glen)``): prompt-prefix K/V stored after a cold
      prefill, tagged with the weights epoch that made it. Dropped least
      recently used first under budget pressure, and never served across a
      weight swap (``purge_stale``, and a lookup at another epoch deletes).

    Pages are stored codec-encoded as f32: ``none`` round-trips the
    cache's bf16 or f32 values exactly, ``blockwise4bit`` stores about 8x
    fewer bytes with a bounded restore error. Called from the scheduler
    thread only; the counters are read by other threads without a lock.
    """

    def __init__(self, *, host_slots: int = 32, codec: str = "none"):
        if host_slots < 1:
            raise ValueError(f"need at least one host slot, got {host_slots}")
        self.host_slots = int(host_slots)
        self.codec_name = str(codec)
        self.codec = get_codec(self.codec_name)
        self._paused: dict[int, _TierEntry] = {}
        # insertion order is recency order (move_to_end on a hit)
        self._prefix: collections.OrderedDict[tuple, _TierEntry] = collections.OrderedDict()
        # transfer accounting: f32 bytes moved each way, stores, hits, drops
        self.pages_out = 0
        self.pages_in = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.prefix_stores = 0
        self.prefix_hits = 0
        self.prefix_dropped = 0
        self.prefix_stale_purged = 0

    # -- encode/decode -------------------------------------------------------

    def _encode(self, k: np.ndarray, v: np.ndarray, epoch: int) -> _TierEntry:
        kf = np.ascontiguousarray(k, np.float32)
        vf = np.ascontiguousarray(v, np.float32)
        pk, mk = self.codec.encode(kf.reshape(-1))
        pv, mv = self.codec.encode(vf.reshape(-1))
        return _TierEntry(
            payload_k=bytes(pk),
            payload_v=bytes(pv),
            meta_k=mk,
            meta_v=mv,
            shape=tuple(k.shape),
            raw_bytes=kf.nbytes + vf.nbytes,
            epoch=int(epoch),
        )

    def _decode(self, e: _TierEntry) -> tuple[np.ndarray, np.ndarray]:
        n = int(np.prod(e.shape))
        k = np.asarray(self.codec.decode(e.payload_k, (n,), e.meta_k), np.float32).reshape(e.shape)
        v = np.asarray(self.codec.decode(e.payload_v, (n,), e.meta_v), np.float32).reshape(e.shape)
        return k, v

    # -- paused pages (pinned) -----------------------------------------------

    def can_pin(self) -> bool:
        """Room for one more paused page? Prefix entries do not block a
        pin: ``put_paused`` drops them, least recently used first."""
        return len(self._paused) < self.host_slots

    def put_paused(self, req_id: int, k: np.ndarray, v: np.ndarray) -> None:
        if req_id in self._paused:
            raise ValueError(f"request {req_id} already paused in the tier")
        if not self.can_pin():
            raise RuntimeError(f"host tier full ({self.host_slots} pinned pages)")
        e = self._encode(k, v, epoch=-1)
        # pinned pages preempt droppable prefix entries under budget
        while len(self._paused) + len(self._prefix) >= self.host_slots and self._prefix:
            self._prefix.popitem(last=False)
            self.prefix_dropped += 1
        self._paused[req_id] = e
        self.pages_out += 1
        self.bytes_out += e.raw_bytes

    def pop_paused(self, req_id: int) -> tuple[np.ndarray, np.ndarray]:
        e = self._paused.pop(req_id)
        self.pages_in += 1
        self.bytes_in += e.raw_bytes
        return self._decode(e)

    def drop_paused(self, req_id: int) -> bool:
        """Discard a paused page without restoring it (the request was
        cancelled or expired while cold)."""
        return self._paused.pop(req_id, None) is not None

    # -- prefix namespace ----------------------------------------------------

    def has_prefix(self, key: str, glen: int, epoch: int) -> bool:
        e = self._prefix.get((key, int(glen)))
        return e is not None and e.epoch == int(epoch)

    def put_prefix(self, key: str, glen: int, epoch: int, k: np.ndarray, v: np.ndarray) -> bool:
        """Store a prompt prefix's pages; returns False, storing nothing,
        when the whole budget is pinned."""
        while len(self._paused) + len(self._prefix) >= self.host_slots:
            if not self._prefix:
                return False
            self._prefix.popitem(last=False)
            self.prefix_dropped += 1
        self._prefix[(key, int(glen))] = self._encode(k, v, epoch)
        self._prefix.move_to_end((key, int(glen)))
        self.prefix_stores += 1
        return True

    def get_prefix(self, key: str, glen: int, epoch: int) -> Optional[tuple[np.ndarray, np.ndarray]]:
        kk = (key, int(glen))
        e = self._prefix.get(kk)
        if e is None:
            return None
        if e.epoch != int(epoch):
            # made by older weights: serving it would mix epochs
            del self._prefix[kk]
            self.prefix_stale_purged += 1
            return None
        self._prefix.move_to_end(kk)
        self.prefix_hits += 1
        self.pages_in += 1
        self.bytes_in += e.raw_bytes
        return self._decode(e)

    def purge_stale(self, epoch: int) -> int:
        """Drop every prefix entry not made at ``epoch`` (after a weight
        swap). Paused pages stay: their K/V belongs to the sequence's own
        history, as a live slot's ring page survives a swap."""
        stale = [kk for kk, e in self._prefix.items() if e.epoch != int(epoch)]
        for kk in stale:
            del self._prefix[kk]
        self.prefix_stale_purged += len(stale)
        return len(stale)

    def resident_prefixes(self, epoch: int) -> list:
        """``[[key, glen], ...]`` of the prefix entries made at ``epoch``."""
        return [[key, glen] for (key, glen), e in self._prefix.items() if e.epoch == int(epoch)]

    # -- introspection -------------------------------------------------------

    @property
    def paused_count(self) -> int:
        return len(self._paused)

    @property
    def prefix_count(self) -> int:
        return len(self._prefix)

    def occupancy(self) -> float:
        return (len(self._paused) + len(self._prefix)) / self.host_slots

    def stored_bytes(self) -> int:
        return sum(
            len(e.payload_k) + len(e.payload_v)
            for e in list(self._paused.values()) + list(self._prefix.values())
        )

    def stats(self) -> dict:
        return {
            "codec": self.codec_name,
            "host_slots": self.host_slots,
            "paused": len(self._paused),
            "prefix_entries": len(self._prefix),
            "occupancy": round(self.occupancy(), 4),
            "pages_out": self.pages_out,
            "pages_in": self.pages_in,
            "bytes_out": self.bytes_out,
            "bytes_in": self.bytes_in,
            "stored_bytes": self.stored_bytes(),
            "prefix_stores": self.prefix_stores,
            "prefix_hits": self.prefix_hits,
            "prefix_dropped": self.prefix_dropped,
            "prefix_stale_purged": self.prefix_stale_purged,
        }
