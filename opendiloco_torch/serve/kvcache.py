"""Host-side bookkeeping of the slot-paged ring KV cache.

The device tensors live in ``models.llama.init_kv_cache`` ([L, S, T, Nkv,
Dh]: one fixed ring page per batch slot); this module tracks which slots
are free, which prefill bucket a prompt pads to, how many speculative
proposals a verify pass accepts and how long a prompt prefix two requests
share. A copy of the same pieces of ``opendiloco_tpu/serve/kvcache.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


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
