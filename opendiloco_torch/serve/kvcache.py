"""Host-side bookkeeping of the slot-paged ring KV cache.

The device tensors live in ``models.llama.init_kv_cache`` ([L, S, T, Nkv,
Dh]: one fixed ring page per batch slot); this module tracks which slots
are free and which prefill bucket a prompt pads to. A copy of the same
pieces of ``opendiloco_tpu/serve/kvcache.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence


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
