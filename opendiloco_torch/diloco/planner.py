"""The streaming fragment partition.

The port's copy of ``opendiloco_tpu/diloco/planner.py``
``fragment_partition``, that function only: every peer derives the same
fragments from the shared leaf sizes, so fragment k's all-reduce lines
up across workers with no coordination.
"""
from __future__ import annotations


def fragment_partition(leaf_sizes: list[int], n_frag: int) -> list[list[int]]:
    """Partition leaf indices into ``n_frag`` contiguous, size-balanced,
    non-empty fragments (the Streaming DiLoCo fragment schedule). Greedy:
    close a fragment once it reaches the ideal share, or when the leaves
    left are exactly the fragments still needing one each."""
    total = sum(leaf_sizes)
    fragments: list[list[int]] = []
    current: list[int] = []
    acc = 0
    target = total / n_frag
    for i, size in enumerate(leaf_sizes):
        current.append(i)
        acc += size
        remaining = len(leaf_sizes) - (i + 1)
        still_needed = n_frag - len(fragments) - 1
        if len(fragments) < n_frag - 1 and (acc >= target or remaining == still_needed):
            fragments.append(current)
            current = []
            acc = 0
    fragments.append(current)
    if len(fragments) != n_frag or any(not f for f in fragments):
        raise ValueError(f"cannot split {len(leaf_sizes)} leaves into {n_frag} non-empty fragments")
    return fragments
