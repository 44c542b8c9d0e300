"""Debugging utilities: parameter-layout fingerprints.

The port's copy of ``schema_fingerprint`` from
``opendiloco_tpu/utils/debug.py``: the DiLoCo optimizer asserts with it
that the parameter layout did not change mid-epoch.
"""
from __future__ import annotations

import hashlib
from typing import Any


def _leaves_with_paths(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def schema_fingerprint(tree: Any) -> str:
    """Hash of paths, shapes and dtypes only (no values): a cheap
    invariant for asserting the parameter layout is stable across an
    epoch. Keys are walked in sorted order, as ``jax.tree.flatten`` does."""
    h = hashlib.sha256()
    for path, leaf in _leaves_with_paths(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        h.update(f"{path}:{shape}/{getattr(leaf, 'dtype', '?')}".encode())
    return h.hexdigest()[:16]
