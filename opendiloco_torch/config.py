"""Serving-plane configuration: the ``ServeConfig`` fields this port reads.

A copy of the geometry part of ``opendiloco_tpu.config.ServeConfig``
(same names, defaults and validation), as a dataclass so the port needs
no pydantic. Fields for hot swap, speculative decode, prefix reuse, the
KV tier and the HTTP front end arrive with the slices that use them.
"""
from __future__ import annotations

import dataclasses
from typing import Union

WEIGHT_FORMATS = ("fp32", "w4")


@dataclasses.dataclass
class ServeConfig:
    # continuous-batching geometry
    max_batch: int = 8  # decode slots (concurrent sequences)
    max_context: int = 1024  # per-slot ring KV page; longer sequences slide
    # prefill buckets (prompts pad up to the smallest fit; prompts beyond
    # the largest bucket are rejected, not truncated)
    prefill_buckets: Union[list, str] = dataclasses.field(
        default_factory=lambda: [64, 256, 1024]
    )
    max_queue: int = 1024  # backpressure: submits beyond this are rejected
    # replica weight residency: "fp32", or "w4" (stacked matmul weights
    # blockwise-4-bit packed at rest; norms/embeddings/lm head stay fp32)
    weight_format: str = "fp32"

    def __post_init__(self):
        if isinstance(self.prefill_buckets, str):
            self.prefill_buckets = [
                int(x) for x in self.prefill_buckets.split(",") if x.strip()
            ]
        self.prefill_buckets = [int(b) for b in self.prefill_buckets]
        if self.weight_format not in WEIGHT_FORMATS:
            raise ValueError(
                f"serve.weight_format must be one of {WEIGHT_FORMATS}, "
                f"got {self.weight_format!r}"
            )
        if self.max_batch < 1:
            raise ValueError("serve.max_batch must be >= 1")
        if not self.prefill_buckets:
            raise ValueError("serve.prefill_buckets must be non-empty")
        if min(self.prefill_buckets) < 1:
            raise ValueError("serve.prefill_buckets must be positive")
        if max(self.prefill_buckets) > self.max_context:
            raise ValueError(
                "largest prefill bucket exceeds serve.max_context "
                "(a prompt must fit its slot's KV page)"
            )
