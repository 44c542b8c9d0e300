"""Serving plane: continuous-batching inference on the card.

``build_serving(serve_cfg, model_cfg, params)`` returns a started
:class:`ServingPlane`: a :class:`ServeEngine` (bucketed prefill, paged
decode, speculative decode and prefix reuse through the hand-written
kernels) driven by a :class:`ContinuousBatcher` thread. This slice serves static weights with
no socket front end; hot swap from a DiLoCo optimizer and the HTTP
server arrive with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from opendiloco_torch.config import ServeConfig
from opendiloco_torch.device import DeviceLike
from opendiloco_torch.models.llama import LlamaConfig
from opendiloco_torch.serve.engine import ServeEngine, not_ported
from opendiloco_torch.serve.kvcache import SlotAllocator, pick_bucket
from opendiloco_torch.serve.scheduler import ContinuousBatcher, Request

__all__ = [
    "ContinuousBatcher",
    "Request",
    "ServeEngine",
    "ServingPlane",
    "SlotAllocator",
    "build_serving",
    "pick_bucket",
]


@dataclasses.dataclass
class ServingPlane:
    """The live pieces, with one-call teardown."""

    engine: ServeEngine
    batcher: ContinuousBatcher

    def stop(self) -> None:
        self.batcher.stop()


def build_serving(
    serve_cfg: ServeConfig,
    model_cfg: LlamaConfig,
    params: dict,
    diloco_opt=None,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
    start_server: bool = False,
) -> ServingPlane:
    """Assemble and start engine + batcher from a :class:`ServeConfig`,
    serving ``params`` (a dict of tensors or numpy arrays in the JAX
    layout). ``device`` defaults to the card and raises without one."""
    if diloco_opt is not None:
        raise not_ported("serving from a DiLoCo optimizer", "hot swap and install_wire")
    if start_server:
        raise not_ported("the HTTP front end", "HTTP front end")
    engine = ServeEngine(
        model_cfg,
        params,
        num_slots=serve_cfg.max_batch,
        max_context=serve_cfg.max_context,
        prefill_buckets=serve_cfg.prefill_buckets,
        compute_dtype=compute_dtype,
        weight_format=serve_cfg.weight_format,
        device=device,
        spec_k=serve_cfg.spec_decode_k,
        draft_layers=serve_cfg.draft_layers,
    )
    batcher = ContinuousBatcher(
        engine, max_queue=serve_cfg.max_queue, prefix_cache=serve_cfg.prefix_cache
    ).start()
    return ServingPlane(engine=engine, batcher=batcher)
