"""Serving plane: continuous-batching inference on the card, off the live
master weights of a training run.

``build_serving(serve_cfg, model_cfg, params, diloco_opt)`` returns a
started :class:`ServingPlane`: a :class:`ServeEngine` (bucketed prefill,
paged decode, speculative decode and prefix reuse through the
hand-written kernels) driven by a :class:`ContinuousBatcher` thread, and
a :class:`ServeServer` taking HTTP and JSONL requests. With a DiLoCo
optimizer the engine hot-swaps its weights from the optimizer's
codec-encoded master snapshots between decode steps, within
``serve_cfg.max_stale_rounds`` outer rounds of the trainer. With
``serve_cfg.kv_tier`` the batcher gets a :class:`HostKVTier` (evicted
slot pages and a prompt-prefix store in host memory). ``train()``
builds it when ``config.serve.enabled``, so training and serving share
one process and one card.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from opendiloco_torch.config import ServeConfig
from opendiloco_torch.device import DeviceLike
from opendiloco_torch.models.llama import LlamaConfig
from opendiloco_torch.serve.engine import ServeEngine
from opendiloco_torch.serve.kvcache import HostKVTier, SlotAllocator, pick_bucket
from opendiloco_torch.serve.scheduler import ContinuousBatcher, Request
from opendiloco_torch.serve.server import ServeServer

__all__ = [
    "ContinuousBatcher",
    "HostKVTier",
    "Request",
    "ServeEngine",
    "ServeServer",
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
    server: Optional[ServeServer] = None

    @property
    def port(self) -> Optional[int]:
        return None if self.server is None else self.server.port

    def stop(self) -> None:
        """Stop accepting, then stop the batcher, which fails every request
        still queued or in flight with "server stopped"."""
        if self.server is not None:
            self.server.stop()
        self.batcher.stop()


def build_serving(
    serve_cfg: ServeConfig,
    model_cfg: LlamaConfig,
    params: dict,
    diloco_opt=None,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    device: DeviceLike = None,
    start_server: bool = True,
) -> ServingPlane:
    """Assemble and start engine, batcher and (``start_server``) the socket
    front end on ``serve_cfg.host``/``port``, serving ``params`` (a dict of
    tensors or numpy arrays in the JAX layout; a trainer's live tensors are
    copied after the work queued on the caller's stream). ``diloco_opt``
    supplies the hot-swap source (``master_snapshot_wire`` and ``epoch``);
    None serves static weights. ``device`` defaults to the card and raises
    without one. ``ODTP_KV_TIER`` (0 or 1), ``ODTP_KV_HOST_SLOTS`` and
    ``ODTP_KV_TIER_CODEC`` override the config's tier fields, as in the JAX
    package."""
    snapshot_fn = epoch_fn = None
    epoch = 0
    if diloco_opt is not None:
        snapshot_fn = diloco_opt.master_snapshot_wire
        epoch_fn = lambda: diloco_opt.epoch  # noqa: E731
        epoch = diloco_opt.epoch
    engine = ServeEngine(
        model_cfg,
        params,
        num_slots=serve_cfg.max_batch,
        max_context=serve_cfg.max_context,
        prefill_buckets=serve_cfg.prefill_buckets,
        compute_dtype=compute_dtype,
        epoch=epoch,
        weight_format=serve_cfg.weight_format,
        device=device,
        spec_k=serve_cfg.spec_decode_k,
        draft_layers=serve_cfg.draft_layers,
        snapshot_fn=snapshot_fn,
        epoch_fn=epoch_fn,
        max_stale_rounds=serve_cfg.max_stale_rounds,
    )
    env_tier = os.environ.get("ODTP_KV_TIER")
    kv_tier = None
    if bool(int(env_tier)) if env_tier else serve_cfg.kv_tier:
        kv_tier = HostKVTier(
            host_slots=int(os.environ.get("ODTP_KV_HOST_SLOTS") or serve_cfg.kv_host_slots),
            codec=os.environ.get("ODTP_KV_TIER_CODEC") or serve_cfg.kv_tier_codec,
        )
    batcher = ContinuousBatcher(
        engine,
        max_queue=serve_cfg.max_queue,
        swap_every_steps=serve_cfg.swap_every_steps,
        prefix_cache=serve_cfg.prefix_cache,
        kv_tier=kv_tier,
    ).start()
    server = None
    if start_server:
        try:
            server = ServeServer(batcher, host=serve_cfg.host, port=serve_cfg.port)
        except BaseException:
            batcher.stop()
            raise
    return ServingPlane(engine=engine, batcher=batcher, server=server)
