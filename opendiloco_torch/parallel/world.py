"""The world messenger: a sharded worker's processes in the outer loop.

The port's copy of ``opendiloco_tpu/parallel/world.py``. Each DiLoCo
worker may be several processes, one device each, but only one of them,
the *world messenger* (rank 0), joins the outer fabric and holds a
backend (the reference elects ``local_rank == 0``,
open_diloco/train_fsdp.py:183, 205-212). The other ranks meet it at
collectives over the worker's group: :meth:`DistWorld.broadcast_arrays`
and :meth:`DistWorld.broadcast_obj` fan the messenger's averaged
pseudo-gradient and control values out. The boundary params' whole host
copies and each rank's blocks of the new master come from the trainer,
which owns the layout (``InnerTrainer.host_params`` and
``InnerTrainer.host_block``; the JAX world's ``gather_params`` and
``to_global``). :class:`HostWorld` is the single-process case, where each
operation is a passthrough; ``DiLoCoOptimizer`` is written against this
interface. Collectives must be called by every rank in the same order.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


class HostWorld:
    """One process: this process is the worker."""

    is_messenger: bool = True
    process_count: int = 1

    def broadcast_arrays(self, arrs: list) -> list:
        return arrs

    def broadcast_obj(self, obj: Any) -> Any:
        return obj


class DistWorld(HostWorld):
    """The processes of one worker over the default ``torch.distributed``
    group. Arrays travel on ``device``: NCCL takes CUDA tensors only, gloo
    host tensors."""

    def __init__(self, device: torch.device):
        import torch.distributed as dist

        self.device = torch.device(device)
        self.is_messenger = dist.get_rank() == 0
        self.process_count = dist.get_world_size()

    def broadcast_arrays(self, arrs: list) -> list:
        """The messenger's arrays on every rank (the followers' give the
        shapes only)."""
        import torch.distributed as dist

        out = []
        for a in arrs:
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)
            dist.broadcast(t, src=0)
            out.append(t.to("cpu", copy=True).numpy())
        return out

    def broadcast_obj(self, obj: Any) -> Any:
        """Small control values from the messenger (pickled)."""
        import torch.distributed as dist

        box = [obj if self.is_messenger else None]
        dist.broadcast_object_list(box, src=0, device=self.device if self.device.type == "cuda" else None)
        return box[0]


def make_world(device=None) -> HostWorld:
    """The world of the current process topology: :class:`DistWorld` when
    the default group holds more than one process, else :class:`HostWorld`."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return DistWorld(device if device is not None else "cpu")
    return HostWorld()
