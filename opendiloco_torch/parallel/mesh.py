"""Device mesh and sharding strategies over ``torch.distributed``.

The port's copy of ``opendiloco_tpu/parallel/mesh.py``, with the same
strategy names (the reference's FSDP menu, open_diloco/utils.py:138-152):

- NO_SHARD            -> data parallel: params replicated, grads all-reduced.
- FULL_SHARD (ZeRO-3) -> params and optimizer state cut over the "fsdp"
                         axis; each layer's weights are gathered when it runs.
- SHARD_GRAD_OP (ZeRO-2) -> params replicated, optimizer state cut.
- HYBRID_SHARD        -> (dp, fsdp): ZeRO-3 inside fsdp, replicas across dp.
- HYBRID_SHARD_ZERO2  -> (dp, fsdp): ZeRO-2 inside fsdp.

One process drives one device. The axis arithmetic (:func:`mesh_sizes`)
is a pure function of the number of processes and gives the JAX
function's sizes and ``ValueError`` texts for that many devices; then
``init_device_mesh`` builds the ``("pp", "dp", "fsdp", "ep", "sp", "tp")``
mesh whose groups the trainer's collectives run over. Rank ``r`` sits at
mesh coordinate ``r`` in row-major order, as device ``r`` of the JAX mesh
does, so batch rows and leaf blocks fall where the JAX layout puts them.
Without a process group the plan is the single-device plan (no mesh, no
collectives).

The batch is cut over ("dp", "fsdp") and the sequence over "sp", as the
JAX ``MeshPlan.batch_spec`` cuts them; "ep", "tp" and "pp" are not batch
axes: the ranks of an ep group hold the same tokens and different
experts, those of a tp group the same tokens and different heads and FFN
columns (Megatron), those of a pp group the same rows and different
layers (the GPipe stages of :mod:`~opendiloco_torch.parallel.pipeline`).
Rank ``r`` at coordinate ``r`` puts the tp ranks next to each other. The
data group (:meth:`MeshPlan.batch_group`) is the ranks that hold distinct
tokens: those that share this rank's pp, ep and tp coordinates.

The tp, pp and sp axes run through a comm (:meth:`MeshPlan.comm`,
:mod:`~opendiloco_torch.parallel.comm`): the group's :class:`DistComm`,
or, on one card, the rank threads of :func:`loopback_plans`, whose data
group is their sp comm.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional

SHARDING_STRATEGIES = (
    "NO_SHARD",
    "SHARD_GRAD_OP",
    "FULL_SHARD",
    "HYBRID_SHARD",
    "HYBRID_SHARD_ZERO2",
)
AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# strategies where parameters themselves live sharded on the fsdp axis
_PARAM_SHARDED = {"FULL_SHARD", "HYBRID_SHARD"}
# strategies where optimizer state is sharded on the fsdp axis
_OPTSTATE_SHARDED = {"FULL_SHARD", "HYBRID_SHARD", "SHARD_GRAD_OP", "HYBRID_SHARD_ZERO2"}


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A strategy laid over the processes of one worker. ``mesh`` is the
    ``DeviceMesh`` (None: one device, no process group)."""

    strategy: str
    sizes: tuple  # one size per name of AXES
    batch_axes: tuple = ("dp", "fsdp")  # axes the batch dim is sharded over
    fsdp_axis: Optional[str] = None  # axis params/opt-state shard over (or None)
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None
    pp_axis: Optional[str] = None
    ep_axis: Optional[str] = None
    mesh: Any = None
    # the ranks that share this rank's pp, ep and tp coordinates (None:
    # every rank; under rank threads their comm)
    data_group: Any = None
    # under pp x sp, the ranks that share this rank's pp, ep, tp and sp
    # coordinates: the batch blocks of its sequence chunk, over which the
    # routed experts take their statistics there (None: not built)
    block_group: Any = None
    # axis -> comm of rank threads in one process (loopback_plans); None:
    # the comms are the mesh's groups
    comms: Any = None

    @property
    def grouped(self) -> bool:
        """Whether other ranks take part: a process group or rank threads."""
        return self.mesh is not None or bool(self.comms)

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def data_parallel_size(self) -> int:
        return math.prod(self.shape[a] for a in self.batch_axes)

    def group(self, axis: str):
        """The process group of this rank along ``axis`` (None without a mesh)."""
        return None if self.mesh is None else self.mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.comms and axis in self.comms:
            return self.comms[axis].rank
        return 0 if self.mesh is None else self.mesh.get_local_rank(axis)

    def comm(self, axis: str):
        """The comm of this rank along ``axis``: the rank threads' or the
        mesh group's (:mod:`~opendiloco_torch.parallel.comm`); None where
        the axis has one rank."""
        if self.shape[axis] == 1:
            return None
        if self.comms and axis in self.comms:
            return self.comms[axis]
        from opendiloco_torch.parallel.comm import DistComm

        return DistComm(self.group(axis))

    def batch_group(self):
        """The data group: the ranks that hold distinct tokens (the batch cut
        over dp and fsdp, the sequence over sp), every process of the worker
        when ep, tp and pp are 1; None when this rank is alone in it.
        Losses and gradients are summed over it. Under rank threads
        (:func:`loopback_plans`) it is a comm, which the collectives of
        :mod:`~opendiloco_torch.parallel.comm` take as they take a group."""
        import torch.distributed as dist

        if self.data_size == 1:
            return None
        if self.comms:
            return self.data_group
        if self.mesh is None:
            return None
        return dist.group.WORLD if self.data_group is None else self.data_group

    @property
    def data_size(self) -> int:
        """The ranks of the data group."""
        return self.data_parallel_size * self.shape["sp"]

    @property
    def batch_index(self) -> int:
        """This rank's block of the batch: dp coordinate * fsdp + fsdp coordinate."""
        return self.coord("dp") * self.shape["fsdp"] + self.coord("fsdp")


def mesh_sizes(
    strategy: str,
    n: int,
    *,
    dp_size: Optional[int] = None,
    fsdp_size: Optional[int] = None,
    tp_size: int = 1,
    sp_size: int = 1,
    pp_size: int = 1,
    ep_size: int = 1,
    local_count: Optional[int] = None,
) -> dict:
    """The (pp, dp, fsdp, ep, sp, tp) sizes ``build_mesh`` of the JAX
    package gives on ``n`` devices, with its ``ValueError`` texts.
    ``local_count`` is the devices of one host (the hybrid default shards
    within a host); None means ``n``."""
    if strategy not in SHARDING_STRATEGIES:
        raise ValueError(f"unknown sharding strategy {strategy!r}")
    total = n
    if n % (tp_size * sp_size * pp_size * ep_size) != 0:
        raise ValueError(
            f"{n} devices not divisible by tp*sp*pp*ep="
            f"{tp_size * sp_size * pp_size * ep_size}"
        )
    n = n // pp_size
    n_data = n // (tp_size * sp_size * ep_size)

    if strategy in ("HYBRID_SHARD", "HYBRID_SHARD_ZERO2"):
        if dp_size and dp_size > n_data:
            raise ValueError(
                f"dp_size {dp_size} exceeds the {n_data} data devices left "
                f"after pp={pp_size} x ep={ep_size} x sp={sp_size} x "
                f"tp={tp_size} ({n * pp_size} devices total)"
            )
        if fsdp_size is None:
            fsdp_size = dp_size and n_data // dp_size
        if fsdp_size is None:
            # default: shard within a host, replicate across hosts
            fsdp_size = max(1, min(n_data, total if local_count is None else local_count))
        dp_size = n_data // fsdp_size
    elif strategy == "NO_SHARD":
        dp_size, fsdp_size = n_data, 1
    else:  # FULL_SHARD / SHARD_GRAD_OP: one flat axis
        dp_size, fsdp_size = 1, n_data

    if dp_size * fsdp_size * tp_size * sp_size * ep_size != n:
        raise ValueError(
            f"mesh pp={pp_size} dp={dp_size} fsdp={fsdp_size} ep={ep_size} "
            f"sp={sp_size} tp={tp_size} does not cover {n * pp_size} devices"
        )
    return dict(zip(AXES, (pp_size, dp_size, fsdp_size, ep_size, sp_size, tp_size)))


def _plan(strategy: str, sizes: dict, mesh=None, data_group=None, block_group=None) -> MeshPlan:
    return MeshPlan(
        strategy=strategy,
        sizes=tuple(sizes[a] for a in AXES),
        fsdp_axis="fsdp" if strategy in _PARAM_SHARDED | _OPTSTATE_SHARDED else None,
        tp_axis="tp" if sizes["tp"] > 1 else None,
        sp_axis="sp" if sizes["sp"] > 1 else None,
        pp_axis="pp" if sizes["pp"] > 1 else None,
        ep_axis="ep" if sizes["ep"] > 1 else None,
        mesh=mesh,
        data_group=data_group,
        block_group=block_group,
    )


def layout_plan(strategy: str = "NO_SHARD", n: int = 1, **sizes) -> MeshPlan:
    """The plan of ``strategy`` on ``n`` devices without a process group:
    its sizes and specs, no collectives (``sizes``: as :func:`mesh_sizes`)."""
    return _plan(strategy, mesh_sizes(strategy, n, **sizes))


def single_device_plan(strategy: str = "NO_SHARD") -> MeshPlan:
    """One device, no process group: every axis 1, no collectives."""
    return layout_plan(strategy)


def _host_process_count(backend: str) -> Optional[int]:
    """The processes of one host, one device each: torchrun's
    ``LOCAL_WORLD_SIZE`` where it is set, else the host's CUDA devices
    under NCCL (torch FSDP's own hybrid default), else None (unknown)."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local:
        return int(local)
    if backend == "nccl":
        import torch

        return torch.cuda.device_count()
    return None


def build_mesh(
    strategy: str = "NO_SHARD",
    *,
    dp_size: Optional[int] = None,
    fsdp_size: Optional[int] = None,
    tp_size: int = 1,
    sp_size: int = 1,
    pp_size: int = 1,
    ep_size: int = 1,
) -> MeshPlan:
    """The plan of ``strategy`` over the processes of the default
    ``torch.distributed`` group, one device each (the single-device plan
    when no group is initialized). The device type follows the group's
    backend: NCCL on the card, gloo on the CPU. A hybrid strategy with
    neither size shards over the processes of one host
    (:func:`_host_process_count`), and raises where they are not known."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    local_count = None
    if n > 1 and strategy.startswith("HYBRID") and dp_size is None and fsdp_size is None:
        local_count = _host_process_count(dist.get_backend())
        if local_count is None:
            raise ValueError(
                f"{strategy} over {n} processes shards within a host by default, and the processes of one "
                "host are not known here (no LOCAL_WORLD_SIZE, no CUDA): give fsdp_size or dp_size "
                "(--fsdp-size / --dp-size)"
            )
    sizes = mesh_sizes(strategy, n, dp_size=dp_size, fsdp_size=fsdp_size, tp_size=tp_size, sp_size=sp_size,
                       pp_size=pp_size, ep_size=ep_size, local_count=local_count)
    if not grouped:
        return _plan(strategy, sizes)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, tuple(sizes[a] for a in AXES), mesh_dim_names=AXES)
    rank = dist.get_rank()
    block_group = None
    if sizes["pp"] > 1 and sizes["sp"] > 1 and sizes["dp"] * sizes["fsdp"] > 1:
        block_group = _group_by(sizes, rank, ("pp", "ep", "tp", "sp"))
    return _plan(strategy, sizes, mesh, _data_group(sizes, rank), block_group)


def _coords(sizes: dict, rank: int) -> dict:
    """Mesh coordinates of ``rank`` (row-major over AXES)."""
    out = {}
    for axis in reversed(AXES):
        rank, out[axis] = divmod(rank, sizes[axis])
    return out


def _data_group(sizes: dict, rank: int):
    """The group of the ranks that share ``rank``'s pp, ep and tp
    coordinates, in global rank order (None when those axes are 1: every
    rank)."""
    model_axes = ("pp", "ep", "tp")
    if all(sizes[a] == 1 for a in model_axes):
        return None
    return _group_by(sizes, rank, model_axes)


def _group_by(sizes: dict, rank: int, key_axes: tuple):
    """The group of the ranks that share ``rank``'s coordinates along
    ``key_axes``, in global rank order. Every rank makes every such group,
    in one order, as ``new_group`` asks."""
    import itertools

    import torch.distributed as dist

    world = math.prod(sizes.values())
    coords = [_coords(sizes, r) for r in range(world)]
    mine = None
    for key in itertools.product(*(range(sizes[a]) for a in key_axes)):
        ranks = [r for r in range(world) if tuple(coords[r][a] for a in key_axes) == key]
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def loopback_plans(*, tp_size: int = 1, pp_size: int = 1, sp_size: int = 1) -> list:
    """The NO_SHARD plans of ``tp_size * sp_size * pp_size`` ranks in one
    process, one thread each (rank ``r`` at mesh coordinate ``r``, tp
    innermost), their tp, sp and pp comms
    :class:`~opendiloco_torch.parallel.comm.LoopbackGroup` ranks: the path
    over one card, where NCCL takes one rank. The sp comm is also the data
    group (:meth:`MeshPlan.batch_group`): the sp ranks hold distinct
    tokens, and no other axis cuts the batch. Every other axis is 1."""
    from opendiloco_torch.parallel.comm import LoopbackGroup

    axes = ("pp", "sp", "tp")
    sizes = mesh_sizes("NO_SHARD", tp_size * sp_size * pp_size, tp_size=tp_size, sp_size=sp_size,
                       pp_size=pp_size)
    groups: dict = {}  # (axis, the coordinates on the other axes) -> the axis's group
    plans = []
    for r in range(math.prod(sizes.values())):
        c = _coords(sizes, r)
        comms = {}
        for a in axes:
            key = (a, *(c[b] for b in axes if b != a))
            if key not in groups:
                groups[key] = LoopbackGroup(sizes[a])
            comms[a] = groups[key].rank(c[a])
        plans.append(dataclasses.replace(_plan("NO_SHARD", sizes), comms=comms,
                                         data_group=comms["sp"] if sp_size > 1 else None))
    return plans


def params_sharded(strategy: str) -> bool:
    return strategy in _PARAM_SHARDED


def optstate_sharded(strategy: str) -> bool:
    return strategy in _OPTSTATE_SHARDED
