"""Which dim of each Llama leaf a strategy cuts over the pp, ep, tp and
fsdp axes.

The port's copy of ``opendiloco_tpu/parallel/sharding.py``: a spec is the
tuple form of the JAX ``PartitionSpec`` (``("pp", "ep", "fsdp", "tp")``;
``()`` for a replicated leaf), by the JAX rules:

- pp: the leading stacked-layer dim of every layer leaf, the norm
  vectors' too, when pp divides the layers (the stages' contiguous
  layers); otherwise the layer dim is never cut;
- an expert-stacked FFN leaf ([L, E, ...]) cuts its expert dim over ep
  (under every strategy), and its tp and fsdp indices move one place
  past it;
- tp: the Megatron dim of ``_LAYOUT`` (heads of q/k/v/o, the FFN's
  columns, the vocab of embed and head) where tp divides it;
- fsdp: the preferred dim of ``_LAYOUT``, else (taken by tp, or not
  divisible) the largest divisible other free dim;
- other norms replicated.

Rank ``r`` of an axis holds the ``r``-th of the equal contiguous blocks
along that axis's dim (:func:`local_block`), as JAX's shard ``r`` does.
Each axis cuts a dim of its own, so a rank's block is the same whatever
order the cuts are taken in.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from opendiloco_torch.models.llama import LlamaConfig, flatten_params, shapes
from opendiloco_torch.parallel.mesh import MeshPlan, optstate_sharded, params_sharded

# per-leaf: (tp dim index, preferred fsdp dim index) -- indices into the
# UNSTACKED shape (layer leaves get +1 for the leading L axis)
_LAYOUT: dict[str, tuple[Optional[int], int]] = {
    "embed_tokens": (0, 1),  # [V, D]: fsdp on D
    "lm_head": (1, 0),  # [D, V]
    "final_norm": (None, -1),
    "input_norm": (None, -1),
    "post_attn_norm": (None, -1),
    "q_proj": (1, 0),  # [D, Nh*Dh]
    "k_proj": (1, 0),
    "v_proj": (1, 0),
    "o_proj": (0, 1),  # [Nh*Dh, D]
    "gate_proj": (1, 0),  # [D, F]
    "up_proj": (1, 0),
    "down_proj": (0, 1),  # [F, D] (or [E, F, D] under MoE)
    "router": (None, 0),  # [D, E]: small, fsdp on D
}

# FFN leaves that gain a leading expert dim when num_experts > 0
_EXPERT_LEAVES = {"gate_proj", "up_proj", "down_proj"}


def _leaf_spec(name: str, shape: tuple, stacked: bool, *, shard: bool, fsdp_n: int, ep_n: int = 1, tp_n: int = 1,
               pp_n: int = 1) -> tuple:
    ndim = len(shape)
    offset = 1 if stacked else 0
    pp_cut = stacked and pp_n > 1 and shape[0] % pp_n == 0
    if ndim <= offset + 1:
        return ("pp",) if pp_cut else ()  # norm vectors: split by stage, else replicate
    axes: list = [None] * ndim
    if pp_cut:
        axes[0] = "pp"
    if name in _EXPERT_LEAVES and ndim == offset + 3:
        if ep_n > 1 and shape[offset] % ep_n == 0:
            axes[offset] = "ep"
        offset += 1  # the tp and fsdp indices apply past the expert dim
    tp_dim, fsdp_dim = _LAYOUT[name]
    if tp_n > 1 and tp_dim is not None and shape[tp_dim + offset] % tp_n == 0:
        axes[tp_dim + offset] = "tp"
    if shard and fsdp_dim >= 0:
        d = fsdp_dim + offset
        if axes[d] is None and shape[d] % fsdp_n == 0:
            axes[d] = "fsdp"
        else:
            # preferred dim not divisible: any other free non-layer dim, largest first
            for i in sorted((i for i in range(offset, ndim) if axes[i] is None), key=lambda i: -shape[i]):
                if shape[i] % fsdp_n == 0:
                    axes[i] = "fsdp"
                    break
    return tuple(axes)


def param_specs(cfg: LlamaConfig, plan: MeshPlan, *, for_params: bool = True) -> dict:
    """Dict tree of spec tuples matching ``llama.shapes(cfg)``:
    for_params=True the resident layout of the params, False that of the
    optimizer state (ZeRO-2 cuts the state while params stay whole). The
    expert dim is cut over ep in both."""
    shard = bool(plan.fsdp_axis) and (
        params_sharded(plan.strategy) if for_params else optstate_sharded(plan.strategy))
    n = plan.shape

    def one(tree: dict, stacked: bool) -> dict:
        return {k: one(v, True) if isinstance(v, dict)
                else _leaf_spec(k, v, stacked, shard=shard, fsdp_n=n["fsdp"], ep_n=n["ep"], tp_n=n["tp"],
                                pp_n=n["pp"])
                for k, v in tree.items()}

    return one(shapes(cfg), False)


def optstate_specs(cfg: LlamaConfig, plan: MeshPlan) -> dict:
    """The AdamW state's specs: ``{"mu": [...], "nu": [...]}`` in
    :func:`flatten_params` order, each moment cut as its param's
    optimizer-state spec (``param_specs(for_params=False)``); the counts
    are host integers. The JAX function matches moments to params by
    shape instead, which gives another spec only where two leaves of one
    shape have different specs (tests/test_torch_parallel.py)."""
    specs = flatten_params(param_specs(cfg, plan, for_params=False))
    return {"mu": list(specs), "nu": list(specs)}


def spec_dim(spec: tuple, axis: str = "fsdp") -> Optional[int]:
    """The dim a spec cuts over ``axis``, or None."""
    return spec.index(axis) if axis in spec else None


def block_bounds(size: int, n: int, r: int) -> tuple[int, int]:
    """(start, length) of block ``r`` of ``n`` along a dim of ``size``."""
    if size % n:
        raise ValueError(f"a dim of {size} does not split into {n} equal blocks")
    b = size // n
    return r * b, b


def local_block(x, dim: Optional[int], n: int, r: int):
    """Block ``r`` of ``n`` of ``x`` (a tensor or numpy array) along
    ``dim``: a view; ``x`` itself when ``dim`` is None or ``n`` is 1."""
    if dim is None or n == 1:
        return x
    start, length = block_bounds(x.shape[dim], n, r)
    if isinstance(x, np.ndarray):
        return x[(slice(None),) * dim + (slice(start, start + length),)]
    return x.narrow(dim, start, length)


def join_blocks(blocks: list, dim: Optional[int]):
    """The full leaf from its blocks in rank order (the first when ``dim``
    is None: a replicated leaf)."""
    if dim is None:
        return blocks[0]
    if isinstance(blocks[0], np.ndarray):
        return np.concatenate(blocks, axis=dim)
    import torch

    return torch.cat(blocks, dim=dim)


class ParamGather:
    """The forward's gather of a FULL_SHARD or HYBRID_SHARD layout over the
    fsdp group: a cut top-level leaf, or all of a layer's cut blocks at
    once (:meth:`layer`), come back whole in the compute dtype; a
    replicated leaf is only cast."""

    def __init__(self, specs: dict, group):
        self.group = group
        self.dims = {k: spec_dim(v) for k, v in specs.items() if not isinstance(v, dict)}
        # a layer's block drops the leading stacked dim
        self.layer_dims = {k: None if spec_dim(v) is None else spec_dim(v) - 1 for k, v in specs["layers"].items()}

    def _whole(self, dims: list, leaves: list, dtype) -> list:
        """The leaves whole in ``dtype``: the cut ones (``dims[i]`` not
        None) through one :class:`~opendiloco_torch.parallel.comm.GatherLayer`,
        the replicated ones cast."""
        cut = [i for i, d in enumerate(dims) if d is not None]
        out = [x.to(dtype) if d is None else None for x, d in zip(leaves, dims)]
        if cut:
            from opendiloco_torch.parallel.comm import GatherLayer

            fulls = GatherLayer.apply(tuple(dims[i] for i in cut), self.group, dtype, *[leaves[i] for i in cut])
            for i, full in zip(cut, fulls):
                out[i] = full
        return out

    def __call__(self, name: str, leaf, dtype):
        return self._whole([self.dims[name]], [leaf], dtype)[0]

    def layer(self, names: list, blocks: list, dtype) -> list:
        """One layer's weights, whole: its cut blocks in one gather."""
        return self._whole([self.layer_dims[n] for n in names], blocks, dtype)
