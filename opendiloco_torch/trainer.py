"""Inner-loop trainer: one worker's train step, on one device or cut over
the processes of a ``torch.distributed`` group.

The counterpart of ``opendiloco_tpu/trainer.py``: forward and backward per
micro-batch with gradient accumulation over ``[accum, mb, seq]``,
global-norm clip, AdamW with linear warmup then cosine decay, and fp16
dynamic loss scaling. The semantics are optax's and the JAX step's, not
PyTorch's defaults, written out here:

- the schedule gives lr 0 at step 0 and is read with the count before
  its increment (optax ``scale_by_schedule``);
- the clip scales by ``(g / norm) * max_norm`` when ``norm >= max_norm``
  (optax ``clip_by_global_norm``; no epsilon);
- AdamW adds ``wd * p`` to the Adam update and multiplies the sum by
  ``-lr``, on every leaf, with the bias corrections computed in f32
  (optax ``adamw``).

State is ``{"params", "opt_state", "step", "scaler"}`` as in the JAX
package: params are the f32 dict tree with ``requires_grad`` leaves, on
the device; ``opt_state`` holds the Adam moments (device tensors in
:func:`~opendiloco_torch.models.llama.flatten_params` order) and the two
integer counts of the optax chain. Where the JAX step is functional and
donates its state, the port updates params and moments in place.

Under a :class:`~opendiloco_torch.parallel.mesh.MeshPlan` with a process
group the strategies are explicit collectives on these leaves (the
layouts XLA derives from the JAX package's PartitionSpecs):

- each rank is handed its rows of the global batch (:meth:`InnerTrainer.shard_batch`);
  the loss stays the mean over the global micro-batch's non-ignored
  tokens (sum and count summed over the ranks before the division), and
  each rank's gradient is its rows' share;
- FULL_SHARD and HYBRID_SHARD hold each cut leaf's block
  (:mod:`~opendiloco_torch.parallel.sharding`); the forward gathers a
  layer's weights when it runs, in the compute dtype, and the backward
  reduce-scatters that layer's f32 gradient into the block;
- once a step, after accumulation, the gradients are summed in f32:
  all-reduced over the world (NO_SHARD, and every replicated leaf),
  reduce-scattered into the optimizer state's blocks over fsdp (ZeRO-2),
  and all-reduced over dp for the hybrids;
- the global norm sums each leaf's squares over the ranks that hold
  distinct blocks, a replicated leaf once;
- AdamW updates the local blocks; ZeRO-2 then all-gathers the params (f32).

Over sp each rank holds a chunk of every sequence: attention is the
flash-chunk ring over the sp group (``attn_impl`` "ring", the default
there), or, under "xla" or "pallas", the whole sequence's attention on
every rank, q, k and v gathered over sp and the rank's own rows kept, as
the JAX package's partitioner gathers them. Rope takes global positions,
and the loss pairs each position with the next token's label across
chunk boundaries (the global last position is dropped), summed over the
data group as the batch is. Over ep each rank holds ``E/ep`` experts of every
routed-expert leaf and the same tokens as its ep peers; the FFN sums its
partial combine over ep (:mod:`~opendiloco_torch.parallel.experts`), so
every replicated leaf's gradient is whole on each ep rank and is summed
over the data group only, never over ep.

Over tp each rank holds its blocks of the Megatron cuts (heads of
q/k/v/o, columns of the FFN, the vocab of embed and head) and runs its
heads and columns (``models/llama.py _tp_attention``); the head is
gathered for the loss. Every gradient a tp rank computes for a leaf that
tp does not cut is already whole and the same on every tp rank, so it is
summed over the data group only; the norm counts it once. Over pp each
stage holds L/pp contiguous layers and runs the GPipe schedule
(:mod:`~opendiloco_torch.parallel.pipeline`): stage 0 embeds, the last
stage's final norm, head and loss read the joined hidden states, and the
gradients of embed, final norm and head (zero on the stages that do not
use them) are summed over pp, so that they end every step identical on
every stage. ``gather_state``, ``host_params``, ``local_params`` and
``scatter_state`` join and cut over every axis, so checkpoints and the
outer loop see whole leaves.

At one process every collective is an identity and the step is the
single-device step bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from opendiloco_torch import obs
from opendiloco_torch.device import DeviceLike, resolve_device
from opendiloco_torch.models.convert import params_from_numpy
from opendiloco_torch.models import llama
from opendiloco_torch.models.llama import (
    LlamaConfig,
    RematPolicy,
    _maybe_remat,
    causal_lm_loss,
    flatten_params,
    forward,
    init_params,
    unflatten_params,
)
from opendiloco_torch.ops.fused_xent import IGNORE, fused_linear_cross_entropy_sharded
from opendiloco_torch.ops.ring_attention import DistRing
from opendiloco_torch.parallel.comm import TensorParallel
from opendiloco_torch.parallel.experts import ExpertPlan
from opendiloco_torch.parallel.mesh import AXES, MeshPlan, params_sharded, single_device_plan
from opendiloco_torch.parallel.pipeline import pipeline_hidden
from opendiloco_torch.parallel.sharding import ParamGather, local_block, param_specs, spec_dim
from opendiloco_torch.utils.spans import span


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The optimization-relevant slice of the top-level Config."""

    lr: float = 4e-4
    weight_decay: float = 0.1
    adam_betas: tuple = (0.9, 0.95)
    adam_eps: float = 1e-8
    warmup_steps: int = 1000
    total_steps: int = 88_000
    max_grad_norm: float = 1.0
    precision: str = "bf16-mixed"
    # "auto": the hand-written kernels on the card, plain attention on the
    # CPU, the ring under sp; "pallas": the kernels (their plain versions
    # on the CPU); "xla": plain attention; "ring": the flash-chunk ring
    attn_impl: str = "auto"
    remat: RematPolicy = True
    # the fused lm-head + cross-entropy (B3/B4): None resolves to on for
    # looped stacks on the card (see _resolve_perf_defaults)
    fused_loss: Optional[bool] = None
    # kept for the JAX signature (it decides fused_loss's default); no
    # effect in eager PyTorch
    scan_unroll: Optional[int] = None
    pp_microbatches: Optional[int] = None  # pipeline micro-batches (None: the pp size)
    # sp + pp with a non-ring attention: the sp axis shards activations
    # while every rank attends over the whole sequence; never implicit
    allow_sp_activation_sharding: bool = False
    # fp16 dynamic loss scaling (GradScaler semantics)
    init_loss_scale: float = 2.0**15
    scale_growth_interval: int = 2000

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.precision == "bf16-mixed":
            return torch.bfloat16
        if self.precision == "fp16-mixed":
            return torch.float16
        return torch.float32

    @property
    def use_loss_scaling(self) -> bool:
        return self.precision == "fp16-mixed"


def make_schedule(tc: TrainerConfig):
    """step -> lr: linear warmup from 0 then cosine decay to 0 over the
    remaining steps, in f32 as optax computes it
    (``join_schedules([linear_schedule(0, lr, warmup),
    cosine_decay_schedule(lr, total - warmup)], [warmup])``)."""
    f32 = np.float32
    warmup = int(tc.warmup_steps)
    decay_steps = float(max(1, tc.total_steps - tc.warmup_steps))

    def schedule(step: int) -> float:
        step = int(step)
        if step < warmup:
            # polynomial_schedule(0, lr, power 1): (init - end) * frac + end
            frac = f32(1) - f32(min(max(step, 0), warmup)) / f32(warmup)
            return float(f32(0.0 - tc.lr) * frac + f32(tc.lr))
        count = f32(min(float(step - warmup), decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count / f32(decay_steps), dtype=f32))
        return float(f32(tc.lr) * cosine)

    return schedule


class InnerOptimizer:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay))`` over a flat list of f32 tensors, updated in
    place. State: {"count": adam count, "schedule_count": the schedule's
    count, "mu": [...], "nu": [...]} (the two integer counts of the optax
    chain, which ``force_step_position`` rewrites)."""

    def __init__(self, tc: TrainerConfig):
        self.tc = tc
        self.schedule = make_schedule(tc)

    def init(self, leaves: list) -> dict:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        return {"count": 0, "schedule_count": 0, "mu": zeros,
                "nu": [torch.zeros_like(z) for z in zeros]}

    @torch.no_grad()
    def update(self, grads: list, state: dict, params: list, grad_norm: torch.Tensor) -> None:
        """Apply one step to ``params`` in place; ``grad_norm`` is the
        global norm of ``grads`` (the clip's trigger). The leaves go
        through one at a time, so the update's f32 temporaries stay within
        a few copies of the largest leaf (1.01 GB at config_1b) rather than
        of all the params (4.40 GB)."""
        f32 = np.float32
        b1, b2 = self.tc.adam_betas
        count = state["count"] + 1
        bc1 = float(f32(1) - f32(b1) ** f32(count))
        bc2 = float(f32(1) - f32(b2) ** f32(count))
        lr = self.schedule(state["schedule_count"])
        for i in range(len(params)):
            _adamw_leaves(self.tc, [grads[i]], [state["mu"][i]], [state["nu"][i]], [params[i]],
                          grad_norm, bc1, bc2, lr)
        state["count"] = count
        state["schedule_count"] += 1


def _adamw_leaves(tc: TrainerConfig, g: list, mu: list, nu: list, p: list, grad_norm: torch.Tensor,
                  bc1: float, bc2: float, lr: float) -> None:
    """One clipped AdamW step over lists of leaves, in place on ``mu``,
    ``nu`` and ``p``; ``bc1``/``bc2`` are the bias corrections."""
    b1, b2 = tc.adam_betas
    with span("adamw.clip"):
        # clip: select(norm < max_norm, g, (g / norm) * max_norm)
        clip = grad_norm >= tc.max_grad_norm
        scaled = torch._foreach_div(g, grad_norm)
        torch._foreach_mul_(scaled, tc.max_grad_norm)
        g = [torch.where(clip, a, b) for a, b in zip(scaled, g)]
        del scaled
    with span("adamw.update"):
        # moments: (1 - b) * g**order + b * t
        new_mu = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(new_mu, torch._foreach_mul(mu, b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_add_(g2, torch._foreach_mul(nu, b2))
        del g
        for dst, src in zip(mu, new_mu):
            dst.copy_(src)
        for dst, src in zip(nu, g2):
            dst.copy_(src)
        del new_mu, g2
        # m_hat / (sqrt(v_hat) + eps) + wd * p, times -lr
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, tc.adam_eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        if tc.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(p, tc.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)


def make_inner_optimizer(tc: TrainerConfig) -> InnerOptimizer:
    return InnerOptimizer(tc)


def global_norm(tensors: list, reduce_squares=None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x**2), as optax.global_norm.
    ``reduce_squares`` (list -> list) may first sum each leaf's square
    over the ranks that hold its blocks."""
    sq = [torch.sum(t * t) for t in tensors]
    if reduce_squares is not None:
        sq = reduce_squares(sq)
    total = sq[0]
    for x in sq[1:]:
        total = total + x
    return torch.sqrt(total)


def _resolve_perf_defaults(
    tc: TrainerConfig, model_cfg: LlamaConfig, device: torch.device, plan: Optional[MeshPlan] = None
) -> TrainerConfig:
    """Resolve attn_impl="auto" / fused_loss=None / scan_unroll=None.

    Under a plan with an sp axis "auto" takes the ring (the only attention
    that keeps the sequence chunks local); an explicit "xla" or "pallas"
    passes through and attends over the whole sequence, gathered over sp.
    Otherwise "auto" takes on the card the hand-written flash-attention
    kernels (the JAX package's "pallas" on a TPU), elsewhere the plain
    attention. scan_unroll resolves as the JAX package's does (full unroll
    for dense stacks of at most 16 layers on the card, else 1), and
    fused_loss=None follows it: on where the card runs the kernel
    attention without sp and the layer loop stays rolled (unroll <
    layers), as at config_1b's 22 layers and at every MoE config; off
    under sp, at config_150m and on the CPU. An explicit True or False
    passes through, on the CPU too, where the kernels' plain versions run."""
    if tc.attn_impl not in ("auto", "pallas", "xla", "ring"):
        raise ValueError(f"unknown attn_impl {tc.attn_impl!r}")
    on_card = device.type == "cuda"
    sp = plan is not None and plan.sp_axis is not None
    changes: dict = {}
    if tc.attn_impl == "auto":
        # sp + pp with the opt-in: full-sequence attention, the activation-sharding mode
        ring = sp and not (tc.allow_sp_activation_sharding and plan.pp_axis is not None)
        changes["attn_impl"] = "ring" if ring else ("pallas" if on_card else "xla")
    if tc.scan_unroll is None:
        dense_shallow = not model_cfg.num_experts and model_cfg.num_hidden_layers <= 16
        changes["scan_unroll"] = model_cfg.num_hidden_layers if on_card and dense_shallow else 1
    if tc.fused_loss is None:
        attn = changes.get("attn_impl", tc.attn_impl)
        unroll = changes.get("scan_unroll", tc.scan_unroll) or 1
        changes["fused_loss"] = on_card and attn == "pallas" and not sp and unroll < model_cfg.num_hidden_layers
    return dataclasses.replace(tc, **changes)


class InnerTrainer:
    """Owns the optimizer and the train/eval steps of one worker on one
    device (the card unless ``device`` names another), or of this rank of a
    worker cut over a process group (``plan``, from
    :func:`~opendiloco_torch.parallel.mesh.build_mesh`; default the
    single-device plan).

    state: {"params": f32 dict tree (this rank's blocks under FULL_SHARD
    and HYBRID_SHARD), "opt_state": see InnerOptimizer (blocks under every
    strategy but NO_SHARD), "step": int, "scaler": {"scale": float,
    "good_steps": int}}
    """

    def __init__(self, model_cfg: LlamaConfig, tc: TrainerConfig, device: DeviceLike = None,
                 plan: Optional[MeshPlan] = None):
        self.device = resolve_device(device)
        plan = plan if plan is not None else single_device_plan()
        tc = _resolve_perf_defaults(tc, model_cfg, self.device, plan)
        _maybe_remat(None, tc.remat)  # an unknown policy raises here, not mid-step
        if plan.pp_axis and plan.sp_axis and tc.attn_impl != "ring" and not tc.allow_sp_activation_sharding:
            raise ValueError(
                f"sp+pp with attn_impl={tc.attn_impl!r} would shard activations while every device attends over "
                "the FULL sequence. Use the default/ring attention (composes with the pipeline), or opt into the "
                "activation-sharding mode with --allow-sp-activation-sharding"
            )
        if plan.pp_axis:
            pp_n = plan.shape["pp"]
            if model_cfg.num_hidden_layers % pp_n:
                raise ValueError(f"{model_cfg.num_hidden_layers} layers cannot stage over pp={pp_n} (must divide "
                                 "evenly)")
            if tc.attn_impl == "ring" and not plan.sp_axis:
                raise ValueError(
                    "ring attention under pp needs a sequence-parallel axis to ring over: add sp_size > 1 (the "
                    "pipeline binds both axes manual and the ring runs on each stage's local chunks), or use "
                    "attn_impl xla/pallas"
                )
        if plan.ep_axis:
            ep_n = plan.shape["ep"]
            if model_cfg.num_experts == 0:
                raise ValueError(
                    f"--ep-size {ep_n} with a dense model silently replicates work across the ep axis; use an "
                    "MoE config (num_experts > 0) or drop ep_size"
                )
            if model_cfg.num_experts % ep_n:
                raise ValueError(f"{model_cfg.num_experts} experts cannot shard over ep={ep_n} (must divide evenly)")
        self.model_cfg = model_cfg
        self.tc = tc
        self.optimizer = make_inner_optimizer(tc)
        self.schedule = make_schedule(tc)
        self._post_dispatch_hooks: list = []
        self._set_plan(plan)

    def _set_plan(self, plan: MeshPlan) -> None:
        """The layout: which dim each param and optimizer-state leaf is cut
        along on this rank (None: whole), and the groups."""
        self.plan = plan
        self._dist = plan.grouped
        if plan.mesh is not None:
            import torch.distributed as dist

            # a CUDA run never drops to gloo
            want = "nccl" if self.device.type == "cuda" else "gloo"
            if dist.get_backend() != want:
                raise ValueError(f"a trainer on {self.device.type} runs its collectives over {want}, "
                                 f"not {dist.get_backend()!r}")
        self._comms = {a: plan.comm(a) for a in AXES if plan.shape[a] > 1} if self._dist else {}
        self._fsdp_n, self._fsdp_r = plan.shape["fsdp"], plan.coord("fsdp")
        self._sp_n, self._sp_r = plan.shape["sp"], plan.coord("sp")
        self._params_cut = params_sharded(plan.strategy)
        specs = param_specs(self.model_cfg, plan)
        flat = flatten_params(specs)
        self.param_dims = [spec_dim(x) for x in flat]
        self.opt_dims = [spec_dim(x) for x in flatten_params(param_specs(self.model_cfg, plan, for_params=False))]
        # the model-parallel cuts, in params and optimizer state alike: the
        # layer dim over pp, the expert dim over ep, the Megatron dim over tp
        self.mp_dims = {a: [spec_dim(x, a) for x in flat] for a in ("pp", "ep", "tp")}
        # the resident params' layout (ZeRO-2 keeps them whole)
        self.resident_dims = self.param_dims if self._params_cut else [None] * len(self.param_dims)
        self._gather = ParamGather(specs, plan.group("fsdp")) if self._dist and self._params_cut else None
        self._batch_group = plan.batch_group() if self._dist and plan.data_size > 1 else None
        self._ring = None
        if "sp" in self._comms and self.tc.attn_impl == "ring":
            # rank threads: their sp comm is the ring
            self._ring = self._comms["sp"] if plan.comms else DistRing(plan.group("sp"))
        self._experts = ExpertPlan(plan) if self._dist and self.model_cfg.num_experts else None
        self._tp = TensorParallel(self._comms["tp"]) if "tp" in self._comms else None
        self._pp = self._comms.get("pp")
        # sp through a non-ring attention: every rank attends over whole
        # sequences, gathered over sp (models/llama.py _attn_fn)
        self._seq = TensorParallel(self._comms["sp"]) if "sp" in self._comms and self.tc.attn_impl != "ring" else None
        # the head is gathered over tp for the loss where tp cuts the vocab
        self._head_cut = self._tp is not None and self.model_cfg.vocab_size % self._tp.size == 0
        mp_cut = self._dist and any(d is not None for dims in self.mp_dims.values() for d in dims)
        # whether this rank holds blocks: of the params, of any state leaf
        self._params_blocked = mp_cut or (self._dist and self._params_cut and self._fsdp_n > 1)
        self._blocked = mp_cut or (self._dist and self._fsdp_n > 1)
        # the leaves outside the layer stack (embed, final norm, head): whole
        # on every stage, their gradients summed over pp
        self._top = [spec_dim(x, "pp") is None for x in flat]

    def _block(self, x, i: int, dim: Optional[int]):
        """This rank's block of full leaf ``i`` (a tensor or a host array):
        cut over pp, ep and tp, then along ``dim`` over fsdp (a view; the
        leaf itself where nothing cuts)."""
        for axis, dims in self.mp_dims.items():
            x = local_block(x, dims[i], self.plan.shape[axis], self.plan.coord(axis))
        return local_block(x, dim, self._fsdp_n, self._fsdp_r)

    def _whole(self, x: torch.Tensor, i: int, dim: Optional[int]) -> torch.Tensor:
        """Leaf ``i`` cut along ``dim`` over fsdp and over the model-parallel
        axes, joined (collectives); a whole leaf as it is. Detached."""
        x = x.detach()
        if not self._dist:
            return x
        cuts = [("fsdp", dim), *((a, dims[i]) for a, dims in self.mp_dims.items())]
        for axis, d in cuts:
            if d is not None and axis in self._comms:
                x = self._comms[axis].all_gather(x, d)
        return x

    def _opt_targets(self, leaves: list) -> list:
        """The param tensors AdamW updates: the leaves themselves, or under
        ZeRO-2 views of their optimizer-state blocks."""
        if self._params_cut:
            return list(leaves)
        return [local_block(p, d, self._fsdp_n, self._fsdp_r) for p, d in zip(leaves, self.opt_dims)]
    # -- state ------------------------------------------------------------

    def init_state(
        self, rng: Union[int, torch.Generator, None] = None, params: Optional[dict] = None
    ) -> dict:
        """Draw fresh params (``rng``: a seed or a ``torch.Generator``) or
        adopt ``params`` (a dict tree of numpy arrays, as the JAX package
        hands them over), as f32 leaves on the device that require grad,
        with a fresh optimizer state."""
        if params is None:
            gen = rng if isinstance(rng, torch.Generator) else None
            if gen is None:
                gen = torch.Generator(device=self.device).manual_seed(0 if rng is None else int(rng))
            params = init_params(gen, self.model_cfg, device=self.device)
            for p in flatten_params(params):
                p.requires_grad_(True)
        else:
            params = params_from_numpy(params, self.device, torch.float32, requires_grad=True)
        # drawn whole on every rank (the same draws under any layout), then cut
        params = self.local_params(params)
        scale = self.tc.init_loss_scale if self.tc.use_loss_scaling else 1.0
        return {
            "params": params,
            "opt_state": self.optimizer.init(self._opt_targets(flatten_params(params))),
            "step": 0,
            "scaler": {"scale": float(scale), "good_steps": 0},
        }

    def local_params(self, params: dict) -> dict:
        """Full f32 leaves -> this rank's resident params: blocks under
        FULL_SHARD and HYBRID_SHARD (own memory, requiring grad), the
        leaves themselves otherwise."""
        if not self._params_blocked:
            return params
        leaves = [self._block(p, i, d).detach().clone().requires_grad_(True)
                  for i, (p, d) in enumerate(zip(flatten_params(params), self.resident_dims))]
        return unflatten_params(params, leaves)

    def gather_state(self, state: dict) -> dict:
        """The state with every leaf whole (params and AdamW moments
        gathered over fsdp, f32): a checkpoint's layout, which loads at any
        world size. A collective: every rank calls it. Returns ``state``
        itself when nothing is cut."""
        if not self._blocked:
            return state
        whole = lambda xs, dims: [self._whole(x, i, d) for i, (x, d) in enumerate(zip(xs, dims))]
        opt = dict(state["opt_state"])
        opt["mu"], opt["nu"] = whole(opt["mu"], self.opt_dims), whole(opt["nu"], self.opt_dims)
        return {**state, "params": unflatten_params(state["params"], whole(flatten_params(state["params"]), self.resident_dims)),
                "opt_state": opt}

    def host_params(self, leaves: list, idx: Optional[list] = None) -> list[np.ndarray]:
        """Whole f32 host copies, owning their memory, of the resident
        param ``leaves`` (or of those at ``idx``): the outer loop's view of
        the params. A collective when the params are cut."""
        idx = range(len(leaves)) if idx is None else idx
        return [self._whole(leaves[i], i, self.resident_dims[i]).to("cpu", torch.float32, copy=True).numpy()
                for i in idx]

    def host_block(self, i: int, host_arr: np.ndarray) -> np.ndarray:
        """This rank's block of resident param leaf ``i`` from the whole
        host array (the array itself when the leaf is whole)."""
        return np.ascontiguousarray(self._block(host_arr, i, self.resident_dims[i]))

    @torch.no_grad()
    def scatter_state(self, full: dict) -> dict:
        """The inverse of :meth:`gather_state`: this rank's blocks of a
        state whose leaves are whole (a loaded checkpoint)."""
        if not self._blocked:
            return full
        params = self.local_params(full["params"])
        opt = dict(full["opt_state"])
        opt["mu"] = [self._block(x, i, d).clone() for i, (x, d) in enumerate(zip(opt["mu"], self.opt_dims))]
        opt["nu"] = [self._block(x, i, d).clone() for i, (x, d) in enumerate(zip(opt["nu"], self.opt_dims))]
        return {**full, "params": params, "opt_state": opt}

    def force_step_position(self, state: dict, step: int) -> dict:
        """Teleport the LR-schedule position to ``step``: rewrites
        ``state["step"]`` and every integer count of the optimizer state
        (the schedule reads its own count). A late joiner at outer epoch E
        resumes the schedule at E * local_steps."""
        state = dict(state)
        state["step"] = int(step)
        opt = dict(state["opt_state"])
        opt["count"] = int(step)
        opt["schedule_count"] = int(step)
        state["opt_state"] = opt
        return state

    # -- steps ------------------------------------------------------------

    def _fused_lm_loss(self, hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The shifted fused lm-head + cross-entropy over the final hidden
        states: the single shift and reshape site, as in the JAX package
        (the sharded entry over the plan's batch axes, the head gathered
        over tp where tp cuts it). Under sp the labels are already the
        next-token targets (:meth:`_seq_chunk`)."""
        d = hidden.shape[-1]
        if self._sp_n == 1:
            hidden, labels = hidden[:, :-1], labels[:, 1:]
        with span("loss.fused"):
            return fused_linear_cross_entropy_sharded(
                hidden.reshape(-1, d), head, labels.reshape(-1),
                mesh=self.plan if self._dist else None, batch_axes=self.plan.batch_axes,
                tp_axis=self.plan.tp_axis if self._head_cut else None,
            )

    def _lm_loss(self, hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The loss over final hidden states and this rank's head: fused, or
        through the logits of the head gathered over tp."""
        if self.tc.fused_loss:
            return self._fused_lm_loss(hidden, head, labels)
        if self._head_cut:
            head = self._tp.gather(head, 1, partial=False)
        with span("llama.lm_head"):
            logits = (hidden @ head).float()
        return causal_lm_loss(logits, labels, group=self._batch_group, shift=self._sp_n == 1)

    def _positions(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Global positions of this rank's [B, T] tokens (its sequence chunk
        under sp)."""
        B, T = input_ids.shape
        start = self._sp_r * T if self._sp_n > 1 else 0
        return torch.arange(start, start + T, device=input_ids.device).expand(B, T)

    def _forward_kw(self, input_ids: torch.Tensor) -> dict:
        """The model's options on this rank: the ring, the expert plan, the
        tp rank, the pipeline (forward without gradients: eval, probes) and
        the global positions of this rank's tokens."""
        return dict(compute_dtype=self.tc.compute_dtype, attn_impl=self.tc.attn_impl, gather=self._gather,
                    ring_mesh=self._ring, experts=self._experts, tp=self._tp, seq=self._seq, pp_mesh=self._pp,
                    pp_microbatches=self.tc.pp_microbatches, positions=self._positions(input_ids))

    def _loss_fn(self, params: dict, input_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        kw = dict(self._forward_kw(input_ids), remat=self.tc.remat, scan_unroll=self.tc.scan_unroll)
        moe = bool(self.model_cfg.num_experts)
        out = forward(params, input_ids, self.model_cfg, return_hidden=True, return_moe_aux=moe, **kw)
        loss = self._lm_loss(out[0], out[1], labels)
        if moe:
            loss = loss + self.model_cfg.router_aux_coef * out[-1]
        return loss

    def _pp_rows(self, input_ids: torch.Tensor, labels: torch.Tensor) -> tuple:
        """This rank's rows of the pipeline's global micro-batches. The JAX
        pipeline cuts the global batch of B rows into M micro-batches of
        B/M rows (``h0.reshape(M, B // M, ...)``), and each batch block
        holds its share of every one; a rank holds a contiguous block of
        rows instead. Routed experts take capacity and aux per micro-batch,
        so under pp with several blocks and micro-batches the rows (with
        their labels) are exchanged over the data group: micro-batch m of
        block j gets global rows ``m B/M + j b + [0, b)``. A dense stack's
        micro-batches are independent; its rows stay where they are."""
        M = self.tc.pp_microbatches or self._pp.size
        blocks = self.plan.data_parallel_size
        if not self.model_cfg.num_experts or M == 1 or blocks == 1:
            return input_ids, labels
        from opendiloco_torch.parallel.comm import all_gather_dim

        out = []
        for a in (input_ids, labels):
            B, T = a.shape
            parts = all_gather_dim(a[None].contiguous(), 0, self._batch_group)  # [blocks * sp, B, T]
            rows = parts.reshape(blocks, self._sp_n, B, T)[:, self._sp_r].reshape(M, blocks, B // M, T)
            out.append(rows[:, self.plan.batch_index].reshape(B, T))
        return tuple(out)

    def _pp_loss_grads(self, params: dict, leaves: list, input_ids: torch.Tensor, labels: torch.Tensor,
                       scale: float) -> tuple:
        """One micro-batch through the GPipe schedule on this stage:
        (the scaled loss, whole on the last stage and 0 elsewhere; the
        scaled gradient of each of ``leaves``, zero where this stage does
        not use the leaf). Stage 0 embeds, the last stage runs the final
        norm, the head and the loss; the MoE aux of each stage's layers
        takes its gradient on its stage."""
        cfg, pp, cd = self.model_cfg, self._pp, self.tc.compute_dtype
        M = self.tc.pp_microbatches or pp.size
        input_ids, labels = self._pp_rows(input_ids, labels)
        kw = self._forward_kw(input_ids)
        ffn_fn = None
        if cfg.num_experts:
            ffn_fn = lambda x, layer: llama._switch_ffn(cfg, x, layer, self._experts, None, self._tp)
        stage = llama.stage_fn(params, cfg, compute_dtype=cd, attn_fn=llama._attn_fn(self.tc.attn_impl, self._ring,
                                                                                      self._seq),
                               ffn_fn=ffn_fn, remat=self.tc.remat, gather=self._gather, tp=self._tp)
        top = llama._cast_top(params, cd, self._gather)
        first, last = pp.rank == 0, pp.rank == pp.size - 1
        h0 = llama.embed(top, input_ids, cfg, self._tp) if first else None
        run = pipeline_hidden(stage, h0, kw["positions"], pp, microbatches=M, grad=True, width=cfg.hidden_size,
                              dtype=cd)
        aux = run.aux_total(cfg.num_hidden_layers) if cfg.num_experts else None
        stack = [i for i, t in enumerate(self._top) if not t]
        grads: list = [None] * len(leaves)
        dys, loss = None, torch.zeros((), device=self.device)
        if last:
            with span("llama.final_norm"):
                h = llama._rms_norm(run.hidden, top["final_norm"], cfg.rms_norm_eps)
            xent = self._lm_loss(h, llama._head(top, cfg), labels)
            tops = [i for i, t in enumerate(self._top) if t]
            with span("trainer.backward"):
                got = torch.autograd.grad(xent * scale, [*(leaves[i] for i in tops), *run.ys], allow_unused=True)
            for i, g in zip(tops, got):
                grads[i] = g
            dys = list(got[len(tops):])
            loss = xent.detach() if aux is None else xent.detach() + cfg.router_aux_coef * aux
            loss = loss * scale
            del h, xent, got
        aux_grad = None if aux is None else cfg.router_aux_coef * scale / (cfg.num_hidden_layers * M)
        with span("trainer.backward"):
            got, dh0 = run.backward([leaves[i] for i in stack], dys, aux_grad)
            for i, g in zip(stack, got):
                grads[i] = g
            if first:
                (g,) = torch.autograd.grad(h0, [leaves[0]], dh0)  # embed_tokens: the first leaf
                grads[0] = g if grads[0] is None else grads[0] + g
        return loss, [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]

    def _train_step_impl(self, state: dict, batch: dict):
        """batch tensors are [accum, mb, seq]."""
        params = state["params"]
        leaves = flatten_params(params)
        accum = batch["input_ids"].shape[0]
        scale = state["scaler"]["scale"]
        loss_sum, grad_sum = None, None
        for i in range(accum):
            if self._pp is not None:
                loss, grads = self._pp_loss_grads(params, leaves, batch["input_ids"][i], batch["labels"][i], scale)
            else:
                loss = self._loss_fn(params, batch["input_ids"][i], batch["labels"][i]) * scale
                with span("trainer.backward"):
                    grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
            with span("trainer.grad_accum"):
                if grad_sum is None:
                    loss_sum, grad_sum = loss, list(grads)
                else:
                    loss_sum = loss_sum + loss
                    torch._foreach_add_(grad_sum, grads)
            del grads
        inv = float(np.float32(1.0) / (np.float32(accum) * np.float32(scale)))
        with span("trainer.grad_accum"):
            torch._foreach_mul_(grad_sum, inv)
            loss = loss_sum * inv
        if self._pp is not None:
            loss = self._pp.broadcast(loss, self._pp.size - 1)  # the last stage's
        if self._dist:
            with span("trainer.grad_reduce"):
                grad_sum = self._reduce_grads(grad_sum)
        with span("trainer.grad_norm"):
            grad_norm = global_norm(grad_sum, self._sum_cut_squares if self._dist else None)
        targets = self._opt_targets(leaves)

        scaler = state["scaler"]
        if self.tc.use_loss_scaling:
            # GradScaler semantics: on non-finite grads skip the update and
            # halve the scale; grow 2x after scale_growth_interval clean steps
            finite = bool(torch.isfinite(grad_norm))
            if finite:
                self.optimizer.update(grad_sum, state["opt_state"], targets, grad_norm)
                self._gather_updated(leaves, targets)
            good = scaler["good_steps"] + 1 if finite else 0
            grow = finite and good >= self.tc.scale_growth_interval
            new_scale = (scale * 2.0 if grow else scale) if finite else scale * 0.5
            scaler = {"scale": new_scale, "good_steps": 0 if grow else good}
            metrics = {
                "loss": loss,
                "grad_norm": grad_norm,
                "found_inf": torch.tensor(0.0 if finite else 1.0),
                "loss_scale": torch.tensor(scale),
            }
        else:
            self.optimizer.update(grad_sum, state["opt_state"], targets, grad_norm)
            self._gather_updated(leaves, targets)
            metrics = {"loss": loss, "grad_norm": grad_norm}
        new_state = {
            "params": params,
            "opt_state": state["opt_state"],
            "step": state["step"] + 1,
            "scaler": scaler,
        }
        return new_state, metrics

    def _reduce_grads(self, grads: list) -> list:
        """The once-a-step gradient sum over the ranks, in f32 (see the
        module docstring); returns each leaf's gradient in its optimizer
        state's layout. Under pp the leaves outside the stack are then
        summed over the stages."""
        from opendiloco_torch.parallel.comm import all_reduce_, reduce_scatter_dim

        plan, data = self.plan, self._batch_group
        out = grads
        if data is not None:  # other ranks hold distinct tokens
            # the ranks that hold the same block of a leaf cut over fsdp
            replicas = [plan.group(a) for a in ("dp", "sp") if plan.shape[a] > 1]
            out = []
            for g, pd, od in zip(grads, self.param_dims, self.opt_dims):
                if self._params_cut and pd is not None:
                    pass  # reduce-scattered over fsdp by the forward's gather
                elif od is not None:
                    g = reduce_scatter_dim(g, od, plan.group("fsdp"))
                else:
                    out.append(all_reduce_(g, data))
                    continue
                for group in replicas:
                    g = all_reduce_(g, group)
                out.append(g)
        if self._pp is not None:
            out = [self._pp.all_reduce(g) if top else g for g, top in zip(out, self._top)]
        return out

    def _sum_cut_squares(self, sq: list) -> list:
        """Each cut leaf's square summed over the ranks that hold its other
        blocks: over fsdp, then ep, tp and pp (one all-reduce of the
        per-leaf sums each); a leaf an axis does not cut counts once."""
        for axis, dims in (("fsdp", self.opt_dims), *self.mp_dims.items()):
            cut = [i for i, d in enumerate(dims) if d is not None]
            if cut and axis in self._comms:
                summed = self._comms[axis].all_reduce(torch.stack([sq[i] for i in cut]))
                for j, i in enumerate(cut):
                    sq[i] = summed[j]
        return sq

    @torch.no_grad()
    def _gather_updated(self, leaves: list, targets: list) -> None:
        """ZeRO-2: each rank updated its block of the whole params; gather
        the blocks back into every rank's copy (f32)."""
        if not self._dist or self._params_cut or "fsdp" not in self._comms:
            return
        for p, t, d in zip(leaves, targets, self.opt_dims):
            if d is not None:
                p.copy_(self._comms["fsdp"].all_gather(t.detach(), d))

    @torch.no_grad()
    def _eval_step_impl(self, params: dict, batch: dict) -> torch.Tensor:
        ids, labels = batch["input_ids"], batch["labels"]
        if self._pp is not None:
            ids, labels = self._pp_rows(ids, labels)
        return self._loss_fn(params, ids, labels)

    @torch.no_grad()
    def _probe_step_impl(self, params: dict, batch: dict) -> dict:
        # the JAX probe runs the stack unpipelined: one micro-batch here
        kw = dict(self._forward_kw(batch["input_ids"]), pp_microbatches=1)
        _, aux = forward(params, batch["input_ids"], self.model_cfg, remat=False, return_aux=True, **kw)
        if self._batch_group is not None:
            # L2 norms over the whole batch: the ranks' squares summed
            from opendiloco_torch.parallel.comm import all_reduce_

            aux = {k: torch.sqrt(all_reduce_(aux[k].float() ** 2, self._batch_group))
                   for k in ("attn_out_norm", "lm_head_norm")}
        return aux

    # -- host API ---------------------------------------------------------

    def _batch(self, a: np.ndarray, pinned: bool = False) -> torch.Tensor:
        """int64 ids on the device. ``pinned`` on the card: staged in pinned
        host memory and copied without blocking, on the current stream."""
        if pinned and self.device.type == "cuda":
            staged = torch.empty(a.shape, dtype=torch.int64, pin_memory=True)
            staged.numpy()[...] = a
            return staged.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(self.device)

    def _seq_chunk(self, input_ids: np.ndarray, labels: Optional[np.ndarray]) -> tuple:
        """Under sp, this rank's chunk of each sequence [..., T] of the ids,
        and of the next-token targets (the labels shifted by one, the
        global last position ignored), which the loss then takes unshifted:
        the last position of chunk r is scored against the first label of
        chunk r + 1, as the JAX loss's shift on the global arrays does."""
        if self._sp_n == 1:
            return input_ids, labels
        T = input_ids.shape[-1]
        if T % self._sp_n:
            raise ValueError(f"sequence {T} not divisible by sp={self._sp_n}")
        cut = slice(self._sp_r * (T // self._sp_n), (self._sp_r + 1) * (T // self._sp_n))
        if labels is not None:
            pad = np.full(labels.shape[:-1] + (1,), IGNORE, labels.dtype)
            labels = np.concatenate([labels[..., 1:], pad], axis=-1)[..., cut]
        return input_ids[..., cut], labels

    def shard_batch(self, input_ids: np.ndarray, labels: np.ndarray, accum: int, *, pinned: bool = False) -> dict:
        """[bs, T] host arrays -> [accum, bs / accum, T / sp] device tensors.
        Under a plan of several processes the arrays are this process's
        rows of the global batch (a dataloader that strides by batch block,
        as ``train()`` runs it; the JAX batch spec cuts each micro-batch the
        same way), whole sequences; under sp the trainer keeps its chunk
        (:meth:`_seq_chunk`). Issues no collective. ``pinned`` (the input
        prefetcher's): on the card the copies go from pinned host memory,
        without blocking, on the caller's current stream; the default
        copies synchronously."""
        gbs, seq = input_ids.shape
        if gbs % accum:
            raise ValueError(f"batch {gbs} not divisible by accum {accum}")
        ids, labels = self._seq_chunk(*(a.reshape(accum, gbs // accum, seq) for a in (input_ids, labels)))
        return {"input_ids": self._batch(ids, pinned), "labels": self._batch(labels, pinned)}

    def add_post_dispatch_hook(self, fn) -> None:
        """Register a ``state -> state`` callback fired after every
        ``train_step``."""
        self._post_dispatch_hooks.append(fn)

    def train_step(self, state: dict, batch: dict):
        tr = obs.tracer()
        if tr is None:
            state, metrics = self._train_step_impl(state, batch)
        else:
            # dispatch wall: the CUDA step runs on asynchronously, its
            # device time shows in train()'s step time
            t0 = tr.now()
            state, metrics = self._train_step_impl(state, batch)
            tr.add_span("inner/dispatch", t0, tr.now())
            tr.count("inner_steps")
        for hook in self._post_dispatch_hooks:
            state = hook(state)
        return state, metrics

    def eval_loss(self, params: dict, input_ids: np.ndarray, labels: np.ndarray) -> float:
        """The mean loss of a [bs, T] batch (this process's rows, as
        :meth:`shard_batch`), over the whole batch's counted tokens."""
        input_ids, labels = self._seq_chunk(input_ids, labels)
        batch = {"input_ids": self._batch(input_ids), "labels": self._batch(labels)}
        return float(self._eval_step_impl(params, batch))

    def probe_norms(self, params: dict, input_ids: np.ndarray) -> dict:
        aux = self._probe_step_impl(params, {"input_ids": self._batch(self._seq_chunk(input_ids, None)[0])})
        out = {
            f"activation_norm/layers.{i}.self_attn": float(v)
            for i, v in enumerate(aux["attn_out_norm"].cpu())
        }
        out["activation_norm/lm_head"] = float(aux["lm_head_norm"])
        return out

    def current_lr(self, step: int) -> float:
        return float(self.schedule(step))

