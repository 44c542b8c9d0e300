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
flash-chunk ring over the sp group, rope takes global positions, and the
loss pairs each position with the next token's label across chunk
boundaries (the global last position is dropped), summed over the data
group as the batch is. Over ep each rank holds ``E/ep`` experts of every
routed-expert leaf and the same tokens as its ep peers; the FFN sums its
partial combine over ep (:mod:`~opendiloco_torch.parallel.experts`), so
every replicated leaf's gradient is whole on each ep rank and is summed
over the data group only, never over ep.

At one process every collective is an identity and the step is the
single-device step bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from opendiloco_torch.device import DeviceLike, resolve_device
from opendiloco_torch.models.convert import params_from_numpy
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
from opendiloco_torch.parallel.experts import ExpertPlan
from opendiloco_torch.parallel.mesh import MeshPlan, params_sharded, single_device_plan
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
    that keeps the sequence chunks local); otherwise on the card the
    hand-written flash-attention kernels (the JAX package's "pallas" on a
    TPU), elsewhere the plain attention. scan_unroll resolves as the JAX
    package's does (full unroll for dense stacks of at most 16 layers on
    the card, else 1), and fused_loss=None follows it: on where the card
    runs the kernel attention without sp and the layer loop stays rolled
    (unroll < layers), as at config_1b's 22 layers and at every MoE
    config; off at config_150m and on the CPU. An explicit True or False
    passes through, on the CPU too, where the kernels' plain versions run."""
    if tc.attn_impl not in ("auto", "pallas", "xla", "ring"):
        raise ValueError(f"unknown attn_impl {tc.attn_impl!r}")
    on_card = device.type == "cuda"
    sp = plan is not None and plan.sp_axis is not None
    changes: dict = {}
    if tc.attn_impl == "auto":
        changes["attn_impl"] = "ring" if sp else ("pallas" if on_card else "xla")
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
        _maybe_remat(None, tc.remat)  # an unported policy raises here, not mid-step
        on_card = self.device.type == "cuda"
        if on_card and tc.compute_dtype == torch.float16 and (tc.attn_impl == "pallas" or tc.fused_loss):
            raise NotImplementedError(
                "precision='fp16-mixed' through the flash-attention and fused "
                "cross-entropy kernels is not ported (they take f32 and bf16; "
                "ROADMAP.md A7): use bf16-mixed, or attn_impl='xla' and fused_loss=False"
            )
        if plan.sp_axis and tc.attn_impl != "ring":
            raise ValueError(
                f"sp_size {plan.shape['sp']} cuts every sequence into chunks, and attn_impl={tc.attn_impl!r} "
                "would attend within a chunk only: use attn_impl 'ring' or 'auto'"
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
        self._dist = plan.mesh is not None
        if self._dist:
            import torch.distributed as dist

            # a CUDA run never drops to gloo
            want = "nccl" if self.device.type == "cuda" else "gloo"
            if dist.get_backend() != want:
                raise ValueError(f"a trainer on {self.device.type} runs its collectives over {want}, "
                                 f"not {dist.get_backend()!r}")
        self._fsdp_n, self._fsdp_r = plan.shape["fsdp"], plan.coord("fsdp")
        self._ep_n, self._ep_r = plan.shape["ep"], plan.coord("ep")
        self._sp_n, self._sp_r = plan.shape["sp"], plan.coord("sp")
        self._params_cut = params_sharded(plan.strategy)
        specs = param_specs(self.model_cfg, plan)
        self.param_dims = [spec_dim(x) for x in flatten_params(specs)]
        self.opt_dims = [spec_dim(x) for x in flatten_params(param_specs(self.model_cfg, plan, for_params=False))]
        # the expert dim, cut over ep in params and optimizer state alike
        self.ep_dims = [spec_dim(x, "ep") for x in flatten_params(specs)]
        # the resident params' layout (ZeRO-2 keeps them whole)
        self.resident_dims = self.param_dims if self._params_cut else [None] * len(self.param_dims)
        self._gather = ParamGather(specs, plan.group("fsdp")) if self._dist and self._params_cut else None
        self._batch_group = plan.batch_group() if self._dist and plan.data_size > 1 else None
        self._ring = DistRing(plan.group("sp")) if self._dist and self._sp_n > 1 else None
        self._experts = ExpertPlan(plan) if self._dist and self.model_cfg.num_experts else None
        ep_cut = self._dist and any(d is not None for d in self.ep_dims)
        # whether this rank holds blocks: of the params, of any state leaf
        self._params_blocked = ep_cut or (self._dist and self._params_cut and self._fsdp_n > 1)
        self._blocked = ep_cut or (self._dist and self._fsdp_n > 1)

    def _block(self, x, dim: Optional[int], ep_dim: Optional[int] = None):
        """This rank's block of a full leaf: of its expert dim over ep, then
        along ``dim`` over fsdp (a view; the leaf itself where neither cuts)."""
        return local_block(local_block(x, ep_dim, self._ep_n, self._ep_r), dim, self._fsdp_n, self._fsdp_r)

    def _whole(self, x: torch.Tensor, dim: Optional[int], ep_dim: Optional[int] = None) -> torch.Tensor:
        """A leaf cut along ``dim`` over fsdp and ``ep_dim`` over ep, joined
        (collectives); a whole leaf as it is. Detached."""
        x = x.detach()
        if not self._dist:
            return x
        from opendiloco_torch.parallel.comm import all_gather_dim

        if dim is not None and self._fsdp_n > 1:
            x = all_gather_dim(x, dim, self.plan.group("fsdp"))
        if ep_dim is not None and self._ep_n > 1:
            x = all_gather_dim(x, ep_dim, self.plan.group("ep"))
        return x

    def _opt_targets(self, leaves: list) -> list:
        """The param tensors AdamW updates: the leaves themselves, or under
        ZeRO-2 views of their optimizer-state blocks."""
        if self._params_cut:
            return list(leaves)
        return [self._block(p, d) for p, d in zip(leaves, self.opt_dims)]
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
        leaves = [self._block(p, d, e).detach().clone().requires_grad_(True)
                  for p, d, e in zip(flatten_params(params), self.resident_dims, self.ep_dims)]
        return unflatten_params(params, leaves)

    def gather_state(self, state: dict) -> dict:
        """The state with every leaf whole (params and AdamW moments
        gathered over fsdp, f32): a checkpoint's layout, which loads at any
        world size. A collective: every rank calls it. Returns ``state``
        itself when nothing is cut."""
        if not self._blocked:
            return state
        whole = lambda xs, dims: [self._whole(x, d, e) for x, d, e in zip(xs, dims, self.ep_dims)]
        opt = dict(state["opt_state"])
        opt["mu"], opt["nu"] = whole(opt["mu"], self.opt_dims), whole(opt["nu"], self.opt_dims)
        return {**state, "params": unflatten_params(state["params"], whole(flatten_params(state["params"]), self.resident_dims)),
                "opt_state": opt}

    def host_params(self, leaves: list, idx: Optional[list] = None) -> list[np.ndarray]:
        """Whole f32 host copies, owning their memory, of the resident
        param ``leaves`` (or of those at ``idx``): the outer loop's view of
        the params. A collective when the params are cut."""
        idx = range(len(leaves)) if idx is None else idx
        return [self._whole(leaves[i], self.resident_dims[i], self.ep_dims[i])
                .to("cpu", torch.float32, copy=True).numpy() for i in idx]

    def host_block(self, i: int, host_arr: np.ndarray) -> np.ndarray:
        """This rank's block of resident param leaf ``i`` from the whole
        host array (the array itself when the leaf is whole)."""
        return np.ascontiguousarray(self._block(host_arr, self.resident_dims[i], self.ep_dims[i]))

    @torch.no_grad()
    def scatter_state(self, full: dict) -> dict:
        """The inverse of :meth:`gather_state`: this rank's blocks of a
        state whose leaves are whole (a loaded checkpoint)."""
        if not self._blocked:
            return full
        params = self.local_params(full["params"])
        opt = dict(full["opt_state"])
        opt["mu"] = [self._block(x, d, e).clone() for x, d, e in zip(opt["mu"], self.opt_dims, self.ep_dims)]
        opt["nu"] = [self._block(x, d, e).clone() for x, d, e in zip(opt["nu"], self.opt_dims, self.ep_dims)]
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
        (the sharded entry over the plan's batch axes). Under sp the labels
        are already the next-token targets (:meth:`_seq_chunk`)."""
        d = hidden.shape[-1]
        if self._sp_n == 1:
            hidden, labels = hidden[:, :-1], labels[:, 1:]
        with span("loss.fused"):
            return fused_linear_cross_entropy_sharded(
                hidden.reshape(-1, d), head, labels.reshape(-1),
                mesh=self.plan if self._dist else None, batch_axes=self.plan.batch_axes, tp_axis=self.plan.tp_axis,
            )

    def _forward_kw(self, input_ids: torch.Tensor) -> dict:
        """The model's options on this rank: the ring, the expert plan and,
        under sp, the global positions of this rank's sequence chunk."""
        kw = dict(compute_dtype=self.tc.compute_dtype, attn_impl=self.tc.attn_impl, gather=self._gather,
                  ring_mesh=self._ring, experts=self._experts)
        if self._sp_n > 1:
            B, T = input_ids.shape
            kw["positions"] = torch.arange(self._sp_r * T, (self._sp_r + 1) * T, device=input_ids.device).expand(B, T)
        return kw

    def _loss_fn(self, params: dict, input_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        kw = dict(self._forward_kw(input_ids), remat=self.tc.remat, scan_unroll=self.tc.scan_unroll)
        moe = bool(self.model_cfg.num_experts)
        if self.tc.fused_loss:
            out = forward(params, input_ids, self.model_cfg, return_hidden=True, return_moe_aux=moe, **kw)
            loss = self._fused_lm_loss(out[0], out[1], labels)
        else:
            out = forward(params, input_ids, self.model_cfg, return_moe_aux=moe, **kw)
            loss = causal_lm_loss(out[0] if moe else out, labels, group=self._batch_group, shift=self._sp_n == 1)
        if moe:
            loss = loss + self.model_cfg.router_aux_coef * out[-1]
        return loss

    def _train_step_impl(self, state: dict, batch: dict):
        """batch tensors are [accum, mb, seq]."""
        params = state["params"]
        leaves = flatten_params(params)
        accum = batch["input_ids"].shape[0]
        scale = state["scaler"]["scale"]
        loss_sum, grad_sum = None, None
        for i in range(accum):
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
        state's layout."""
        from opendiloco_torch.parallel.comm import all_reduce_, reduce_scatter_dim

        plan, data = self.plan, self._batch_group
        if data is None:
            return grads  # no other rank holds distinct tokens
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
        return out

    def _sum_cut_squares(self, sq: list) -> list:
        """Each cut leaf's square summed over the fsdp group, then an expert
        leaf's over the ep group (one all-reduce of the per-leaf sums
        each); a replicated leaf's as it is."""
        from opendiloco_torch.parallel.comm import all_reduce_

        for dims, axis in ((self.opt_dims, "fsdp"), (self.ep_dims, "ep")):
            cut = [i for i, d in enumerate(dims) if d is not None]
            if cut and self.plan.shape[axis] > 1:
                summed = all_reduce_(torch.stack([sq[i] for i in cut]), self.plan.group(axis))
                for j, i in enumerate(cut):
                    sq[i] = summed[j]
        return sq

    @torch.no_grad()
    def _gather_updated(self, leaves: list, targets: list) -> None:
        """ZeRO-2: each rank updated its block of the whole params; gather
        the blocks back into every rank's copy (f32)."""
        if not self._dist or self._params_cut:
            return
        for p, t, d in zip(leaves, targets, self.opt_dims):
            if d is not None:
                p.copy_(self._whole(t, d))

    @torch.no_grad()
    def _eval_step_impl(self, params: dict, batch: dict) -> torch.Tensor:
        return self._loss_fn(params, batch["input_ids"], batch["labels"])

    @torch.no_grad()
    def _probe_step_impl(self, params: dict, batch: dict) -> dict:
        _, aux = forward(params, batch["input_ids"], self.model_cfg, remat=False, return_aux=True,
                         **self._forward_kw(batch["input_ids"]))
        if self._batch_group is not None:
            # L2 norms over the whole batch: the ranks' squares summed
            from opendiloco_torch.parallel.comm import all_reduce_

            aux = {k: torch.sqrt(all_reduce_(aux[k].float() ** 2, self._batch_group))
                   for k in ("attn_out_norm", "lm_head_norm")}
        return aux

    # -- host API ---------------------------------------------------------

    def _batch(self, a: np.ndarray) -> torch.Tensor:
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

    def shard_batch(self, input_ids: np.ndarray, labels: np.ndarray, accum: int) -> dict:
        """[bs, T] host arrays -> [accum, bs / accum, T / sp] device tensors.
        Under a plan of several processes the arrays are this process's
        rows of the global batch (a dataloader that strides by batch block,
        as ``train()`` runs it; the JAX batch spec cuts each micro-batch the
        same way), whole sequences; under sp the trainer keeps its chunk
        (:meth:`_seq_chunk`)."""
        gbs, seq = input_ids.shape
        if gbs % accum:
            raise ValueError(f"batch {gbs} not divisible by accum {accum}")
        ids, labels = self._seq_chunk(*(a.reshape(accum, gbs // accum, seq) for a in (input_ids, labels)))
        return {"input_ids": self._batch(ids), "labels": self._batch(labels)}

    def add_post_dispatch_hook(self, fn) -> None:
        """Register a ``state -> state`` callback fired after every
        ``train_step``."""
        self._post_dispatch_hooks.append(fn)

    def train_step(self, state: dict, batch: dict):
        state, metrics = self._train_step_impl(state, batch)
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

