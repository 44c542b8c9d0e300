"""Inner-loop trainer: one worker's train step on one device.

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
)
from opendiloco_torch.ops.fused_xent import fused_linear_cross_entropy_sharded


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
    # CPU; "pallas": the kernels (their plain versions on the CPU); "xla":
    # plain attention
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
    # clip: select(norm < max_norm, g, (g / norm) * max_norm)
    clip = grad_norm >= tc.max_grad_norm
    scaled = torch._foreach_div(g, grad_norm)
    torch._foreach_mul_(scaled, tc.max_grad_norm)
    g = [torch.where(clip, a, b) for a, b in zip(scaled, g)]
    del scaled
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


def global_norm(tensors: list) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x**2), as optax.global_norm."""
    total = None
    for t in tensors:
        sq = torch.sum(t * t)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _resolve_perf_defaults(
    tc: TrainerConfig, model_cfg: LlamaConfig, device: torch.device
) -> TrainerConfig:
    """Resolve attn_impl="auto" / fused_loss=None / scan_unroll=None.

    On the card "auto" takes the hand-written flash-attention kernels (the
    JAX package's "pallas" on a TPU); elsewhere the plain attention.
    scan_unroll resolves as the JAX package's does (full unroll for dense
    stacks of at most 16 layers on the card, else 1), and fused_loss=None
    follows it: on where the card runs the kernel attention and the layer
    loop stays rolled (unroll < layers), as at config_1b's 22 layers; off
    at config_150m and on the CPU. An explicit True or False passes
    through, on the CPU too, where the kernels' plain versions run."""
    if tc.attn_impl == "ring":
        raise NotImplementedError("ring attention is not ported yet (ROADMAP.md A14)")
    if tc.attn_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown attn_impl {tc.attn_impl!r}")
    on_card = device.type == "cuda"
    changes: dict = {}
    if tc.attn_impl == "auto":
        changes["attn_impl"] = "pallas" if on_card else "xla"
    if tc.scan_unroll is None:
        dense_shallow = not model_cfg.num_experts and model_cfg.num_hidden_layers <= 16
        changes["scan_unroll"] = model_cfg.num_hidden_layers if on_card and dense_shallow else 1
    if tc.fused_loss is None:
        attn = changes.get("attn_impl", tc.attn_impl)
        unroll = changes.get("scan_unroll", tc.scan_unroll) or 1
        changes["fused_loss"] = on_card and attn == "pallas" and unroll < model_cfg.num_hidden_layers
    return dataclasses.replace(tc, **changes)


class InnerTrainer:
    """Owns the optimizer and the train/eval steps of one worker on one
    device (the card unless ``device`` names another).

    state: {"params": f32 dict tree, "opt_state": see InnerOptimizer,
    "step": int, "scaler": {"scale": float, "good_steps": int}}
    """

    def __init__(self, model_cfg: LlamaConfig, tc: TrainerConfig, device: DeviceLike = None):
        self.device = resolve_device(device)
        tc = _resolve_perf_defaults(tc, model_cfg, self.device)
        _maybe_remat(None, tc.remat)  # an unported policy raises here, not mid-step
        on_card = self.device.type == "cuda"
        if on_card and tc.compute_dtype == torch.float16 and (tc.attn_impl == "pallas" or tc.fused_loss):
            raise NotImplementedError(
                "precision='fp16-mixed' through the flash-attention and fused "
                "cross-entropy kernels is not ported (they take f32 and bf16; "
                "ROADMAP.md A7): use bf16-mixed, or attn_impl='xla' and fused_loss=False"
            )
        if model_cfg.num_experts:
            raise NotImplementedError("routed-expert (MoE) training is not ported yet (ROADMAP.md A14)")
        self.model_cfg = model_cfg
        self.tc = tc
        self.optimizer = make_inner_optimizer(tc)
        self.schedule = make_schedule(tc)
        self._post_dispatch_hooks: list = []

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
        scale = self.tc.init_loss_scale if self.tc.use_loss_scaling else 1.0
        return {
            "params": params,
            "opt_state": self.optimizer.init(flatten_params(params)),
            "step": 0,
            "scaler": {"scale": float(scale), "good_steps": 0},
        }

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
        (one device, so the unsharded entry)."""
        d = hidden.shape[-1]
        return fused_linear_cross_entropy_sharded(
            hidden[:, :-1].reshape(-1, d), head, labels[:, 1:].reshape(-1), mesh=None
        )

    def _loss_fn(self, params: dict, input_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        kw = dict(
            compute_dtype=self.tc.compute_dtype,
            attn_impl=self.tc.attn_impl,
            remat=self.tc.remat,
            scan_unroll=self.tc.scan_unroll,
        )
        if self.tc.fused_loss:
            hidden, head = forward(params, input_ids, self.model_cfg, return_hidden=True, **kw)
            return self._fused_lm_loss(hidden, head, labels)
        return causal_lm_loss(forward(params, input_ids, self.model_cfg, **kw), labels)

    def _train_step_impl(self, state: dict, batch: dict):
        """batch tensors are [accum, mb, seq]."""
        params = state["params"]
        leaves = flatten_params(params)
        accum = batch["input_ids"].shape[0]
        scale = state["scaler"]["scale"]
        loss_sum, grad_sum = None, None
        for i in range(accum):
            loss = self._loss_fn(params, batch["input_ids"][i], batch["labels"][i]) * scale
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
            if grad_sum is None:
                loss_sum, grad_sum = loss, list(grads)
            else:
                loss_sum = loss_sum + loss
                torch._foreach_add_(grad_sum, grads)
            del grads
        inv = float(np.float32(1.0) / (np.float32(accum) * np.float32(scale)))
        torch._foreach_mul_(grad_sum, inv)
        loss = loss_sum * inv
        grad_norm = global_norm(grad_sum)

        scaler = state["scaler"]
        if self.tc.use_loss_scaling:
            # GradScaler semantics: on non-finite grads skip the update and
            # halve the scale; grow 2x after scale_growth_interval clean steps
            finite = bool(torch.isfinite(grad_norm))
            if finite:
                self.optimizer.update(grad_sum, state["opt_state"], leaves, grad_norm)
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
            self.optimizer.update(grad_sum, state["opt_state"], leaves, grad_norm)
            metrics = {"loss": loss, "grad_norm": grad_norm}
        new_state = {
            "params": params,
            "opt_state": state["opt_state"],
            "step": state["step"] + 1,
            "scaler": scaler,
        }
        return new_state, metrics

    @torch.no_grad()
    def _eval_step_impl(self, params: dict, batch: dict) -> torch.Tensor:
        return self._loss_fn(params, batch["input_ids"], batch["labels"])

    @torch.no_grad()
    def _probe_step_impl(self, params: dict, batch: dict) -> dict:
        _, aux = forward(
            params, batch["input_ids"], self.model_cfg,
            compute_dtype=self.tc.compute_dtype,
            attn_impl=self.tc.attn_impl,
            remat=False,
            return_aux=True,
        )
        return aux

    # -- host API ---------------------------------------------------------

    def _batch(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(self.device)

    def shard_batch(self, input_ids: np.ndarray, labels: np.ndarray, accum: int) -> dict:
        """[bs, T] host arrays -> [accum, bs / accum, T] device tensors."""
        gbs, seq = input_ids.shape
        if gbs % accum:
            raise ValueError(f"batch {gbs} not divisible by accum {accum}")
        shaped = lambda a: self._batch(a.reshape(accum, gbs // accum, seq))
        return {"input_ids": shaped(input_ids), "labels": shaped(labels)}

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
        batch = {"input_ids": self._batch(input_ids), "labels": self._batch(labels)}
        return float(self._eval_step_impl(params, batch))

    def probe_norms(self, params: dict, input_ids: np.ndarray) -> dict:
        aux = self._probe_step_impl(params, {"input_ids": self._batch(input_ids)})
        out = {
            f"activation_norm/layers.{i}.self_attn": float(v)
            for i, v in enumerate(aux["attn_out_norm"].cpu())
        }
        out["activation_norm/lm_head"] = float(aux["lm_head_norm"])
        return out

    def current_lr(self, step: int) -> float:
        return float(self.schedule(step))

