"""Functional Llama: the training forward and loss, prefill and paged
incremental decode.

The PyTorch counterpart of ``opendiloco_tpu/models/llama.py``. Parameters are a plain dict of tensors in the JAX layout:
per-layer weights stacked on a leading layer axis, linear weights
[in, out] (``x @ W``), so weights cross between the packages unchanged
(:mod:`opendiloco_torch.models.convert`). The JAX ``lax.scan`` over layers
is a Python loop here.

Dtype points follow the JAX package: RMS-norm variance in f32, rope in
x's dtype, attention scores in f32, logits in f32.

The training :func:`forward` routes attention through the hand-written
flash-attention kernels (``attn_impl="pallas"``, the JAX name kept so a
config carries over), the plain ``xla_attention`` (``"xla"``) or the
flash-chunk ring over a sequence cut into chunks (``"ring"``,
:mod:`~opendiloco_torch.ops.ring_attention`); under sp "xla" and
"pallas" attend over the whole sequence, gathered from the sp ranks
(``seq``, :func:`_attn_fn`). It checkpoints each layer
under ``remat=True`` (``torch.utils.checkpoint``, non-reentrant: the
backward reruns the layer's forward, kernels included) or, under
``remat="dots"``/``"dots_all"``, keeps the matmul and flash-forward
outputs and reruns the rest (:func:`_maybe_remat`). A config with
``num_experts > 0`` runs the Switch top-1 routed-expert FFN
(:func:`_switch_ffn`) in every layer. Under tensor parallelism (``tp``,
:class:`~opendiloco_torch.parallel.comm.TensorParallel`) a rank runs its
heads and FFN columns (Megatron: :func:`_tp_attention`, :func:`_tp_ffn`)
and looks up its rows of a vocab-cut embedding; under the pipeline each
stage runs its layers (:func:`stage_fn`,
:mod:`~opendiloco_torch.parallel.pipeline`).

For serving, ``kernels=True`` routes decode attention through the hand-written
paged-decode-attention kernel, the tail attention of the speculative
draft and verify passes and of the continued prefill through the
spec-tail-attention kernel, and every packed (``w4``) weight matmul
through the fused dequant-matmul kernel; on the CPU those wrappers take
their plain versions. ``kernels=False`` is the plain path, the JAX
package's ``decode_kernel="xla"``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from opendiloco_torch.device import resolve_device
from opendiloco_torch.ops.attention import decode_attention, spec_tail_attention, xla_attention
from opendiloco_torch.ops.decode_kernels import (
    paged_decode_attention,
    spec_tail_attention_fused,
    w4_matmul,
)
from opendiloco_torch.ops.flash_attention import FLASH_FWD_OP, flash_attention
from opendiloco_torch.ops.ring_attention import SOLO, ring_flash_attention
from opendiloco_torch.quant import dequant_w4
from opendiloco_torch.utils.spans import span


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Model hyperparameters, JSON-compatible with HF llama configs and
    with ``opendiloco_tpu.models.llama.LlamaConfig`` (same fields)."""

    vocab_size: int = 32_000
    hidden_size: int = 1024
    intermediate_size: int = 2688
    num_hidden_layers: int = 12
    num_attention_heads: int = 16
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    # routed experts: 0 = dense FFN; > 0 = Switch top-1 routed experts in
    # every layer (training only: the serving forwards take dense stacks)
    num_experts: int = 0
    expert_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json(cls, path: str) -> "LlamaConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "LlamaConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    def to_dict(self) -> dict[str, Any]:
        """The HF-shaped ``config.json`` body, as the JAX package writes it."""
        d = dataclasses.asdict(self)
        if d["num_key_value_heads"] is None:
            d["num_key_value_heads"] = self.num_attention_heads
        d.update(architectures=["LlamaForCausalLM"], model_type="llama", hidden_act="silu", use_cache=False)
        return d


def shapes(cfg: LlamaConfig) -> dict:
    """Shapes of the parameter dict (all f32 masters), JAX layout."""
    D, F_, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L, Nh, Nkv, Dh = (
        cfg.num_hidden_layers, cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim,
    )
    E = cfg.num_experts
    ffn = (
        {
            "router": (L, D, E),
            "gate_proj": (L, E, D, F_),
            "up_proj": (L, E, D, F_),
            "down_proj": (L, E, F_, D),
        }
        if E
        else {"gate_proj": (L, D, F_), "up_proj": (L, D, F_), "down_proj": (L, F_, D)}
    )
    tree = {
        "embed_tokens": (V, D),
        "layers": {
            "input_norm": (L, D),
            "post_attn_norm": (L, D),
            "q_proj": (L, D, Nh * Dh),
            "k_proj": (L, D, Nkv * Dh),
            "v_proj": (L, D, Nkv * Dh),
            "o_proj": (L, Nh * Dh, D),
            **ffn,
        },
        "final_norm": (D,),
    }
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = (D, V)
    return tree


def num_params(cfg: LlamaConfig) -> int:
    """The parameter count of the whole model (every leaf of :func:`shapes`)."""
    def count(tree) -> int:
        return sum(count(v) for v in tree.values()) if isinstance(tree, dict) else math.prod(tree)

    return count(shapes(cfg))


def init_params(
    generator: torch.Generator, cfg: LlamaConfig, *, device=None
) -> dict:
    """Fresh f32 weights: normal(0, initializer_range) for projections and
    embeddings, ones for norms. Drawn with ``generator`` on ``device``
    (default: the generator's device), leaf by leaf in sorted-key order."""
    dev = resolve_device(device) if device is not None else generator.device

    def make(name: str, shape):
        if isinstance(shape, dict):
            return {k: make(k, shape[k]) for k in sorted(shape)}
        if "norm" in name:
            return torch.ones(shape, dtype=torch.float32, device=dev)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.mul_(cfg.initializer_range)

    return make("", shapes(cfg))


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    # variance in float32 for stability (HF llama semantics)
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


def _rope_tables(
    positions: torch.Tensor, d: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [B, T, 1, D/2] float32 for the given positions, computed
    once per forward and shared by every layer's q and k."""
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d
    inv_freq = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * inv_freq  # [B, T, D/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate [B, T, H, D] by precomputed tables (HF half-rotation layout),
    in x's dtype."""
    c = cos.to(x.dtype)
    s = sin.to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over [B, T, H, D] with HF half-rotation layout."""
    cos, sin = _rope_tables(positions, x.shape[-1], theta)
    return _rope_apply(x, cos, sin)


# ---------------------------------------------------------------------------
# training: forward, loss, flattening
# ---------------------------------------------------------------------------

# rematerialization policy accepted everywhere a ``remat`` argument
# appears: False/"none" saves all activations; True/"full" checkpoints
# per layer; "dots" saves the matmul and flash-forward outputs and
# recomputes the elementwise chain; "dots_all" also saves batched products
RematPolicy = Union[bool, str]

# the ops whose outputs a selective policy keeps: the products without
# batch dims (the JAX package's dots_with_no_batch_dims_saveable) and B1's
# out and lse (its save_only_these_names("attn_out", "attn_lse"))
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, FLASH_FWD_OP)
# "dots_all" (dots_saveable): the batched products too, the plain
# attention's scores and weighted sums and the routed experts' einsums
_DOTS_ALL_SAVED = _DOTS_SAVED + (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _maybe_remat(block, remat: RematPolicy):
    """Apply the rematerialization policy to a per-layer block function.

    False/"none": keep every activation; True/"full": keep the block's
    inputs and rerun its forward in the backward, kernels included;
    "dots"/"dots_all": a selective checkpoint that keeps the outputs of
    the ops above and reruns the norms, rope and SwiGLU around them
    (``create_selective_checkpoint_contexts``), so B1 runs once a layer.
    Collectives inside the block (tp, fsdp gathers, the ring) rerun as
    under True. Every policy gives the same gradients bit for bit."""
    if remat in (False, None, "none"):
        return block
    if remat in (True, "full"):
        return lambda *args: checkpoint(block, *args, use_reentrant=False)
    if remat in ("dots", "dots_all"):
        saved = list(_DOTS_ALL_SAVED if remat == "dots_all" else _DOTS_SAVED)
        contexts = functools.partial(create_selective_checkpoint_contexts, saved)
        return lambda *args: checkpoint(block, *args, use_reentrant=False, context_fn=contexts)
    raise ValueError(f"unknown remat policy {remat!r}")


def _switch_ffn(cfg: LlamaConfig, x: torch.Tensor, layer: dict, experts=None,
                stats: Optional[list] = None, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Switch-Transformer top-1 routed expert FFN -> (out, aux loss), the
    JAX function's form: router logits in f32, top-1 by argmax, capacity
    ``ceil(N / E * capacity_factor)``, a token's slot the cumsum of the
    one-hot over the token order, dense [N, E, C] dispatch and combine,
    and over-capacity tokens passed through by the residual only.

    ``experts`` (a :class:`~opendiloco_torch.parallel.experts.ExpertPlan`)
    means x holds this rank's tokens of a batch cut over a process group
    and ``layer`` this rank's block of the experts: N is the global token
    count, the slots and the load-balance means are the global ones, and
    the partial combine is summed over ep. ``stats`` gets this rank's
    count of tokens dropped by capacity. Under ``tp`` (a
    :class:`~opendiloco_torch.parallel.comm.TensorParallel`) the expert
    leaves hold this rank's columns of F where tp divides it: the experts'
    input enters the region and their outputs are summed over tp before
    the combine; routing is the same on every tp rank."""
    B, T, D = x.shape
    E = cfg.num_experts
    N = B * T
    xf = x.reshape(N, D)
    logits = (xf @ layer["router"]).float()  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    expert = probs.argmax(dim=-1)  # [N]
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, E).float()  # [N, E]
    if experts is None:
        n_all = N
        density, density_proxy = onehot.mean(dim=0), probs.mean(dim=0)
        pos = torch.cumsum(onehot, dim=0) * onehot - 1.0  # slot within expert
    else:
        ids, b0, t0 = experts.global_expert_ids(expert.reshape(B, T))
        n_all = ids.numel()
        onehot_all = F.one_hot(ids.reshape(-1), E).float()
        pos = (torch.cumsum(onehot_all, dim=0) * onehot_all - 1.0).reshape(*ids.shape, E)
        pos = pos[b0:b0 + B, t0:t0 + T].reshape(N, E)
        density = onehot_all.mean(dim=0)
        density_proxy = experts.sum_data(probs.sum(dim=0)) / n_all
    # load-balance aux (Switch eq. 4): density * router-probability mass
    aux = E * torch.sum(density * density_proxy)
    if experts is not None:
        aux = experts.mean_chunks(aux)
    cap = max(1, math.ceil(n_all / E * cfg.expert_capacity_factor))
    if stats is not None:
        stats.append((pos >= cap).sum())
    e0, n_local = (0, E) if experts is None else experts.local_experts(E)
    pos = pos[:, e0:e0 + n_local]
    # -1 (not routed here) and >= cap (over capacity) dispatch nowhere
    keep = (pos >= 0) & (pos < cap)
    slot = torch.where(keep, pos, torch.zeros_like(pos)).long()
    d = torch.zeros((N, n_local, cap), dtype=x.dtype, device=x.device)
    d.scatter_(2, slot[..., None], keep[..., None].to(x.dtype))  # [N, E, C]
    if experts is not None:
        xf, gate = experts.to_experts(xf, gate)
    expert_in = torch.einsum("nec,nd->ecd", d, xf)  # [E, C, D]
    cut = tp is not None and cfg.intermediate_size % tp.size == 0
    if cut:
        expert_in = tp.copy(expert_in)
    h1 = F.silu(torch.einsum("ecd,edf->ecf", expert_in, layer["gate_proj"])) * torch.einsum(
        "ecd,edf->ecf", expert_in, layer["up_proj"])
    out_e = torch.einsum("ecf,efd->ecd", h1, layer["down_proj"])
    if cut:
        out_e = tp.reduce(out_e)
    combine = d * gate.to(x.dtype)[:, None, None]
    y = torch.einsum("nec,ecd->nd", combine, out_e)
    if experts is not None:
        y = experts.from_experts(y)
    return y.reshape(B, T, D), aux


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, q0: int, hl: int, group: int) -> tuple:
    """The kv heads that q heads [q0, q0 + hl) of a GQA layer attend with
    (``group`` q heads a kv head) where tp does not divide the kv heads, as
    kernel operands: one kv head when the rank's q heads lie inside one
    group, else one kv head per q head."""
    if group % hl == 0:
        return k[:, :, q0 // group:q0 // group + 1], v[:, :, q0 // group:q0 // group + 1]
    idx = torch.arange(q0, q0 + hl, device=k.device) // group
    return k[:, :, idx], v[:, :, idx]


def _tp_attention(cfg: LlamaConfig, attn_fn, x: torch.Tensor, layer: dict, rope: tuple, tp) -> torch.Tensor:
    """Attention and o_proj on a tp rank, summed over tp (Megatron). q/k/v
    hold the rank's columns where tp divides them (the JAX specs), o_proj
    the matching rows. Where tp divides the q heads the rank attends with
    its own: its kv heads when tp divides those too, else the kv heads its
    q heads need out of k and v gathered over tp (JAX's
    ``flash_attention_sharded`` replicates them into the kernel's region).
    Where it does not, every rank attends with all heads and multiplies its
    rows' slice of the output. A tensor a rank uses only in part enters
    through ``tp.copy`` or a partial gather, so that every gradient that
    leaves the block is whole and the same on every rank."""
    B, T, _ = x.shape
    Nh, Nkv, Dh = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    n, r = tp.size, tp.rank
    cos, sin = rope
    q_cut, kv_cut = (Nh * Dh) % n == 0, (Nkv * Dh) % n == 0
    xc = tp.copy(x)

    def whole(name: str, cut: bool) -> torch.Tensor:  # all columns, for partial consumers
        return tp.gather(xc @ layer[name], -1, partial=True) if cut else tp.copy(x @ layer[name])

    with span("llama.qkv"):
        if q_cut and Nh % n == 0:
            hl = Nh // n
            q = (xc @ layer["q_proj"]).reshape(B, T, hl, Dh)
            if kv_cut and Nkv % n == 0:
                k = (xc @ layer["k_proj"]).reshape(B, T, Nkv // n, Dh)
                v = (xc @ layer["v_proj"]).reshape(B, T, Nkv // n, Dh)
            else:
                k = whole("k_proj", kv_cut).reshape(B, T, Nkv, Dh)
                v = whole("v_proj", kv_cut).reshape(B, T, Nkv, Dh)
                k, v = (t.contiguous() for t in _kv_for_heads(k, v, r * hl, hl, Nh // Nkv))
            rows = None
        else:
            q = whole("q_proj", q_cut).reshape(B, T, Nh, Dh)
            k = whole("k_proj", kv_cut).reshape(B, T, Nkv, Dh)
            v = whole("v_proj", kv_cut).reshape(B, T, Nkv, Dh)
            lo, hi = (r * Nh * Dh) // n, ((r + 1) * Nh * Dh) // n  # this rank's rows of o_proj
            rows = (lo, hi)
    with span("llama.rope"):
        q = _rope_apply(q, cos, sin)
        k = _rope_apply(k, cos, sin)
    with span("llama.attention"):
        attn = attn_fn(q, k, v).reshape(B, T, -1)
    with span("llama.o_proj"):
        if rows is None:
            out = attn @ layer["o_proj"]
        else:
            w = layer["o_proj"] if q_cut else tp.copy(layer["o_proj"])[rows[0]:rows[1]]
            out = attn[..., rows[0]:rows[1]] @ w
        return tp.reduce(out)


def _tp_ffn(cfg: LlamaConfig, x: torch.Tensor, layer: dict, tp) -> torch.Tensor:
    """The SwiGLU FFN on a tp rank: its columns of gate/up and rows of down
    where tp divides the FFN dim, the partial products summed over tp; the
    whole FFN on every rank otherwise."""
    if cfg.intermediate_size % tp.size:
        return (F.silu(x @ layer["gate_proj"]) * (x @ layer["up_proj"])) @ layer["down_proj"]
    xc = tp.copy(x)
    act = F.silu(xc @ layer["gate_proj"]) * (xc @ layer["up_proj"])
    return tp.reduce(act @ layer["down_proj"])


def _decoder_block(
    cfg: LlamaConfig, attn_fn, h: torch.Tensor, layer: dict, rope: tuple, probe: bool, ffn_fn=None, tp=None
) -> tuple:
    """Returns (hidden, attn-output L2 norm or None, moe aux or None). The
    norm is the activation probe the reference attaches to ``self_attn``;
    it is computed only when ``probe`` is set (under tp on the summed
    output). ``ffn_fn(x, layer) -> (out, aux)`` replaces the dense FFN (the
    routed experts). ``tp``: this rank's heads and FFN columns
    (:func:`_tp_attention`, :func:`_tp_ffn`)."""
    B, T, _ = h.shape
    Nh, Nkv, Dh = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    cos, sin = rope
    with span("llama.attn_norm"):
        x = _rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
    if tp is not None:
        attn_out = _tp_attention(cfg, attn_fn, x, layer, rope, tp)
    else:
        with span("llama.qkv"):
            q = (x @ layer["q_proj"]).reshape(B, T, Nh, Dh)
            k = (x @ layer["k_proj"]).reshape(B, T, Nkv, Dh)
            v = (x @ layer["v_proj"]).reshape(B, T, Nkv, Dh)
        with span("llama.rope"):
            q = _rope_apply(q, cos, sin)
            k = _rope_apply(k, cos, sin)
        with span("llama.attention"):
            attn = attn_fn(q, k, v)
        with span("llama.o_proj"):
            attn_out = attn.reshape(B, T, Nh * Dh) @ layer["o_proj"]
    attn_norm = torch.sqrt(torch.sum(attn_out.float() ** 2)) if probe else None
    with span("llama.attn_residual"):
        h = h + attn_out
    with span("llama.ffn_norm"):
        x = _rms_norm(h, layer["post_attn_norm"], cfg.rms_norm_eps)
    if ffn_fn is not None:
        with span("llama.moe"):
            ffn, aux = ffn_fn(x, layer)
        with span("llama.ffn_residual"):
            return h + ffn, attn_norm, aux
    if tp is not None:
        with span("llama.ffn"):
            ffn = _tp_ffn(cfg, x, layer, tp)
        with span("llama.ffn_residual"):
            return h + ffn, attn_norm, None
    with span("llama.gate_up"):
        gate, up = x @ layer["gate_proj"], x @ layer["up_proj"]
    with span("llama.swiglu"):
        act = F.silu(gate) * up
    del gate, up  # not live at the down product
    with span("llama.down"):
        ffn = act @ layer["down_proj"]
    with span("llama.ffn_residual"):
        return h + ffn, attn_norm, None


def _attn_fn(attn_impl: str, ring=None, seq=None):
    """The attention of a block. ``seq`` (a
    :class:`~opendiloco_torch.parallel.comm.TensorParallel` over sp): a
    rank holds a chunk of each sequence and attends over the whole, as
    every device of the JAX package's sp mesh does under "xla" and
    "pallas" (and under sp + pp's activation-sharding mode): the roped q,
    k and v are gathered over sp (each rank uses its chunk's rows of the
    output: partial gathers, whose backward reduce-scatters) and the rank
    keeps its chunk of the output."""
    if attn_impl == "xla":
        fn = lambda q, k, v: xla_attention(q, k, v, causal=True)
    elif attn_impl == "pallas":
        fn = lambda q, k, v: flash_attention(q, k, v, causal=True)
    elif attn_impl == "ring":
        ring = SOLO if ring is None else ring
        return lambda q, k, v: ring_flash_attention(q, k, v, ring)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    if seq is None:
        return fn

    def whole_sequence(q, k, v):
        T = q.shape[1]
        out = fn(*(seq.gather(t, 1, partial=True) for t in (q, k, v)))
        return out.narrow(1, seq.rank * T, T)

    return whole_sequence


def run_layers(cfg: LlamaConfig, layers: dict, h: torch.Tensor, positions: torch.Tensor, *,
               compute_dtype: torch.dtype, attn_fn, ffn_fn=None, remat: RematPolicy = True, probe: bool = False,
               gather=None, tp=None) -> tuple:
    """The stacked layer leaves ``layers`` ([L', ...]: the whole stack, or a
    pipeline stage's) over ``h`` at ``positions``: (h, the attn-output
    norms (None unless ``probe``), the MoE aux of each layer (None for a
    dense stack)). The f32 leaves are cast to ``compute_dtype`` here; under
    ``gather`` (FULL_SHARD/HYBRID_SHARD blocks) each layer's weights are
    gathered inside its block when it runs (again on recompute under
    ``remat``), never the whole stack."""
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    names = sorted(layers)
    if gather is None:
        with span("llama.cast_params"):
            stacks = {n: layers[n].to(compute_dtype) for n in names}

        def block(h, *weights):
            return _decoder_block(cfg, attn_fn, h, dict(zip(names, weights)), rope, probe, ffn_fn, tp)
    else:
        with span("llama.layer_params"):  # one unbind a stack, not a slice per use
            stacks = {n: layers[n].unbind(0) for n in names}

        def block(h, *blocks):
            with span("llama.gather_params"):
                weights = gather.layer(names, list(blocks), compute_dtype)
            return _decoder_block(cfg, attn_fn, h, dict(zip(names, weights)), rope, probe, ffn_fn, tp)

    block = _maybe_remat(block, remat)
    norms, auxs = [], []
    for i in range(layers[names[0]].shape[0]):
        with span("llama.layer_params"):  # layer i's slices of the stacked weights
            weights = [stacks[n][i] for n in names]
        h, norm, aux = block(h, *weights)
        norms.append(norm)
        auxs.append(aux)
    return h, norms, auxs


def _cast_top(params: dict, compute_dtype: torch.dtype, gather) -> dict:
    """The leaves outside the stack in the compute dtype (gathered over
    fsdp under ``gather``)."""
    with span("llama.gather_params" if gather is not None else "llama.cast_params"):
        if gather is not None:
            return {k: gather(k, v, compute_dtype) for k, v in params.items() if k != "layers"}
        return {k: v.to(compute_dtype) for k, v in params.items() if k != "layers"}


def embed(cparams: dict, input_ids: torch.Tensor, cfg: LlamaConfig, tp=None) -> torch.Tensor:
    """The embedding rows of ``input_ids``: a vocab-parallel lookup where
    tp cuts the table's vocab."""
    with span("llama.embed"):
        if tp is not None and cfg.vocab_size % tp.size == 0:
            return tp.embed(cparams["embed_tokens"], input_ids)
        return cparams["embed_tokens"][input_ids]


def stage_fn(params: dict, cfg: LlamaConfig, *, compute_dtype: torch.dtype, attn_fn, ffn_fn=None,
             remat: RematPolicy = True, probe: bool = False, gather=None, tp=None):
    """A pipeline stage: ``(x, positions) -> (y, MoE aux summed over the
    stage's layers or None, attn-output norms)`` through the stacked layer
    leaves of ``params`` (this stage's L/pp layers)."""

    def run(x: torch.Tensor, positions: torch.Tensor) -> tuple:
        y, norms, auxs = run_layers(cfg, params["layers"], x, positions, compute_dtype=compute_dtype,
                                    attn_fn=attn_fn, ffn_fn=ffn_fn, remat=remat, probe=probe, gather=gather, tp=tp)
        aux = torch.stack(auxs).sum() if cfg.num_experts else None
        return y, aux, norms

    return run


def forward(
    params: dict,
    input_ids: torch.Tensor,
    cfg: LlamaConfig,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "xla",
    remat: RematPolicy = True,
    positions: Optional[torch.Tensor] = None,
    return_aux: bool = False,
    return_hidden: bool = False,
    ring_mesh=None,
    pp_mesh=None,
    pp_microbatches: Optional[int] = None,
    return_moe_aux: bool = False,
    scan_unroll: Optional[int] = None,
    gather=None,
    experts=None,
    moe_stats: Optional[list] = None,
    tp=None,
    seq=None,
):
    """input_ids [B, T] int -> logits [B, T, V] float32.

    ``attn_impl`` "pallas" runs the flash-attention kernels (their plain
    versions on the CPU), "xla" the plain attention, "ring" the flash-chunk
    ring over ``ring_mesh`` (a ring of
    :mod:`~opendiloco_torch.ops.ring_attention`: ``input_ids`` and
    ``positions`` are then this rank's chunk of the sequence; without a
    ring, one causal chunk). return_hidden=True returns (final_hidden
    [B, T, D], head [D, V]) instead of logits, and with
    return_moe_aux=True (final_hidden, head, moe_aux); return_moe_aux=True
    alone returns (logits, moe_aux), the routers' aux loss averaged over
    the layers (0 for a dense stack). return_aux=True also returns the
    activation probes {"attn_out_norm": [L], "lm_head_norm": scalar,
    "moe_aux": scalar}.

    The f32 params are cast to ``compute_dtype`` here, inside the autograd
    graph, so gradients arrive in f32 at the f32 leaves. ``scan_unroll``
    is accepted for the JAX signature and has no effect: the layers are a
    Python loop.

    ``gather`` (a :class:`~opendiloco_torch.parallel.sharding.ParamGather`)
    means ``params`` hold this rank's blocks of a FULL_SHARD or
    HYBRID_SHARD layout (:func:`run_layers`). ``experts`` (an
    :class:`~opendiloco_torch.parallel.experts.ExpertPlan`) means the batch
    and the expert leaves are cut over a process group (:func:`_switch_ffn`);
    ``moe_stats`` (a list) gets each layer's count of tokens dropped by
    capacity. ``tp`` (a
    :class:`~opendiloco_torch.parallel.comm.TensorParallel`) means the
    params hold this rank's tp blocks: the blocks run on its heads and FFN
    columns, the embedding is vocab-parallel, the logits come from the head
    gathered over tp, and ``return_hidden`` hands back this rank's block of
    the head ([D, V/tp]; the fused loss gathers it). ``seq``: see
    :func:`_attn_fn`.

    ``pp_mesh`` (a comm over the pp axis,
    :meth:`~opendiloco_torch.parallel.mesh.MeshPlan.comm`) means the params
    hold this stage's layers: the decoder stack runs as the GPipe schedule
    over ``pp_microbatches`` micro-batches (default the pp size;
    :mod:`~opendiloco_torch.parallel.pipeline`), and the last stage's final
    hidden states are broadcast to every stage, as the JAX pipeline's
    masked psum replicates them; the attn-output norms of every stage are
    gathered. This entry is the pipelined forward without gradients (eval,
    probes): the training step runs the schedule's backward
    (``InnerTrainer``)."""
    del scan_unroll
    B, T = input_ids.shape
    if positions is None:
        positions = torch.arange(T, device=input_ids.device).expand(B, T)
    attn_fn = _attn_fn(attn_impl, ring_mesh, seq)
    ffn_fn = None
    if cfg.num_experts:
        ffn_fn = lambda x, layer: _switch_ffn(cfg, x, layer, experts, moe_stats, tp)
    cparams = _cast_top(params, compute_dtype, gather)
    h = embed(cparams, input_ids, cfg, tp)
    kw = dict(compute_dtype=compute_dtype, attn_fn=attn_fn, ffn_fn=ffn_fn, remat=remat, probe=return_aux,
              gather=gather, tp=tp)
    if pp_mesh is not None:
        h, attn_norms, moe_aux = _pipelined(params, h, positions, cfg, pp_mesh, pp_microbatches, kw)
    else:
        h, attn_norms, layer_auxs = run_layers(cfg, params["layers"], h, positions, **kw)
        moe_aux = torch.stack(layer_auxs).mean() if cfg.num_experts else torch.zeros((), device=h.device)
        attn_norms = torch.stack(attn_norms) if return_aux else None
    with span("llama.final_norm"):
        h = _rms_norm(h, cparams["final_norm"], cfg.rms_norm_eps)
    head = _head(cparams, cfg)
    if return_hidden:
        return (h, head, moe_aux) if return_moe_aux else (h, head)
    if tp is not None and cfg.vocab_size % tp.size == 0:
        head = tp.gather(head, 1, partial=False)
    with span("llama.lm_head"):
        logits = (h @ head).float()
    if return_aux:
        return logits, {
            "attn_out_norm": attn_norms,
            "lm_head_norm": torch.sqrt(torch.sum(logits**2)),
            "moe_aux": moe_aux,
        }
    if return_moe_aux:
        return logits, moe_aux
    return logits


def _pipelined(params: dict, h0: torch.Tensor, positions: torch.Tensor, cfg: LlamaConfig, pp, microbatches,
               kw: dict) -> tuple:
    """The no-gradient pipelined stack of :func:`forward`: (the final
    hidden states on every stage, the attn-output norms of every layer or
    None, the MoE aux averaged over layers and micro-batches)."""
    from opendiloco_torch.parallel.pipeline import pipeline_hidden

    if torch.is_grad_enabled() and any(p.requires_grad for p in flatten_params(params)):
        raise ValueError("forward(pp_mesh=...) runs the pipeline without gradients (eval, probes); a training "
                         "step runs the schedule's backward through InnerTrainer: call it under torch.no_grad()")
    M = microbatches or pp.size
    with torch.no_grad():
        run = pipeline_hidden(stage_fn(params, cfg, **kw), h0, positions, pp, microbatches=M, grad=False)
        h = run.hidden if run.hidden is not None else torch.empty_like(h0)
        h = pp.broadcast(h, pp.size - 1)
        norms = None
        if kw["probe"]:
            # a layer's norm over the whole batch: the micro-batches' squares summed
            local = torch.stack([torch.sqrt(sum(run.norms[m][i] ** 2 for m in range(M)))
                                 for i in range(len(run.norms[0]))])
            norms = pp.all_gather(local, 0)
        moe_aux = torch.zeros((), device=h.device)
        if cfg.num_experts:
            moe_aux = pp.all_reduce(torch.stack(run.auxs).sum()) / (cfg.num_hidden_layers * M)
    return h, norms, moe_aux


def causal_lm_loss(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100, *, group=None, shift: bool = True
) -> torch.Tensor:
    """Shifted next-token cross-entropy, mean over non-ignored targets
    (HF CausalLM loss semantics). With ``group`` the rows are this rank's
    share of a batch cut over the group: the sum and the count are summed
    over it before the division (the mean over the whole batch), and each
    rank's gradient is its own rows' share. ``shift=False``: ``labels``
    are already the next-token targets of each position (a chunk of a
    sequence cut over sp, whose last target lies in the next chunk)."""
    with span("loss.causal_lm"):
        shift_logits = logits[:, :-1] if shift else logits
        shift_labels = labels[:, 1:] if shift else labels
        mask = shift_labels != ignore_index
        safe_labels = torch.where(mask, shift_labels, torch.zeros_like(shift_labels))
        logp = torch.log_softmax(shift_logits, dim=-1)
        nll = -torch.gather(logp, -1, safe_labels[..., None].long())[..., 0]
        total = torch.sum(nll * mask)
        count = torch.sum(mask)
        if group is not None:
            from opendiloco_torch.parallel.comm import all_reduce_, sum_over

            total, count = sum_over(total, group), all_reduce_(count, group)
        return total / torch.clamp(count, min=1)


def flatten_params(tree: dict) -> list:
    """Leaves in ``jax.tree.flatten`` order (keys sorted at every level),
    the order of the DiLoCo master list and of the outer all-reduce."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(flatten_params(v) if isinstance(v, dict) else [v])
    return out


def unflatten_params(template: dict, leaves: list) -> dict:
    """The inverse of :func:`flatten_params` against a template tree."""
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it) for k in sorted(node)}

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


# ---------------------------------------------------------------------------
# serving: prefill / incremental decode over a slot-paged ring KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedW4:
    """A matmul weight held blockwise-4-bit packed at rest (serve
    ``weight_format="w4"``): ``q`` [L, ceil(n/2)] uint8 packed nibbles and
    ``s`` [L, nblocks] int16 fp16-bit scales per ``W4_BLOCK`` values, per
    layer, as :func:`opendiloco_torch.quant.pack_blockwise4_stacked` makes
    them. ``shape`` is the per-layer unpacked shape. Indexing by layer
    gives that layer's packed weight."""

    q: torch.Tensor
    s: torch.Tensor
    shape: tuple

    def __getitem__(self, layer: int) -> "PackedW4":
        return PackedW4(self.q[layer], self.s[layer], self.shape)


def _wmul(x: torch.Tensor, w, dtype: torch.dtype, kernels: bool = True) -> torch.Tensor:
    """One weight-matmul site: ``x @ W``. A packed weight goes through the
    fused dequant-matmul when ``kernels`` is set (on the card a shape the
    kernel cannot take raises there); otherwise it is dequantized to
    ``dtype`` first. Dense weights are already in the compute dtype
    (``_cast_serving_params``)."""
    if isinstance(w, PackedW4):
        if kernels:
            lead = x.shape[:-1]
            out = w4_matmul(x.reshape(-1, x.shape[-1]), w.q, w.s, w.shape, dtype)
            return out.reshape(*lead, w.shape[1])
        return x @ dequant_w4(w.q, w.s, w.shape, dtype)
    return x @ w


def _cast_serving_params(params: dict, dtype: torch.dtype) -> dict:
    """The forward-boundary cast, w4-aware: packed leaves stay packed
    (their dequant targets ``dtype`` at the matmul site). A leaf already
    in ``dtype`` is returned as is, so a pre-cast dict costs nothing."""
    if isinstance(params, dict):
        return {k: _cast_serving_params(v, dtype) for k, v in params.items()}
    if isinstance(params, PackedW4):
        return params
    return params.to(dtype)


def init_kv_cache(
    cfg: LlamaConfig,
    num_slots: int,
    max_context: int,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> dict:
    """Zeroed {"k", "v"} ring pages [L, S, T, Nkv, Dh]: one fixed-size page
    per batch slot. Writes wrap at T, so a sequence that outgrows its page
    keeps decoding with sliding-window attention over the last T tokens."""
    shape = (cfg.num_hidden_layers, num_slots, max_context, cfg.kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _require_dense(cfg: LlamaConfig, what: str) -> None:
    if cfg.num_experts:
        raise NotImplementedError(f"{what} supports dense FFN stacks only")


def _layer(layers: dict, i: int) -> dict:
    return {k: w[i] for k, w in layers.items()}


def _head(cparams: dict, cfg: LlamaConfig) -> torch.Tensor:
    return cparams["embed_tokens"].T if cfg.tie_word_embeddings else cparams["lm_head"]


def _ffn(x: torch.Tensor, layer: dict, cd: torch.dtype, kernels: bool) -> torch.Tensor:
    gate = F.silu(_wmul(x, layer["gate_proj"], cd, kernels))
    return _wmul(gate * _wmul(x, layer["up_proj"], cd, kernels), layer["down_proj"], cd, kernels)


def _serve_layer(h, layer, cfg: LlamaConfig, cos, sin, cd: torch.dtype, kernels: bool, attend):
    """One decoder layer of the serving forwards over h [B, T, D]: the q,
    k, v projections and rope, ``attend(q, k, v)`` -> [B, T, H, Dh] (which
    may write the ring first), the o projection and the FFN, each with its
    residual. Returns (h, k, v)."""
    B, T = h.shape[:2]
    Nh, Nkv, Dh = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    x = _rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
    q = _wmul(x, layer["q_proj"], cd, kernels).reshape(B, T, Nh, Dh)
    k = _wmul(x, layer["k_proj"], cd, kernels).reshape(B, T, Nkv, Dh)
    v = _wmul(x, layer["v_proj"], cd, kernels).reshape(B, T, Nkv, Dh)
    q = _rope_apply(q, cos, sin)
    k = _rope_apply(k, cos, sin)
    attn = attend(q, k, v)
    h = h + _wmul(attn.reshape(B, T, Nh * Dh), layer["o_proj"], cd, kernels)
    x = _rms_norm(h, layer["post_attn_norm"], cfg.rms_norm_eps)
    return h + _ffn(x, layer, cd, kernels), k, v


@torch.no_grad()
def prefill_forward(
    params: dict,
    input_ids: torch.Tensor,
    length: int,
    cfg: LlamaConfig,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    kernels: bool = True,
):
    """Prompt prefill: ids [1, P] -> (last-token logits [1, V] f32,
    per-layer K/V [L, P, Nkv, Dh] in the compute dtype).

    ``length`` is the true prompt length; ``input_ids`` may be right-padded
    to a bucket. Padding K/V rows land in the returned stack (and the
    cache) but are never attended: the decode mask stops at the live
    length, and every ring write overwrites index ``len % T`` before index
    ``len`` becomes visible."""
    _require_dense(cfg, "prefill_forward")
    B, P = input_ids.shape
    cd = compute_dtype
    cparams = _cast_serving_params(params, cd)
    positions = torch.arange(P, device=input_ids.device).expand(B, P)
    cos, sin = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    h = cparams["embed_tokens"][input_ids]
    ks, vs = [], []
    for i in range(cfg.num_hidden_layers):
        h, k, v = _serve_layer(h, _layer(cparams["layers"], i), cfg, cos, sin, cd, kernels,
                               lambda q, k, v: xla_attention(q, k, v, causal=True))
        ks.append(k[0])
        vs.append(v[0])
    h_last = _rms_norm(h[:, length - 1 : length], cparams["final_norm"], cfg.rms_norm_eps)
    logits = (h_last @ _head(cparams, cfg)).float()
    return logits[:, 0], torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def cache_insert(
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    ks: torch.Tensor,
    vs: torch.Tensor,
    slot: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a prefilled sequence's K/V [L, P, Nkv, Dh] into ``slot`` of the
    cache [L, S, T, Nkv, Dh] at ring positions [0, P). Stale rows of a
    previous tenant beyond P stay masked until decode's ring writes reach
    them. The JAX package donates the cache to this update; the port
    writes in place and returns the same tensors."""
    P = ks.shape[1]
    if P > cache_k.shape[2]:
        raise ValueError(f"prefill length {P} exceeds slot context {cache_k.shape[2]}")
    cache_k[:, slot, :P] = ks.to(cache_k.dtype)
    cache_v[:, slot, :P] = vs.to(cache_v.dtype)
    return cache_k, cache_v


@torch.no_grad()
def decode_forward(
    params: dict,
    tokens: torch.Tensor,
    lens: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cfg: LlamaConfig,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    kernels: bool = True,
):
    """One incremental decode step over all S slots.

    tokens [S] int are each slot's current input token; lens [S] int32 are
    the token counts already cached (== the new token's position);
    cache_{k,v} are [L, S, T, Nkv, Dh]. Returns (logits [S, V] f32,
    cache_k, cache_v): the new K/V is written at ring index ``lens % T``
    and attention covers the last ``min(lens + 1, T)`` positions. Where
    the JAX package donates the caches, the port writes them in place."""
    _require_dense(cfg, "decode_forward")
    S = tokens.shape[0]
    L, _, T = cache_k.shape[:3]
    cd = compute_dtype
    cparams = _cast_serving_params(params, cd)
    lens = lens.to(torch.int32)
    cos, sin = _rope_tables(lens[:, None], cfg.head_dim, cfg.rope_theta)
    rows = torch.arange(S, device=tokens.device)
    write_idx = torch.remainder(lens, T).long()

    def attend(q, k, v, ck, cv):  # ck/cv: one layer's ring views [S, T, Nkv, Dh]
        # in place: the JAX package's donated ck.at[rows, write_idx].set(k)
        ck[rows, write_idx] = k[:, 0].to(ck.dtype)
        cv[rows, write_idx] = v[:, 0].to(cv.dtype)
        if kernels:
            return paged_decode_attention(q[:, 0].contiguous(), ck, cv, lens)
        return decode_attention(q[:, 0], ck, cv, lens)

    h = cparams["embed_tokens"][tokens][:, None]  # [S, 1, D]
    for i in range(L):
        h, _, _ = _serve_layer(h, _layer(cparams["layers"], i), cfg, cos, sin, cd, kernels,
                               lambda q, k, v, i=i: attend(q, k, v, cache_k[i], cache_v[i]))
    h = _rms_norm(h, cparams["final_norm"], cfg.rms_norm_eps)
    logits = (h @ _head(cparams, cfg)).float()
    return logits[:, 0], cache_k, cache_v


def _tail_attention(q, ck, cv, tk, tv, lens, q_start: int, kernels: bool) -> torch.Tensor:
    if kernels:
        return spec_tail_attention_fused(
            q.contiguous(), ck, cv, tk.contiguous(), tv.contiguous(), lens, q_start=q_start
        )
    return spec_tail_attention(q, ck, cv, tk, tv, lens, q_start=q_start)


@torch.no_grad()
def verify_forward(
    params: dict,
    tail: torch.Tensor,
    lens: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cfg: LlamaConfig,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    kernels: bool = True,
):
    """Batched multi-token verify pass of self-speculative decode.

    tail [S, K] int are K unverified tokens per slot (the current token,
    then the draft's proposals) at absolute positions ``lens + i``;
    cache_{k,v} [L, S, T, Nkv, Dh] hold the ring as of before the tail and
    are only read. Returns (logits [S, K, V] f32, tail_ks, tail_vs [L, S,
    K, Nkv, Dh]): one full-depth logit row per tail position, and the
    tail's K/V, kept out of the ring so that rejected tokens need no
    rollback (:func:`spec_cache_insert` writes the accepted rows).

    Also the continued prefill of shared-prefix reuse (S = 1, tail = the
    suffix, lens = the reused prefix length)."""
    _require_dense(cfg, "verify_forward")
    K = tail.shape[1]
    cd = compute_dtype
    cparams = _cast_serving_params(params, cd)
    lens = lens.to(device=tail.device, dtype=torch.int32)
    positions = lens[:, None] + torch.arange(K, dtype=torch.int32, device=tail.device)[None]
    cos, sin = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    h = cparams["embed_tokens"][tail.long()]  # [S, K, D]
    tail_ks, tail_vs = [], []
    for i in range(cache_k.shape[0]):
        h, k, v = _serve_layer(
            h, _layer(cparams["layers"], i), cfg, cos, sin, cd, kernels,
            lambda q, k, v, i=i: _tail_attention(q, cache_k[i], cache_v[i], k, v, lens, 0, kernels),
        )
        tail_ks.append(k)
        tail_vs.append(v)
    h = _rms_norm(h, cparams["final_norm"], cfg.rms_norm_eps)
    logits = (h @ _head(cparams, cfg)).float()
    return logits, torch.stack(tail_ks), torch.stack(tail_vs)


@torch.no_grad()
def draft_propose(
    params: dict,
    tokens: torch.Tensor,
    lens: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cfg: LlamaConfig,
    *,
    k_steps: int,
    draft_layers: int,
    compute_dtype: torch.dtype = torch.bfloat16,
    kernels: bool = True,
) -> torch.Tensor:
    """Self-speculative draft: ``k_steps`` greedy tokens per slot from the
    first ``draft_layers`` layers of the same weights (final norm and lm
    head shared with the full stack). Returns proposals [S, k_steps] int32.

    The truncated stack's K/V for the proposed tail lives in its own
    [Ld, S, k_steps, Nkv, Dh] buffer, never in the ring: the draft dirties
    nothing, and exactness is the verify pass's job. Where the JAX package
    threads that buffer through its scan, the port writes row i in place."""
    _require_dense(cfg, "draft_propose")
    S = tokens.shape[0]
    L, _, _, Nkv, Dh = cache_k.shape
    Ld = int(draft_layers)
    if not 1 <= Ld <= L:
        raise ValueError(f"draft_layers {Ld} outside [1, {L}]")
    cd = compute_dtype
    cparams = _cast_serving_params(params, cd)
    head = _head(cparams, cfg)
    lens = lens.to(device=tokens.device, dtype=torch.int32)
    tkb = torch.zeros((Ld, S, k_steps, Nkv, Dh), dtype=cd, device=tokens.device)
    tvb = torch.zeros_like(tkb)

    def attend(q, k, v, li, i):
        tkb[li, :, i] = k[:, 0]
        tvb[li, :, i] = v[:, 0]
        return _tail_attention(q, cache_k[li], cache_v[li], tkb[li], tvb[li], lens, i, kernels)

    cur = tokens.long()
    proposals = []
    for i in range(k_steps):
        cos, sin = _rope_tables((lens + i)[:, None], Dh, cfg.rope_theta)
        h = cparams["embed_tokens"][cur][:, None]  # [S, 1, D]
        for li in range(Ld):
            h, _, _ = _serve_layer(h, _layer(cparams["layers"], li), cfg, cos, sin, cd, kernels,
                                   lambda q, k, v, li=li, i=i: attend(q, k, v, li, i))
        h = _rms_norm(h, cparams["final_norm"], cfg.rms_norm_eps)
        logits = (h @ head).float()
        cur = logits[:, 0].argmax(dim=-1)
        proposals.append(cur)
    return torch.stack(proposals, dim=1).to(torch.int32)


@torch.no_grad()
def spec_cache_insert(
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    tail_ks: torch.Tensor,
    tail_vs: torch.Tensor,
    lens: torch.Tensor,
    accept: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Insert each slot's accepted tail prefix into the ring: tail rows
    i <= accept[s] land at ring index ``(lens[s] + i) % T``. Rejected rows
    are not written, which leaves the cache the JAX function leaves (it
    writes their current value back). In place; returns the caches.
    Requires K <= T so that a tail never collides with itself."""
    L, S, T, Nkv, Dh = cache_k.shape
    K = tail_ks.shape[2]
    if K > T:
        raise ValueError(f"tail width {K} exceeds ring context {T}")
    dev = cache_k.device
    lens = lens.to(device=dev, dtype=torch.int64)
    accept = accept.to(device=dev, dtype=torch.int64)
    i = torch.arange(K, device=dev)[None]
    slot, row = (i <= accept[:, None]).nonzero(as_tuple=True)
    pos = torch.remainder(lens[slot] + row, T)
    cache_k[:, slot, pos] = tail_ks[:, slot, row].to(cache_k.dtype)
    cache_v[:, slot, pos] = tail_vs[:, slot, row].to(cache_v.dtype)
    return cache_k, cache_v


@torch.no_grad()
def prefix_copy(
    cache_k: torch.Tensor, cache_v: torch.Tensor, src: int, dst: int, plen: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Copy the first ``plen`` ring rows of slot ``src`` into slot ``dst``
    (shared-prefix reuse). Rows >= plen keep dst's previous bytes, stale
    and masked as in any slot reuse. In place; returns the caches."""
    cache_k[:, dst, :plen] = cache_k[:, src, :plen]
    cache_v[:, dst, :plen] = cache_v[:, src, :plen]
    return cache_k, cache_v


@torch.no_grad()
def suffix_insert(
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    ks: torch.Tensor,
    vs: torch.Tensor,
    slot: int,
    start: int,
    count: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a continued prefill's suffix K/V [L, P', Nkv, Dh] into
    ``slot`` at rows [start, start + count), the positioned counterpart of
    :func:`cache_insert` (a prompt fits its page, so no ring wrap; rows
    past the page and padding rows past ``count`` are dropped). In place;
    returns the caches."""
    n = max(0, min(count, cache_k.shape[2] - start, ks.shape[1]))
    cache_k[:, slot, start : start + n] = ks[:, :n].to(cache_k.dtype)
    cache_v[:, slot, start : start + n] = vs[:, :n].to(cache_v.dtype)
    return cache_k, cache_v
