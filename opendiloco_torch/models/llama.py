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
config carries over) or the plain ``xla_attention`` (``"xla"``), and
checkpoints each layer under ``remat=True`` (``torch.utils.checkpoint``,
non-reentrant: the backward reruns the layer's forward, kernels included).

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
import json
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from opendiloco_torch.device import resolve_device
from opendiloco_torch.ops.attention import decode_attention, spec_tail_attention, xla_attention
from opendiloco_torch.ops.decode_kernels import (
    paged_decode_attention,
    spec_tail_attention_fused,
    w4_matmul,
)
from opendiloco_torch.ops.flash_attention import flash_attention
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
    # routed experts: carried so every config file loads; the serving
    # forward takes dense stacks only
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
# per layer. "dots" and "dots_all" (save the matmul outputs) are not
# ported yet and raise.
RematPolicy = Union[bool, str]


def _maybe_remat(block, remat: RematPolicy):
    """Apply the rematerialization policy to a per-layer block function."""
    if remat in (False, None, "none"):
        return block
    if remat in (True, "full"):
        return lambda *args: checkpoint(block, *args, use_reentrant=False)
    if remat in ("dots", "dots_all"):
        raise NotImplementedError(
            f"remat={remat!r} (save matmul outputs, recompute the rest) is not "
            "ported yet (ROADMAP.md A8: selective remat); use True or False"
        )
    raise ValueError(f"unknown remat policy {remat!r}")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def _decoder_block(
    cfg: LlamaConfig, attn_fn, h: torch.Tensor, layer: dict, rope: tuple, probe: bool
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (hidden, attn-output L2 norm or None): the dense branch of
    the JAX block. The norm is the activation probe the reference attaches
    to ``self_attn``; it is computed only when ``probe`` is set."""
    B, T, _ = h.shape
    Nh, Nkv, Dh = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    cos, sin = rope
    with span("llama.attn_norm"):
        x = _rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
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
    with span("llama.gate_up"):
        gate, up = x @ layer["gate_proj"], x @ layer["up_proj"]
    with span("llama.swiglu"):
        act = F.silu(gate) * up
    del gate, up  # not live at the down product
    with span("llama.down"):
        ffn = act @ layer["down_proj"]
    with span("llama.ffn_residual"):
        return h + ffn, attn_norm


def _attn_fn(attn_impl: str):
    if attn_impl == "xla":
        return lambda q, k, v: xla_attention(q, k, v, causal=True)
    if attn_impl == "pallas":
        return lambda q, k, v: flash_attention(q, k, v, causal=True)
    if attn_impl == "ring":
        raise _not_ported("ring attention (attn_impl='ring')", "A14")
    raise ValueError(f"unknown attn_impl {attn_impl!r}")


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
    scan_unroll: Optional[int] = None,
):
    """input_ids [B, T] int -> logits [B, T, V] float32.

    ``attn_impl`` "pallas" runs the flash-attention kernels (their plain
    versions on the CPU), "xla" the plain attention. return_hidden=True
    returns (final_hidden [B, T, D], head [D, V]) instead of logits.
    return_aux=True also returns the activation probes
    {"attn_out_norm": [L], "lm_head_norm": scalar}.

    The f32 params are cast to ``compute_dtype`` here, inside the autograd
    graph, so gradients arrive in f32 at the f32 leaves. ``scan_unroll``
    is accepted for the JAX signature and has no effect: the layers are a
    Python loop. Multi-device meshes (``ring_mesh``), the pipeline
    (``pp_mesh``) and routed experts raise."""
    if pp_mesh is not None:
        raise _not_ported("the pipeline-parallel forward (pp_mesh)", "A14")
    if ring_mesh is not None:
        raise _not_ported("sharded attention over a device mesh (ring_mesh)", "A10")
    if cfg.num_experts:
        raise _not_ported("the routed-expert (MoE) forward", "A14")
    del scan_unroll
    B, T = input_ids.shape
    if positions is None:
        positions = torch.arange(T, device=input_ids.device).expand(B, T)
    attn_fn = _attn_fn(attn_impl)
    with span("llama.cast_params"):
        cparams = {k: (v.to(compute_dtype) if not isinstance(v, dict)
                       else {n: w.to(compute_dtype) for n, w in v.items()})
                   for k, v in params.items()}
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    names = sorted(cparams["layers"])

    def block(h, *weights):
        return _decoder_block(cfg, attn_fn, h, dict(zip(names, weights)), rope, return_aux)

    block = _maybe_remat(block, remat)
    with span("llama.embed"):
        h = cparams["embed_tokens"][input_ids]
    attn_norms = []
    for i in range(cfg.num_hidden_layers):
        with span("llama.layer_params"):  # layer i's slices of the stacked weights
            weights = [cparams["layers"][n][i] for n in names]
        h, norm = block(h, *weights)
        attn_norms.append(norm)
    with span("llama.final_norm"):
        h = _rms_norm(h, cparams["final_norm"], cfg.rms_norm_eps)
    head = _head(cparams, cfg)
    if return_hidden:
        return h, head
    with span("llama.lm_head"):
        logits = (h @ head).float()
    if return_aux:
        return logits, {
            "attn_out_norm": torch.stack(attn_norms),
            "lm_head_norm": torch.sqrt(torch.sum(logits**2)),
        }
    return logits


def causal_lm_loss(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100
) -> torch.Tensor:
    """Shifted next-token cross-entropy, mean over non-ignored targets
    (HF CausalLM loss semantics)."""
    with span("loss.causal_lm"):
        shift_logits = logits[:, :-1]
        shift_labels = labels[:, 1:]
        mask = shift_labels != ignore_index
        safe_labels = torch.where(mask, shift_labels, torch.zeros_like(shift_labels))
        logp = torch.log_softmax(shift_logits, dim=-1)
        nll = -torch.gather(logp, -1, safe_labels[..., None].long())[..., 0]
        total = torch.sum(nll * mask)
        count = torch.clamp(torch.sum(mask), min=1)
        return total / count


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
