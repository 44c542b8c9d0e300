"""Functional Llama for serving: prefill and paged incremental decode.

The PyTorch counterpart of ``opendiloco_tpu/models/llama.py``, for the
serving plane. Parameters are a plain dict of tensors in the JAX layout:
per-layer weights stacked on a leading layer axis, linear weights
[in, out] (``x @ W``), so weights cross between the packages unchanged
(:mod:`opendiloco_torch.models.convert`). The JAX ``lax.scan`` over layers
is a Python loop here.

Dtype points follow the JAX package: RMS-norm variance in f32, rope in
x's dtype, attention scores in f32, logits in f32.

``kernels=True`` routes decode attention through the hand-written
paged-decode-attention kernel and every packed (``w4``) weight matmul
through the fused dequant-matmul kernel; on the CPU those wrappers take
their plain versions. ``kernels=False`` is the plain path, the JAX
package's ``decode_kernel="xla"``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import torch
import torch.nn.functional as F

from opendiloco_torch.device import resolve_device
from opendiloco_torch.ops.attention import decode_attention, xla_attention
from opendiloco_torch.ops.decode_kernels import paged_decode_attention, w4_matmul
from opendiloco_torch.quant import dequant_w4


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
    Nh, Nkv, Dh = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    cd = compute_dtype
    cparams = _cast_serving_params(params, cd)
    positions = torch.arange(P, device=input_ids.device).expand(B, P)
    cos, sin = _rope_tables(positions, Dh, cfg.rope_theta)
    h = cparams["embed_tokens"][input_ids]
    ks, vs = [], []
    for i in range(cfg.num_hidden_layers):
        layer = _layer(cparams["layers"], i)
        x = _rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
        q = _wmul(x, layer["q_proj"], cd, kernels).reshape(B, P, Nh, Dh)
        k = _wmul(x, layer["k_proj"], cd, kernels).reshape(B, P, Nkv, Dh)
        v = _wmul(x, layer["v_proj"], cd, kernels).reshape(B, P, Nkv, Dh)
        q = _rope_apply(q, cos, sin)
        k = _rope_apply(k, cos, sin)
        attn = xla_attention(q, k, v, causal=True)
        h = h + _wmul(attn.reshape(B, P, Nh * Dh), layer["o_proj"], cd, kernels)
        x = _rms_norm(h, layer["post_attn_norm"], cfg.rms_norm_eps)
        h = h + _ffn(x, layer, cd, kernels)
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
    L, _, T, Nkv, Dh = cache_k.shape
    Nh = cfg.num_attention_heads
    cd = compute_dtype
    cparams = _cast_serving_params(params, cd)
    lens = lens.to(torch.int32)
    cos, sin = _rope_tables(lens[:, None], Dh, cfg.rope_theta)
    rows = torch.arange(S, device=tokens.device)
    write_idx = torch.remainder(lens, T).long()
    h = cparams["embed_tokens"][tokens][:, None]  # [S, 1, D]
    for i in range(L):
        layer = _layer(cparams["layers"], i)
        ck, cv = cache_k[i], cache_v[i]  # views [S, T, Nkv, Dh]
        x = _rms_norm(h, layer["input_norm"], cfg.rms_norm_eps)
        q = _wmul(x, layer["q_proj"], cd, kernels).reshape(S, 1, Nh, Dh)
        k = _wmul(x, layer["k_proj"], cd, kernels).reshape(S, 1, Nkv, Dh)
        v = _wmul(x, layer["v_proj"], cd, kernels).reshape(S, 1, Nkv, Dh)
        q = _rope_apply(q, cos, sin)
        k = _rope_apply(k, cos, sin)
        # in place: the JAX package's donated ck.at[rows, write_idx].set(k)
        ck[rows, write_idx] = k[:, 0].to(ck.dtype)
        cv[rows, write_idx] = v[:, 0].to(cv.dtype)
        if kernels:
            attn = paged_decode_attention(q[:, 0].contiguous(), ck, cv, lens)
        else:
            attn = decode_attention(q[:, 0], ck, cv, lens)
        h = h + _wmul(attn.reshape(S, 1, Nh * Dh), layer["o_proj"], cd, kernels)
        x = _rms_norm(h, layer["post_attn_norm"], cfg.rms_norm_eps)
        h = h + _ffn(x, layer, cd, kernels)
    h = _rms_norm(h, cparams["final_norm"], cfg.rms_norm_eps)
    logits = (h @ _head(cparams, cfg)).float()
    return logits[:, 0], cache_k, cache_v
