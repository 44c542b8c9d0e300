"""Model sources: packaged size configs, config files and HF model
directories.

The port's copy of ``opendiloco_tpu/models/hf_io.py``: a model directory
holds an HF llama ``config.json`` and ``model.safetensors``, read and
written with the port's own safetensors code
(:mod:`opendiloco_torch.utils.safetensors_io`), so the files interchange
with HF tooling and with the JAX package. Layout differences handled here,
as there:

- HF linear weights are [out_features, in_features]; ours are [in, out]
  (we compute ``x @ W``): transposed both ways;
- our per-layer weights are stacked on a leading layer axis; HF keys are
  per layer: stacked and unstacked.

Leaves come back as f32 numpy arrays in the JAX package's tree layout,
which ``InnerTrainer.init_state(params=)`` takes.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from opendiloco_torch.models.llama import LlamaConfig, shapes
from opendiloco_torch.utils import safetensors_io

_PKG_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

# (our layer-tree key, HF module name, transpose?)
_LAYER_KEYS = [
    ("input_norm", "input_layernorm", False),
    ("post_attn_norm", "post_attention_layernorm", False),
    ("q_proj", "self_attn.q_proj", True),
    ("k_proj", "self_attn.k_proj", True),
    ("v_proj", "self_attn.v_proj", True),
    ("o_proj", "self_attn.o_proj", True),
    ("gate_proj", "mlp.gate_proj", True),
    ("up_proj", "mlp.up_proj", True),
    ("down_proj", "mlp.down_proj", True),
]


def resolve_model_path(path_model: str) -> str:
    """Map a name like 'configs/config_150m.json', a packaged size name
    ('150m'), or a directory path to a concrete config path/dir."""
    if os.path.isdir(path_model) or os.path.isfile(path_model):
        return path_model
    short = path_model.removeprefix("configs/").removesuffix(".json")
    short = short.removeprefix("config_")
    candidate = os.path.join(_PKG_CONFIG_DIR, f"config_{short}.json")
    if os.path.isfile(candidate):
        return candidate
    raise FileNotFoundError(f"cannot resolve model path {path_model!r}")


def load_config(path_model: str) -> LlamaConfig:
    path = resolve_model_path(path_model)
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    return LlamaConfig.from_json(path)


def _reject_moe(cfg: LlamaConfig, op: str) -> None:
    if cfg.num_experts:
        raise ValueError(
            f"cannot {op} MoE weights as HF llama safetensors (the llama "
            "architecture has no routed experts); use the framework "
            "checkpointer (opendiloco_torch.ckpt) for MoE models"
        )


def _shape_tree(tree) -> dict:
    return {k: _shape_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree.shape)


def load_params(model_dir: str, cfg: Optional[LlamaConfig] = None) -> dict:
    """Read an HF llama ``model.safetensors`` into our stacked tree of f32
    numpy leaves; raises when a shape disagrees with the config."""
    if cfg is None:
        cfg = load_config(model_dir)
    _reject_moe(cfg, "load")
    tensors = safetensors_io.load_file(os.path.join(model_dir, "model.safetensors"))

    def get(name: str, transpose: bool) -> np.ndarray:
        t = tensors[name]
        if t.dtype == np.uint16:  # bf16 words: widen to f32 exactly
            t = (t.astype(np.uint32) << 16).view(np.float32)
        t = t.astype(np.float32, copy=False)
        return np.ascontiguousarray(t.T if transpose else t)

    L = cfg.num_hidden_layers
    layers = {
        ours: np.stack([get(f"model.layers.{i}.{hf}.weight", tr) for i in range(L)], axis=0)
        for ours, hf, tr in _LAYER_KEYS
    }
    params = {
        "embed_tokens": get("model.embed_tokens.weight", False),
        "layers": layers,
        "final_norm": get("model.norm.weight", False),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight", True)
    got, want = _shape_tree(params), shapes(cfg)
    if got != want:
        raise ValueError(f"weight shapes mismatch config: {got} vs {want}")
    return params


def save_params(params: dict, cfg: LlamaConfig, model_dir: str) -> None:
    """Write our tree (numpy arrays or tensors on any device) as an
    HF-named ``model.safetensors`` + ``config.json``, in f32."""
    _reject_moe(cfg, "save")
    os.makedirs(model_dir, exist_ok=True)

    def host(x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", torch.float32).numpy()
        return np.asarray(x, dtype=np.float32)

    out: dict[str, np.ndarray] = {
        "model.embed_tokens.weight": host(params["embed_tokens"]),
        "model.norm.weight": host(params["final_norm"]),
    }
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = host(params["lm_head"]).T
    for ours, hf, tr in _LAYER_KEYS:
        stacked = host(params["layers"][ours])
        for i in range(cfg.num_hidden_layers):
            out[f"model.layers.{i}.{hf}.weight"] = stacked[i].T if tr else stacked[i]
    safetensors_io.save_file(out, os.path.join(model_dir, "model.safetensors"))
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)


def get_model(path_model: str) -> tuple[LlamaConfig, Optional[dict]]:
    """Resolve a model source to (config, params). params is None for a
    bare size config (the caller draws weights with ``init_params``); a
    directory loads its weights (:func:`load_params`)."""
    path = resolve_model_path(path_model)
    if os.path.isdir(path):
        cfg = load_config(path)
        return cfg, load_params(path, cfg)
    return LlamaConfig.from_json(path), None
