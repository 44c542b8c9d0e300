"""Model sources: packaged size configs and config files.

The bare-config part of ``opendiloco_tpu/models/hf_io.py``
(``resolve_model_path``, ``load_config``, ``get_model``). The port ships
its own copy of the config files under ``models/configs``. Loading HF
safetensors weights arrives with a later slice; a directory source
raises until then.
"""
from __future__ import annotations

import os
from typing import Optional

from opendiloco_torch.models.llama import LlamaConfig

_PKG_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


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


def get_model(path_model: str) -> tuple[LlamaConfig, Optional[dict]]:
    """Resolve a model source to (config, params). params is None for a
    bare size config (the caller draws weights with ``init_params``)."""
    path = resolve_model_path(path_model)
    if os.path.isdir(path):
        raise NotImplementedError(
            "loading safetensors weights from a model directory is not "
            "ported yet (ROADMAP.md queue A: dense model forward and weight IO)"
        )
    return LlamaConfig.from_json(path), None
