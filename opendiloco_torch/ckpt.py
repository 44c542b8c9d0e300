"""Checkpoint and resume: one worker's device state plus host sidecars.

The port's copy of ``opendiloco_tpu/ckpt.py``:

- layout ``{path}/model_step_{N}/diloco_rank_{R}/`` (:func:`ckpt_dir`);
- the trainer state in one ``device_state.safetensors``
  (:mod:`opendiloco_torch.utils.safetensors_io`; the JAX package writes an
  Orbax ``device_state/`` folder there, which the port does not read):
  params under their tree path names (``params.layers.q_proj``), the
  AdamW moments under the param they belong to (``opt_state.mu.<path>``,
  ``opt_state.nu.<path>``), all f32 and exact, and the integer and scalar
  state (``step``, the optimizer's ``count`` and ``schedule_count``, the
  loss scaler) as JSON in the file's ``__metadata__``;
- the host sidecars, byte for byte the JAX package's files: the DiLoCo
  state (master, outer momentum, epoch, local step) as
  ``diloco_state.bin``/``.json`` (:mod:`opendiloco_torch.diloco.state_io`),
  the data position as ``dataloader_{process}.json`` (read with the
  legacy ``dataloader.json`` as fallback) and ``global_state.json``;
- latest-checkpoint discovery by step (:func:`get_resume_info`), top-k
  retention (:func:`delete_old_checkpoints`) and a writability probe.

Remote paths (``scheme://``) go through ``fsspec``, imported only there.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from opendiloco_torch.data.dataloader import process_index_and_count
from opendiloco_torch.diloco import state_io
from opendiloco_torch.models.llama import flatten_params
from opendiloco_torch.utils import safetensors_io
from opendiloco_torch.utils.logger import get_text_logger

log = get_text_logger(__name__)

_STEP_RE = re.compile(r"model_step_(\d+)$")
DEVICE_STATE = "device_state.safetensors"
_FORMAT = "opendiloco_torch.device_state/1"


def _process_index() -> int:
    """This process's index among the processes of one worker (own seam
    so tests can simulate other hosts)."""
    return process_index_and_count()[0]


def _is_remote(path: str) -> bool:
    return "://" in path


def _fs(path: str):
    import fsspec

    fs, _, (p,) = fsspec.get_fs_token_paths(path)
    return fs, p


def _fs_open(path: str, mode: str):
    if _is_remote(path):
        import fsspec

        return fsspec.open(path, mode).open()
    if "w" in mode:
        os.makedirs(os.path.dirname(path), exist_ok=True)
    return open(path, mode)


def _listdir(path: str) -> list[str]:
    if _is_remote(path):
        fs, p = _fs(path)
        try:
            # detail=False: several backends (memory, gcs) default to info dicts
            return [x.rstrip("/").split("/")[-1] for x in fs.ls(p, detail=False)]
        except FileNotFoundError:
            return []
    try:
        return os.listdir(path)
    except FileNotFoundError:
        return []


def _exists(path: str) -> bool:
    if _is_remote(path):
        fs, p = _fs(path)
        return fs.exists(p)
    return os.path.exists(path)


def ckpt_dir(path: str, step: int, diloco_rank: Optional[int] = None) -> str:
    d = f"{path.rstrip('/')}/model_step_{step}"
    if diloco_rank is not None:
        d = f"{d}/diloco_rank_{diloco_rank}"
    return d


def check_checkpoint_path_access(path: str, rank: int = 0) -> None:
    """Fail fast on an unwritable checkpoint destination. The probe's name
    carries (diloco rank, process index), so processes probing one folder
    at once never race on one file."""
    probe = f"{path.rstrip('/')}/.write_probe_{rank}_{_process_index()}"
    with _fs_open(probe, "w") as f:
        f.write("ok")
    if _is_remote(probe):
        fs, p = _fs(probe)
        fs.rm(p)
    else:
        os.remove(probe)


# ---------------------------------------------------------------------------
# the trainer state <-> device_state.safetensors
# ---------------------------------------------------------------------------


def _param_paths(tree: dict, prefix: str = "") -> list[str]:
    """Tree path names in :func:`flatten_params` order."""
    out = []
    for k in sorted(tree):
        name = f"{prefix}{k}"
        out.extend(_param_paths(tree[k], name + ".") if isinstance(tree[k], dict) else [name])
    return out


def _split_state(state: dict) -> tuple[dict[str, torch.Tensor], dict]:
    """({file name: tensor}, JSON-able host state) of a trainer state:
    the params, and every per-param list of the optimizer state (the AdamW
    moments) named by param; everything else is host state."""
    paths = _param_paths(state["params"])
    tensors = {f"params.{p}": t for p, t in zip(paths, flatten_params(state["params"]))}
    host: dict = {}
    for key, value in state.items():
        if key == "params":
            continue
        if key == "opt_state":
            host_opt = {}
            for k, v in value.items():
                if isinstance(v, (list, tuple)):
                    if len(v) != len(paths):
                        raise ValueError(f"opt_state.{k} holds {len(v)} leaves for {len(paths)} params")
                    tensors.update({f"opt_state.{k}.{p}": t for p, t in zip(paths, v)})
                else:
                    host_opt[k] = v
            host[key] = host_opt
        else:
            host[key] = value
    return tensors, _jsonify(host)


def _write_device_state(d: str, state: dict) -> None:
    tensors, host = _split_state(state)
    meta = {"format": _FORMAT, "state": json.dumps(host)}
    with _fs_open(f"{d}/{DEVICE_STATE}", "wb") as f:
        safetensors_io.write(f, tensors, meta)


@torch.no_grad()
def _read_device_state(d: str, state: dict) -> dict:
    """Copy the stored values into ``state``'s own tensors, on their
    device and in place, and its host entries; returns ``state``."""
    path = f"{d}/{DEVICE_STATE}"
    if not _exists(path):
        if _exists(f"{d}/device_state"):
            raise ValueError(
                f"{d} holds an Orbax device_state/ folder, the JAX package's checkpoint; "
                f"the port reads only its own {DEVICE_STATE}"
            )
        raise FileNotFoundError(f"no {DEVICE_STATE} in {d}")
    tensors, _ = _split_state(state)
    with _fs_open(path, "rb") as f:
        header, meta, base = safetensors_io.read_header(f)
        if meta.get("format") != _FORMAT:
            raise ValueError(f"{path}: not a device state written by the port ({meta.get('format')!r})")
        if set(header) != set(tensors):
            raise ValueError(
                f"{path} does not match the state: missing {sorted(set(tensors) - set(header))}, "
                f"extra {sorted(set(header) - set(tensors))}"
            )
        for name, dst in tensors.items():
            src = torch.from_numpy(safetensors_io.read_entry(f, base, name, header[name]))
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(f"{name}: stored {src.dtype} {tuple(src.shape)}, state holds "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
    host = json.loads(meta["state"])
    for key, value in host.items():
        if key == "opt_state":
            state["opt_state"].update(value)
        else:
            state[key] = value
    return state


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def save_checkpoint(
    path: str,
    step: int,
    state: dict,
    *,
    diloco_rank: Optional[int] = None,
    diloco_state: Optional[dict] = None,
    dataloader_state: Optional[dict] = None,
    extra: Optional[dict[str, Any]] = None,
) -> str:
    """Write one worker's checkpoint; returns the checkpoint directory.

    The data position is this process's (``dataloader_{process}.json``);
    the files one worker shares (device state, DiLoCo state, global
    state) are written by process 0 only."""
    d = ckpt_dir(path, step, diloco_rank)
    pi = _process_index()
    if pi == 0:
        _write_device_state(d, state)
    if diloco_state is not None and pi == 0:
        meta, arrays = state_io.pack_state(_coerce_host(diloco_state))
        with _fs_open(f"{d}/diloco_state.bin", "wb") as f:
            for a in arrays:
                if a.nbytes:
                    f.write(memoryview(a.reshape(-1)).cast("B"))
        with _fs_open(f"{d}/diloco_state.json", "w") as f:
            json.dump(meta, f)
    if dataloader_state is not None:
        with _fs_open(f"{d}/dataloader_{pi}.json", "w") as f:
            json.dump(_jsonify(dataloader_state), f)
    if extra and pi == 0:
        with _fs_open(f"{d}/global_state.json", "w") as f:
            json.dump(_jsonify(extra), f)
    log.info("saved checkpoint step %d -> %s", step, d)
    return d


def load_checkpoint(d: str, state: dict) -> tuple[dict, Optional[dict], Optional[dict], dict]:
    """Restore (state, diloco_state, dataloader_state, extra) from a
    checkpoint directory. The stored tensors are copied into ``state``'s
    tensors in place (leaves that require grad, and lists that hold them,
    stay valid); ``state`` itself is returned."""
    state = _read_device_state(d, state)

    diloco_state = None
    if _exists(f"{d}/diloco_state.json"):
        with _fs_open(f"{d}/diloco_state.json", "r") as f:
            meta = json.load(f)
        with _fs_open(f"{d}/diloco_state.bin", "rb") as f:
            diloco_state = state_io.read_state(meta, f)

    dataloader_state = None
    pi = _process_index()
    for name in (f"dataloader_{pi}.json", "dataloader.json"):  # legacy fallback
        if _exists(f"{d}/{name}"):
            with _fs_open(f"{d}/{name}", "r") as f:
                dataloader_state = json.load(f)
            break

    extra = {}
    if _exists(f"{d}/global_state.json"):
        with _fs_open(f"{d}/global_state.json", "r") as f:
            extra = json.load(f)
    return state, diloco_state, dataloader_state, extra


# ---------------------------------------------------------------------------
# discovery / retention
# ---------------------------------------------------------------------------


def _steps(ckpt_path: str) -> list[int]:
    return sorted(int(m.group(1)) for m in (_STEP_RE.match(x) for x in _listdir(ckpt_path)) if m)


def get_resume_info(
    resume: Optional[str | bool], ckpt_path: str, diloco_rank: Optional[int] = None
) -> tuple[bool, Optional[str], int]:
    """(should_resume, ckpt_dir, step): ``resume=True`` finds the latest
    step under ``ckpt_path``; a string is a checkpoint directory."""
    if not resume:
        return False, None, 0
    if isinstance(resume, str) and resume not in ("True", "true"):
        m = _STEP_RE.search(resume.rstrip("/").replace(f"/diloco_rank_{diloco_rank}", ""))
        step = int(m.group(1)) if m else 0
        d = resume if diloco_rank is None else f"{resume.rstrip('/')}/diloco_rank_{diloco_rank}"
        return True, d, step
    steps = _steps(ckpt_path)
    if not steps:
        return False, None, 0
    return True, ckpt_dir(ckpt_path, steps[-1], diloco_rank), steps[-1]


def delete_old_checkpoints(ckpt_path: str, topk: Optional[int]) -> None:
    """Keep only the most recent ``topk`` checkpoints."""
    if not topk:
        return
    for step in _steps(ckpt_path)[:-topk]:
        d = ckpt_dir(ckpt_path, step)
        log.info("deleting old checkpoint %s", d)
        if _is_remote(d):
            fs, p = _fs(d)
            try:
                fs.rm(p, recursive=True)
            except (FileNotFoundError, OSError) as e:
                # every diloco rank runs this on the shared path; losing a
                # double-delete race must not stop training
                log.warning("retention GC of %s failed (%s); continuing", d, e)
        else:
            shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# numpy tree packing (DiLoCo master and outer optimizer state; no pickle)
# ---------------------------------------------------------------------------


def _coerce_host(obj: Any) -> Any:
    """Tensors (on any device) and other array-likes in a state tree become
    host numpy arrays, tuples lists, so the packed form is the same
    whatever held the state."""
    if isinstance(obj, dict):
        return {k: _coerce_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_coerce_host(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if hasattr(obj, "__array__") and not isinstance(obj, np.ndarray):
        return np.asarray(obj)
    return obj


def _pack_tree(tree: dict) -> tuple[dict, bytes]:
    """(meta, blob) of ``diloco_state.json``/``.bin`` (the saver writes
    the same bytes array by array)."""
    return state_io.serialize_state(_coerce_host(tree))


def _unpack_tree(meta: dict, blob: bytes) -> dict:
    return state_io.deserialize_state(meta, blob)


def _jsonify(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist(), "dtype": str(obj.dtype)}
    return obj
