"""Parity of the port's checkpoint and resume, weight directories, command
line and JSONL logger with the JAX package, on the CPU.

Each case runs both packages in one process on the same inputs: the
checkpoint layout, discovery, retention, the write probe, the multihost
sidecar scoping, the legacy loader fallback and the ``memory://`` cycle of
``tests/test_ckpt.py``; the packed DiLoCo state; the host sidecars, which
must be the same bytes; HF weight directories each way; ``parse_argv``;
and the JSONL rows. The JAX package writes its device state with Orbax,
the port one ``device_state.safetensors`` (read here with the
``safetensors`` package as well as with the port's own reader).

Tolerances, where values are computed and not copied: the slice run from
a weights directory holds per-step losses at rtol 1e-5 and final params
at atol 1e-6, and ``average_state_every`` the masters at atol 1e-5, the
tolerances and the reason of ``tests/test_torch_train.py`` (both sides f32,
sums in another order). Everything stored and read back is exact.
"""
import dataclasses
import json
import os
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

from opendiloco_tpu import ckpt as jckpt
from opendiloco_tpu.parallel.mesh import build_mesh
from opendiloco_torch import ckpt as tckpt
from opendiloco_torch.config import Config, DilocoConfig, parse_argv
from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
from opendiloco_torch.models import hf_io as thf
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.models.convert import params_to_numpy
from opendiloco_torch.train import train
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from opendiloco_torch.utils import safetensors_io

torch.set_num_threads(2)


def _tcfg(tiny_cfg, **kw):
    """The port's LlamaConfig of the JAX one (the same fields)."""
    return tllama.LlamaConfig(**{**dataclasses.asdict(tiny_cfg), **kw})


def _np_params(cfg, seed):
    """Weights in the shared layout, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.02)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    return draw(tllama.shapes(cfg))


def _jax_state(tiny_cfg):
    from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
    from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig

    trainer = JInnerTrainer(tiny_cfg, JTrainerConfig(precision="fp32", remat=False, total_steps=10, warmup_steps=2),
                            build_mesh("NO_SHARD", devices=[jax.devices()[0]]))
    return trainer.init_state(jax.random.key(0))


def _torch_state(tiny_cfg, seed=0, precision="fp32"):
    trainer = InnerTrainer(_tcfg(tiny_cfg), TrainerConfig(precision=precision, remat=False, total_steps=10,
                                                          warmup_steps=2), device="cpu")
    return trainer, trainer.init_state(seed)


def _diloco_state(seed=0):
    rng = np.random.default_rng(seed)
    master = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]
    return {
        "master": master,
        "outer_opt": {"lr": 0.7, "momentum": 0.9, "nesterov": True, "bufs": [m * 0.5 for m in master]},
        "epoch": 2,
        "local_step": 1,
        "samples_in_epoch": 8,
    }


SIDECARS = ("diloco_state.bin", "diloco_state.json", "dataloader_0.json", "global_state.json")


def _read(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# layout, discovery, retention, probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path,step,rank", [("/x", 500, None), ("/x/", 500, 3), ("memory://ckpts/", 7, 0)])
def test_ckpt_dir_layout_matches_jax(path, step, rank):
    assert tckpt.ckpt_dir(path, step, rank) == jckpt.ckpt_dir(path, step, rank)


def test_get_resume_info_discovery_matches_jax(tmp_path):
    root = str(tmp_path)
    calls = [(True, root, None), (True, root, 1)]
    got = [[lib.get_resume_info(*c) for c in calls] for lib in (jckpt, tckpt)]
    for s in (10, 9, 100):
        os.makedirs(tmp_path / f"model_step_{s}")
    os.makedirs(tmp_path / "model_step_x")
    calls += [(True, root, None), (True, root, 2), ("True", root, None), ("true", root, 0),
              (str(tmp_path / "model_step_10"), root, None), (str(tmp_path / "model_step_10"), root, 2),
              (str(tmp_path / "model_step_10" / "diloco_rank_2"), root, 2), (None, root, None),
              (False, root, 1)]
    got = [[lib.get_resume_info(*c) for c in calls] for lib in (jckpt, tckpt)]
    assert got[0] == got[1]
    assert got[1][2] == (True, f"{root}/model_step_100", 100)


def test_delete_old_checkpoints_matches_jax(tmp_path):
    left = {}
    for name, lib in (("jax", jckpt), ("port", tckpt)):
        for s in (1, 2, 3, 4, 5):
            os.makedirs(tmp_path / name / f"model_step_{s}" / "diloco_rank_0")
        lib.delete_old_checkpoints(str(tmp_path / name), topk=2)
        lib.delete_old_checkpoints(str(tmp_path / name), topk=None)
        left[name] = sorted(os.listdir(tmp_path / name))
    assert left["port"] == left["jax"] == ["model_step_4", "model_step_5"]


def test_check_checkpoint_path_access_matches_jax(tmp_path):
    for name, lib in (("jax", jckpt), ("port", tckpt)):
        lib.check_checkpoint_path_access(str(tmp_path / name / "new_dir"), rank=1)
        assert os.listdir(tmp_path / name / "new_dir") == []
        with pytest.raises(OSError):
            lib.check_checkpoint_path_access("/proc/definitely/not/writable")


# ---------------------------------------------------------------------------
# sidecars and the packed DiLoCo state
# ---------------------------------------------------------------------------


def test_sidecars_are_the_jax_packages_bytes(tmp_path, tiny_cfg):
    """The same DiLoCo state, data position and global state give the same
    files in both packages; each package reads the other's DiLoCo state.
    The port refuses the JAX package's Orbax device state by name."""
    sidecars = dict(diloco_state=_diloco_state(), dataloader_state={"dataset": {"samples_seen": 99, "seed": 43}},
                    extra={"loss": 1.5, "step": 7})
    jd = jckpt.save_checkpoint(str(tmp_path / "jax"), 7, _jax_state(tiny_cfg), diloco_rank=1, **sidecars)
    _, state = _torch_state(tiny_cfg)
    td = tckpt.save_checkpoint(str(tmp_path / "port"), 7, state, diloco_rank=1, **sidecars)
    assert td.endswith("model_step_7/diloco_rank_1") and os.path.relpath(td, tmp_path / "port") == \
        os.path.relpath(jd, tmp_path / "jax")
    for name in SIDECARS:
        assert _read(td, name) == _read(jd, name), name
    assert sorted(os.listdir(td)) == sorted([*SIDECARS, "device_state.safetensors"])
    meta = json.loads(_read(td, "diloco_state.json"))
    for a, b in ((jckpt._unpack_tree(meta, _read(td, "diloco_state.bin")), sidecars["diloco_state"]),
                 (tckpt._unpack_tree(meta, _read(jd, "diloco_state.bin")), sidecars["diloco_state"])):
        assert all(np.array_equal(x, y) for x, y in zip(a["master"], b["master"]))
        assert all(np.array_equal(x, y) for x, y in zip(a["outer_opt"]["bufs"], b["outer_opt"]["bufs"]))
        assert {k: a[k] for k in ("epoch", "local_step", "samples_in_epoch")} == {"epoch": 2, "local_step": 1,
                                                                                  "samples_in_epoch": 8}
    with pytest.raises(ValueError, match="Orbax"):
        tckpt.load_checkpoint(jd, state)


def _trees():
    base = _diloco_state(3)
    yield "diloco", base
    yield "no-momentum", {**base, "outer_opt": {**base["outer_opt"], "bufs": None}}
    yield "mixed", {"a": np.array(3.5, np.float32), "b": (np.arange(6, dtype=np.int64).reshape(2, 3), None),
                    "c": {"d": [1, 2.5, "x", True], "e": np.zeros((0, 3), np.float32)},
                    "f": np.arange(10, dtype=np.float64)[::3]}


@pytest.mark.parametrize("name,tree", list(_trees()), ids=[n for n, _ in _trees()])
def test_pack_tree_matches_jax(name, tree):
    jmeta, jblob = jckpt._pack_tree(tree)
    tmeta, tblob = tckpt._pack_tree(tree)
    assert json.dumps(tmeta) == json.dumps(jmeta) and tblob == jblob
    # tensors (on any device) pack as their numpy arrays
    as_tensors = jax.tree.map(lambda x: torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) and x.ndim else x,
                              tree, is_leaf=lambda x: isinstance(x, np.ndarray))
    assert tckpt._pack_tree(as_tensors)[1] == jblob
    for back in (tckpt._unpack_tree(jmeta, jblob), jckpt._unpack_tree(tmeta, tblob)):
        assert jax.tree.structure(back) == jax.tree.structure(jckpt._coerce_host(tree))
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jckpt._coerce_host(tree))):
            assert np.array_equal(x, y) and np.asarray(x).dtype == np.asarray(y).dtype


def test_state_codecs_round_trip_like_jax():
    # codecs on state payloads are ported: an fp16 payload is the JAX
    # package's (tests/test_torch_codecs.py holds every codec) and reads
    # back in both packages
    from opendiloco_tpu.diloco import tcp as jtcp
    from opendiloco_tpu.diloco.compression import get_codec as jget_codec

    from opendiloco_torch.diloco import state_io
    from opendiloco_torch.diloco.compression import get_codec

    tree = {"a": np.linspace(-1, 1, 5, dtype=np.float32), "n": np.arange(3, dtype=np.int64)}
    meta, blob = state_io.serialize_state(tree, get_codec("fp16"))
    assert (meta, blob) == jtcp.serialize_state(tree, jget_codec("fp16"))
    assert meta["enc"][1] is None and len(blob) == 5 * 2 + 3 * 8
    for back in (state_io.deserialize_state(meta, blob), jtcp.deserialize_state(meta, blob)):
        assert np.array_equal(back["a"], tree["a"].astype(np.float16).astype(np.float32))
        assert np.array_equal(back["n"], tree["n"])


def test_multihost_sidecar_scoping_matches_jax(tmp_path, tiny_cfg, monkeypatch):
    """The data position is kept per process, the shared files by process
    0 only (``tests/test_ckpt.py`` test_multihost_sidecar_scoping), in
    both packages with the same files and the same reads."""
    _, tstate = _torch_state(tiny_cfg)
    jstate = _jax_state(tiny_cfg)
    seen = {}
    for name, lib, state in (("jax", jckpt, jstate), ("port", tckpt, tstate)):
        kw = dict(diloco_rank=0, diloco_state={"epoch": 1})
        monkeypatch.setattr(lib, "_process_index", lambda: 0)
        lib.save_checkpoint(str(tmp_path / name), 3, state, dataloader_state={"samples_seen": 10},
                            extra={"loss": 1.0}, **kw)
        monkeypatch.setattr(lib, "_process_index", lambda: 1)
        d = lib.save_checkpoint(str(tmp_path / name), 3, state, dataloader_state={"samples_seen": 20},
                                extra={"loss": 2.0}, **kw)
        _, dstate, lstate1, extra = lib.load_checkpoint(d, state)
        monkeypatch.setattr(lib, "_process_index", lambda: 0)
        _, _, lstate0, _ = lib.load_checkpoint(d, state)
        files = {f for f in os.listdir(d) if f != "device_state" and not f.startswith("device_state.")}
        seen[name] = (files, dstate, lstate1, lstate0, extra)
        for f in files:
            seen[name] += (_read(d, f),)
    assert seen["port"] == seen["jax"]
    assert seen["port"][2:5] == ({"samples_seen": 20}, {"samples_seen": 10}, {"loss": 1.0})


def test_legacy_dataloader_sidecar_fallback_matches_jax(tmp_path, tiny_cfg):
    _, tstate = _torch_state(tiny_cfg)
    for name, lib, state in (("jax", jckpt, _jax_state(tiny_cfg)), ("port", tckpt, tstate)):
        d = lib.save_checkpoint(str(tmp_path / name), 4, state, diloco_rank=0)
        with open(os.path.join(d, "dataloader.json"), "w") as f:
            json.dump({"samples_seen": 7}, f)
        assert lib.load_checkpoint(d, state)[2] == {"samples_seen": 7}


def test_remote_path_full_cycle_memory_fs(monkeypatch, tiny_cfg):
    """Every remote branch (open, listdir, exists, probe, retention) over
    fsspec's in-process ``memory://`` filesystem, in both packages. The
    JAX package's Orbax leg is stubbed as in ``tests/test_ckpt.py``; the
    port's device state goes through fsspec too and comes back exact."""
    import fsspec
    import orbax.checkpoint as ocp

    class _StubCkptr:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def save(self, path, state, force=False):
            pass

        def restore(self, path, target):
            return target

    monkeypatch.setattr(ocp, "StandardCheckpointer", _StubCkptr)
    store = fsspec.filesystem("memory")
    store.store.clear()
    trainer, tstate = _torch_state(tiny_cfg)
    want = [p.detach().clone() for p in tllama.flatten_params(tstate["params"])]
    sidecars = dict(diloco_state=_diloco_state(), dataloader_state={"dataset": {"samples_seen": 5}},
                    extra={"loss": 0.5})
    out = {}
    for name, lib, state in (("jax", jckpt, {"step": np.int32(7)}), ("port", tckpt, tstate)):
        root = f"memory://{name}"
        lib.check_checkpoint_path_access(root, rank=0)
        assert not store.ls(f"/{name}", detail=False)
        for step in (3, 7):
            d = lib.save_checkpoint(root, step, state, diloco_rank=0, **sidecars)
        assert d == f"{root}/model_step_7/diloco_rank_0"
        found = lib.get_resume_info(True, root, diloco_rank=0)
        _, dstate, lstate, extra = lib.load_checkpoint(d, state)
        lib.delete_old_checkpoints(root, topk=1)
        out[name] = (found[0], found[2], lstate, extra, lib.get_resume_info(True, root, diloco_rank=0)[2],
                     lib._exists(f"{root}/model_step_3/diloco_rank_0/diloco_state.json"),
                     [store.cat(f"/{name}/model_step_7/diloco_rank_0/{f}") for f in SIDECARS])
        assert dstate["epoch"] == 2
    assert out["port"] == out["jax"]
    assert out["port"][:6] == (True, 7, {"dataset": {"samples_seen": 5}}, {"loss": 0.5}, 7, False)
    # the port's params came back through fsspec, exact
    with torch.no_grad():
        for p in tllama.flatten_params(tstate["params"]):
            p.zero_()
    tckpt.load_checkpoint("memory://port/model_step_7/diloco_rank_0", tstate)
    assert all(torch.equal(a, b) for a, b in zip(tllama.flatten_params(tstate["params"]), want))
    store.store.clear()


# ---------------------------------------------------------------------------
# the device state file
# ---------------------------------------------------------------------------


def test_trainer_state_round_trip_is_bitwise(tmp_path, tiny_cfg):
    """fp16-mixed, so the loss scaler is live: params, AdamW moments, the
    step, both optimizer counts and the scaler come back exactly, into the
    state's own tensors, and the next step from either state is the same."""
    trainer, state = _torch_state(tiny_cfg, precision="fp16-mixed")
    ids = np.random.default_rng(0).integers(0, tiny_cfg.vocab_size, (4, 16)).astype(np.int32)
    batch = trainer.shard_batch(ids, ids.copy(), accum=2)
    for _ in range(3):
        state, _ = trainer.train_step(state, batch)
    state["scaler"] = {"scale": 2.0 ** 13 * 1.5, "good_steps": 3}  # a value a fresh state lacks
    d = tckpt.save_checkpoint(str(tmp_path), 3, state)
    other = trainer.init_state(1)
    leaves, mu = tllama.flatten_params(other["params"]), other["opt_state"]["mu"]
    loaded, dstate, lstate, extra = tckpt.load_checkpoint(d, other)
    assert loaded is other and (dstate, lstate, extra) == (None, None, {})
    assert all(a is b and a.requires_grad for a, b in zip(tllama.flatten_params(other["params"]), leaves))
    assert other["opt_state"]["mu"] is mu
    for key in ("params", "mu", "nu"):
        a = tllama.flatten_params(state["params"]) if key == "params" else state["opt_state"][key]
        b = tllama.flatten_params(other["params"]) if key == "params" else other["opt_state"][key]
        assert all(torch.equal(x, y) for x, y in zip(a, b)), key
    assert (other["step"], other["scaler"]) == (3, {"scale": 2.0 ** 13 * 1.5, "good_steps": 3})
    assert {k: other["opt_state"][k] for k in ("count", "schedule_count")} == {"count": 3, "schedule_count": 3}
    # the file is plain safetensors: names by tree path, the counts in its metadata
    from safetensors import safe_open

    with safe_open(os.path.join(d, "device_state.safetensors"), framework="numpy") as f:
        assert "params.layers.q_proj" in f.keys() and "opt_state.nu.embed_tokens" in f.keys()
        np.testing.assert_array_equal(f.get_tensor("params.layers.q_proj"),
                                      state["params"]["layers"]["q_proj"].detach().numpy())
        assert json.loads(f.metadata()["state"])["opt_state"] == {"count": 3, "schedule_count": 3}
    _, m1 = trainer.train_step(state, batch)
    _, m2 = trainer.train_step(other, batch)
    assert float(m1["loss"]) == float(m2["loss"]) and float(m1["grad_norm"]) == float(m2["grad_norm"])


def test_device_state_that_does_not_fit_raises(tmp_path, tiny_cfg):
    _, state = _torch_state(tiny_cfg)
    d = tckpt.save_checkpoint(str(tmp_path), 1, state)
    wider = InnerTrainer(_tcfg(tiny_cfg, hidden_size=128), TrainerConfig(precision="fp32"),
                         device="cpu").init_state(0)
    with pytest.raises(ValueError, match="params.embed_tokens"):
        tckpt.load_checkpoint(d, wider)
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path / "none"), state)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

DTYPES = {"F32": np.float32, "F16": np.float16, "I32": np.int32, "I64": np.int64}


def _tensors(dtype):
    rng = np.random.default_rng(1)
    shapes = [(3, 5), (7,), (), (0, 4), (2, 1, 3)]
    return {f"t{i}.w": np.asarray(rng.standard_normal(s) * 100).astype(dtype) for i, s in enumerate(shapes)}


@pytest.mark.parametrize("direction", ["port-writes", "port-reads"])
@pytest.mark.parametrize("dtype", [*DTYPES, "BF16"])
def test_safetensors_files_interchange_with_the_package(tmp_path, dtype, direction):
    path = str(tmp_path / "t.safetensors")
    if dtype == "BF16":  # numpy has no bf16: through the package's torch side
        from safetensors.torch import load_file, save_file

        tensors = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _tensors(np.float32).items()}
        if direction == "port-writes":
            safetensors_io.save_file(tensors, path)
            got = load_file(path)
        else:
            save_file(tensors, path)
            with open(path, "rb") as f:
                got = safetensors_io.load_torch(f)[0]
        assert got.keys() == tensors.keys()
        assert all(got[k].dtype == torch.bfloat16 and torch.equal(got[k], tensors[k]) for k in tensors)
        return
    from safetensors.numpy import load_file, save_file

    tensors = _tensors(DTYPES[dtype])
    if direction == "port-writes":
        safetensors_io.save_file(tensors, path, metadata={"k": "v"})
        got = load_file(path)
    else:
        save_file(tensors, path, metadata={"k": "v"})
        got = safetensors_io.load_file(path)
        with open(path, "rb") as f:
            assert safetensors_io.load(f)[1] == {"k": "v"}
    assert got.keys() == tensors.keys()
    for k in tensors:
        assert got[k].dtype == tensors[k].dtype and got[k].shape == tensors[k].shape
        np.testing.assert_array_equal(got[k], tensors[k])


def test_safetensors_refuses_what_it_cannot_read(tmp_path):
    import struct

    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", 1 << 40))
    with pytest.raises(ValueError, match="header"):
        safetensors_io.load_file(str(path))
    header = json.dumps({"x": {"dtype": "F64", "shape": [1], "data_offsets": [0, 8]}}).encode()
    path.write_bytes(struct.pack("<Q", len(header)) + header + bytes(8))
    with pytest.raises(TypeError, match="F64"):
        safetensors_io.load_file(str(path))
    safetensors_io.save_file({"x": np.ones(4, np.float32)}, str(path))
    path.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ValueError, match="ends inside"):
        safetensors_io.load_file(str(path))
    with pytest.raises(TypeError, match="float64"):
        safetensors_io.save_file({"x": np.ones(2)}, str(path))


# ---------------------------------------------------------------------------
# HF weight directories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_jax_weights_directory_loads_in_the_port(tmp_path, tiny_cfg, tied):
    from opendiloco_tpu.models.hf_io import save_params as jsave

    jcfg = dataclasses.replace(tiny_cfg, tie_word_embeddings=tied)
    params = _np_params(_tcfg(jcfg), 3)
    jsave(params, jcfg, str(tmp_path))
    cfg, got = thf.get_model(str(tmp_path))
    assert dataclasses.asdict(cfg) == {**dataclasses.asdict(jcfg), "num_key_value_heads": jcfg.kv_heads}
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert a.dtype == np.float32 and a.flags.c_contiguous and np.array_equal(a, b)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_port_weights_directory_loads_in_jax(tmp_path, tiny_cfg, tied):
    from opendiloco_tpu.models.hf_io import get_model as jget_model

    cfg = _tcfg(tiny_cfg, tie_word_embeddings=tied)
    trainer = InnerTrainer(cfg, TrainerConfig(precision="fp32"), device="cpu")
    params = trainer.init_state(5)["params"]  # tensors that require grad
    thf.save_params(params, cfg, str(tmp_path))
    jcfg, got = jget_model(str(tmp_path))
    assert jcfg.to_dict() == cfg.to_dict()
    want = params_to_numpy(params)
    assert jax.tree.structure(jax.device_get(got)) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(jax.device_get(got)), jax.tree.leaves(want)):
        assert np.array_equal(np.asarray(a), b)


def test_weights_directory_checks_shapes_and_refuses_moe(tmp_path, tiny_cfg):
    cfg = _tcfg(tiny_cfg)
    thf.save_params(_np_params(cfg, 0), cfg, str(tmp_path))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dataclasses.replace(cfg, intermediate_size=96).to_dict(), f)
    with pytest.raises(ValueError, match="shapes mismatch"):
        thf.get_model(str(tmp_path))
    moe = dataclasses.replace(cfg, num_experts=2)
    with pytest.raises(ValueError, match="MoE"):
        thf.save_params({}, moe, str(tmp_path / "moe"))
    with pytest.raises(ValueError, match="MoE"):
        thf.load_params(str(tmp_path), moe)


# ---------------------------------------------------------------------------
# command line, metric logger, profiler
# ---------------------------------------------------------------------------

ARGVS = [
    [],
    ["--path-model", "2m", "--fake-data", "--seq-length", "64"],
    ["--diloco.local-steps", "500", "--diloco.world_rank", "3", "--no-diloco.outer-nesterov"],
    ["--ckpt.interval=10", "--ckpt.resume", "--lr", "1e-3"],
    ["--no-ckpt.interval", "--remat", "dots", "--adam-betas", "0.9,0.99"],
    ["--lr", "1", "--lr", "2"],
    ["--ckpt.path", "gs://b/x", "--ckpt.resume", "/ckpts/model_step_10", "--fake-data"],
    ["--serve.prefill-buckets", "64,256"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "empty")
def test_parse_argv_matches_jax(argv):
    from opendiloco_tpu.config import parse_argv as jparse

    assert parse_argv(argv) == jparse(argv)


@pytest.mark.parametrize("argv", [["positional"], ["--a", "1", "--a.b", "2"]])
def test_parse_argv_refuses_as_jax_does(argv):
    from opendiloco_tpu.config import parse_argv as jparse

    for fn in (jparse, parse_argv):
        with pytest.raises(ValueError):
            fn(argv)


def test_config_from_argv_matches_jax():
    """The fields the port reads take the JAX package's values from the
    same command line (strings converted to each field's type)."""
    from opendiloco_tpu.config import Config as JConfig

    argv = ["--path-model", "2m", "--fake-data", "--fake-data-mode", "ramp", "--seq-length", "64",
            "--lr", "1e-3", "--warmup-steps", "4", "--total-steps", "20", "--precision", "fp32",
            "--per-device-train-batch-size", "4", "--total-batch-size", "32", "--no-remat", "--fused-loss", "false",
            "--adam-betas", "0.9,0.99", "--eval-interval", "5", "--profile-dir", "trace", "--profile-start", "2",
            "--metric-logger-type", "jsonl", "--ckpt.path", "out", "--ckpt.interval", "10", "--ckpt.topk", "2",
            "--ckpt.resume", "true", "--diloco.local-steps", "4", "--diloco.backend", "loopback",
            "--diloco.outer-lr", "0.5", "--diloco.average-state-every", "2", "--diloco.skip-load-from-peers"]
    tc, jc = Config(**parse_argv(argv)), JConfig(**parse_argv(argv))
    for f in dataclasses.fields(Config):
        if f.name in ("ckpt", "diloco", "serve", "fleet", "project"):
            continue
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    for section in ("ckpt", "diloco"):
        for f in dataclasses.fields(getattr(tc, section)):
            assert getattr(getattr(tc, section), f.name) == getattr(getattr(jc, section), f.name), (section, f.name)
    assert (tc.seq_length, tc.ckpt.interval, tc.remat, tc.fused_loss) == (64, 10, False, False)


def test_jsonl_logger_writes_the_jax_packages_file(tmp_path):
    from opendiloco_tpu.utils.logger import JsonlLogger as JJsonl
    from opendiloco_tpu.utils.logger import read_jsonl as jread

    from opendiloco_torch.utils.logger import get_logger, read_jsonl

    rows = [{"Loss": np.float32(2.5), "step": 1, "lr": 1e-3, "outer": {"a": np.float64(0.25), "b": None},
             "name": "x", "ok": True},
            {"Loss": 2.25, "step": 2, "grad_norm": np.array(0.5, np.float32), "obj": object.__name__}]
    for path, logger in ((tmp_path / "jax.jsonl", JJsonl(str(tmp_path / "jax.jsonl"), {})),
                         (tmp_path / "port.jsonl", get_logger("jsonl", str(tmp_path / "port.jsonl"), {}))):
        for r in rows:
            logger.log(r)
        logger.finish()
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    with open(tmp_path / "port.jsonl", "a") as f:
        f.write('{"Loss": 1.0, "st')  # a killed writer's last partial line
    assert read_jsonl(str(tmp_path / "port.jsonl")) == jread(str(tmp_path / "port.jsonl"))
    assert len(read_jsonl(str(tmp_path / "port.jsonl"))) == 2


@pytest.mark.parametrize("start,steps,trace", [(1, 2, "trace_rank0_step3.json"), (3, 5, "trace_rank0_step4.json")],
                         ids=["inside", "past-the-end"])
def test_profiler_window_writes_a_chrome_trace(tmp_path, start, steps, trace):
    """A window inside the run ends at its last step; one that reaches past
    ``total_steps`` is written when the run ends."""
    summary = train(Config(path_model="2m", fake_data=True, seq_length=32, per_device_train_batch_size=2,
                           total_batch_size=2, warmup_steps=1, total_steps=4, precision="fp32",
                           metric_logger_type="dummy", project=str(tmp_path / "m.pkl"),
                           profile_dir=str(tmp_path / "prof"), profile_start=start, profile_steps=steps),
                    device="cpu")
    assert summary["step"] == 4
    assert os.listdir(tmp_path / "prof") == [trace]
    with open(tmp_path / "prof" / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("trainer.backward" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------


def _rows(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_train_from_a_weights_directory_with_resume_matches_jax(tmp_path, tiny_cfg, monkeypatch):
    """One weights directory, written by the JAX package's ``save_params``
    from numpy; both packages' ``train()`` start from it (tiny config, fake
    data, fp32), checkpoint at step 3 and run to 6, then resume from step
    3 into a second folder. The JAX side runs in-process on a one-device
    CPU mesh. Losses rtol 1e-5, final params atol 1e-6 (both f32, sums in
    another order); each package's resumed rows equal its own unbroken
    run's."""
    from opendiloco_tpu import train as jtrain_mod
    from opendiloco_tpu.config import Config as JConfig
    from opendiloco_tpu.models.hf_io import save_params as jsave
    from opendiloco_tpu.trainer import InnerTrainer as JInnerTrainer
    from opendiloco_tpu.trainer import TrainerConfig as JTrainerConfig

    one = [jax.devices()[0]]
    monkeypatch.setattr(jtrain_mod, "build_mesh", lambda strategy, **kw: build_mesh(strategy, devices=one, **kw))
    wdir = str(tmp_path / "weights")
    jsave(_np_params(_tcfg(tiny_cfg), 11), tiny_cfg, wdir)
    base = dict(path_model=wdir, fake_data=True, seq_length=32, per_device_train_batch_size=4,
                total_batch_size=8, warmup_steps=2, total_steps=6, lr=1e-3, precision="fp32", remat=False,
                attn_implementation="xla", metric_logger_type="dummy")
    rows = {}
    for name, run, cls in (("jax", jtrain_mod.train, JConfig), ("port", lambda c: train(c, device="cpu"), Config)):
        full = dict(base, project=str(tmp_path / f"{name}-full.pkl"),
                    ckpt=dict(path=str(tmp_path / f"{name}-a"), interval=3))
        resumed = dict(base, project=str(tmp_path / f"{name}-resumed.pkl"),
                       ckpt=dict(path=str(tmp_path / f"{name}-b"), interval=3,
                                 resume=str(tmp_path / f"{name}-a" / "model_step_3")))
        run(cls(**full))
        run(cls(**resumed))
        rows[name] = (_rows(full["project"]), _rows(resumed["project"]))
        assert [r["step"] for r in rows[name][1]] == [4, 5, 6]
        assert [r["Loss"] for r in rows[name][1]] == [r["Loss"] for r in rows[name][0][3:]]
    for j, t in zip(rows["jax"], rows["port"]):
        np.testing.assert_allclose([r["Loss"] for r in t], [r["Loss"] for r in j], rtol=1e-5)
        assert [r["lr"] for r in t] == pytest.approx([r["lr"] for r in j], rel=1e-6)
    # final params of the resumed runs, from their step-6 checkpoints
    jtrainer = JInnerTrainer(tiny_cfg, JTrainerConfig(precision="fp32", remat=False),
                             build_mesh("NO_SHARD", devices=one))
    jstate = jckpt.load_checkpoint(str(tmp_path / "jax-b" / "model_step_6"),
                                   jtrainer.init_state(jax.random.key(0)))[0]
    from safetensors.numpy import load_file

    tfile = load_file(str(tmp_path / "port-b" / "model_step_6" / "device_state.safetensors"))
    jparams = jax.tree_util.tree_flatten_with_path(jax.device_get(jstate["params"]))[0]
    assert len(jparams) == sum(k.startswith("params.") for k in tfile)
    for path, leaf in jparams:
        name = "params." + ".".join(p.key for p in path)
        np.testing.assert_allclose(tfile[name], np.asarray(leaf), atol=1e-6, rtol=0)


def _diloco_masters(make_step, n_steps, local_steps):
    """Two workers in threads; each records its master after every outer
    step. ``make_step(rank)`` returns (opt, step_fn)."""
    from test_diloco import batches

    masters, errors = [[], []], []

    def worker(rank):
        try:
            opt, step = make_step(rank)
            for ids, labels in batches(1000 + rank, 256, n_steps):
                if step(ids, labels):
                    masters[rank].append([np.array(m, np.float32) for m in opt.master])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return masters


def test_average_state_every_matches_jax(tiny_cfg):
    """``average_state_every`` 2 over two loopback workers that start from
    different weights: their masters differ after the first outer step and
    are equal from the second on, where the all-reduce of the masters first
    runs (averaged pseudo-gradients keep equal masters equal); the port's
    masters match the JAX host path's at atol 1e-5 after each of the 4."""
    from opendiloco_tpu.config import DilocoConfig as JDilocoConfig
    from opendiloco_tpu.diloco import DiLoCoOptimizer as JDiLoCoOptimizer
    from opendiloco_tpu.diloco import LoopbackWorld as JLoopbackWorld
    from test_diloco import make_trainer

    kw = dict(local_steps=2, average_state_every=2, backend="loopback", timeout_waiting_for_peers=30.0,
              averaging_timeout=60.0)
    params = [_np_params(_tcfg(tiny_cfg), 20 + r) for r in range(2)]
    jbackends, tbackends = JLoopbackWorld(2).make_backends(), LoopbackWorld(2).make_backends()

    def jax_worker(rank):
        trainer = make_trainer(tiny_cfg)
        box = {"state": trainer.init_state(jax.random.key(0), params=params[rank])}
        opt = JDiLoCoOptimizer(trainer, jbackends[rank], JDilocoConfig(**kw), box["state"], batch_size=8)

        def step(ids, labels):
            box["state"], m = opt.step(box["state"], trainer.shard_batch(ids, labels, accum=1))
            return "outer_step_s" in m

        return opt, step

    def port_worker(rank):
        tc = TrainerConfig(lr=1e-3, warmup_steps=2, total_steps=200, precision="fp32", remat=False)
        trainer = InnerTrainer(_tcfg(tiny_cfg), tc, device="cpu")
        box = {"state": trainer.init_state(params=params[rank])}
        opt = DiLoCoOptimizer(trainer, tbackends[rank], DilocoConfig(**kw), box["state"], batch_size=8)

        def step(ids, labels):
            box["state"], m = opt.step(box["state"], trainer.shard_batch(ids, labels, accum=1))
            return "outer_step_s" in m

        return opt, step

    jm = _diloco_masters(jax_worker, 8, 2)
    tm = _diloco_masters(port_worker, 8, 2)
    assert len(tm[0]) == len(tm[1]) == len(jm[0]) == 4
    for rnd in range(4):
        same = all(np.array_equal(a, b) for a, b in zip(tm[0][rnd], tm[1][rnd]))
        assert same == (rnd >= 1), rnd
        for rank in range(2):
            for a, b in zip(tm[rank][rnd], jm[rank][rnd]):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
