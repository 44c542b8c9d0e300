"""Resume oracles of the port: a run broken at a checkpoint and resumed
reproduces the unbroken run.

The patterns of the JAX package's integration tests
(``tests/test_training/test_train.py`` ``test_train_and_resume_deterministic``
and ``test_multi_worker_resume_deterministic``): run N steps with
checkpoints, run again resuming mid-way, and hold the rows of the
overlapping steps against each other. On the CPU every op of a step
repeats bit for bit, so losses, LRs and gradient norms must be equal,
not close (the reference allows loss atol 1e-3; the port needs none).

The file imports no JAX, so the card cases run on the card machine too
(``python -m pytest --noconftest tests/test_torch_resume.py``); whether a
card is there is decided in the ``cuda`` fixture.
"""
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from opendiloco_torch import ckpt as ckpt_lib
from opendiloco_torch.config import Config
from opendiloco_torch.diloco import LoopbackWorld
from opendiloco_torch.models.llama import flatten_params
from opendiloco_torch.train import train
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_KEYS = ("Loss", "lr", "grad_norm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rows(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_rows_equal(resumed, full, first_step):
    by_step = {r["step"]: r for r in full}
    assert [r["step"] for r in resumed] == list(range(first_step, max(by_step) + 1))
    for r in resumed:
        for k in ROW_KEYS:
            assert r[k] == by_step[r["step"]][k], (r["step"], k, r[k], by_step[r["step"]][k])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


# Runs the CLI module as ``python -m`` does, and at exit writes the
# process's thread settings and MKL/OMP environment to stderr between two
# markers: what a failed exact comparison of two processes reports.
_CLI = """
import atexit, json, os, runpy, sys
def _report():
    import torch
    env = {k: v for k, v in os.environ.items() if k.startswith(("MKL", "OMP", "KMP"))}
    sys.stderr.write("THREADS_BEGIN\\n" + torch.__config__.parallel_info()
                     + "env " + json.dumps(env, sort_keys=True) + "\\nTHREADS_END\\n")
atexit.register(_report)
sys.argv[0] = "opendiloco_torch.train"
runpy.run_module("opendiloco_torch.train", run_name="__main__", alter_sys=True)
"""


def _cli(args, device="cpu", timeout=300, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "OPENDILOCO_TORCH_DEVICE"}
    if device is not None:
        env["OPENDILOCO_TORCH_DEVICE"] = device
    env.update(extra_env or {})
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", _CLI, *args], capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=REPO)


def _threads(stderr: str) -> str:
    """The thread settings a CLI process reported at exit."""
    if "THREADS_BEGIN" not in stderr:
        return "(not reported)"
    return stderr.split("THREADS_BEGIN", 1)[1].split("THREADS_END", 1)[0].strip()


def _cli_args(tmp_path, project, precision="fp32"):
    return ["--path-model", "2m", "--fake-data", "--seq-length", "64", "--per-device-train-batch-size", "4",
            "--total-batch-size", "8", "--lr", "1e-3", "--warmup-steps", "4", "--total-steps", "20",
            "--precision", precision, "--metric-logger-type", "dummy", "--project", str(project),
            "--ckpt.path", str(tmp_path / "ckpts"), "--ckpt.interval", "10"]


def _cli_resume(tmp_path, device, precision):
    full = tmp_path / "full.pkl"
    r_full = _cli(_cli_args(tmp_path, full, precision), device)
    assert r_full.returncode == 0, r_full.stderr[-3000:]
    resumed = tmp_path / "resumed.pkl"
    r_res = _cli(_cli_args(tmp_path, resumed, precision)
                 + ["--ckpt.resume", str(tmp_path / "ckpts" / "model_step_10")], device)
    assert r_res.returncode == 0, r_res.stderr[-3000:]
    assert len(_rows(full)) == 20
    rows_full, rows_res = _rows(full), _rows(resumed)
    try:
        _assert_rows_equal(rows_res, rows_full, 11)
    except AssertionError:
        # the check stays exact; a miss says what differed between the two
        # processes: their rows at the first differing step, their thread
        # settings, their MKL/OMP environment
        by_step = {r["step"]: r for r in rows_full}
        first = next((r for r in rows_res if any(r[k] != by_step.get(r["step"], {}).get(k) for k in ROW_KEYS)),
                     None)
        step = None if first is None else first["step"]
        raise AssertionError(
            f"resumed rows differ from the full run's; first differing step {step}\n"
            f"full run's row: {by_step.get(step)}\nresumed run's row: {first}\n"
            f"full run's process:\n{_threads(r_full.stderr)}\nresumed run's process:\n{_threads(r_res.stderr)}\n"
            f"steps: full {[r['step'] for r in rows_full]}, resumed {[r['step'] for r in rows_res]}")


def test_cli_train_and_resume_deterministic(tmp_path):
    """``python -m opendiloco_torch.train`` on the CPU: 20 steps with a
    checkpoint at 10, then a run resuming from ``model_step_10``."""
    _cli_resume(tmp_path, "cpu", "fp32")


def test_cli_rows_do_not_depend_on_mkl_threads(tmp_path):
    """The CLI's CPU rows are the same bits whatever number of threads MKL
    runs on (ROADMAP.md C5: the CLI pins MKL's strict reproducible mode,
    ``device.pin_cpu_gemm_bits``, and one CPU thread,
    ``device.pin_cpu_threads``; without the first, 2 threads against 8
    moved ``Loss`` or ``grad_norm`` at nine of these 20 steps)."""
    rows = {}
    for n in (2, 8):
        project = tmp_path / f"mkl{n}.pkl"
        r = _cli(_cli_args(tmp_path / f"run{n}", project), extra_env={"MKL_NUM_THREADS": str(n)})
        assert r.returncode == 0, r.stderr[-3000:]
        rows[n] = _rows(project)
    assert len(rows[8]) == 20
    _assert_rows_equal(rows[2], rows[8], 1)


def test_cli_without_a_device_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the default device where there is no card")
    r = _cli(_cli_args(tmp_path, tmp_path / "m.pkl"), device=None, timeout=120)
    assert r.returncode != 0
    assert "OPENDILOCO_TORCH_DEVICE=cpu" in r.stderr
    assert not (tmp_path / "ckpts").exists()


# ---------------------------------------------------------------------------
# two loopback workers in threads
# ---------------------------------------------------------------------------


def _worker_config(tmp_path, rank, name, ckpt):
    return Config(path_model="2m", fake_data=True, fake_data_mode="ramp", seq_length=64,
                  per_device_train_batch_size=4, total_batch_size=8, warmup_steps=2, total_steps=12, lr=3e-3,
                  metric_logger_type="dummy", project=str(tmp_path / f"{name}-{rank}.pkl"), precision="fp32",
                  ckpt=ckpt,
                  diloco=dict(local_steps=4, backend="loopback", world_rank=rank, timeout_waiting_for_peers=30.0))


def _run_two_workers(tmp_path, name, ckpt):
    backends = LoopbackWorld(2).make_backends()
    errors = []

    def run(rank):
        try:
            train(_worker_config(tmp_path, rank, name, ckpt), backends[rank], device="cpu")
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return [_rows(tmp_path / f"{name}-{r}.pkl") for r in range(2)]


@pytest.mark.parametrize("interval,resume_at", [(4, 8), (2, 6)], ids=["epoch-boundary", "mid-epoch"])
def test_multi_worker_resume_deterministic(tmp_path, interval, resume_at):
    """Two workers, local_steps 4, 12 steps (3 outer rounds) with a
    checkpoint every ``interval`` steps; two fresh workers on a fresh
    loopback world resume from ``model_step_{resume_at}``. At 6 the
    checkpoint sits inside an epoch (local step 2 of 4), so the DiLoCo
    local step, the samples of the epoch and the loader's position all
    have to come back. Both runs' step-12 checkpoints (params, AdamW
    moments, master, outer momentum) are the same bytes."""
    full = _run_two_workers(tmp_path, "full", dict(path=str(tmp_path / "a"), interval=interval))
    d = tmp_path / "a" / f"model_step_{resume_at}"
    assert sorted(os.listdir(d)) == ["diloco_rank_0", "diloco_rank_1"]
    assert sorted(os.listdir(d / "diloco_rank_0")) == [
        "dataloader_0.json", "device_state.safetensors", "diloco_state.bin", "diloco_state.json",
        "global_state.json"]
    resumed = _run_two_workers(tmp_path, "resumed", dict(path=str(tmp_path / "b"), interval=interval,
                                                         resume=str(d)))
    for rank in range(2):
        _assert_rows_equal(resumed[rank], full[rank], resume_at + 1)
        assert [r["outer_epoch"] for r in resumed[rank] if "outer_step_s" in r] == [
            e for e in (1, 2, 3) if 4 * e > resume_at]
        last = os.path.join("model_step_12", f"diloco_rank_{rank}")
        for f in sorted(os.listdir(tmp_path / "a" / last)):
            assert (tmp_path / "b" / last / f).read_bytes() == (tmp_path / "a" / last / f).read_bytes(), f


def test_resume_true_finds_the_latest_and_topk_keeps_two(tmp_path):
    """``ckpt.resume=True`` discovers the newest step under ``ckpt.path``;
    ``ckpt.topk`` 2 leaves the two newest."""
    cfg = dict(path_model="2m", fake_data=True, seq_length=32, per_device_train_batch_size=4,
               total_batch_size=4, warmup_steps=1, total_steps=6, precision="fp32", metric_logger_type="jsonl")
    train(Config(**cfg, project=str(tmp_path / "full.jsonl"),
                 ckpt=dict(path=str(tmp_path / "c"), interval=2, topk=2)), device="cpu")
    assert sorted(os.listdir(tmp_path / "c")) == ["model_step_4", "model_step_6"]
    summary = train(Config(**{**cfg, "total_steps": 8}, project=str(tmp_path / "more.jsonl"),
                           ckpt=dict(path=str(tmp_path / "c"), resume=True)), device="cpu")
    assert summary["step"] == 8 and summary["ckpt_load_s"] > 0
    from opendiloco_torch.utils.logger import read_jsonl

    assert [r["step"] for r in read_jsonl(tmp_path / "more.jsonl")] == [7, 8]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_state_saved_on_the_card_loads_bit_for_bit(cuda, tmp_path):
    from opendiloco_torch.models.hf_io import load_config

    cfg = load_config("2m")
    tr = InnerTrainer(cfg, TrainerConfig(warmup_steps=1, total_steps=10), device=cuda)
    state = tr.init_state(0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)
    batch = tr.shard_batch(ids, ids.copy(), accum=2)
    for _ in range(2):
        state, _ = tr.train_step(state, batch)
    d = ckpt_lib.save_checkpoint(str(tmp_path), 2, state)
    other = tr.init_state(1)
    other, *_ = ckpt_lib.load_checkpoint(d, other)
    for a, b in zip(flatten_params(state["params"]) + state["opt_state"]["mu"] + state["opt_state"]["nu"],
                    flatten_params(other["params"]) + other["opt_state"]["mu"] + other["opt_state"]["nu"]):
        assert b.device == a.device and torch.equal(a, b)
    assert {k: other[k] for k in ("step", "scaler")} == {k: state[k] for k in ("step", "scaler")}
    assert other["opt_state"]["count"] == state["opt_state"]["count"] == 2
    # the next step from either state is the same, bit for bit
    _, m1 = tr.train_step(state, batch)
    _, m2 = tr.train_step(other, batch)
    assert float(m1["loss"]) == float(m2["loss"]) and float(m1["grad_norm"]) == float(m2["grad_norm"])


@pytest.mark.cuda
def test_cli_resume_on_the_card_is_bitwise(cuda, tmp_path):
    """The CLI on the card (the default device) in bf16 through the
    flash-attention kernels: the resumed rows equal the unbroken run's."""
    _cli_resume(tmp_path, None, "bf16-mixed")
