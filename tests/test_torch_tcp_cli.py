"""A galaxy of the port's command-line workers over real sockets, on the
CPU: ``python -m opendiloco_torch.diloco.rendezvous`` and two ``python -m
opendiloco_torch.train --diloco.initial-peers ...`` processes (2m, four
steps, two outer rounds, no backend handed in), then a late port worker
onboarded by a JAX ``TcpBackend``'s state (the JAX package's encoding,
``ODTP_STATE_CODEC=none``).

Both CLI workers end with bit-equal masters (their checkpoints' DiLoCo
state), and the late worker adopts the served master, epoch and outer
momentum bit for bit.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

from opendiloco_tpu.diloco.backend import PeerProgress as JPeerProgress
from opendiloco_tpu.diloco.tcp import TcpBackend as JTcpBackend
from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco import DiLoCoOptimizer, state_io
from opendiloco_torch.diloco.tcp import TcpBackend
from opendiloco_torch.models import hf_io
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, LOCAL_STEPS = 4, 2


def _env(**extra):
    env = dict(os.environ, OPENDILOCO_TORCH_DEVICE="cpu", CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", ODTP_EXPECT_PEERS="2", ODTP_STATE_CODEC="none", **extra)
    env.pop("ODTP_CHAOS", None)
    return env


def _worker_cmd(rank: int, address: str, tmp: pathlib.Path) -> list[str]:
    return [sys.executable, "-m", "opendiloco_torch.train", "--path-model", "2m", "--fake-data",
            "--seq-length", "32", "--per-device-train-batch-size", "4", "--total-batch-size", "4",
            "--total-steps", str(STEPS), "--precision", "fp32", "--metric-logger-type", "dummy",
            "--project", str(tmp / f"rows{rank}.pkl"),
            "--diloco.local-steps", str(LOCAL_STEPS), "--diloco.initial-peers", address,
            "--diloco.world-rank", str(rank), "--diloco.galaxy-size", "2",
            "--ckpt.path", str(tmp / "ckpt"), "--ckpt.interval", str(STEPS)]


def _read_diloco_state(tmp: pathlib.Path, rank: int) -> dict:
    d = tmp / "ckpt" / f"model_step_{STEPS}" / f"diloco_rank_{rank}"
    meta = json.loads((d / "diloco_state.json").read_text())
    with open(d / "diloco_state.bin", "rb") as f:
        return state_io.read_state(meta, f)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def test_cli_galaxy_and_late_worker_onboarding(tmp_path, monkeypatch):
    env = _env()
    procs = []
    try:
        daemon = subprocess.Popen(
            [sys.executable, "-m", "opendiloco_torch.diloco.rendezvous", "--host", "127.0.0.1", "--port", "0",
             "--identity-file", str(tmp_path / "rendezvous_identity")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        procs.append(daemon)
        m = re.search(r"initial_peers = (\S+:\d+)", daemon.stdout.readline())
        assert m, "the daemon did not announce its address"
        address = m.group(1)
        for rank in (0, 1):
            with open(tmp_path / f"worker{rank}.log", "w") as log:
                procs.append(subprocess.Popen(_worker_cmd(rank, address, tmp_path), cwd=ROOT, env=env, stdout=log,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 240
        for rank, p in enumerate(procs[1:]):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            assert rc == 0, (tmp_path / f"worker{rank}.log").read_text()[-4000:]
        assert (tmp_path / "rendezvous_identity").read_text().strip()

        states = [_read_diloco_state(tmp_path, r) for r in (0, 1)]
        for s in states:
            assert s["epoch"] == STEPS // LOCAL_STEPS
        for a, b in zip(states[0]["master"], states[1]["master"]):
            assert a.shape == b.shape and np.array_equal(_bits(a), _bits(b))
        for a, b in zip(states[0]["outer_opt"]["bufs"], states[1]["outer_opt"]["bufs"]):
            assert np.array_equal(_bits(a), _bits(b))
        for r in (0, 1):  # both rounds over both workers
            log = (tmp_path / f"worker{r}.log").read_text()
            assert log.count("all-reduce over 2 peers") == STEPS // LOCAL_STEPS, log[-2000:]

        # a late port worker onboards from a JAX worker serving rank 0's state
        monkeypatch.setenv("ODTP_STATE_CODEC", "none")
        served = {"master": states[0]["master"], "epoch": states[0]["epoch"], "outer_opt": states[0]["outer_opt"]}
        jserver = JTcpBackend([address], peer_id="worker-0", matchmaking_time=2.0)
        late = TcpBackend([address], peer_id="worker-2", matchmaking_time=2.0)
        try:
            jserver.serve_state(lambda: served)
            jserver.report_progress(JPeerProgress("worker-0", served["epoch"], 0, 1.0, time.time()))
            cfg, _ = hf_io.get_model("2m")
            trainer = InnerTrainer(cfg, TrainerConfig(precision="fp32", total_steps=STEPS), device="cpu")
            state = trainer.init_state(123)
            opt = DiLoCoOptimizer(trainer, late, DilocoConfig(local_steps=LOCAL_STEPS, backend="tcp",
                                                              outer_placement="host"), state, batch_size=4)
            state = opt.load_state_from_peers(state)
            assert state is not None and opt.epoch == served["epoch"]
            params = tllama.flatten_params(state["params"])
            for mine, theirs, p in zip(opt.master, served["master"], params):
                assert np.array_equal(_bits(mine), _bits(theirs))
                assert np.array_equal(_bits(p.detach().numpy()), _bits(theirs))
            sd = opt.state_dict()
            for mine, theirs in zip(sd["outer_opt"]["bufs"], served["outer_opt"]["bufs"]):
                assert np.array_equal(_bits(mine), _bits(theirs))
        finally:
            late.close()
            jserver.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
