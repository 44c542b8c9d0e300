"""Gossip rounds through the port's entry points over real sockets, on the
CPU.

- The command line: ``python -m opendiloco_torch.diloco.rendezvous`` and
  two ``python -m opendiloco_torch.train --diloco.outer-mode gossip``
  processes (2m, four steps, two outer rounds, the outer plane on the
  device, blockwise4bit with error feedback), async matching
  (``ODTP_ASYNC_STALENESS`` 1, a patience long enough that the two meet
  at every boundary). Both end with the same master and momentum bit for
  bit in their checkpoints, and each checkpoint carries its per-partner
  residuals (``gossip_ef``, keyed by the other worker).
- ``train()`` in two threads, each handed a port ``TcpBackend``, lockstep
  pairs with streaming fragments (eager): both workers' checkpoints hold
  the same master bit for bit.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time

import numpy as np

from opendiloco_torch.config import Config
from opendiloco_torch.diloco import state_io
from opendiloco_torch.diloco.rendezvous import RendezvousServer
from opendiloco_torch.diloco.tcp import TcpBackend
from opendiloco_torch.train import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, LOCAL_STEPS = 4, 2


def _read_diloco_state(ckpt: pathlib.Path, rank: int) -> dict:
    d = ckpt / f"model_step_{STEPS}" / f"diloco_rank_{rank}"
    meta = json.loads((d / "diloco_state.json").read_text())
    with open(d / "diloco_state.bin", "rb") as f:
        return state_io.read_state(meta, f)


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(np.ascontiguousarray(x, np.float32).view(np.uint32),
                       np.ascontiguousarray(y, np.float32).view(np.uint32)) for x, y in zip(a, b))


def test_cli_gossip_galaxy_async_on_the_device_plane(tmp_path):
    env = dict(os.environ, OPENDILOCO_TORCH_DEVICE="cpu", CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", ODTP_STATE_CODEC="none", ODTP_ASYNC_STALENESS="1",
               ODTP_ASYNC_PATIENCE_S="90")
    env.pop("ODTP_CHAOS", None)
    procs = []
    try:
        daemon = subprocess.Popen(
            [sys.executable, "-m", "opendiloco_torch.diloco.rendezvous", "--host", "127.0.0.1", "--port", "0"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        procs.append(daemon)
        m = re.search(r"initial_peers = (\S+:\d+)", daemon.stdout.readline())
        assert m, "the daemon did not announce its address"
        for rank in (0, 1):
            cmd = [sys.executable, "-m", "opendiloco_torch.train", "--path-model", "2m", "--fake-data",
                   "--seq-length", "32", "--per-device-train-batch-size", "4", "--total-batch-size", "4",
                   "--total-steps", str(STEPS), "--precision", "fp32", "--metric-logger-type", "dummy",
                   "--project", str(tmp_path / f"rows{rank}.pkl"), "--diloco.local-steps", str(LOCAL_STEPS),
                   "--diloco.initial-peers", m.group(1), "--diloco.world-rank", str(rank),
                   "--diloco.galaxy-size", "2", "--diloco.outer-mode", "gossip", "--diloco.outer-placement",
                   "device", "--diloco.compression", "blockwise4bit", "--diloco.error-feedback",
                   "--ckpt.path", str(tmp_path / "ckpt"), "--ckpt.interval", str(STEPS)]
            with open(tmp_path / f"worker{rank}.log", "w") as log:
                procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 240
        for rank, p in enumerate(procs[1:]):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            assert rc == 0, (tmp_path / f"worker{rank}.log").read_text()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
    states = [_read_diloco_state(tmp_path / "ckpt", r) for r in (0, 1)]
    assert all(s["epoch"] == STEPS // LOCAL_STEPS for s in states)
    assert _same(states[0]["master"], states[1]["master"])
    assert _same(states[0]["outer_opt"]["bufs"], states[1]["outer_opt"]["bufs"])
    for rank, s in enumerate(states):
        assert "ef_residual" not in s and list(s["gossip_ef"]) == [f"worker-{1 - rank}"]
        log = (tmp_path / f"worker{rank}.log").read_text()
        assert log.count("gossip exchange over 2 peers") == STEPS // LOCAL_STEPS, log[-2000:]


def test_train_gossip_over_tcp_streaming(tmp_path, monkeypatch):
    monkeypatch.setenv("ODTP_STATE_CODEC", "none")
    daemon = RendezvousServer("127.0.0.1", 0).start_in_thread()
    backends = [TcpBackend([daemon.address], peer_id=f"worker-{r}", matchmaking_time=2.0) for r in (0, 1)]
    errors = []

    def run(rank):
        try:
            cfg = Config(path_model="2m", fake_data=True, seq_length=32, per_device_train_batch_size=4,
                         total_batch_size=4, total_steps=STEPS, precision="fp32", metric_logger_type="dummy",
                         project=str(tmp_path / f"rows{rank}.pkl"),
                         ckpt=dict(path=str(tmp_path / "ckpt"), interval=STEPS),
                         diloco=dict(local_steps=LOCAL_STEPS, backend="tcp", world_rank=rank, galaxy_size=2,
                                     outer_mode="gossip", streaming_fragments=2, overlap_comm="eager",
                                     outer_placement="host", timeout_waiting_for_peers=30.0,
                                     averaging_timeout=60.0))
            assert train(cfg, backends[rank], device="cpu")["step"] == STEPS
        except Exception as e:  # pragma: no cover
            errors.append((rank, e))

    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        for b in backends:
            b.close()
        daemon.stop()
    assert not errors, errors
    states = [_read_diloco_state(tmp_path / "ckpt", r) for r in (0, 1)]
    assert _same(states[0]["master"], states[1]["master"])
    for b in backends:
        pairs = [h for h in b.round_ledger if h.get("gossip")]
        assert len(pairs) == 2 * STEPS // LOCAL_STEPS and all(h["group_size"] == 2 for h in pairs)
