"""A sharded DiLoCo worker of the port on the CPU: the world-messenger
split and the multihost command line, over gloo groups of separate
processes (``tests/torch_dist_child.py``; ``file://`` stores under
``tmp_path``).

- A worker of two ranks under a one-worker loopback galaxy gives the
  masters of the single-process worker after every step (atol 1e-5, the
  tolerance of the DiLoCo parity tests: the ranks' gradient sums
  re-associate f32 additions, and the outer step multiplies pseudo-gradient
  differences by lr 0.7 and momentum; the fp16 codec of one case rounds
  them too). Only rank 0 holds a backend.
- ``python -m opendiloco_torch.train --multihost`` over two processes under
  FULL_SHARD writes one data position per process, resumes bit for bit,
  and its checkpoint holds the one-process run's whole leaves and loads
  at one process.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

from opendiloco_torch.config import DilocoConfig
from opendiloco_torch.diloco import DiLoCoOptimizer, LoopbackWorld
from opendiloco_torch.models import llama as tllama
from opendiloco_torch.models.llama import LlamaConfig
from opendiloco_torch.trainer import InnerTrainer, TrainerConfig
from torch_dist_child import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TC = dict(lr=1e-3, warmup_steps=2, total_steps=100, precision="fp32", remat=False, attn_impl="xla")
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128)
BASE = dict(local_steps=2, backend="loopback")
# name: (strategy, mesh kwargs, DilocoConfig at two ranks, what one rank runs instead)
CASES = {
    "blocking": ("FULL_SHARD", {}, BASE, {}),
    "eager": ("FULL_SHARD", {}, {**BASE, "overlap_comm": "eager"}, {}),
    "delayed-zero2-ef": ("SHARD_GRAD_OP", {}, {**BASE, "overlap_comm": "delayed", "compression": "fp16",
                                               "error_feedback": True}, {}),
    # more than one rank: device placement and streaming x overlap fall back
    # to host placement and blocking fragments
    "stream-device": ("FULL_SHARD", {}, {**BASE, "streaming_fragments": 2, "overlap_comm": "delayed",
                                         "outer_placement": "device"},
                      {"overlap_comm": "none", "outer_placement": "host"}),
}


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        base, scale = (1.0, 0.1) if "norm" in name else (0.0, 0.02)
        return (base + scale * rng.standard_normal(tree)).astype(np.float32)

    return draw(tllama.shapes(cfg))


def _batches(vocab: int, n: int = 8):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        ids = ((rng.integers(0, vocab, (16, 1)) + np.arange(32)) % vocab).astype(np.int32)
        out.append((ids, ids.copy()))
    return out


def _single_process(cfg, params, batches, dcfg: dict):
    trainer = InnerTrainer(cfg, TrainerConfig(**TC), device="cpu")
    state = trainer.init_state(params=params)
    backend = LoopbackWorld(1, compression=dcfg.get("compression", "none")).make_backends()[0]
    opt = DiLoCoOptimizer(trainer, backend, DilocoConfig(**dcfg), state, batch_size=16)
    masters, losses = [], []
    for ids, labels in batches:
        state, m = opt.step(state, trainer.shard_batch(ids, labels, accum=2))
        losses.append(float(m["loss"]))
        if opt._pending is not None:
            opt._pending["future"].result()  # land each round at the next poll
        masters.append([x.copy() for x in opt.master])
    opt.flush(state)
    return {"masters": masters, "losses": losses, "final": [x.copy() for x in opt.master]}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    cfg = LlamaConfig(**CFG)
    params = _np_params(cfg, 6)
    batches = _batches(cfg.vocab_size)
    cases = {k: (s, kw, d) for k, (s, kw, d, _) in CASES.items()}
    ranks = spawn("diloco", 2, dict(cfg=CFG, params=params, batches=batches, tc=TC, accum=2, cases=cases,
                                    batch_size=16), tmp_path_factory.mktemp("diloco"))
    single = {k: _single_process(cfg, params, batches, {**d, **one}) for k, (_, _, d, one) in CASES.items()}
    return ranks, single


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_worker_gives_the_single_process_masters(two_ranks, case):
    ranks, single = two_ranks
    got, want = ranks[0][case], single[case]
    assert len(got["masters"]) == len(want["masters"]) == 8
    for step, (a, b) in enumerate(zip(got["masters"], want["masters"])):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=1e-5, rtol=0, err_msg=f"step {step}")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    # every rank replays the same host outer step: the masters agree bit for bit
    assert all(np.array_equal(x, y) for x, y in zip(ranks[0][case]["final"], ranks[1][case]["final"]))
    assert ranks[1][case]["losses"] == got["losses"]


@pytest.mark.parametrize("case", list(CASES))
def test_only_the_messenger_holds_a_backend(two_ranks, case):
    ranks, _ = two_ranks
    assert [r[case]["has_backend"] for r in ranks] == [True, False]
    assert all(r[case]["placement"] == "host" and not r[case]["streams"] for r in ranks)


ARGS = ["--path-model", "2m", "--fake-data", "--fake-data-mode", "ramp", "--seq-length", "64",
        "--per-device-train-batch-size", "2", "--total-batch-size", "8", "--total-steps", "8", "--warmup-steps", "2",
        "--lr", "1e-3", "--precision", "fp32", "--metric-logger-type", "dummy", "--ckpt.interval", "4"]


def _launch(args: list, timeout: float = 150.0) -> None:
    """Each argument list one process of ``python -m opendiloco_torch.train``
    on the CPU, all started together; waits with ``timeout``, kills
    stragglers, and fails on a non-zero exit."""
    env = {**os.environ, "OPENDILOCO_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-m", "opendiloco_torch.train", *a], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for a in args]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:  # never leak a wedged process
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)


def _rows(path) -> list:
    with open(path, "rb") as f:
        return pickle.load(f)


def _device_state(step_dir) -> dict:
    from opendiloco_torch.utils import safetensors_io

    return safetensors_io.load_file(str(step_dir / "device_state.safetensors"))


def test_cli_multihost_full_shard_resumes_bit_for_bit(tmp_path):
    """Two processes under FULL_SHARD checkpoint at step 4 and resume bit
    for bit. The checkpoint holds whole leaves: they equal the step-4
    checkpoint of one process on the same global batches (params atol
    1e-5, the AdamW moments within 1e-5 of each leaf's largest magnitude;
    two ranks re-associate the f32 gradient sums), and one process that
    loads it, at the one-process data position, goes on along the
    two-process trajectory (loss rtol 1e-5)."""
    def two(store: str, project: str, extra: list) -> list:
        return [[*ARGS, "--sharding-strategy", "FULL_SHARD", "--multihost", "--coordinator-address",
                 f"file://{tmp_path / store}", "--num-processes", "2", "--process-id", str(i), "--project",
                 str(tmp_path / project), *extra] for i in range(2)]

    ckpts = tmp_path / "ckpts"
    _launch(two("s1", "full.pkl", ["--ckpt.path", str(ckpts)]))
    step4 = ckpts / "model_step_4"
    assert sorted(os.listdir(step4)) == ["dataloader_0.json", "dataloader_1.json", "device_state.safetensors",
                                         "global_state.json"]
    # the resume, and one process from the start, at once
    _launch([*two("s2", "resumed.pkl", ["--ckpt.path", str(tmp_path / "ckpts2"), "--ckpt.resume", str(step4)]),
             [*ARGS, "--project", str(tmp_path / "single.pkl"), "--ckpt.path", str(tmp_path / "single")]])
    full, resumed = _rows(tmp_path / "full.pkl"), _rows(tmp_path / "resumed.pkl")
    assert [r["step"] for r in full] == list(range(1, 9)) and [r["step"] for r in resumed] == [5, 6, 7, 8]
    for r in resumed:
        f = full[r["step"] - 1]
        assert (r["Loss"], r["lr"], r["grad_norm"]) == (f["Loss"], f["lr"], f["grad_norm"])
    got, want = _device_state(step4), _device_state(tmp_path / "single" / "model_step_4")
    assert got.keys() == want.keys() and any(k.startswith("opt_state.nu.") for k in got)
    for k in sorted(want):
        assert got[k].shape == want[k].shape, k
        atol = 1e-5 if k.startswith("params.") else 1e-5 * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=atol, err_msg=k)
    # one process loads the two-process checkpoint and trains on. A data
    # position is per process (process p of n reads samples p, p + n, ...,
    # as in the JAX package), so the copy it loads carries the one
    # process's position: the samples both processes have read
    at_one = tmp_path / "at_one" / "model_step_4"
    shutil.copytree(step4, at_one)
    seen = [json.loads((step4 / f"dataloader_{i}.json").read_text())["dataset"] for i in range(2)]
    (at_one / "dataloader_1.json").unlink()
    (at_one / "dataloader_0.json").write_text(json.dumps(
        {"dataset": {**seen[0], "samples_seen": sum(d["samples_seen"] for d in seen)}}))
    _launch([[*ARGS, "--project", str(tmp_path / "one.pkl"), "--ckpt.path", str(tmp_path / "ckpts3"),
              "--ckpt.resume", str(at_one)]])
    one = _rows(tmp_path / "one.pkl")
    assert [r["step"] for r in one] == [5, 6, 7, 8]
    np.testing.assert_allclose([r["Loss"] for r in one], [f["Loss"] for f in full[4:]], rtol=1e-5)
    assert [r["lr"] for r in one] == [f["lr"] for f in full[4:]]
